"""Serving export (port of cafe_tpu/tools/export_model.py): the eval step
with the trained state baked in, loadable without the Python model code.

The JAX package serializes its jitted eval step with jax.export. The
port's counterpart is torch.export.export of a module whose forward is
the eager eval path (gather, transform, towers) with the trained state
closed over as constants, saved with torch.export.save;
`load_and_run` is torch.export.load(path).module()(*args). A state on
the card is exported from its CUDA tensors and the program runs there;
the eager path is exported, never a CUDA graph.

    python -m cafe_tpu_torch.tools.export_model --checkpoint run/m \\
        --config_json run/config.json --out model.pt2 [--batch_size 1024]

`--config_json` is a flat JSON of the run's flags (config.from_json);
`force_platform: "cpu"` in it exports on the CPU, anything else on the
card.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..train.step import build_eval_step


class _Serve(torch.nn.Module):
    """eval(dense, ids) -> prob, or eval(ids) for a zero-dense dataset
    (the models then take dense=None): build_eval_step's eager step on
    the closed-over state."""

    def __init__(self, model, embed_layer, state, dense: bool):
        super().__init__()
        self._step = build_eval_step(model, embed_layer, capture=False)
        self._state, self._dense = state, dense

    def forward(self, *args):
        if self._dense:
            return self._step(self._state, *args)
        return self._step(self._state, None, *args)


def export_eval_step(model, embed_layer, state, batch_size: int,
                     num_dense: int, num_sparse: int, out_path: str) -> int:
    """Write eval(dense, ids) -> prob with the trained state baked in, on
    the state's device, for batches of `batch_size`. Returns the size of
    the written file in bytes."""
    dev = state.step.device
    ids = torch.zeros((batch_size, num_sparse), dtype=torch.int32,
                      device=dev)
    if num_dense > 0:
        args = (torch.zeros((batch_size, num_dense), dtype=torch.float32,
                            device=dev), ids)
    else:
        args = (ids,)
    serve = _Serve(model, embed_layer, state, num_dense > 0)
    with torch.no_grad():
        # one eager call first: the parts make their cached constants
        # lazily, and a first call under the tracer would cache traced
        # tensors in their place
        serve(*args)
        program = torch.export.export(serve, args)
    torch.export.save(program, out_path)
    return os.path.getsize(out_path)


def load_and_run(path: str, *args):
    """Load and call: (dense, ids) for dense models, (ids,) for zero-dense
    ones, as export_eval_step wrote them."""
    with torch.no_grad():
        return torch.export.load(path).module()(*args)


def main(argv=None):
    p = argparse.ArgumentParser(description="Export a trained model.")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--config_json", required=True,
                   help="the run's flags as a flat JSON document")
    args = p.parse_args(argv)
    from ..config import from_json
    from ..train.checkpoint import load_checkpoint
    from ..train.loop import build_all, get_dataset
    cfg = from_json(args.config_json)
    device = "cpu" if cfg.force_platform == "cpu" else "cuda"
    train_data = get_dataset(cfg, "train")
    model, embed, state, _, _ = build_all(cfg, train_data, device=device,
                                          capture=False)
    state, _ = load_checkpoint(args.checkpoint, state)
    n = export_eval_step(model, embed, state, args.batch_size,
                         train_data.num_dense, train_data.num_sparse,
                         args.out)
    print(f"exported {n} bytes to {args.out}")


if __name__ == "__main__":
    main()
