"""The serving export (cafe_tpu_torch/tools/export_model.py) on the CPU:
the exported program, loaded back with none of the model code, scores a
batch as the port's eval step does (within 1e-5) and as the JAX
package's eval step does on the same bridged state, for CAFE v1, CAFE+
and QR; the zero-dense variant; the tool's main from a checkpoint and a
config JSON (tests/test_tools.py's export round trip)."""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafe_tpu.config import Config as JConfig
from cafe_tpu.data import batch_iterator as jbatches
from cafe_tpu.train.loop import build_all as jbuild_all, get_dataset as jdata
from cafe_tpu_torch.bridge import from_reference
from cafe_tpu_torch.config import Config as TConfig
from cafe_tpu_torch.tools.export_model import (export_eval_step,
                                               load_and_run, main)
from cafe_tpu_torch.train import build_all as tbuild_all, get_dataset
from cafe_tpu_torch.train.checkpoint import load_checkpoint
from test_torch_train import SMALL

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B = 16
CONFIGS = {"cafe": {}, "cafe_plus": {"cafe_plus": True},
           "qr": {"compress_method": "qr"},
           "cafe_zero_dense": {"synthetic_dense": 0}}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_export_round_trip(name, tmp_path):
    kw = dict(SMALL, **CONFIGS[name])
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jtrain = jdata(jcfg, "train")
    _, _, jstate, jstep, jeval = jbuild_all(jcfg, jtrain)
    for dense, sparse, label, valid in list(jbatches(
            jtrain, kw["mini_batch_size"], drop_last=True))[:2]:
        jstate, _ = jstep(jstate, None if dense is None
                          else jnp.asarray(dense), jnp.asarray(sparse),
                          jnp.asarray(label), valid)
    jstate = jax.device_get(jstate)
    data = get_dataset(tcfg, "train")
    model, embed, _, _, eval_step = tbuild_all(tcfg, data, device="cpu")
    state = from_reference(jstate, "cpu")
    out = str(tmp_path / "model.pt2")
    n = export_eval_step(model, embed, state, B, data.num_dense,
                         data.num_sparse, out)
    assert n > 1000
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 500, (B, data.num_sparse)).astype(np.int32)
    dense = (None if data.num_dense == 0 else
             rng.normal(0, 1, (B, data.num_dense)).astype(np.float32))
    args = (torch.from_numpy(ids),) if dense is None else \
        (torch.from_numpy(dense), torch.from_numpy(ids))
    served = load_and_run(out, *args)
    direct = eval_step(state, None if dense is None else args[0], args[-1])
    np.testing.assert_allclose(served.numpy(), direct.numpy(), atol=1e-5)
    want = np.asarray(jeval(jstate, None if dense is None
                            else jnp.asarray(dense), jnp.asarray(ids)))
    np.testing.assert_allclose(served.numpy(), want, atol=1e-5)


def test_export_tool_main(tmp_path, capsys):
    """main_torch trains and saves; the tool exports that checkpoint from
    the run's flags as JSON; the program scores as the reloaded eval
    step."""
    sys.path.insert(0, str(REPO))
    import main_torch
    flags = dict(SMALL, synthetic_rows=2048, test_freq=6,
                 force_platform="cpu", tensor_board_filename="",
                 save_model=str(tmp_path / "m"))
    main_torch.main([x for k, v in flags.items()
                     for x in (f"--{k}", str(v))])
    assert "saved model to" in capsys.readouterr().out
    cfg_json = tmp_path / "config.json"
    cfg_json.write_text(json.dumps(dataclasses.asdict(TConfig(**flags))))
    out = str(tmp_path / "model.pt2")
    main(["--checkpoint", flags["save_model"], "--out", out,
          "--batch_size", str(B), "--config_json", str(cfg_json)])
    assert f"to {out}" in capsys.readouterr().out
    cfg = TConfig(**flags)
    data = get_dataset(cfg, "test")
    _, _, state, _, eval_step = tbuild_all(cfg, get_dataset(cfg, "train"),
                                           device="cpu")
    state, _ = load_checkpoint(flags["save_model"], state)
    args = (torch.from_numpy(np.ascontiguousarray(data.dense[:B])),
            torch.from_numpy(np.ascontiguousarray(data.sparse[:B])))
    np.testing.assert_allclose(load_and_run(out, *args).numpy(),
                               eval_step(state, *args).numpy(), atol=1e-5)
