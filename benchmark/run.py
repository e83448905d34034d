#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. Prints one JSON line last on standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), `device`, with --trace 1 `breakdown`,
and last `checks`, each number the check compared with its limit; the
same numbers are the last lines on standard error. Exits non-zero with
no result when there is no card, fewer cards than the cell asks for, or
when the process holds JAX or the JAX package after the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "cafe_tpu")


def forbidden_modules():
    """The loaded modules whose top-level name is JAX's or the JAX
    package's (compared whole: cafe_tpu_torch is not cafe_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # also read the control and the planted faults of the check (the
    # readings its limits were set from; off in the benchmark's runs)
    p.add_argument("--readings", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark import check, core
    from benchmark.cell import Run

    man = core.manifest()
    cell = core.cell(man, args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"benchmark: the cell {cell['name']} needs {cell['chips']} "
              f"CUDA card(s); torch sees {cards}", file=sys.stderr)
        return 2
    run = Run(man, cell, core.config(man, cell["config"]),
              core.traffic(cell["traffic"]), core.limits(cell["name"]),
              args.seed, args.seconds, bool(args.trace),
              [f"cuda:{i}" for i in range(cell["chips"])], T_START,
              readings=bool(args.readings))
    res = run.run()
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {found} after the window",
              file=sys.stderr)
        return 3
    for note in run.notes:
        print(note, file=sys.stderr)
    print(json.dumps(res), flush=True)
    for line in check.lines(run.numbers, run.limits):
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
