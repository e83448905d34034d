#!/usr/bin/env python3
"""The readings a cell's limits are set from, many seeds in one process.

    python3 benchmark/readings.py --workload <cell> --seeds <n> [<n> ...] \
        [--faults <m>]

For each seed: the cell's set-up and checked calls (no warm-up, no
window), the check's numbers against the reference, and for the first
`--faults` seeds also the control's and the planted faults' numbers
(their gaps from the reference). One JSON line a seed, then a summary:
the largest sound reading of each number (the lower reading) and the
smallest reading of each control or fault (the upper ones). The
benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", type=int, default=3)
    args = p.parse_args(argv)
    import torch

    from benchmark import core
    from benchmark.cell import Run

    man = core.manifest()
    cell = core.cell(man, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print("readings: the cell's cards are not here", file=sys.stderr)
        return 2
    lower, upper = {}, {}
    for i, seed in enumerate(args.seeds):
        run = Run(man, cell, core.config(man, cell["config"]),
                  core.traffic(cell["traffic"]), core.limits(cell["name"]),
                  seed, 0.0, False,
                  [f"cuda:{d}" for d in range(cell["chips"])],
                  time.perf_counter(), readings=i < args.faults, quick=True)
        res = run.run()
        nums = {k: v["value"] for k, v in res["checks"].items()}
        for k, v in nums.items():
            lower[k] = max(lower.get(k, 0.0), v)
        for name, rd in (res.get("readings") or {}).items():
            for k, v in rd.items():
                key = f"{name}.{k}"
                upper[key] = min(upper.get(key, float("inf")), v)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "numbers": nums,
                          "readings": res.get("readings"),
                          "notes": run.notes}), flush=True)
        del run, res
    print(json.dumps({"workload": cell["name"], "seeds": len(args.seeds),
                      "lower": lower, "upper": upper,
                      "seconds": time.perf_counter() - T_START}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
