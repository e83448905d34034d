"""Experiment-grid runner over task JSONs (port of
cafe_tpu/tools/job_scheduler.py): each task is one run of main_torch.py.

Reads the reference's task-file format unchanged: a `base` section plus
per-method sections where list-valued keys in {compress_rate,
cafe_sketch_threshold, cafe_hash_rate, cafe_decay} are zipped into one
task per position (paired knob schedules). Each task gets a
tensor_board_filename suffixed by its distinguishing value, a config.json
dump, and a captured stdouterr.log.

Tasks run on the card, as sequential subprocesses by default or round
robin over N parallel workers (--workers N); --cpu appends
`--force_platform cpu` to every task's flags, so a grid runs on the CPU.

Usage:
  python -m cafe_tpu_torch.tools.job_scheduler tasks/criteo.json
  python -m cafe_tpu_torch.tools.job_scheduler --cpu --workers 4 grid.json
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import sys
from typing import Dict, List

FLATTEN = ["compress_rate", "cafe_sketch_threshold", "cafe_hash_rate",
           "cafe_decay"]
# canonical section ordering (reference method names); any other non-"base"
# section (e.g. "cafe_plus", sensitivity variants) runs after these
METHODS = ["full", "hash", "qr", "ada", "mde", "cafe", "off"]


def load_tasks(config_file: str,
               flatten: List[str] = FLATTEN) -> List[Dict]:
    with open(config_file) as f:
        config = json.load(f)
    base_args = config["base"]
    tasks = []
    extra = [k for k in config if k != "base" and k not in METHODS]
    for met in METHODS + extra:
        if met not in config:
            continue
        if not isinstance(config[met], dict):
            raise ValueError(
                f"section {met!r} must be an object of flag overrides "
                f"(see tasks/criteo.json), got "
                f"{type(config[met]).__name__}")
        new_task = dict(base_args)
        flags = {}
        for k, v in config[met].items():
            if k not in flatten or not isinstance(v, list):
                new_task[k] = v
            else:
                flags[k] = v
        if not flags:
            tasks.append(new_task)
            continue
        keys = list(flags.keys())
        diff = "compress_rate" if "compress_rate" in flags else keys[0]
        if diff != "compress_rate" and len(flags) > 1:
            raise ValueError(
                f"section {met!r} sweeps {keys} without compress_rate: "
                f"only compress_rate may anchor a multi-knob zip (other "
                f"lists pair WITH it, one value per rate)")
        lens = {k: len(v) for k, v in flags.items()}
        if len(set(lens.values())) > 1:
            raise ValueError(
                f"paired knob lists in section {met!r} have mismatched "
                f"lengths {lens}; zip would silently drop grid points")
        for vs in zip(*flags.values()):
            cur = dict(new_task)
            for k, v in zip(keys, vs):
                cur[k] = v
            cur["tensor_board_filename"] = (
                cur.get("tensor_board_filename", "board/run") + str(cur[diff]))
            tasks.append(cur)
    return tasks


def run_task(task: Dict, root: str, cpu: bool = False) -> int:
    """One task as a main_torch.py subprocess (on the card, or on the CPU
    with `cpu`); its config.json and stdouterr.log go to the task's board
    directory. Returns the process's return code."""
    task = dict(task)
    for key in ("data_path", "tensor_board_filename"):
        if key in task and not osp.isabs(str(task[key])):
            task[key] = osp.join(root, str(task[key]))
    log_dir = task.get("tensor_board_filename", osp.join(root, "board/run"))
    os.makedirs(log_dir, exist_ok=True)
    with open(osp.join(log_dir, "config.json"), "w") as f:
        json.dump(task, f, indent=4)
    cmd = [sys.executable, osp.join(root, "main_torch.py")]
    for k, v in task.items():
        cmd += [f"--{k}", str(v)]
    if cpu:
        cmd += ["--force_platform", "cpu"]
    with open(osp.join(log_dir, "stdouterr.log"), "w") as log:
        result = subprocess.run(cmd, stdout=log, stderr=log, text=True)
    name = osp.split(log_dir)[1]
    print(f"Task {name} finished with return code {result.returncode}",
          flush=True)
    return result.returncode


def schedule(config_files: List[str], workers: int = 1,
             cpu: bool = False) -> List[int]:
    root = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
    tasks: List[Dict] = []
    for cf in config_files:
        tasks.extend(load_tasks(cf))
    print(f"Number of tasks: {len(tasks)}")
    if workers <= 1:
        return [run_task(t, root, cpu) for t in tasks]
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        futures = [ex.submit(run_task, t, root, cpu) for t in tasks]
        return [f.result() for f in futures]


def main(argv=None):
    p = argparse.ArgumentParser(description="Run task grids.")
    p.add_argument("configs", nargs="+")
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--cpu", action="store_true",
                   help="run every task with --force_platform cpu")
    args = p.parse_args(argv)
    codes = schedule(args.configs, args.workers, args.cpu)
    # signal deaths have NEGATIVE returncodes (e.g. -9 for OOM-kill);
    # max() would report success for them
    sys.exit(max((abs(c) for c in codes), default=0))


if __name__ == "__main__":
    main()
