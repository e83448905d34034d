"""Interactions-CSV preprocessing for the graph recommenders (a copy of
cafe_tpu/tools/process_interactions.py that names this package in its
usage line; the same events give the same train.txt / test.txt bytes).

The role of the reference's process_nowplaying_rs.py (TOIS_revision/
PinSAGE): ingest a (user, item, timestamp) event table, factorize the ids,
and split each user's interactions by time — the last `leave_n` events are
held out for evaluation (data_utils.py:13-52's train/val/test-by-time).
Output is the gowalla-style train.txt/test.txt ("user item item ...")
that `main_graphrec_torch.py --data_path` consumes for both LightGCN and
PinSAGE (whose hit@K evaluation seeds on each user's LAST train item, so
train lines here are written in ascending time order).

Usage:
  python -m cafe_tpu_torch.tools.process_interactions --input events.csv \
      --output data/mydataset --user_col user_id --item_col track_id \
      --time_col created_at
"""

from __future__ import annotations

import argparse
import csv
import os
import os.path as osp
from typing import Dict, List


def process(input_path: str, out_dir: str, user_col: str, item_col: str,
            time_col: str = "", leave_n: int = 1, sep: str = ",") -> Dict:
    users: Dict[str, int] = {}
    items: Dict[str, int] = {}
    events: List[tuple] = []
    with open(input_path, newline="") as f:
        reader = csv.DictReader(f, delimiter=sep)
        cols = reader.fieldnames or []
        missing = [c for c in (user_col, item_col) +
                   ((time_col,) if time_col else ()) if c not in cols]
        if missing:
            raise ValueError(f"columns {missing} not in CSV header {cols}")
        for row in reader:
            u, i = row.get(user_col), row.get(item_col)
            if not u or not i:
                continue
            t = row.get(time_col, "") if time_col else ""
            if u not in users:
                users[u] = len(users)
            if i not in items:
                items[i] = len(items)
            events.append((users[u], items[i], t))

    per_user: List[List[tuple]] = [[] for _ in range(len(users))]
    for idx, (u, i, t) in enumerate(events):
        # stable key: timestamp string (lexicographic; ISO timestamps and
        # zero-padded epochs sort correctly), arrival order as tiebreak
        per_user[u].append((t, idx, i))

    os.makedirs(out_dir, exist_ok=True)
    n_train = n_test = 0
    with open(osp.join(out_dir, "train.txt"), "w") as ftr, \
            open(osp.join(out_dir, "test.txt"), "w") as fte:
        for u, evs in enumerate(per_user):
            evs.sort()
            seen = set()
            ordered = []
            for _, _, i in evs:           # dedup, keep first occurrence
                if i not in seen:
                    seen.add(i)
                    ordered.append(i)
            cut = max(len(ordered) - leave_n, 1) if len(ordered) > 1 \
                else len(ordered)
            train, test = ordered[:cut], ordered[cut:]
            ftr.write(" ".join(map(str, [u] + train)) + "\n")
            fte.write(" ".join(map(str, [u] + test)) + "\n")
            n_train += len(train)
            n_test += len(test)
    return {"users": len(users), "items": len(items),
            "train_interactions": n_train, "test_interactions": n_test}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert an interactions CSV to graphrec train/test.txt")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--user_col", default="user_id")
    p.add_argument("--item_col", default="item_id")
    p.add_argument("--time_col", default="",
                   help="timestamp column for the by-time split; empty = "
                        "arrival order")
    p.add_argument("--leave_n", type=int, default=1,
                   help="held-out interactions per user (last by time)")
    p.add_argument("--sep", default=",")
    args = p.parse_args(argv)
    stats = process(args.input, args.output, args.user_col, args.item_col,
                    args.time_col, args.leave_n, args.sep)
    print(stats)


if __name__ == "__main__":
    main()
