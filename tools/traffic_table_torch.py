#!/usr/bin/env python3
"""Per-mesh-size predicted-vs-recorded collective-bytes table, for the
PyTorch / CUDA port (cafe_tpu_torch; no jax). Port of
tools/traffic_table.py: the same configuration, header, columns and
criterion.

The JAX tool compiles the sharded train step on n virtual CPU devices and
sums the compiled collectives' result bytes. torch compiles no program to
read: here n ranks, one process each, run one sharded train step
(--shard_exchange explicit) and the bytes are those of the collectives
the step calls, as parallel/exchange.record_collectives notes them
(cafe_tpu_torch/tools/wire_audit.audit; rank 0's record). That step is
eager (capture=False) on the cards too: the record is made on the host
at each call, and a replayed CUDA graph makes none. The model is
cafe_tpu_torch/tools/hlo_traffic.model_result_bytes. The "HLO total"
column keeps the JAX tool's name and holds the recorded total; per-axis
is the recorded axis ("data" on a flat mesh, "dcn" / "ici" on a
two-level one) where the JAX tool classifies HLO replica groups.

Meshes (a number is a flat mesh, DxI a two-level one of D hosts of I
ranks, --mesh_inner I):
  --device cpu   gloo ranks on the CPU: 2, 4, 8, 4x2 and 2x4 (the JAX
                 tool's 64 and 256 devices would be as many processes).
  --device cuda  NCCL, one rank per card: 2, 4 and 2x2. A mesh of more
                 ranks than there are cards raises.

A row passes when 0.5x <= ratio <= 3x (hash) or 4x (CAFE) and no
collective passes the wire audit's O(batch) bound max(8*m*(dim+4)*4,
2*dense_bytes), its test of table-sized movement. Exit code 1 if a row
fails or a mesh's ranks fail (the JAX tool prints an ERROR row and exits
0).

    python3 tools/traffic_table_torch.py [--method hash|cafe]
        [--meshes 2 4 2x2] [--device cuda]
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys
from typing import Dict, List, Tuple

import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from cafe_tpu_torch.tools.hlo_traffic import model_result_bytes  # noqa
from cafe_tpu_torch.tools.wire_audit import run_audits  # noqa: E402

FIELDS, DIM, CR, VOCAB = 4, 16, 0.05, 2 ** 17
UPPER = {"hash": 3.0, "cafe": 4.0}      # tests/test_sharding.py bounds
MESHES = {"cpu": ["2", "4", "8", "4x2", "2x4"], "cuda": ["2", "4", "2x2"]}
TITLE = ("# Predicted vs compiled collective bytes — {method}, batch "
         "max(128, 2n) x 4 fields, dim 16, cr 0.05, vocab 2^17\n")
HEADER = ("| mesh | batch | collectives | HLO total | model total | "
          "ratio | largest op | table | per-axis |")
RULE = "|---|---|---|---|---|---|---|---|---|"
CRITERION = ("\nPASS criterion (tests/test_sharding.py::TestTrafficPrediction"
             "): 0.5x <= ratio <= 3-4x and no op near table size; the model "
             "is docs/PERF.md's byte model in HLO-result terms.")
GLOO_NOTE = ("gloo ranks on the CPU, one process each: the JAX tool's 64 "
             "and 256 devices would be as many processes, too many to "
             "start on one host.")


def parse_mesh(spec: str) -> Tuple[int, int]:
    """"8" -> (8, 0) flat; "4x2" -> (8, 2): 4 hosts of 2 ranks."""
    if "x" in spec:
        outer, inner = (int(v) for v in spec.split("x"))
        return outer * inner, inner
    return int(spec), 0


def shape_label(n: int, inner: int) -> str:
    return f"{n}" if not inner else f"{n // inner}x{inner} dcn/ici"


def config_argv(n: int, inner: int, method: str, device: str) -> List[str]:
    """main_torch.py's flags for the JAX tool's child configuration
    (tools/traffic_table.py:45-50) on an n-rank mesh."""
    return ["--dataset", "synthetic", "--embedding_dim", str(DIM),
            "--compress_method", method, "--compress_rate", str(CR),
            "--cafe_sketch_threshold", "5", "--learning_rate", "0.1",
            "--synthetic_rows", "4096", "--synthetic_fields", str(FIELDS),
            "--synthetic_vocab", str(VOCAB), "--synthetic_dense", "13",
            "--mini_batch_size", str(max(128, 2 * n)),
            "--shard_embeddings", "true", "--shard_exchange", "explicit",
            "--mesh_inner", str(inner), "--tensor_board_filename", ""] \
        + (["--force_platform", "cpu"] if device == "cpu" else [])


def record(res: Dict, n: int, inner: int, method: str) -> Dict:
    """One row's numbers from rank 0's audit (the JAX tool's child
    record, plus the audit's bound, the count over it and bytes by op)."""
    by_op: Dict[str, int] = {}
    for op, _, nb in res["collectives"]:
        by_op[op] = by_op.get(op, 0) + nb
    model = model_result_bytes(res["lanes"], DIM, n, res["dense_bytes"],
                               method=method, hotn=res["hotn"])
    return {"n": n, "inner": inner, "method": method,
            "batch": max(128, 2 * n),
            "collectives": len(res["collectives"]),
            "hlo_total": res["total"],
            "largest": max((c[2] for c in res["collectives"]), default=0),
            "model_total": model["total"], "model": model,
            "table_bytes": 4 * DIM * res["part0_rows"],
            "per_axis": res["by_axis"], "by_op": by_op,
            "bound": res["bound"], "over": res["over"]}


def check_cards(meshes: List[Tuple[int, int]], device: str) -> None:
    """Raise unless every mesh has a card per rank (device cuda)."""
    if device != "cuda":
        return
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    need = max(n for n, _ in meshes)
    if need > cards:
        raise RuntimeError(f"traffic_table: a {need}-rank mesh needs {need}"
                           f" CUDA cards (one NCCL rank each); found "
                           f"{cards}")


def rows(n: int, inner: int, methods: List[str], device: str = "cuda"
         ) -> List[Dict]:
    """Each method's record on one n-rank mesh, audited in one set of
    ranks (this process at n = 1)."""
    check_cards([(n, inner)], device)
    reports = run_audits([config_argv(n, inner, m, device)
                          for m in methods], n)
    return [record(res, n, inner, m) for res, m in zip(reports, methods)]


def ratio(r: Dict) -> float:
    return r["hlo_total"] / max(r["model_total"], 1)


def passes(r: Dict) -> bool:
    """The JAX tool's criterion: ratio within [0.5, 3 or 4] and no
    collective past the O(batch) bound."""
    return 0.5 <= ratio(r) <= UPPER[r["method"]] and r["over"] == 0


def format_row(r: Dict) -> str:
    """The JAX tool's markdown row (tools/traffic_table.py:113-126)."""
    ax = ", ".join(f"{k} {v/1024:.0f}K" for k, v in
                   sorted(r["per_axis"].items())) or "-"
    return (f"| {shape_label(r['n'], r['inner'])} | {r['batch']} | "
            f"{r['collectives']} | {r['hlo_total']/1024:.0f} KB | "
            f"{r['model_total']/1024:.0f} KB | {ratio(r):.2f}x | "
            f"{r['largest']/1024:.0f} KB | "
            f"{r['table_bytes']/1024:.0f} KB | {ax} |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--method", default="hash", choices=["hash", "cafe"])
    ap.add_argument("--meshes", nargs="+", default=None,
                    help="flat sizes (8) and two-level DxI (4x2); default "
                         "per device: cpu 2 4 8 4x2 2x4, cuda 2 4 2x2")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    meshes = [parse_mesh(m) for m in (args.meshes or MESHES[args.device])]
    check_cards(meshes, args.device)

    print(TITLE.format(method=args.method))
    print(HEADER)
    print(RULE)
    failed = []
    for n, inner in meshes:
        try:
            r = rows(n, inner, [args.method], args.device)[0]
        except RuntimeError as e:
            print(f"| {shape_label(n, inner)} | ERROR | | | | | | | "
                  f"{str(e)[:80]} |", flush=True)
            failed.append(shape_label(n, inner))
            continue
        print(format_row(r), flush=True)
        if not passes(r):
            failed.append(shape_label(n, inner))
    print(CRITERION)
    if args.device == "cpu":
        print(GLOO_NOTE)
    if failed:
        print(f"FAIL: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
