"""Offline preprocessing: raw CSV/TSV -> binary memmap format.

Replicates the contract of ArtifactEvaluation/datasets/process_data.py
BYTE-FOR-BYTE on the Criteo one-shot path (tests/test_preprocess_parity.py
runs both on the same raw fixture and compares output files):
  * dense features  -> log(x + 1) if x > 0 else 0, missing -> 0
    (process_data.py:64-73; the exact np.log(x+1) double-rounding is
    reproduced, not log1p)
  * sparse features -> per-field label encoding in SORTED unique-value
    order (sklearn LabelEncoder.fit_transform semantics), missing ->
    the string "0" (pandas fillna("0")), each field an independent
    contiguous id space starting at 0                    (process_data.py:75-86)
  * outputs processed_{sparse_sep,dense,label,count}.bin

Parity caveat: pandas type inference — a sparse column whose every value
parses numeric becomes int64 and LabelEncoder then sorts numerically;
this encoder always keys raw strings. Criteo's hex fields parse as
object/str, where the two agree.

Implemented as a streaming two-pass encoder (pass 1: collect per-field
vocabularies; pass 2: encode) so terabyte-scale inputs never need to fit in
memory — the reference's CriteoTB path does the same with pickled unique sets
(process_data.py:106-162).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import List, Optional

import numpy as np


class StreamingEncoder:
    def __init__(self, num_dense: int, num_sparse: int,
                 label_col: int = 0, dense_cols: Optional[List[int]] = None,
                 sparse_cols: Optional[List[int]] = None, sep: str = "\t",
                 clip_label: bool = False, skip_header: bool = False):
        self.num_dense = num_dense
        self.num_sparse = num_sparse
        self.label_col = label_col
        self.dense_cols = dense_cols or list(range(1, 1 + num_dense))
        self.sparse_cols = (sparse_cols
                            or list(range(1 + num_dense,
                                          1 + num_dense + num_sparse)))
        self.sep = sep
        self.clip_label = clip_label
        self.skip_header = skip_header
        self.vocabs: List[dict] = [dict() for _ in range(num_sparse)]

    def collect(self, path: str) -> None:
        with open(path, "r") as f:
            if self.skip_header:
                next(f, None)
            for line in f:
                cols = line.rstrip("\n").split(self.sep)
                for j, c in enumerate(self.sparse_cols):
                    v = cols[c] if c < len(cols) and cols[c] else "0"
                    vocab = self.vocabs[j]
                    if v not in vocab:
                        vocab[v] = len(vocab)

    def finalize(self) -> None:
        """Re-key every vocabulary to SORTED unique-value order — sklearn
        LabelEncoder semantics (process_data.py:82-84), so ids match the
        reference encoder exactly. Idempotent; encode() calls it."""
        self.vocabs = [{k: i for i, k in enumerate(sorted(v))}
                       for v in self.vocabs]

    def encode(self, paths: List[str], out_dir: str,
               chunk_rows: int = 1_000_000) -> None:
        self.finalize()
        os.makedirs(out_dir, exist_ok=True)
        counts = np.array([len(v) for v in self.vocabs], dtype=np.int32)
        counts.tofile(osp.join(out_dir, "processed_count.bin"))
        sp_f = open(osp.join(out_dir, "processed_sparse_sep.bin"), "wb")
        de_f = (open(osp.join(out_dir, "processed_dense.bin"), "wb")
                if self.num_dense else None)
        la_f = open(osp.join(out_dir, "processed_label.bin"), "wb")
        sp_buf, de_buf, la_buf = [], [], []

        def flush():
            if sp_buf:
                np.asarray(sp_buf, dtype=np.int32).tofile(sp_f)
                sp_buf.clear()
            if de_f is not None and de_buf:
                np.asarray(de_buf, dtype=np.float32).tofile(de_f)
                de_buf.clear()
            if la_buf:
                np.asarray(la_buf, dtype=np.int32).tofile(la_f)
                la_buf.clear()

        for path in paths:
            with open(path, "r") as f:
                if self.skip_header:
                    next(f, None)
                for line in f:
                    cols = line.rstrip("\n").split(self.sep)
                    lab = cols[self.label_col]
                    lab = int(float(lab)) if lab else 0
                    if self.clip_label:  # kdd12 clicks>1 -> 1
                        lab = min(lab, 1)
                    la_buf.append(lab)
                    if self.num_dense:
                        row = []
                        for c in self.dense_cols:
                            v = cols[c] if c < len(cols) else ""
                            x = float(v) if v not in ("", None) else 0.0
                            # exact reference math: np.log(x+1) if x > 0
                            # else 0 (process_data.py:70-72) — not log1p,
                            # whose double rounding can differ by 1 ulp
                            row.append(np.log(x + 1.0) if x > 0 else 0.0)
                        de_buf.append(row)
                    srow = []
                    for j, c in enumerate(self.sparse_cols):
                        v = cols[c] if c < len(cols) and cols[c] else "0"
                        srow.append(self.vocabs[j].get(v, 0))
                    sp_buf.append(srow)
                    if len(sp_buf) >= chunk_rows:
                        flush()
        flush()
        sp_f.close()
        la_f.close()
        if de_f is not None:
            de_f.close()


def process_criteo(in_path: str, out_dir: str) -> None:
    enc = StreamingEncoder(num_dense=13, num_sparse=26, sep="\t")
    enc.collect(in_path)
    enc.encode([in_path], out_dir)


def process_criteotb(day_paths: List[str], out_dir: str) -> None:
    """CriteoTB: 24 day files -> per-day binaries sparse_{d}_sep.bin /
    dense_{d}.bin / label_{d}.bin + global processed_count.bin (reference:
    per-day streaming + global re-encode, process_data.py:106-162)."""
    enc = StreamingEncoder(num_dense=13, num_sparse=26, sep="\t")
    for p in day_paths:
        enc.collect(p)
    os.makedirs(out_dir, exist_ok=True)
    counts = np.array([len(v) for v in enc.vocabs], dtype=np.int32)
    counts.tofile(osp.join(out_dir, "processed_count.bin"))
    for day, p in enumerate(day_paths):
        sub = StreamingEncoder(num_dense=13, num_sparse=26, sep="\t")
        sub.vocabs = enc.vocabs  # shared global vocabulary
        tmp = osp.join(out_dir, f"_day{day}")
        sub.encode([p], tmp)
        os.replace(osp.join(tmp, "processed_sparse_sep.bin"),
                   osp.join(out_dir, f"sparse_{day}_sep.bin"))
        os.replace(osp.join(tmp, "processed_dense.bin"),
                   osp.join(out_dir, f"dense_{day}.bin"))
        os.replace(osp.join(tmp, "processed_label.bin"),
                   osp.join(out_dir, f"label_{day}.bin"))
        os.remove(osp.join(tmp, "processed_count.bin"))
        os.rmdir(tmp)


def process_avazu(in_path: str, out_dir: str) -> None:
    # avazu csv: id,click,hour,C1,... (WITH a header row) -> drop id,
    # label=click, 22 sparse
    enc = StreamingEncoder(num_dense=0, num_sparse=22, label_col=1,
                           sparse_cols=list(range(2, 24)), sep=",",
                           skip_header=True)
    enc.collect(in_path)
    enc.encode([in_path], out_dir)


def process_kdd12(in_path: str, out_dir: str) -> None:
    enc = StreamingEncoder(num_dense=0, num_sparse=11, label_col=0,
                           sparse_cols=list(range(1, 12)), sep="\t",
                           clip_label=True)
    enc.collect(in_path)
    enc.encode([in_path], out_dir)


def main(argv=None):
    p = argparse.ArgumentParser(description="Preprocess raw CTR data.")
    p.add_argument("--dataset", required=True,
                   choices=["criteo", "criteotb", "avazu", "kdd12"])
    p.add_argument("--input", required=True, nargs="+",
                   help="input file; criteotb takes the day files in order")
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)
    if args.dataset == "criteotb":
        process_criteotb(args.input, args.output)
        return
    if len(args.input) != 1:
        p.error(f"--dataset {args.dataset} takes exactly one input file")
    {"criteo": process_criteo, "avazu": process_avazu,
     "kdd12": process_kdd12}[args.dataset](args.input[0], args.output)


if __name__ == "__main__":
    main()
