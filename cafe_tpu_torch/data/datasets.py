"""CTR datasets over the reference's binary memmap format.

Binary layout (identical to ArtifactEvaluation/load_data.py:39-66 so datasets
preprocessed for the reference work here unchanged):

  processed_sparse_sep.bin : int32   [num_sample, num_sparse]  per-field ids
  processed_dense.bin      : float32 [num_sample, num_dense]   log(1+x) dense
  processed_label.bin      : int32   [num_sample]
  processed_count.bin      : int32   [num_sparse]              per-field vocab

Splits replicate the reference exactly:
  criteo   6/7 head train, 1/7 tail test      (load_data.py:162-171)
  avazu    last 4,218,938 rows test           (load_data.py:283-291)
  kdd12    seed-2023 shuffled 10% test        (load_data.py:307-318)
  criteotb day files 0-22 train / 23 test     (load_data.py:174-267)

Unlike the reference (torch DataLoader + per-sample __getitem__ + collate,
load_data.py:385-443), batches here are contiguous memmap slices — the files
are row-major and access is sequential, so a batch is one memcpy. Batch shapes
are static (jit-friendly): the final partial batch is padded and carries a
`valid` count.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DatasetSpec:
    num_sparse: int
    num_dense: int
    num_sample: int


# Row/field counts: ArtifactEvaluation/load_data.py:149-321.
DATASET_SPECS = {
    "criteo": DatasetSpec(26, 13, 45840617),
    "criteotb": DatasetSpec(26, 13, 4373472329),
    "avazu": DatasetSpec(22, 0, 40428967),
    "kdd12": DatasetSpec(11, 0, 149639105),
    "criteotb13": DatasetSpec(26, 13, 1648937279),
}


@dataclasses.dataclass
class CTRArrays:
    """One split of a CTR dataset as (possibly memmapped) arrays.

    `index` (optional) is a row-permutation (kdd12's random split); when
    present, batch slicing goes through fancy indexing instead of a raw slice.
    """

    sparse: np.ndarray  # int32 [N, F]
    dense: Optional[np.ndarray]  # float32 [N, D] or None
    label: np.ndarray  # int32 [N]
    counts: np.ndarray  # int32 [F] per-field vocabulary sizes
    index: Optional[np.ndarray] = None
    # --max_ind_range hashing (dlrm_s_pytorch's --max-ind-range): ids are
    # reduced modulo this at batch/stat time; 0 = off. counts must be
    # clamped consistently by the loader.
    mod_range: int = 0

    @property
    def num_sparse(self) -> int:
        return self.sparse.shape[1]

    @property
    def num_dense(self) -> int:
        return 0 if self.dense is None else self.dense.shape[1]

    def __len__(self) -> int:
        return len(self.index) if self.index is not None else len(self.label)


def _mm(path: str, dtype, shape) -> np.ndarray:
    if not osp.exists(path):
        raise FileNotFoundError(f"Data not exists: {path}")
    return np.memmap(path, dtype=dtype, mode="r").reshape(shape)


def _load_flat(data_path: str, spec: DatasetSpec) -> CTRArrays:
    sparse = _mm(osp.join(data_path, "processed_sparse_sep.bin"), np.int32,
                 (-1, spec.num_sparse))
    n = sparse.shape[0]
    dense = None
    if spec.num_dense:
        dense = _mm(osp.join(data_path, "processed_dense.bin"), np.float32,
                    (n, spec.num_dense))
    label = _mm(osp.join(data_path, "processed_label.bin"), np.int32, (n,))
    counts = np.fromfile(osp.join(data_path, "processed_count.bin"),
                         dtype=np.int32)
    return CTRArrays(sparse, dense, label, counts)


def _split_head_tail(a: CTRArrays, train_len: int, phase: str) -> CTRArrays:
    sl = slice(0, train_len) if phase == "train" else slice(train_len, None)
    return CTRArrays(
        a.sparse[sl],
        a.dense[sl] if a.dense is not None else None,
        a.label[sl],
        a.counts,
        mod_range=a.mod_range,
    )


def _load_criteotb(data_path: str, phase: str, spec: DatasetSpec,
                   max_ind_range: int, train_days) -> CTRArrays:
    """Day-file CriteoTB; days are concatenated logically via per-day memmaps.

    For simplicity of the slicing path we concatenate lazily only at batch
    time; here we return per-day arrays stitched with an index table.
    """
    counts = np.fromfile(osp.join(data_path, "processed_count.bin"),
                         dtype=np.int32)
    if max_ind_range > 0:
        counts = np.minimum(counts, max_ind_range)
    if phase == "train":
        days = list(train_days)
    else:
        days = [23]
    sparse_parts, dense_parts, label_parts = [], [], []
    for day in days:
        sp = _mm(osp.join(data_path, f"sparse_{day}_sep.bin"), np.int32,
                 (-1, spec.num_sparse))
        de = _mm(osp.join(data_path, f"dense_{day}.bin"), np.float32,
                 (-1, spec.num_dense))
        la = _mm(osp.join(data_path, f"label_{day}.bin"), np.int32, (-1,))
        sparse_parts.append(sp)
        dense_parts.append(de)
        label_parts.append(la)
    return _MultiFileCTRArrays(sparse_parts, dense_parts, label_parts, counts,
                               max_ind_range)


class _MultiFileCTRArrays(CTRArrays):
    """CriteoTB-style multi-day split; rows span several memmap files."""

    def __init__(self, sparse_parts, dense_parts, label_parts, counts,
                 max_ind_range):
        self.sparse_parts = sparse_parts
        self.dense_parts = dense_parts
        self.label_parts = label_parts
        self.max_ind_range = max_ind_range
        sizes = np.array([len(p) for p in label_parts], dtype=np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(sizes)])
        super().__init__(
            sparse=sparse_parts[0],  # placeholder for shape info
            dense=dense_parts[0],
            label=label_parts[0],
            counts=counts,
        )

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def read_rows(self, start: int, stop: int):
        """Gather rows [start, stop) possibly crossing file boundaries."""
        sp, de, la = [], [], []
        if start >= stop:
            # Empty range (e.g. a process whose tail slice falls entirely in
            # the global batch's padding): typed 0-row slices, same shapes.
            sp.append(self.sparse_parts[0][:0])
            de.append(self.dense_parts[0][:0])
            la.append(self.label_parts[0][:0])
        lo = start
        while lo < stop:
            f = int(np.searchsorted(self.offsets, lo, side="right") - 1)
            local_lo = lo - int(self.offsets[f])
            local_hi = min(int(self.offsets[f + 1]), stop) - int(self.offsets[f])
            sp.append(self.sparse_parts[f][local_lo:local_hi])
            de.append(self.dense_parts[f][local_lo:local_hi])
            la.append(self.label_parts[f][local_lo:local_hi])
            lo = int(self.offsets[f]) + local_hi
        sparse = np.concatenate(sp) if len(sp) > 1 else np.asarray(sp[0])
        if self.max_ind_range > 0:
            sparse = sparse % self.max_ind_range
        dense = np.concatenate(de) if len(de) > 1 else np.asarray(de[0])
        label = np.concatenate(la) if len(la) > 1 else np.asarray(la[0])
        return sparse, dense, label


def load_dataset(name: str, data_path: str, phase: str,
                 max_ind_range: int = -1) -> CTRArrays:
    if name == "criteotb":
        return _load_criteotb(data_path, phase, DATASET_SPECS[name],
                              max_ind_range, train_days=range(23))
    if name == "criteotb13":
        return _load_criteotb(data_path, phase, DATASET_SPECS[name],
                              max_ind_range, train_days=range(0, 24, 3))
    spec = DATASET_SPECS[name]
    arrays = _load_flat(data_path, spec)
    if max_ind_range > 0:
        # clamp vocabularies AND hash the ids; previously only the
        # criteotb path applied the mod, so flat datasets fed raw ids into
        # tables sized from the clamped counts
        arrays = dataclasses.replace(
            arrays, counts=np.minimum(arrays.counts, max_ind_range),
            mod_range=max_ind_range)
    n = len(arrays.label)
    if name == "criteo":
        return _split_head_tail(arrays, n * 6 // 7, phase)
    if name == "avazu":
        # last-day test split (load_data.py:270-291: the full Avazu's final
        # 4,218,938 rows); proportional fallback for smaller extracts,
        # where the hardcoded count would leave an empty train split
        test_rows = 4218938 if n >= DATASET_SPECS["avazu"].num_sample \
            else max(n // 10, 1)
        return _split_head_tail(arrays, n - test_rows, phase)
    if name == "kdd12":
        rng = np.random.RandomState(2023)
        index = np.arange(n)
        rng.shuffle(index)
        test_size = int(0.1 * n)
        split = index[test_size:] if phase == "train" else index[:test_size]
        return CTRArrays(arrays.sparse, arrays.dense, arrays.label,
                         arrays.counts, index=split,
                         mod_range=arrays.mod_range)
    raise ValueError(f"unknown dataset {name}")


# ---------------------------------------------------------------------------
# Batching
# ---------------------------------------------------------------------------

Batch = Tuple[Optional[np.ndarray], np.ndarray, np.ndarray, int]
# (dense [B, D] f32 | None, sparse [B, F] i32, label [B] f32, valid)


def num_batches(data: CTRArrays, batch_size: int) -> int:
    return (len(data) + batch_size - 1) // batch_size


def _read_block(data: CTRArrays, lo: int, hi: int):
    """(dense, sparse, label) rows [lo, hi) through the dataset's own
    access path (multi-day stitching / index split / mod_range)."""
    multi = isinstance(data, _MultiFileCTRArrays)
    if multi:
        sparse, dense, label = data.read_rows(lo, hi)
    elif data.index is not None:
        rows = data.index[lo:hi]
        sparse = data.sparse[rows]
        dense = data.dense[rows] if data.dense is not None else None
        label = data.label[rows]
    else:
        sparse = data.sparse[lo:hi]
        dense = data.dense[lo:hi] if data.dense is not None else None
        label = data.label[lo:hi]
    sparse = np.ascontiguousarray(sparse, dtype=np.int32)
    if not multi and data.mod_range > 0:
        sparse = sparse % data.mod_range
    label = np.asarray(label, dtype=np.float32)
    if dense is not None:
        dense = np.ascontiguousarray(dense, dtype=np.float32)
    return dense, sparse, label


def _pad_rows(dense, sparse, label, pad_src, pad: int):
    """Append `pad` copies of the single-row pad source (dense?, sparse,
    label) to each array."""
    pd, ps, pl = pad_src
    sparse = np.concatenate([sparse, ps.repeat(pad, 0)])
    label = np.concatenate([label, pl.repeat(pad, 0)])
    if dense is not None:
        dense = np.concatenate([dense, pd.repeat(pad, 0)])
    return dense, sparse, label


def batch_iterator(data: CTRArrays, batch_size: int, *,
                   drop_last: bool = False,
                   start_batch: int = 0,
                   start_row: int = 0) -> Iterator[Batch]:
    """Yield fixed-shape batches; the final partial batch is padded (rows
    repeated from the batch head) and reports its true `valid` count.

    `start_row` offsets the whole stream by that many rows (exact-batch
    checkpoint resume with steps_per_dispatch > 1 needs sub-batch_size
    granularity); `start_batch` additionally skips whole batches."""
    n = len(data)
    base = start_row
    rem = max(n - base, 0)
    nb = rem // batch_size if drop_last else \
        (rem + batch_size - 1) // batch_size
    for b in range(start_batch, nb):
        lo = base + b * batch_size
        hi = min(lo + batch_size, n)
        valid = hi - lo
        dense, sparse, label = _read_block(data, lo, hi)
        if valid < batch_size:
            pad_src = (None if dense is None else dense[:1], sparse[:1],
                       label[:1])
            dense, sparse, label = _pad_rows(dense, sparse, label,
                                             pad_src, batch_size - valid)
        yield dense, sparse, label, valid


def process_batch_iterator(data: CTRArrays, batch_size: int, pid: int,
                           nproc: int, *, drop_last: bool = False,
                           start_batch: int = 0,
                           start_row: int = 0) -> Iterator[Batch]:
    """Per-process slice of batch_iterator's stream WITHOUT materializing
    global batches: process p reads only rows
    [lo + p*B/np, lo + (p+1)*B/np) of each global batch straight from the
    memmap — host I/O and collation are 1/np of the global stream's.
    Yields (dense_p, sparse_p, label_p, global_valid); the padded tail
    reproduces the global iterator's padding (the GLOBAL batch's first
    row) bit-exactly, so multi-host training matches single-process
    loss-for-loss."""
    per = batch_size // nproc
    if per * nproc != batch_size:
        raise ValueError(f"batch {batch_size} must divide by {nproc}")
    n = len(data)
    base = start_row
    rem = max(n - base, 0)
    nb = rem // batch_size if drop_last else \
        (rem + batch_size - 1) // batch_size
    for b in range(start_batch, nb):
        glo = base + b * batch_size
        valid = min(batch_size, n - glo)
        lo = min(glo + pid * per, n)
        hi = max(min(glo + pid * per + per, n), lo)
        dense, sparse, label = _read_block(data, lo, hi)
        if hi - lo < per:
            # this slice extends into the global batch's padding, which
            # repeats the global batch's FIRST row — fetch that one row
            pd, ps, pl = _read_block(data, glo, glo + 1)
            dense, sparse, label = _pad_rows(
                dense, sparse, label,
                (None if pd is None else pd[:1], ps[:1], pl[:1]),
                per - (hi - lo))
        yield dense, sparse, label, valid


# ---------------------------------------------------------------------------
# Frequency statistics (for the `off` offline-hot baseline)
# ---------------------------------------------------------------------------

def _sparse_chunk(data: CTRArrays, lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) through the dataset's OWN access path: multi-day
    stitching (criteotb), index splits (kdd12) and --max_ind_range hashing
    all applied — raw `.sparse` slicing is wrong for those datasets."""
    if isinstance(data, _MultiFileCTRArrays):
        sp, _, _ = data.read_rows(lo, hi)
        return np.asarray(sp)
    if data.index is not None:
        sp = np.asarray(data.sparse[data.index[lo:hi]])
    else:
        sp = np.asarray(data.sparse[lo:hi])
    if data.mod_range > 0:
        sp = sp % data.mod_range
    return sp


def sorted_frequency(data: CTRArrays, out_dir: str,
                     chunk: int = 4_000_000) -> None:
    """Per-field unique ids + counts, written as uni{i}.bin / cnt{i}.bin
    (reference: load_data.py:88-93). Chunked to bound memory on huge files."""
    os.makedirs(out_dir, exist_ok=True)
    f = data.num_sparse
    counters = [np.zeros(int(data.counts[i]), dtype=np.int64)
                for i in range(f)]
    n = len(data)
    for lo in range(0, n, chunk):
        sp = _sparse_chunk(data, lo, min(lo + chunk, n))
        for i in range(f):
            np.add.at(counters[i], sp[:, i], 1)
    for i in range(f):
        uni = np.nonzero(counters[i])[0].astype(np.int32)
        cnt = counters[i][uni].astype(np.int32)
        uni.tofile(osp.join(out_dir, f"uni{i}.bin"))
        cnt.tofile(osp.join(out_dir, f"cnt{i}.bin"))


def generate_hot_features(data: CTRArrays, data_path: str, threshold: float,
                          compress_rate: float, hash_rate: float):
    """Offline global top-k hot dictionary per field (load_data.py:95-146):
    rank ids of all fields larger than `threshold` by frequency, keep the top
    tot*cr*(1-hash_rate) as hot with dense slot numbers, -1 otherwise."""
    import json
    import tempfile
    needed = [i for i in range(data.num_sparse) if data.counts[i] > threshold]
    if data_path:
        freq_dir = osp.join(data_path, "freq")
        # cache is only valid for the exact same split: key on row count +
        # vocabulary sizes (a stale cache from another dataset silently
        # produced a wrong hot dictionary before)
        sig = {"rows": len(data),
               "counts": np.asarray(data.counts).tolist(),
               "mod": int(data.mod_range)}
        sig_path = osp.join(freq_dir, "signature.json")
        cached = all(osp.exists(osp.join(freq_dir, f"uni{i}.bin"))
                     for i in needed)
        if cached and osp.exists(sig_path):
            with open(sig_path) as f:
                cached = json.load(f) == sig
        else:
            cached = False
        if not cached:
            sorted_frequency(data, freq_dir)
            with open(sig_path, "w") as f:
                json.dump(sig, f)
        tmp_dir = None
    else:  # in-memory datasets (synthetic): never cache on disk
        tmp_dir = tempfile.mkdtemp(prefix="cafe_freq_")
        freq_dir = tmp_dir
        sorted_frequency(data, freq_dir)
    tot = 0
    all_ids, all_cnts = [], []
    try:
        for i in needed:
            uni = np.fromfile(osp.join(freq_dir, f"uni{i}.bin"),
                              dtype=np.int32)
            cnt = np.fromfile(osp.join(freq_dir, f"cnt{i}.bin"),
                              dtype=np.int32)
            all_ids.append(uni.astype(np.int64) + tot)
            all_cnts.append(cnt)
            tot += int(data.counts[i])
    finally:
        if tmp_dir is not None:  # don't leak the per-run temp freq dir
            import shutil
            shutil.rmtree(tmp_dir, ignore_errors=True)
    ids = np.concatenate(all_ids)
    cnts = np.concatenate(all_cnts)
    hot_nums = int(tot * compress_rate * (1.0 - hash_rate))
    top = ids[np.argsort(cnts)[-hot_nums:]] if hot_nums > 0 else ids[:0]
    top.sort()
    hot_dict = {}
    lo = 0
    offset = 0
    for i in needed:
        c = int(data.counts[i])
        cur = np.full(c, -1, dtype=np.int32)
        hi = np.searchsorted(top, offset + c)
        local = top[lo:hi] - offset
        # PER-FIELD slot numbering (reference load_data.py:132-145 resets
        # its counter each field) — OffPart.gather adds its own per-field
        # hot-row offsets, so slots here must start at 0 for every field.
        cur[local] = np.arange(len(local), dtype=np.int32)
        hot_dict[i] = cur
        lo = hi
        offset += c
    return hot_dict
