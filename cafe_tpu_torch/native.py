"""ctypes loader for the native (C++) host components (port of
cafe_tpu/native.py; the port keeps its own copy, as it imports nothing of
cafe_tpu).

Compiles the repository's native/*.cpp with g++ into one shared library
under build/cafe_tpu_torch/ at the repository root (listed in
.gitignore), named by a hash of the sources and the flags, at first use,
and exposes typed wrappers:

  HostSketch       sequential HotSketch oracle (+ binary save/load)
  bpr_sample       BPR negative sampler
  NativeEncoder    two-pass TSV/CSV -> binary encoder

These are HOST tools (oracles, preprocessing, samplers); the training hot
path is device code. Without g++ the build raises: nothing falls back to
another sampler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
_SRC_DIR = _ROOT / "native"
_BUILD_DIR = _ROOT / "build" / "cafe_tpu_torch"
_SOURCES = ["hotsketch.cpp", "sampling.cpp", "encoder.cpp"]
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in _SOURCES:
        h.update((_SRC_DIR / s).read_bytes())
    return _BUILD_DIR / f"libcafe_native-{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> str:
    """Compile native/*.cpp unless the library of these sources exists;
    returns its path. Raises without g++ or on a failed compile."""
    out = library_path()
    if force or not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *_FLAGS, "-o", str(tmp),
               *(str(_SRC_DIR / s) for s in _SOURCES)]
        try:
            subprocess.run(cmd, check=True)
        except FileNotFoundError as e:
            raise RuntimeError("cafe_tpu_torch.native: g++ not found; the "
                               "host sampler and sketch need it") from e
        os.replace(tmp, out)   # concurrent builds each move a whole file
    return str(out)


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build())
        _declare(_lib)
    return _lib


def _declare(L: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    L.hs_init.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_float, ctypes.c_int]
    L.hs_batch_query.argtypes = [ctypes.c_int, i32p, ctypes.c_int, i32p]
    L.hs_batch_insert.argtypes = [ctypes.c_int, i32p, f32p, ctypes.c_int,
                                  i32p]
    L.hs_num_hot.argtypes = [ctypes.c_int]
    L.hs_num_hot.restype = ctypes.c_int
    L.hs_hot_items.argtypes = [ctypes.c_int, i32p, i32p, f32p, ctypes.c_int]
    L.hs_hot_items.restype = ctypes.c_int
    L.hs_save_state.argtypes = [ctypes.c_int, ctypes.c_char_p]
    L.hs_save_state.restype = ctypes.c_int
    L.hs_load_state.argtypes = [ctypes.c_int, ctypes.c_char_p]
    L.hs_load_state.restype = ctypes.c_int
    L.bpr_sample.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             i32p, i64p, ctypes.c_int, ctypes.c_uint64,
                             i32p]
    L.bpr_sample.restype = ctypes.c_int
    L.enc_init.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_char,
                           ctypes.c_int, i32p, i32p, ctypes.c_int,
                           ctypes.c_int]
    L.enc_collect.argtypes = [ctypes.c_char_p]
    L.enc_collect.restype = ctypes.c_longlong
    L.enc_counts.argtypes = [i32p]
    L.enc_encode.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                             ctypes.c_char_p, ctypes.c_char_p]
    L.enc_encode.restype = ctypes.c_longlong


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty))


class HostSketch:
    """Sequential host HotSketch (C++), reference-speed oracle.

    The C side holds a fixed pool of 64 sketch slots (like the reference's
    `ss[26]`, sketch.cpp:151); constructing a 65th instance raises rather
    than silently re-initializing a live earlier sketch's slot."""

    _next_idx = 0
    _MAX_SLOTS = 64

    def __init__(self, buckets: int, threshold: float, decay: float = 0.99,
                 cells: int = 4):
        if HostSketch._next_idx >= HostSketch._MAX_SLOTS:
            raise RuntimeError(
                f"HostSketch slot pool exhausted ({self._MAX_SLOTS} per "
                "process); the C state is a fixed-size slot array")
        self.idx = HostSketch._next_idx
        HostSketch._next_idx += 1
        self.buckets = buckets
        lib().hs_init(self.idx, buckets, threshold, decay, cells)

    def insert(self, ids, scores=None) -> np.ndarray:
        ids = _as_i32(ids)
        out = np.empty(len(ids), dtype=np.int32)
        sp = (_ptr(np.ascontiguousarray(scores, np.float32), ctypes.c_float)
              if scores is not None else
              ctypes.cast(None, ctypes.POINTER(ctypes.c_float)))
        lib().hs_batch_insert(self.idx, _ptr(ids, ctypes.c_int32), sp,
                              len(ids), _ptr(out, ctypes.c_int32))
        return out

    def query(self, ids) -> np.ndarray:
        ids = _as_i32(ids)
        out = np.empty(len(ids), dtype=np.int32)
        lib().hs_batch_query(self.idx, _ptr(ids, ctypes.c_int32), len(ids),
                             _ptr(out, ctypes.c_int32))
        return out

    def num_hot(self) -> int:
        return lib().hs_num_hot(self.idx)

    def hot_items(self):
        cap = self.buckets * 4
        ids = np.empty(cap, np.int32)
        slots = np.empty(cap, np.int32)
        scores = np.empty(cap, np.float32)
        n = lib().hs_hot_items(self.idx, _ptr(ids, ctypes.c_int32),
                               _ptr(slots, ctypes.c_int32),
                               _ptr(scores, ctypes.c_float), cap)
        return ids[:n], slots[:n], scores[:n]

    def save(self, path: str) -> None:
        rc = lib().hs_save_state(self.idx, path.encode())
        if rc != 0:
            raise IOError(f"sketch save to {path} failed (rc={rc})")

    def load(self, path: str) -> None:
        rc = lib().hs_load_state(self.idx, path.encode())
        if rc != 0:
            raise IOError(f"sketch load from {path} failed (rc={rc}; "
                          "missing, truncated or corrupt state file)")


def bpr_sample(user_num: int, item_num: int, train_num: int,
               all_pos: Sequence[np.ndarray], neg_num: int = 1,
               seed: int = 0) -> np.ndarray:
    pos_items = _as_i32(np.concatenate(
        [np.asarray(p) for p in all_pos]) if len(all_pos) else
        np.zeros(0, np.int32))
    offsets = np.zeros(user_num + 1, dtype=np.int64)
    for u, p in enumerate(all_pos):
        offsets[u + 1] = offsets[u] + len(p)
    per_user = max(train_num // max(user_num, 1), 1)
    out = np.empty((user_num * per_user, 2 + neg_num), dtype=np.int32)
    rows = lib().bpr_sample(user_num, item_num, train_num,
                            _ptr(pos_items, ctypes.c_int32),
                            _ptr(offsets, ctypes.c_int64),
                            neg_num, seed, _ptr(out, ctypes.c_int32))
    return out[:rows]


class NativeEncoder:
    """Two-pass streaming CSV/TSV -> binary encoder (C++).

    The C side is a single global encoder (the reference's singleton
    pattern); constructing a new NativeEncoder invalidates any previous
    instance — its methods then raise instead of silently operating on the
    new instance's vocabularies."""

    _live: Optional["NativeEncoder"] = None

    def __init__(self, num_dense: int, num_sparse: int, sep: str = "\t",
                 label_col: int = 0,
                 dense_cols: Optional[List[int]] = None,
                 sparse_cols: Optional[List[int]] = None,
                 clip_label: bool = False, skip_header: bool = False):
        if NativeEncoder._live is not None:
            NativeEncoder._live._dead = True
        NativeEncoder._live = self
        self._dead = False
        self.skip_header = skip_header
        self.num_dense = num_dense
        self.num_sparse = num_sparse
        dense_cols = dense_cols or list(range(1, 1 + num_dense))
        sparse_cols = (sparse_cols
                       or list(range(1 + num_dense,
                                     1 + num_dense + num_sparse)))
        dc = _as_i32(dense_cols) if num_dense else np.zeros(1, np.int32)
        sc = _as_i32(sparse_cols)
        lib().enc_init(num_dense, num_sparse, sep.encode()[0], label_col,
                       _ptr(dc, ctypes.c_int32), _ptr(sc, ctypes.c_int32),
                       int(clip_label), int(skip_header))

    def _check_live(self):
        if self._dead:
            raise RuntimeError(
                "this NativeEncoder was invalidated by constructing a "
                "newer one (the C encoder state is a process singleton)")

    def collect(self, path: str) -> int:
        self._check_live()
        n = lib().enc_collect(path.encode())
        if n < 0:
            raise IOError(f"cannot read {path}")
        return n

    def counts(self) -> np.ndarray:
        self._check_live()
        out = np.empty(self.num_sparse, dtype=np.int32)
        lib().enc_counts(_ptr(out, ctypes.c_int32))
        return out

    def encode(self, in_path: str, out_dir: str) -> int:
        self._check_live()
        os.makedirs(out_dir, exist_ok=True)
        self.counts().tofile(osp.join(out_dir, "processed_count.bin"))
        n = lib().enc_encode(
            in_path.encode(),
            osp.join(out_dir, "processed_sparse_sep.bin").encode(),
            osp.join(out_dir, "processed_dense.bin").encode(),
            osp.join(out_dir, "processed_label.bin").encode())
        if n < 0:
            raise IOError("encode failed")
        return n
