"""K3 — SGD sparse apply as a tiled segmented row sum (kernel: rowsum.cu).

Replaces cafe_tpu/ops/pallas_rowsum.py `sparse_add_dense` and its Pallas
kernel `pallas_rowsum_t`. Semantics: table[idx[k]] += upd[k] for every
lane with 0 <= idx[k] < N, duplicate rows summed; other lanes, negative
ones included, are dropped. The table is updated IN PLACE and returned.

On the card one C entry runs the whole function (rowsum.cu): a prep
kernel maps the ids to keys, CUB's radix sort groups the lanes by key
over bit_length(N) bits, and the ported kernel sums each run of equal
keys tile by tile, reading the updates through the sorted lane order
(no permuted copy), with a fix-up kernel for the runs that cross tiles.
Its workspace is one torch allocation, sized by a query entry and kept
per device and stream, made before any CUDA graph captures a call
(`_workspace`). The TPU's [B, D] -> [D, B] transpose is a layout
for its MXU and has no counterpart here.

`sparse_add_dense_` launches the kernel for a CUDA table and runs
`sparse_add_dense_plain_` for a CPU table; it never falls back from one
to the other. The kernel is deterministic (no atomics; see rowsum.cu).
`add_sorted_tiled_plain_` is a model of the kernel's tile, carry and
fix-up decomposition for the CPU tests; no path of the port runs it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import CudaKernel, load

KERNEL = CudaKernel("rowsum.cu", "rowsum_add_launch",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                     ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                     ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                     ctypes.c_void_p])

# sorted lanes a block of the kernel's sum stage (kTile in rowsum.cu)
TILE = 256

# (device index, stream handle) -> the uint8 workspace last used there
_WORKSPACES: dict = {}


def _check(table: torch.Tensor, idx: torch.Tensor,
           upd: torch.Tensor) -> None:
    if table.dim() != 2 or idx.dim() != 1 or upd.dim() != 2 \
            or upd.shape != (idx.shape[0], table.shape[1]):
        raise ValueError(
            f"sparse_add_dense_: table [N, D], idx [B], upd [B, D] expected, "
            f"got {tuple(table.shape)}, {tuple(idx.shape)}, "
            f"{tuple(upd.shape)}")
    if table.dtype != torch.float32 or upd.dtype != torch.float32 \
            or idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"sparse_add_dense_: f32 table/upd and int ids "
                        f"expected, got {table.dtype}, {upd.dtype}, "
                        f"{idx.dtype}")
    if not (table.device == idx.device == upd.device):
        raise ValueError("sparse_add_dense_: tensors on different devices")
    if not table.is_contiguous():
        raise ValueError("sparse_add_dense_: the table must be contiguous "
                         "(it is updated in place)")


def sort_lanes(n_rows: int, idx: torch.Tensor):
    """The plain version of the kernel's prep and sort stages: (sorted
    int32 keys [B], int64 lane order [B]), where lanes outside
    [0, n_rows) get key n_rows and sort last; a stable sort, so each run
    keeps its lanes' batch order."""
    safe = torch.where((idx >= 0) & (idx < n_rows), idx,
                       n_rows).to(torch.int32)
    return torch.sort(safe, stable=True)


def add_sorted_plain_(table: torch.Tensor, keys: torch.Tensor,
                      perm: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """Per-row sums of upd[perm] by the sorted keys into a zero
    accumulator with one spare row for dropped keys, then one add (the
    JAX package's table + acc.T)."""
    n = table.shape[0]
    acc = torch.zeros((n + 1, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    acc.index_add_(0, keys.clamp(0, n).long(), upd[perm.long()])
    table += acc[:n]
    return table


def add_sorted_tiled_plain_(table: torch.Tensor, keys: torch.Tensor,
                            perm: torch.Tensor, upd: torch.Tensor,
                            tile: int) -> torch.Tensor:
    """The kernel's decomposition in plain PyTorch, for the CPU tests:
    each tile of `tile` sorted lanes sums its runs in lane order; a run
    wholly inside the tile is added to its row, a run crossing the
    tile's start becomes the tile's head carry, one starting in the tile
    and crossing its end the tail carry; then the tile holding a
    crossing run's head adds its tail carry and the following tiles'
    head carries, in tile order, to the row once."""
    n, d = table.shape
    b = keys.shape[0]
    keys = keys.tolist()
    rows = upd[perm.long()]
    tiles = -(-b // tile)
    head = torch.zeros((tiles, d), dtype=table.dtype, device=table.device)
    tail = torch.zeros_like(head)
    for t in range(tiles):
        s, e = t * tile, min(b, (t + 1) * tile)
        lo = s
        while lo < e:
            key, hi = keys[lo], lo
            acc = torch.zeros_like(head[0])
            while hi < e and keys[hi] == key:
                acc = acc + rows[hi]
                hi += 1
            if key < n:
                if lo == s and s > 0 and keys[s - 1] == key:
                    head[t] = acc
                elif hi == e and e < b and keys[e] == key:
                    tail[t] = acc
                else:
                    table[key] += acc
            lo = hi
    for t in range(tiles - 1):
        s, e = t * tile, (t + 1) * tile
        key = keys[e - 1]
        if key >= n or keys[e] != key or (t > 0 and keys[s - 1] == key):
            continue
        total, j = tail[t], t + 1
        while j < tiles and keys[j * tile] == key:
            total = total + head[j]
            j += 1
        table[key] += total
    return table


@functools.lru_cache(maxsize=64)
def workspace_bytes(lanes: int, dim: int, n_rows: int, device: int) -> int:
    """Bytes of workspace the kernel needs at this shape on `device`
    (the query entry of rowsum.cu)."""
    fn = load("rowsum.cu").rowsum_workspace_bytes
    fn.argtypes = [ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_int64)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int64()
    with torch.cuda.device(device):
        err = fn(lanes, dim, n_rows, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"rowsum_workspace_bytes: CUDA error {err} at "
                           f"lanes {lanes}, dim {dim}, rows {n_rows}")
    return out.value


def _workspace(device: torch.device, stream, nbytes: int) -> torch.Tensor:
    """The workspace kept for this device and stream, grown to `nbytes`.
    Work on one stream runs in order, so the next call may reuse it.

    A stream that captures a CUDA graph must find it made: an eager call
    at the same shape on that stream allocates it before the capture
    (train/capture.py warms up on the stream it captures on), and the
    graph then reuses it at every replay. Allocating it inside the
    capture would take it from that graph's private pool and hand it to
    the next capture on the stream as well, so this raises instead."""
    key = (device.index, stream.cuda_stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < nbytes:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"sparse_add_dense_: no {nbytes}-byte workspace on the "
                f"capturing stream; run one eager call at this shape on "
                f"that stream before capturing")
        ws = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=device)
        _WORKSPACES[key] = ws
    return ws


def sparse_add_dense_plain_(table: torch.Tensor, idx: torch.Tensor,
                            upd: torch.Tensor) -> torch.Tensor:
    """The wrapper's plain PyTorch version, in place."""
    _check(table, idx, upd)
    return add_sorted_plain_(table, *sort_lanes(table.shape[0], idx), upd)


def sparse_add_dense_(table: torch.Tensor, idx: torch.Tensor,
                      upd: torch.Tensor) -> torch.Tensor:
    """table[idx] += upd in place: one launch of the CUDA entry on the
    card, the plain version for CPU tensors."""
    _check(table, idx, upd)
    if table.device.type == "cpu":
        return sparse_add_dense_plain_(table, idx, upd)
    if table.device.type != "cuda":
        raise ValueError(f"sparse_add_dense_: unsupported device "
                         f"{table.device}")
    (n, d), b = table.shape, idx.shape[0]
    if b >= 2**31 or n >= 2**31 - 1:
        raise ValueError(f"sparse_add_dense_: at most 2^31 - 1 lanes and "
                         f"2^31 - 2 rows, got {b} and {n}")
    idx, upd = idx.contiguous(), upd.contiguous()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream()
        ws = _workspace(table.device, stream,
                        workspace_bytes(b, d, n, table.device.index))
        KERNEL(table.data_ptr(), idx.data_ptr(), idx.element_size(),
               upd.data_ptr(), b, d, n, ws.data_ptr(), ws.numel(),
               stream.cuda_stream)
    return table
