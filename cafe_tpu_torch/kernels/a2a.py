"""K5 — all-to-all over the mesh by peer writes (kernel: a2a.cu).

Replaces cafe_tpu/ops/pallas_a2a.py `a2a_shard` / `pallas_all_to_all`
(the Pallas `_a2a_kernel`). Semantics of `jax.lax.all_to_all` on a
leading chunk axis: this rank's input [n, ...] holds chunk j for rank j;
the output [n, ...] holds chunk s from rank s (chunk `rank` is the local
copy).

`all_to_all` launches the CUDA kernels for a CUDA tensor and runs
`all_to_all_plain` (`dist.all_to_all_single` on the mesh's group) for a
CPU tensor; it never falls back from one to the other. A copy is exact,
so the kernel's output equals the plain version's bit for bit. On the
card it is `receive(send(xs, mesh))`: the SEND kernel, then the RECV
kernel, one launch count a call (a measurement may run the two halves
apart).

The DEVICE COLLECTIVES run on the same kernels, so that a device branch
of a step (utils/cond.cond) can hold a collective that a CUDA graph
captures into a conditional body at any world size (NCCL's cannot be
captured there on more than one rank): `all_gather` is K5 in its gather
mode (the SEND kernel reads the one chunk for every peer), and
`psum_scatter` is K5 on the n row blocks followed by a sum over the
received blocks in rank order. Each has a plain version for CPU tensors
(`all_gather_plain`, `psum_scatter_plain`: the same through
`dist.all_to_all_single`), and each launch counts one K5 launch. Where
each lane has one non-zero contribution (the exchange's owner answers),
the reduce-scatter equals NCCL's bit for bit.

Each rank keeps one workspace per chunk size on its Mesh
(`mesh.a2a_workspaces`): made at the first call of that size (a
collective: every rank makes it in the same call), freed by
`Mesh.close()`. See a2a.cu for the protocol. A call's epoch lives on the
card, in a counter of the workspace that the RECV kernel advances, and
the launches take a peer table of both parities' addresses, fixed for
the workspace's life: a launch captured in a CUDA graph runs its
replay's epoch, so replays and eager calls may interleave, as long as
every rank makes the same calls on a workspace in the same order. The
workspace of a chunk size must exist before a capture that calls K5 (a
GraphedStep's warm-up calls make it). At n = 1 a call is one copy kernel
with no workspace.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from . import build
from .build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
SEND = CudaKernel("a2a.cu", "a2a_send_launch",
                  [_P, _P, _P, _P, _I, _I, ctypes.c_int64, ctypes.c_int64,
                   _I, _P, _P])
RECV = CudaKernel("a2a.cu", "a2a_recv_launch",
                  [_P, _P, _P, _P, _I, _I, ctypes.c_int64, ctypes.c_int64,
                   _I, _P])
# one SEND launch per all-to-all: the count a run reads
KERNEL = SEND

MAX_PEERS = 8          # kMaxPeers in a2a.cu: the cards of one host
_ALIGN = 256


def _round_up(x: int, a: int = _ALIGN) -> int:
    return (x + a - 1) // a * a


def _lib() -> ctypes.CDLL:
    lib = build.load("a2a.cu")
    for name, args in (("a2a_ws_alloc", [ctypes.c_int64,
                                         ctypes.POINTER(_P)]),
                       ("a2a_ws_free", [_P]),
                       ("a2a_ipc_handle", [_P, _P]),
                       ("a2a_ipc_open", [_P, ctypes.POINTER(_P)]),
                       ("a2a_ipc_close", [_P]),
                       ("a2a_parts", [ctypes.c_int64, _I])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def _ok(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.cafe_cuda_error_string(err).decode()})")


class Workspace:
    """This rank's symmetric buffer for all-to-alls of `chunk_bytes`
    chunks over `mesh`, and its peers' buffers mapped through CUDA IPC.

    Layout (every rank the same): receive slots [2 parities][n][stride],
    arrival flags int32 [2][n sources][parts], then this rank's call
    counter and ticket (int32 [2], a2a.cu). `parts` is the smallest part
    count any rank's card picks (a2a.cu `a2a_parts`), so every SEND
    block has one RECV block that waits for it. `peer_slots` /
    `peer_flags` are the SEND kernel's peer table: [parity][peer] the
    peer's slot and flags for this rank."""

    def __init__(self, mesh, chunk_bytes: int):
        n = mesh.size
        if n > MAX_PEERS:
            raise ValueError(f"all_to_all: at most {MAX_PEERS} ranks, got "
                             f"{n}")
        self.lib = _lib()
        self.n, self.me = n, mesh.rank
        self.stride = _round_up(chunk_bytes)
        self.flag_off = 2 * n * self.stride
        base = _P()
        with torch.cuda.device(mesh.device):
            mine = self.lib.a2a_parts(chunk_bytes, n)
            gathered = [None] * n
            dist.all_gather_object(gathered, mine, group=mesh.group)
            self.parts = min(gathered)
            self.counter_off = self.flag_off + _round_up(
                2 * n * self.parts * 4)
            size = self.counter_off + _ALIGN
            _ok(self.lib, self.lib.a2a_ws_alloc(size, ctypes.byref(base)),
                "a2a workspace alloc")
            handle = ctypes.create_string_buffer(64)
            _ok(self.lib, self.lib.a2a_ipc_handle(base, handle),
                "a2a IPC handle")
            handles = [None] * n
            dist.all_gather_object(handles, handle.raw, group=mesh.group)
            self.base = []
            for j, h in enumerate(handles):
                if j == self.me:
                    self.base.append(base.value)
                    continue
                peer = _P()
                _ok(self.lib, self.lib.a2a_ipc_open(h, ctypes.byref(peer)),
                    f"a2a IPC open of rank {j}'s workspace")
                self.base.append(peer.value)
        self.counter = self.base[self.me] + self.counter_off
        order = [(par, j) for par in (0, 1) for j in range(n)]
        self.peer_slots = (_P * (2 * n))(*[self.slot(j, par, self.me)
                                           for par, j in order])
        self.peer_flags = (_P * (2 * n))(*[self.flags(j, par, self.me)
                                           for par, j in order])

    def close(self) -> None:
        for j, ptr in enumerate(self.base):
            if j != self.me:
                _ok(self.lib, self.lib.a2a_ipc_close(ptr), "a2a IPC close")
        _ok(self.lib, self.lib.a2a_ws_free(self.base[self.me]),
            "a2a workspace free")
        self.base = []

    def slot(self, rank: int, parity: int, src: int) -> int:
        """Address of `rank`'s receive slot for chunks from `src`."""
        return self.base[rank] + (parity * self.n + src) * self.stride

    def flags(self, rank: int, parity: int, src: int) -> int:
        """Address of `rank`'s `parts` arrival flags for chunks from
        `src`."""
        return (self.base[rank] + self.flag_off
                + (parity * self.n + src) * self.parts * 4)


class Pending(NamedTuple):
    """A sent all-to-all whose RECV kernel is still to launch."""

    out: torch.Tensor
    ws: Optional[Workspace]   # None at n = 1: the SEND kernel did it all
    chunk: int
    stream: int


def _check(xs: torch.Tensor, mesh) -> None:
    if xs.dim() < 1 or xs.shape[0] != mesh.size:
        raise ValueError(f"all_to_all: input [n={mesh.size}, ...] expected, "
                         f"got {tuple(xs.shape)}")


def all_to_all_plain(xs: torch.Tensor, mesh) -> torch.Tensor:
    """The kernel's plain version: dist.all_to_all_single on the mesh's
    group."""
    _check(xs, mesh)
    out = torch.empty_like(xs, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, xs.contiguous(), group=mesh.group)
    return out


def send(xs: torch.Tensor, mesh, gather: bool = False) -> Pending:
    """The SEND half on the card: the local chunk into a new output and
    every other chunk into its peer's receive slot, each part flagged.
    With `gather` xs is ONE chunk, which every peer receives (the
    all-gather's mode: the output is [n, *xs.shape])."""
    if not gather:
        _check(xs, mesh)
    if xs.device.type != "cuda":
        raise ValueError(f"all_to_all send: a CUDA tensor expected, got "
                         f"{xs.device}")
    xs = xs.contiguous()
    n, me = mesh.size, mesh.rank
    if gather:
        out = xs.new_empty((n,) + tuple(xs.shape))
        chunk = xs.numel() * xs.element_size()
        in_stride = 0
    else:
        out = torch.empty_like(xs)
        chunk = in_stride = xs.numel() // n * xs.element_size()
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    with torch.cuda.device(xs.device):
        if n == 1:
            SEND(xs.data_ptr(), out.data_ptr(), None, None, 1, 0, chunk,
                 in_stride, 0, None, stream)
            return Pending(out, None, chunk, stream)
        ws = mesh.a2a_workspaces.get(chunk)
        if ws is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"all_to_all: no workspace for {chunk}-byte chunks "
                    f"before a capture (it is made by a collective on the "
                    f"host: call K5 at this size eagerly first)")
            ws = mesh.a2a_workspaces[chunk] = Workspace(mesh, chunk)
        SEND(xs.data_ptr(), out.data_ptr(), ws.peer_slots, ws.peer_flags, n,
             me, chunk, in_stride, ws.parts, ws.counter, stream)
    return Pending(out, ws, chunk, stream)


def receive(pending: Pending) -> torch.Tensor:
    """The RECV half: wait for each part of every peer's chunk and copy
    it out of the receive slot. Returns the all-to-all's output."""
    ws = pending.ws
    if ws is None or pending.chunk == 0:
        return pending.out
    with torch.cuda.device(pending.out.device):
        RECV(ws.slot(ws.me, 0, 0), pending.out.data_ptr(),
             ws.flags(ws.me, 0, 0), ws.counter, ws.n, ws.me, pending.chunk,
             ws.stride, ws.parts, pending.stream)
    return pending.out


def all_to_all(xs: torch.Tensor, mesh) -> torch.Tensor:
    """out[s] = chunk `rank` of rank s's xs: the CUDA kernels on the
    card, the plain version for CPU tensors."""
    _check(xs, mesh)
    if xs.device.type == "cpu":
        return all_to_all_plain(xs, mesh)
    if xs.device.type != "cuda":
        raise ValueError(f"all_to_all: unsupported device {xs.device}")
    return receive(send(xs, mesh))


def _cuda_or_plain(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU one (the
    plain version); anything else raises."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type == "cuda"


def _blocks(x: torch.Tensor, mesh) -> torch.Tensor:
    """x [n * k, ...] as [n, k, ...]: block p for rank p."""
    n = mesh.size
    if x.dim() < 1 or x.shape[0] % n:
        raise ValueError(f"psum_scatter: dim 0 of {tuple(x.shape)} is not a "
                         f"multiple of the mesh's {n} ranks")
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def _sum_ranks(ys: torch.Tensor) -> torch.Tensor:
    """ys [n, k, ...] summed over the leading axis in rank order (one add
    a rank, in the tensor's own dtype)."""
    if ys.shape[0] == 1:
        return ys[0]
    out = ys[0] + ys[1]
    for s in range(2, ys.shape[0]):
        out += ys[s]
    return out


def all_gather_plain(x: torch.Tensor, mesh) -> torch.Tensor:
    """all_gather's plain version: dist.all_to_all_single of the chunk
    repeated n times."""
    n = mesh.size
    xs = x.unsqueeze(0).expand((n,) + tuple(x.shape))
    return all_to_all_plain(xs, mesh).reshape((-1,) + tuple(x.shape[1:]))


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Tiled all-gather along dim 0 over the mesh's ranks: rows [s*k,
    (s+1)*k) of the output are rank s's x [k, ...]. K5 in its gather
    mode on the card (one launch count), the plain version for CPU
    tensors."""
    if not _cuda_or_plain(x, "all_gather"):
        return all_gather_plain(x, mesh)
    return receive(send(x, mesh, gather=True)).reshape(
        (-1,) + tuple(x.shape[1:]))


def psum_scatter_plain(x: torch.Tensor, mesh) -> torch.Tensor:
    """psum_scatter's plain version: dist.all_to_all_single of the row
    blocks, then the same sum in rank order."""
    return _sum_ranks(all_to_all_plain(_blocks(x, mesh), mesh))


def psum_scatter(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum over the mesh's ranks, rank p keeping rows [p*k, (p+1)*k) of
    x [n * k, ...]: K5 on the n row blocks (one launch count), then the
    received blocks summed in rank order; the plain version for CPU
    tensors. Bit-equal to NCCL's reduce-scatter where every lane has
    one non-zero contribution."""
    if not _cuda_or_plain(x, "psum_scatter"):
        return psum_scatter_plain(x, mesh)
    return _sum_ranks(all_to_all(_blocks(x, mesh), mesh))
