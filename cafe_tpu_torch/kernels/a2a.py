"""K5 — all-to-all over the mesh by peer writes (kernel: a2a.cu).

Replaces cafe_tpu/ops/pallas_a2a.py `a2a_shard` / `pallas_all_to_all`
(the Pallas `_a2a_kernel`). Semantics of `jax.lax.all_to_all` on a
leading chunk axis: this rank's input [n, ...] holds chunk j for rank j;
the output [n, ...] holds chunk s from rank s (chunk `rank` is the local
copy).

`all_to_all` launches the CUDA kernels for a CUDA tensor and runs
`all_to_all_plain` (`dist.all_to_all_single` on the mesh's group) for a
CPU tensor; it never falls back from one to the other. A copy is exact,
so the kernel's output equals the plain version's bit for bit.

Each rank keeps one workspace per chunk size on its Mesh
(`mesh.a2a_workspaces`): made at the first call of that size (a
collective: every rank makes it in the same call), freed by
`Mesh.close()`. See a2a.cu for the protocol.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from . import build
from .build import CudaKernel

_P = ctypes.c_void_p
SEND = CudaKernel("a2a.cu", "a2a_send_launch",
                  [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                   _P, ctypes.c_int, _P])
RECV = CudaKernel("a2a.cu", "a2a_recv_launch",
                  [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, _P])
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
                       ("a2a_ipc_close", [_P])):
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
    then flags int32 [2][n], then one uint32 block counter."""

    def __init__(self, mesh, chunk_bytes: int):
        n = mesh.size
        if n > MAX_PEERS:
            raise ValueError(f"all_to_all: at most {MAX_PEERS} ranks, got "
                             f"{n}")
        self.lib = _lib()
        self.n, self.me = n, mesh.rank
        self.stride = _round_up(chunk_bytes)
        self.flag_off = 2 * n * self.stride
        self.counter_off = self.flag_off + _round_up(2 * n * 4)
        base = _P()
        with torch.cuda.device(mesh.device):
            _ok(self.lib, self.lib.a2a_ws_alloc(self.counter_off + _ALIGN,
                                                ctypes.byref(base)),
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
        self.epoch = 0

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

    def flag(self, rank: int, parity: int, src: int) -> int:
        return self.base[rank] + self.flag_off + (parity * self.n + src) * 4


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


def all_to_all(xs: torch.Tensor, mesh) -> torch.Tensor:
    """out[s] = chunk `rank` of rank s's xs: the CUDA kernels on the
    card, the plain version for CPU tensors."""
    _check(xs, mesh)
    if xs.device.type == "cpu":
        return all_to_all_plain(xs, mesh)
    if xs.device.type != "cuda":
        raise ValueError(f"all_to_all: unsupported device {xs.device}")
    xs = xs.contiguous()
    out = torch.empty_like(xs)
    n, me = mesh.size, mesh.rank
    chunk = xs.numel() // n * xs.element_size()
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    with torch.cuda.device(xs.device):
        if n == 1:
            SEND(xs.data_ptr(), (_P * 1)(out.data_ptr()), None, 1, 0, chunk,
                 None, 0, stream)
            return out
        ws = mesh.a2a_workspaces.get(chunk)
        if ws is None:
            ws = mesh.a2a_workspaces[chunk] = Workspace(mesh, chunk)
        ws.epoch += 1
        par = ws.epoch & 1
        dst = (_P * n)(*[out.data_ptr() + me * chunk if j == me
                         else ws.slot(j, par, me) for j in range(n)])
        flags = (_P * n)(*[ws.flag(j, par, me) for j in range(n)])
        SEND(xs.data_ptr(), dst, flags, n, me, chunk,
             ws.base[me] + ws.counter_off, ws.epoch, stream)
        RECV(ws.slot(me, par, 0), out.data_ptr(), ws.flag(me, par, 0), n,
             me, chunk, ws.stride, ws.epoch, stream)
    return out
