"""Build the port's CUDA sources at first use and bind them with ctypes.

Each `.cu` file in this directory exposes a plain C interface (pointers,
integers and the CUDA stream; an int return that is cudaGetLastError()
after the launch). `nvcc` compiles it for sm_90a into a shared library
under `build/cafe_tpu_torch/` at the repository root (listed in
.gitignore), named by a hash of the source and the flags, so a changed
source rebuilds and an unchanged one loads at once. A failed build raises;
there is no fallback.

`build()` starts one nvcc per source, all at once, and waits for all of
them: a cold build costs the slowest source, not the sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR.parents[1] / "build" / "cafe_tpu_torch"
SOURCES = ("land.cu", "scatter_add.cu", "rowsum.cu", "gather.cu", "a2a.cu",
           "graph_cond.cu", "span.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}

# the branches (utils/cond._Capture) of replayed graphs whose bodies may
# have run since their launches were last counted (train/capture.py);
# reading or setting a count credits them first. Held strongly: a graph
# freed before the next read still has its bodies' runs counted.
PENDING = set()

# {stream handle of a conditional body being captured: handle of the
# stream whose capture holds it} (utils/cond.py). A body runs in its
# graph's order, so a launch in it may use the outer stream's per-stream
# state (kernels/rowsum.py's workspace).
BODY_STREAMS: Dict[int, int] = {}


def owner_stream(handle: int) -> int:
    """The stream handle whose per-stream state a launch on `handle`
    uses: itself, or for a body being captured the stream that captures
    the graph."""
    return BODY_STREAMS.get(handle, handle)


def settle() -> None:
    """Credit the launches of the branch bodies that ran (one read of
    each pending capture's device counter). Nothing to do during a
    capture, which runs no body."""
    if PENDING and not (torch.cuda.is_available()
                        and torch.cuda.is_current_stream_capturing()):
        while PENDING:
            PENDING.pop().credit()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("cafe_tpu_torch: no CUDA toolkit found (set "
                           "CUDA_HOME or put nvcc on PATH)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(source: str) -> Path:
    text = (KERNEL_DIR / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build(sources: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, in parallel.
    Returns {source: ptxas report} for the sources built by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_DIR / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    reports, failed = {}, []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[src] = log
    if failed:
        raise RuntimeError("cafe_tpu_torch: kernel build failed:\n"
                           + "\n".join(failed))
    return reports


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, building it first if needed."""
    if source not in _LIBS:
        build([source])
        lib = ctypes.CDLL(str(library_path(source)))
        lib.cafe_cuda_error_string.argtypes = [ctypes.c_int]
        lib.cafe_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[source] = lib
    return _LIBS[source]


class CudaKernel:
    """One C entry point of a `.cu` source, loaded at its first launch.

    `launches` counts the launches of this kernel and nothing else, so a
    run can show that its path reached the kernel. A call made while the
    current stream captures a CUDA graph launches nothing: it adds to
    `captured` instead, and the graph adds what its capture added to
    `launches`, and to `graph_launches`, at every replay; a launch in a
    conditional body counts on the replays that ran the body
    (train/capture.py). `spare_launches` counts the launches, among
    `launches`, that a GraphedStep's warm-up made in the branch it ran
    on clones besides the one its predicate took (utils/cond.cond), and
    `body_launches` those that ran inside a branch's body (an eager run
    of the branch taken, or a replay of the body)."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self._launches = 0
        self._graph_launches = 0
        self.captured = 0
        self.spare_launches = 0
        self.body_launches = 0
        self._fn = None

    @property
    def launches(self) -> int:
        settle()
        return self._launches

    @launches.setter
    def launches(self, n: int) -> None:
        settle()
        self._launches = n

    @property
    def graph_launches(self) -> int:
        settle()
        return self._graph_launches

    @graph_launches.setter
    def graph_launches(self, n: int) -> None:
        settle()
        self._graph_launches = n

    def add_launches(self, n: int, in_graph: bool = False) -> None:
        """Count n launches (a graph's replay counts them in_graph)."""
        self._launches += n
        if in_graph:
            self._graph_launches += n

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = load(self.source).cafe_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: launch failed with CUDA "
                               f"error {err} ({msg})")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self._launches += 1
