"""cafe_tpu_torch — the PyTorch / CUDA port of cafe_tpu for NVIDIA Hopper.

Each module mirrors its counterpart in `cafe_tpu/` (same path, same public
names); `cafe_tpu/` stays the unchanged JAX reference that the tests hold
this package against. The port imports torch and numpy, never jax and
nothing of `cafe_tpu`.

The TPU's Pallas kernels on the ported path are hand-written CUDA kernels
under `kernels/` (built with nvcc for sm_90a at first use, bound with
ctypes). Every entry point takes `device`, which defaults to "cuda" and
raises when CUDA is absent: pass device="cpu" to run the kernels' plain
PyTorch versions on the CPU.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
