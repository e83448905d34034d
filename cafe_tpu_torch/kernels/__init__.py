"""Hand-written CUDA kernels (sm_90a) for the TPU kernels on the ported
path, each beside its plain PyTorch version:

* K1 `land.land_max` — replaces cafe_tpu/ops/pallas_land.py;
* K2 `scatter_add.scatter_add_` — replaces cafe_tpu/ops/pallas_apply.py;
* K3 `rowsum.sparse_add_dense_` — replaces cafe_tpu/ops/pallas_rowsum.py.

Sources build at first launch (build.py); importing this package builds
nothing.
"""

from . import land, rowsum, scatter_add

KERNELS = {"land_max": land.KERNEL, "scatter_add": scatter_add.KERNEL,
           "rowsum": rowsum.KERNEL}

__all__ = ["land", "rowsum", "scatter_add", "KERNELS"]
