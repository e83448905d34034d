"""Hand-written CUDA kernels (sm_90a) for the TPU kernels on the ported
path, each beside its plain PyTorch version:

* K1 `land.land_max` — replaces cafe_tpu/ops/pallas_land.py;
* K2 `scatter_add.scatter_add_` — replaces cafe_tpu/ops/pallas_apply.py;
* K3 `rowsum.sparse_add_dense_` — replaces cafe_tpu/ops/pallas_rowsum.py;
* K4 `gather.gather` — replaces cafe_tpu/ops/pallas_gather.py;
* K5 `a2a.all_to_all` — replaces cafe_tpu/ops/pallas_a2a.py.

Sources build at first launch (build.py); importing this package builds
nothing.
"""

from . import a2a, gather, land, rowsum, scatter_add

KERNELS = {"land_max": land.KERNEL, "scatter_add": scatter_add.KERNEL,
           "rowsum": rowsum.KERNEL, "gather": gather.KERNEL,
           "a2a": a2a.KERNEL}

__all__ = ["a2a", "gather", "land", "rowsum", "scatter_add", "KERNELS"]
