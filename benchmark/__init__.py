"""The benchmark of cafe_tpu_torch, the PyTorch / CUDA port: a harness
driven by the data files under this directory (see README.md). It imports
nothing of the JAX package."""
