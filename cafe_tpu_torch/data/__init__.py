from .criteo import CRITEO_COUNTS, make_criteo_batches
from .datasets import CTRArrays, batch_iterator
from .synthetic import make_synthetic_arrays

__all__ = ["CRITEO_COUNTS", "CTRArrays", "batch_iterator",
           "make_criteo_batches", "make_synthetic_arrays"]
