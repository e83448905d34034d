from .criteo import CRITEO_COUNTS, make_criteo_arrays, make_criteo_batches
from .datasets import CTRArrays, batch_iterator, load_dataset, num_batches
from .synthetic import make_synthetic_arrays

__all__ = ["CRITEO_COUNTS", "CTRArrays", "batch_iterator", "load_dataset",
           "make_criteo_arrays", "make_criteo_batches",
           "make_synthetic_arrays", "num_batches"]
