"""criteo_stream: Criteo-shaped rows drawn on the device from a seed.

The distribution of cafe_tpu_torch/data/criteo.py's make_criteo_arrays,
rewritten for the device. For each field of n ids:

  rank  = floor(u^4 * n) mod n        (u uniform in [0, 1): a Zipf-like
                                       skew, the head ids most frequent)
  id    = rank * 1000000007 mod n     (the head scattered over the id
                                       space, as label-encoded data is)

13 dense features log1p(Gamma(2, 2)) and Bernoulli(0.5) labels. The rows
are made in chunks of CHUNK_ROWS, each from its own generator seeded by
(seed, stream, chunk), so row r is the same for any pool size.

The pool holds distinct rows for every dispatch of the window at the
traffic file's `pool_examples_per_s` (twice the predicted rate for a
training mix); a window that runs past it wraps to the start and the
harness counts each wrap.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CHUNK_ROWS = 1 << 20
MULT = 1000000007


def chunk_seed(seed: int, stream: int, chunk: int) -> int:
    """A 64-bit generator seed for one chunk of one stream."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), stream, chunk])
    return int(ss.generate_state(1, np.uint64)[0])


def ids_from_uniform(u: torch.Tensor, n: int) -> torch.Tensor:
    """int32 ids of one field of n ids from f64 uniforms u in [0, 1)."""
    ranks = (u.pow(4.0) * n).to(torch.int64) % n
    return ((ranks * MULT) % n).to(torch.int32)


def dense_from_uniform(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """log1p(Gamma(2, 2)) from two uniforms in [0, 1): Gamma(2, 2) is
    twice the sum of two unit exponentials, -log(1 - u) each."""
    g = -2.0 * (torch.log1p(-u1) + torch.log1p(-u2))
    return torch.log1p(g)


class Pool:
    """`rows` rows on `device`: dense [rows, num_dense] f32, sparse
    [rows, F] int32 and (with `labels`) label [rows] f32."""

    def __init__(self, counts, num_dense: int, rows: int, seed: int,
                 stream: int, device, labels: bool = True):
        self.rows = int(rows)
        f = len(counts)
        dev = torch.device(device)
        self.dense = torch.empty((self.rows, num_dense), dtype=torch.float32,
                                 device=dev)
        self.sparse = torch.empty((self.rows, f), dtype=torch.int32,
                                  device=dev)
        self.label = torch.empty(self.rows, dtype=torch.float32,
                                 device=dev) if labels else None
        self.wraps = 0
        for c in range(math.ceil(self.rows / CHUNK_ROWS)):
            lo = c * CHUNK_ROWS
            n_r = min(CHUNK_ROWS, self.rows - lo)
            g = torch.Generator(device=dev)
            g.manual_seed(chunk_seed(seed, stream, c))
            # every chunk draws CHUNK_ROWS rows, whatever it keeps
            full = CHUNK_ROWS
            for j, n in enumerate(counts):
                u = torch.rand(full, dtype=torch.float64, generator=g,
                               device=dev)[:n_r]
                self.sparse[lo:lo + n_r, j] = ids_from_uniform(u, int(n))
            u1 = torch.rand((full, num_dense), generator=g, device=dev)
            u2 = torch.rand((full, num_dense), generator=g, device=dev)
            self.dense[lo:lo + n_r] = dense_from_uniform(u1[:n_r], u2[:n_r])
            lab = torch.rand(full, generator=g, device=dev)[:n_r]
            if labels:
                self.label[lo:lo + n_r] = (lab < 0.5).float()

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.dense, self.sparse, self.label)
                   if t is not None)

    def batches(self, rows_per: int) -> int:
        """Distinct batches of `rows_per` rows the pool holds."""
        return self.rows // rows_per

    def batch(self, i: int, rows_per: int):
        """(dense, sparse, label) of batch i of `rows_per` rows; an i past
        the pool wraps (counted in `wraps` at each new lap)."""
        nb = self.batches(rows_per)
        if i and i % nb == 0:
            self.wraps += 1
        lo = (i % nb) * rows_per
        sl = slice(lo, lo + rows_per)
        return (self.dense[sl], self.sparse[sl],
                None if self.label is None else self.label[sl])


def make_pool(traffic: dict, lay: dict, rows: int, seed: int, stream: int,
              device) -> Pool:
    """The pool of a traffic mix over a layout's vocabularies."""
    return Pool(lay["counts"], lay["num_dense"], rows, seed, stream, device,
                labels=traffic["entry"] == "train")
