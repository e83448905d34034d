"""Embedding layer construction (port of cafe_tpu/embeddings/__init__.py).

The JAX package's decision tree for the ported methods: fields at or below
the compress threshold (2000 * cr) stay full, and each method sizes its
tables with sizing.py. Methods full, hash and cafe are ported; qr, mde,
off, ada and ae raise NotImplementedError for now.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from . import sizing
from .base import EmbeddingLayer, HashedTablePart, Part
from .cafe import CafePart

__all__ = ["EmbeddingLayer", "build_embedding_layer", "HashedTablePart",
           "CafePart", "Part", "sizing"]


def build_embedding_layer(cfg, counts, dim: int, train_data=None,
                          device="cuda") -> EmbeddingLayer:
    """The layer on `device` (default the card; raises without CUDA
    unless device='cpu')."""
    del train_data  # only the 'off' method reads it
    device = resolve_device(device)
    counts = [int(c) for c in counts]
    nf = len(counts)
    method = cfg.method
    cr = cfg.compress_rate
    opt = cfg.optimizer
    th = sizing.compress_threshold(cr)
    big = [i for i in range(nf) if counts[i] > th]
    small = [i for i in range(nf) if counts[i] <= th]
    parts = []

    if getattr(cfg, "weighted_pooling", ""):
        raise NotImplementedError("weighted pooling is not ported yet "
                                  "(ROADMAP queue Q3)")

    def full_part(fields):
        if fields:
            cs = [counts[i] for i in fields]
            parts.append(HashedTablePart(fields, cs, cs, dim, opt))

    if method == "full" or not big:
        full_part(list(range(nf)))
    elif method == "hash":
        real = [counts[i] if i in set(small)
                else int(np.ceil(counts[i] * cr)) for i in range(nf)]
        parts.append(HashedTablePart(list(range(nf)), counts, real, dim, opt))
    elif method == "cafe":
        if cfg.cafe_plus:
            raise NotImplementedError("CAFE+ (cafe_plus) is not ported yet "
                                      "(ROADMAP queue Q4)")
        full_part(small)
        goff = np.concatenate([[0], np.cumsum(counts)[:-1]])
        cafe_kwargs = dict(
            mig_lanes=cfg.cafe_mig_lanes,
            insert_interval=cfg.cafe_insert_interval,
            land_impl=cfg.cafe_land_impl)
        if cfg.cafe_hot_separate_field:
            for i in big:
                hotn = sizing.cafe_field_hotn(counts[i], cr, dim,
                                              cfg.cafe_hash_rate)
                if hotn > 1:
                    parts.append(CafePart(
                        [i], [counts[i]], [int(goff[i])], hotn,
                        [sizing.cafe_hash_size(counts[i], cr,
                                               cfg.cafe_hash_rate)],
                        dim, cfg.cafe_sketch_threshold, cfg.cafe_decay,
                        counts[i], opt, cfg.cafe_use_freq, **cafe_kwargs))
                else:  # too small for a hot pool -> plain hash fallback
                    parts.append(HashedTablePart(
                        [i], [counts[i]],
                        [int(np.ceil(counts[i] * cr))], dim, opt))
        else:
            hotn = sizing.cafe_hotn(counts, cr, dim, cfg.cafe_hash_rate)
            if hotn > 1:
                parts.append(CafePart(
                    big, [counts[i] for i in big],
                    [int(goff[i]) for i in big], hotn,
                    [sizing.cafe_hash_size(counts[i], cr, cfg.cafe_hash_rate)
                     for i in big],
                    dim, cfg.cafe_sketch_threshold, cfg.cafe_decay,
                    max(counts), opt, cfg.cafe_use_freq, **cafe_kwargs))
            else:
                real = [int(np.ceil(counts[i] * cr)) for i in big]
                parts.append(HashedTablePart(big, [counts[i] for i in big],
                                             real, dim, opt))
    elif method in ("qr", "mde", "off", "ada", "ae"):
        raise NotImplementedError(
            f"compress method {method!r} is not ported yet (ROADMAP "
            f"queue Q3)")
    else:
        raise ValueError(f"unknown compress method {method}")

    for p in parts:
        p.apply_impl = cfg.sparse_apply_impl
    return EmbeddingLayer(parts, nf, dim, device)
