"""Embedding layer construction (port of cafe_tpu/embeddings/__init__.py).

The JAX package's decision tree: fields at or below the compress
threshold (2000 * cr) stay full, and each method (full, hash, qr, mde,
off, cafe, ada, ae) sizes its tables with sizing.py.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from . import sizing
from .ada import AdaPart
from .ae import AEGroupPart
from .base import (EmbeddingLayer, HashedTablePart, MDEGroupPart, OffPart,
                   Part, QRPart)
from .cafe import CafePart

__all__ = ["EmbeddingLayer", "build_embedding_layer", "HashedTablePart",
           "QRPart", "MDEGroupPart", "OffPart", "CafePart", "AdaPart",
           "AEGroupPart", "Part", "sizing"]


def _dim_groups(fields, dims, key=lambda i, d: d):
    """{key: [fields]} in field order, keys sorted."""
    groups = {}
    for i in fields:
        groups.setdefault(key(i, int(dims[i])), []).append(i)
    return sorted(groups.items())


def build_embedding_layer(cfg, counts, dim: int, train_data=None,
                          device="cuda") -> EmbeddingLayer:
    """The layer on `device` (default the card; raises without CUDA
    unless device='cpu'). Method 'off' reads `train_data` for its
    frequency ranking."""
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

    weighted = cfg.weighted_pooling or ""
    if weighted and method not in ("full", "hash"):
        # the reference only builds v_W_l for its plain embedding tables
        raise ValueError(
            f"--weighted_pooling supports methods full/hash, not {method}")

    def full_part(fields):
        if fields:
            cs = [counts[i] for i in fields]
            parts.append(HashedTablePart(fields, cs, cs, dim, opt,
                                         weighted=weighted))

    if method == "full" or not big:
        full_part(list(range(nf)))
    elif method == "hash":
        real = [counts[i] if i in set(small)
                else int(np.ceil(counts[i] * cr)) for i in range(nf)]
        parts.append(HashedTablePart(list(range(nf)), counts, real, dim, opt,
                                     weighted=weighted))
    elif method == "qr":
        coll = sizing.qr_collisions(counts, cr)
        full_part(small)
        parts.append(QRPart(big, [counts[i] for i in big], coll, dim, opt,
                            operation=cfg.qr_operation))
    elif method == "mde":
        dims = sizing.mde_dims(counts, cr, dim, cfg.md_round_dims)
        full_part(small)
        for low_dim, fields in _dim_groups(big, dims):
            parts.append(MDEGroupPart(fields, [counts[i] for i in fields],
                                      low_dim, dim, opt))
    elif method == "off":
        if train_data is None:
            raise ValueError("method 'off' needs the training dataset for "
                             "frequency statistics")
        from ..data.datasets import generate_hot_features
        hot_dict = generate_hot_features(train_data, cfg.data_path, th, cr,
                                         cfg.cafe_hash_rate)
        full_part(small)
        ncold = [int(np.ceil(cr * cfg.cafe_hash_rate * counts[i]))
                 - int((hot_dict[i] >= 0).sum()) for i in big]
        parts.append(OffPart(big, [counts[i] for i in big],
                             [hot_dict[i] for i in big], ncold, dim, opt))
    elif method == "ada":
        full_part(small)
        parts.append(AdaPart(big, [counts[i] for i in big],
                             sizing.ada_hotn(counts, cr, dim), dim, opt))
    elif method == "ae":
        dims = sizing.mde_dims(counts, cr, dim, cfg.md_round_dims)
        full_part(small)
        # also grouped by vocabulary magnitude (factor-4 bands): the
        # decoder pads every field of a group to the group's largest
        # vocabulary
        for (low_dim, _), fields in _dim_groups(
                big, dims,
                key=lambda i, d: (d, int(np.log2(max(counts[i], 2)) // 2))):
            parts.append(AEGroupPart(fields, [counts[i] for i in fields],
                                     low_dim, dim, opt))
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
    else:
        raise ValueError(f"unknown compress method {method}")

    for p in parts:
        p.apply_impl = cfg.sparse_apply_impl
    return EmbeddingLayer(parts, nf, dim, device)
