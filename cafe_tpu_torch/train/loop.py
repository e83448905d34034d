"""Training setup (port of the parts of cafe_tpu/train/loop.py on the
ported path): `model_arch`, `build_all` and the synthetic branch of
`get_dataset`. The epoch loop (`run`), streaming eval, checkpointing and
the CLI are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..data import CTRArrays, make_synthetic_arrays
from ..device import resolve_device
from ..embeddings import build_embedding_layer
from ..models import MODELS
from .step import build_eval_step, build_train_step, init_state


def model_arch(cfg: Config, num_dense: int, num_sparse: int):
    """ln_bot / ln_top selection (main.py:226-243)."""
    dim = cfg.embedding_dim
    if cfg.dataset == "criteotb":
        ln_bot = [num_dense, 512, 256, dim]
    else:
        ln_bot = [num_dense, 512, 256, 64, dim]
    num_fea = num_sparse + (1 if num_dense > 0 else 0)
    m_den_out = ln_bot[-1] if num_dense > 0 else 0
    if cfg.model == "dlrm" and cfg.arch_interaction_op == "cat":
        num_int = num_sparse * dim + m_den_out
    elif cfg.model == "dlrm" and cfg.arch_interaction_itself:
        num_int = (num_fea * (num_fea + 1)) // 2 + m_den_out
    else:
        num_int = (num_fea * (num_fea - 1)) // 2 + m_den_out
    if cfg.dataset == "criteotb":
        ln_top = [num_int, 1024, 1024, 512, 256, 1]
    else:
        ln_top = [num_int, 512, 256, 1]
    return ln_bot, ln_top


def build_all(cfg: Config, train_data=None, device="cuda", params=None):
    """Construct (model, embed_layer, state, train_step, eval_step) on
    `device` (default the card; raises without CUDA unless device='cpu').
    `params` replaces the model's own dense init (bridge.py brings the
    JAX package's over)."""
    dev = resolve_device(device)
    if cfg.model not in MODELS:
        raise NotImplementedError(f"model {cfg.model!r} is not ported yet")
    if train_data is None:
        train_data = get_dataset(cfg, "train")
    if cfg.max_ind_range > 0:
        raise NotImplementedError("max_ind_range is not ported yet")
    counts = np.asarray(train_data.counts)
    ln_bot, ln_top = model_arch(cfg, train_data.num_dense,
                                train_data.num_sparse)
    model = MODELS[cfg.model](
        cfg.embedding_dim, train_data.num_sparse, train_data.num_dense,
        ln_bot, ln_top,
        compute_dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
        interaction_op=cfg.arch_interaction_op,
        interaction_itself=cfg.arch_interaction_itself,
        loss_threshold=cfg.loss_threshold, device=dev)
    embed = build_embedding_layer(cfg, counts, cfg.embedding_dim, train_data,
                                  device=dev)
    state = init_state(model, embed, cfg.numpy_rand_seed, cfg.optimizer,
                       params=params)
    return model, embed, state, build_train_step(model, embed, cfg), \
        build_eval_step(model, embed)


def get_dataset(cfg: Config, phase: str) -> CTRArrays:
    """The synthetic dataset (6/7 train, 1/7 test). The memmap datasets
    are not ported yet."""
    if cfg.dataset != "synthetic":
        raise NotImplementedError(
            f"dataset {cfg.dataset!r} is not ported yet (synthetic only)")
    trace = None
    if cfg.synthetic_trace_file:
        tf = cfg.synthetic_trace_file
        trace = (np.load(tf) if tf.endswith(".npy")
                 else np.fromfile(tf, dtype=np.int32))
    data = make_synthetic_arrays(
        rows=cfg.synthetic_rows, fields=cfg.synthetic_fields,
        vocab=cfg.synthetic_vocab, dense=cfg.synthetic_dense,
        zipf=cfg.synthetic_zipf, seed=cfg.numpy_rand_seed,
        dist=cfg.synthetic_dist, trace=trace,
        shift_at=cfg.synthetic_shift,
        vocab_spread=cfg.synthetic_vocab_spread)
    cut = len(data) * 6 // 7
    sl = slice(0, cut) if phase == "train" else slice(cut, None)
    return CTRArrays(data.sparse[sl],
                     None if data.dense is None else data.dense[sl],
                     data.label[sl], data.counts)
