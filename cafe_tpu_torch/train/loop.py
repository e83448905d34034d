"""Training driver (port of cafe_tpu/train/loop.py): datasets, model and
embedding layer, the epoch/batch loop with the reference's cadence knobs
(print_freq / test_freq / test_throughput), streaming eval, the scalar
suite, best-accuracy and rolling checkpoints with exact-batch resume.

`run` takes its device from the config: `--force_platform cpu` runs on
the CPU (the kernels' plain versions), anything else on the card, which
must be there. Configurations the port does not have yet raise
NotImplementedError naming their ROADMAP queue; none is ignored.

With --mesh_shape / --shard_embeddings, or under torchrun, `run` trains
on a flat mesh of one process per device (parallel/): each rank reads
its slice of every batch, the sharded parts exchange rows over the
mesh's group, eval scores are all-gathered before the metrics, and only
rank 0 prints and logs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
import time
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..data import (CTRArrays, batch_iterator, load_dataset,
                    make_synthetic_arrays, num_batches)
from ..data.datasets import process_batch_iterator
from ..data.loader import device_prefetch
from ..device import resolve_device
from ..embeddings import build_embedding_layer
from ..embeddings.ae import AEGroupPart, pretrain_batches
from ..models import MODELS
from ..parallel import make_mesh, maybe_init_distributed, shard_state
from ..parallel.exchange import all_gather
from ..parallel.mesh import torchrun_world_size
from ..utils.logging import ScalarLogger
from ..utils.timing import fence, queue_bound
from .checkpoint import load_checkpoint, save_checkpoint, save_rolling
from .metrics import binary_metrics
from .step import (TrainState, build_eval_step, build_multi_step,
                   build_train_step, init_state)


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


def build_all(cfg: Config, train_data=None, device="cuda", params=None,
              mesh=None, capture=True):
    """Construct (model, embed_layer, state, train_step, eval_step) on
    `device` (default the card; raises without CUDA unless device='cpu').
    `params` replaces the model's own dense init (bridge.py brings the
    JAX package's over). On the card the steps replay CUDA graphs where
    the configuration allows (train/step.capture_blockers); `capture`
    False keeps them eager.

    With `mesh` (parallel.make_mesh; its device replaces `device`), the
    layer works on this rank's batch slice; with cfg.shard_embeddings the
    parts that support it switch to the explicit exchange BEFORE the
    state is made (the state layout depends on it), and the returned
    state is this rank's slice of the global one."""
    dev = resolve_device(device) if mesh is None else mesh.device
    if train_data is None:
        train_data = get_dataset(cfg, "train")
    counts = np.asarray(train_data.counts)
    if cfg.max_ind_range > 0:
        counts = np.minimum(counts, cfg.max_ind_range)
    ln_bot, ln_top = model_arch(cfg, train_data.num_dense,
                                train_data.num_sparse)
    kwargs = {}
    if cfg.model == "dlrm":
        kwargs = dict(interaction_op=cfg.arch_interaction_op,
                      interaction_itself=cfg.arch_interaction_itself,
                      loss_threshold=cfg.loss_threshold)
    model = MODELS[cfg.model](
        cfg.embedding_dim, train_data.num_sparse, train_data.num_dense,
        ln_bot, ln_top,
        compute_dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
        device=dev, **kwargs)
    embed = build_embedding_layer(cfg, counts, cfg.embedding_dim, train_data,
                                  device=dev)
    if mesh is not None:
        embed.mesh = mesh
        if cfg.shard_embeddings:
            active = embed.set_mesh(mesh, cfg.shard_unique_frac,
                                    cfg.shard_exchange)
            if mesh.rank == 0:
                print(f"{cfg.shard_exchange} exchange on: "
                      f"{active or 'no part (all small: replicated)'}",
                      flush=True)
    state = init_state(model, embed, cfg.numpy_rand_seed, cfg.optimizer,
                       params=params)
    if mesh is not None:
        state = shard_state(state, mesh, embed)
    return model, embed, state, \
        build_train_step(model, embed, cfg, mesh, capture=capture), \
        build_eval_step(model, embed, capture=capture)


def get_dataset(cfg: Config, phase: str) -> CTRArrays:
    """The synthetic dataset (6/7 train, 1/7 test) or a memmap dataset in
    the reference's binary format under cfg.data_path."""
    if cfg.dataset != "synthetic":
        return load_dataset(cfg.dataset, cfg.data_path, phase,
                            cfg.max_ind_range)
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


def wants_mesh(cfg: Config) -> bool:
    """Whether `run` trains on a mesh (as the JAX package's run decides,
    with torchrun's environment standing for its process count)."""
    return cfg.mesh_shape is not None or cfg.shard_embeddings \
        or cfg.dist_num_processes > 1 or (torchrun_world_size() or 1) > 1


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for the configurations the port lacks
    (the embedding builder raises for the options it lacks)."""
    if wants_mesh(cfg):
        unported = [
            (cfg.mesh_inner > 0, "mesh_inner > 0 (the two-level mesh)"),
            (cfg.shard_unique_frac > 0, "shard_unique_frac > 0 (the "
             "unique-compact exchange)"),
            (cfg.shard_embeddings and cfg.shard_exchange == "auto",
             "shard_exchange auto"),
            (bool(cfg.save_model or cfg.load_model),
             "save_model / load_model under a mesh"),
            (cfg.test_throughput, "the latency protocol under a mesh"),
            (cfg.steps_per_dispatch > 1, "steps_per_dispatch > 1 under a "
             "mesh"),
        ]
        if cfg.shard_embeddings and cfg.method in ("qr", "off", "ada"):
            # replicated parts would be another result for ada: the JAX
            # package's sharded AdaPart runs a shard-local admission
            raise NotImplementedError(
                f"compress method {cfg.method} under --shard_embeddings "
                f"(its sharded part) is not ported yet (ROADMAP queue 1 "
                f"item 6.5)")
        for bad, what in unported:
            if bad:
                raise NotImplementedError(f"{what} is not ported yet "
                                          f"(ROADMAP queue Q8)")
    if cfg.quantize_emb_bits in (4, 8):
        raise NotImplementedError(
            "quantize_emb_bits: quantized serving is not ported yet "
            "(ROADMAP queue Q5)")


_EVAL_CACHE_BYTES = 256 << 20


def _eval_cacheable(test_data) -> bool:
    row_bytes = 4 * (test_data.sparse.shape[1]
                     + (0 if test_data.dense is None
                        else test_data.dense.shape[1]))
    return len(test_data) * max(row_bytes, 1) <= _EVAL_CACHE_BYTES


def _on(x, dev):
    """A host batch array as a tensor on `dev` (None stays None)."""
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.require(x, requirements=["C", "W"])).to(dev)


def inference(cfg: Config, eval_step, state: TrainState, test_data,
              throughput: bool = False, mesh=None
              ) -> Tuple[Dict[str, float], float]:
    """Streaming evaluation on the state's device (main.py:32-131).
    Returns (metrics, ms_per_it). Under a mesh each rank scores its slice
    of every test batch through the same exchange, and the scores are
    all-gathered before the metrics (every rank gets them)."""
    dev = state.step.device
    if not throughput:
        scores, targets = [], []
        bs = cfg.test_mini_batch_size
        batches = (batch_iterator(test_data, bs) if mesh is None else
                   process_batch_iterator(test_data, bs, mesh.rank,
                                          mesh.size))
        for dense, sparse, label, valid in device_prefetch(batches, dev):
            p = eval_step(state, dense, sparse)
            if mesh is not None:
                p, label = all_gather(p, mesh), all_gather(label, mesh)
            # a graphed eval step returns one output tensor, which its
            # next replay overwrites: keep a copy of each batch's scores
            scores.append(p[:valid].clone())
            targets.append(label[:valid])
        return binary_metrics(torch.cat(targets).cpu().numpy(),
                              torch.cat(scores).cpu().numpy()), 0.0

    # latency protocol (main.py:51-81): 10 warmup + 1014 timed batches;
    # small test sets cycle. A set small enough is staged on the device
    # once (re-uploading identical host batches every cycle measures the
    # transfer link, not the serving path); a larger one is re-read and
    # copied every batch, as the reference's protocol does.
    cache = [] if _eval_cacheable(test_data) else None

    def _stream():
        got = False
        for dense, sparse, label, valid in batch_iterator(
                test_data, cfg.test_mini_batch_size):
            got = True
            if cache is not None:
                dense, sparse = _on(dense, dev), _on(sparse, dev)
                cache.append((dense, sparse, label, valid))
            yield dense, sparse, label, valid
        if not got:
            return
        while True:
            if cache is not None:
                yield from cache
            else:
                yield from batch_iterator(test_data,
                                          cfg.test_mini_batch_size)

    qbound = queue_bound()
    t_start, n_timed, p, acc = None, 0, None, None
    for it, (dense, sparse, _, _) in enumerate(_stream()):
        if it == 10:
            # drain the warmup calls before starting the clock
            if p is not None:
                fence(p)
            t_start = time.time()
        p = eval_step(state, _on(dense, dev), _on(sparse, dev))
        if it >= 10:
            n_timed += 1
            acc = p[0].clone() if acc is None else acc + p[0]
            if n_timed % qbound == 0:
                fence(acc)
        if it == 1023:
            break
    fence(acc if acc is not None else p)
    if t_start is None:  # fewer than 11 batches seen: nothing to time
        return {}, 0.0
    return {}, (time.time() - t_start) * 1000.0 / max(n_timed, 1)


def pretrain_autoencoders(embed, state: TrainState, train_data,
                          batch: int, nbatches: int, device, mesh=None
                          ) -> int:
    """The AE pretraining phase: the first pretrain_batches(nbatches)
    batches train only the AE parts (in place), whose embeddings the main
    run then serves frozen. Every rank trains on the whole batch; under a
    mesh of several ranks they then take rank 0's result. Returns the
    number of batches."""
    n_pre = pretrain_batches(nbatches)
    parts = [(f"part{i}", p) for i, p in enumerate(embed.parts)
             if isinstance(p, AEGroupPart)]
    for it, (_, sparse, _, _) in enumerate(batch_iterator(train_data,
                                                          batch)):
        if it >= n_pre:
            break
        ids = torch.from_numpy(np.ascontiguousarray(sparse)).to(device)
        for key, p in parts:
            p.pretrain_step(state.embed[key],
                            ids[:, torch.as_tensor(p.field_idx,
                                                   device=device)])
    if mesh is not None and mesh.size > 1:
        for key, _ in parts:
            for t in state.embed[key].values():
                dist.broadcast(t, src=0, group=mesh.group)
    return n_pre


def _start_profile(dev):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _quiet(*args, **kwargs) -> None:
    """print() of the ranks other than 0."""


def run(cfg: Config, capture: bool = True) -> Dict:
    """Train / evaluate as main.py does. On the card the steps replay
    CUDA graphs where the configuration allows; `capture` False keeps
    them eager (build_all)."""
    t_build = time.time()
    check_supported(cfg)
    device = resolve_device("cpu" if cfg.force_platform == "cpu"
                            else "cuda")
    mesh, own_group = None, False
    if wants_mesh(cfg):
        own_group = maybe_init_distributed(cfg, device)
    try:
        if wants_mesh(cfg):
            mesh = make_mesh(cfg.mesh_shape, cfg.mesh_inner, device)
            for nm, bs in (("mini_batch_size", cfg.mini_batch_size),
                           ("test_mini_batch_size",
                            cfg.test_mini_batch_size)):
                if bs % mesh.size:
                    raise ValueError(f"--{nm} {bs} must divide by the "
                                     f"{mesh.size}-device mesh")
            device = mesh.device
        result = _run(cfg, t_build, device, mesh, capture)
        # close() is collective: a rank that failed skips it, so that it
        # exits instead of waiting for ranks that may never arrive
        if mesh is not None:
            mesh.close()
        return result
    finally:
        if own_group:
            dist.destroy_process_group()


def _run(cfg: Config, t_build: float, device, mesh, capture: bool) -> Dict:
    main = mesh is None or mesh.rank == 0
    print_ = print if main else _quiet
    train_data = get_dataset(cfg, "train")
    test_data = get_dataset(cfg, "test")
    model, embed, state, train_step, eval_step = build_all(
        cfg, train_data, device=device, mesh=mesh, capture=capture)
    if mesh is not None:
        print_(f"sharded over {mesh.size} ranks ({mesh.backend}; "
               f"shard_embeddings={cfg.shard_embeddings}, "
               f"exchange={cfg.shard_exchange})", flush=True)
    print_(f"setup done in {time.time() - t_build:.1f}s on {device}; "
           f"counts={np.asarray(train_data.counts)[:8]}...", flush=True)

    if cfg.test_throughput:
        cfg = dataclasses.replace(
            cfg, print_freq=max(cfg.print_freq, 1024),
            test_freq=2 * max(cfg.print_freq, 1024))

    logger = ScalarLogger((cfg.tensor_board_filename or None) if main
                          else None)
    nbatches = num_batches(train_data, cfg.mini_batch_size)
    # k steps per call over a flat [k*B] batch; iteration counters stay
    # in B units
    k_disp = max(cfg.steps_per_dispatch, 1)
    if k_disp > 1:
        train_step = build_multi_step(train_step, k_disp,
                                      donate=cfg.donate_state)
    fetch = cfg.mini_batch_size * k_disp

    best_acc = 0.0
    skip_epoch, skip_batch = 0, 0
    if cfg.load_model:
        load_path = cfg.load_model
        if not osp.exists(load_path) and osp.exists(load_path + ".latest"):
            # best-accuracy checkpoints only exist after a test event;
            # crash-recovery restarts with the same --save_model path
            # pick up the rolling slot
            load_path = load_path + ".latest"
            print(f"{cfg.load_model} not found; resuming from the "
                  f"rolling checkpoint {load_path}", flush=True)
        state, extra = load_checkpoint(load_path, state)
        best_acc = extra.get("test_acc", 0.0)
        skip_epoch = extra.get("epoch", 0)
        skip_batch = extra.get("iter", 0)
        print(f"loaded {cfg.load_model}: epoch={skip_epoch} "
              f"iter={skip_batch} acc={best_acc:.4f}", flush=True)

    if cfg.inference_only:
        metrics, _ = inference(cfg, eval_step, state, test_data, mesh=mesh)
        print_(" ".join(f"{k}={v:.5f}" for k, v in metrics.items()),
               flush=True)
        logger.close()
        return {"metrics": metrics}

    if cfg.method == "ae" and not cfg.load_model:
        n_pre = pretrain_autoencoders(embed, state, train_data,
                                      cfg.mini_batch_size, nbatches, device,
                                      mesh)
        print_(f"autoencoder pretraining done ({n_pre} batches)",
               flush=True)

    result = {}
    # the loss accumulates ON THE DEVICE: one host read per print window
    # keeps the card's queue full between them
    total_loss = torch.zeros((), dtype=torch.float32, device=device)
    total_samp, total_iter = 0.0, 0
    t_window = time.time()
    train_ms = 0.0
    prof = None
    for ep in range(skip_epoch, cfg.nepochs):
        # exact-batch resume: offset the stream by skip_batch ROWS so the
        # first call continues precisely where the checkpoint stopped,
        # whatever the saving run's steps_per_dispatch
        base_it = skip_batch if ep == skip_epoch else 0
        start = base_it * cfg.mini_batch_size
        if mesh is None:
            raw = batch_iterator(train_data, fetch, start_row=start)
        else:
            # each rank reads only its slice of every global batch
            raw = process_batch_iterator(train_data, fetch, mesh.rank,
                                         mesh.size, start_row=start)
        batches = device_prefetch(raw, device)
        for i, (dense, sparse, label, valid) in enumerate(batches):
            if cfg.enable_profiling and main and i == 10 and prof is None:
                prof = _start_profile(device)
            state, m = train_step(state, dense, sparse, label, valid)
            if prof is not None and i == 10 + cfg.profile_steps:
                fence(m["loss"])
                prof.stop()
                out = osp.join(cfg.tensor_board_filename, "profile")
                os.makedirs(out, exist_ok=True)
                prof.export_chrome_trace(osp.join(out, "trace.json"))
                prof = None
                print_(f"profile written to {out}", flush=True)
            total_loss = total_loss + m["loss"] * valid
            total_samp += valid
            total_iter += k_disp

            eff_it = min(base_it + (i + 1) * k_disp, nbatches)
            should_print = (eff_it % cfg.print_freq < k_disp) \
                or (eff_it == nbatches) \
                or (eff_it <= 100 and not cfg.test_throughput)
            should_test = cfg.test_freq > 0 and (
                eff_it % cfg.test_freq < k_disp or eff_it == nbatches)
            if should_print or should_test:
                fence(state.params)
                now = time.time()
                train_ms = (now - t_window) * 1000.0 / max(total_iter, 1)
                t_window = now
                train_loss = float(total_loss) / max(total_samp, 1)
                print_(f"Finished training it {eff_it}/{nbatches} of epoch "
                       f"{ep}, {train_ms:.2f} ms/it, loss {train_loss:.6f}",
                       flush=True)
                log_iter = nbatches * ep + eff_it
                logger.add_scalar("Train/Loss", train_loss, log_iter)
                total_loss = torch.zeros((), dtype=torch.float32,
                                         device=device)
                total_samp, total_iter = 0.0, 0

            # rolling preemption-safety checkpoint (besides the
            # best-accuracy saves below); resume is exact-batch via the
            # saved iter counter
            if cfg.save_freq > 0 and cfg.save_model and \
                    (eff_it % cfg.save_freq < k_disp or eff_it == nbatches):
                save_rolling(cfg.save_model, state, {
                    "test_acc": best_acc, "epoch": ep, "iter": eff_it,
                })

            if should_test or (cfg.test_throughput
                               and eff_it >= 2 * cfg.print_freq):
                if cfg.test_throughput:
                    _, test_ms = inference(cfg, eval_step, state, test_data,
                                           throughput=True)
                    # a test set small enough is staged on the device once:
                    # serving-path latency, not transfer-inclusive latency
                    lat = {"train": train_ms, "test": test_ms,
                           "test_batches_device_cached":
                               _eval_cacheable(test_data)}
                    out = osp.join(cfg.tensor_board_filename, "latency.json")
                    with open(out, "w") as f:
                        json.dump(lat, f)
                    print_(f"latency: {lat}", flush=True)
                    logger.close()
                    return {"latency": lat}
                metrics, _ = inference(cfg, eval_step, state, test_data,
                                       mesh=mesh)
                log_iter = nbatches * ep + eff_it
                for k, v in metrics.items():
                    logger.add_scalar(k if k != "accuracy" else "Test/Acc",
                                      v, log_iter)
                print_(f" accuracy {metrics['accuracy'] * 100:3.3f} %, "
                       f"auc {metrics['roc_auc'] * 100:3.3f} %, best "
                       f"{max(best_acc, metrics['accuracy']) * 100:3.3f} %",
                       flush=True)
                result = {"metrics": metrics}
                if metrics["accuracy"] > best_acc:
                    best_acc = metrics["accuracy"]
                    if cfg.save_model:
                        save_checkpoint(cfg.save_model, state, {
                            "test_acc": best_acc, "epoch": ep,
                            "iter": eff_it,
                        })
                        print(f"saved model to {cfg.save_model}", flush=True)
    logger.close()
    result["best_acc"] = best_acc
    return result
