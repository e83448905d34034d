#!/usr/bin/env python
"""Graph-recommender training driver on the port (PyTorch, one CUDA
card): LightGCN and PinSAGE with optional CAFE-compressed node
embeddings. main_graphrec.py's flags and output lines.

    python main_graphrec_torch.py --model lightgcn --compress_rate 0.1
    python main_graphrec_torch.py --model pinsage --compress_ratio 4
    python main_graphrec_torch.py --force_platform cpu ...   # the CPU

Mirrors the reference's TOIS_revision drivers:
  * LightGCN (code/main.py + Procedure.py): per-epoch BPR training over
    C-sampled (user, pos, neg) triples, recall@k evaluation on the held-out
    interactions, gowalla-style train.txt/test.txt input ("user i1 i2 ...").
  * PinSAGE (model.py:96-193): margin-loss training on random-walk item
    pairs, per-epoch checkpointing that INCLUDES the sketch state
    (save_state/load_state parity, PinSAGE/sketch.cpp:333-402) and
    auto-resume from the latest checkpoint (model.py:135-147).

With no --data_path a synthetic bipartite graph with latent block structure
is generated so recall@k is meaningfully above random. Checkpoints are one
torch.save file of CPU copies of the state (sketch included) plus its
.meta.json, named {model}_epoch_{ep}.ckpt. `main` returns the run's
numbers (recall or hit / NDCG, per-epoch loss, device ms per step, the
host sampler's seconds, the sketch's hot ids, whether the steps were
graphed and their capture seconds).

On the card the steps main_graphrec.py jits (LightGCN's BPR step,
PinSAGE's train step and its representation step) replay CUDA graphs
(train/capture.py), built once before the first epoch; on the CPU they
run eagerly. `main(argv, capture=False)` builds the eager steps on the
card too (chip_smoke.py times the two). A capture that fails raises.
"""

import argparse
import glob
import os.path as osp
import re
import time

import numpy as np
import torch


def load_gowalla_txt(path):
    """LightGCN dataset format: each line 'user item item ...'."""
    user_items = []
    n_items = 0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            u = int(parts[0])
            its = np.array([int(x) for x in parts[1:]], dtype=np.int32)
            while len(user_items) <= u:
                user_items.append(np.empty(0, np.int32))
            user_items[u] = its
            if its.size:
                n_items = max(n_items, int(its.max()) + 1)
    return user_items, n_items


def make_synthetic_interactions(n_users=600, n_items=1200, blocks=8,
                                per_user=24, seed=0):
    """Block-structured bipartite graph: users prefer their block's items
    (the latent structure recall@k can recover)."""
    rng = np.random.default_rng(seed)
    train, test = [], []
    for u in range(n_users):
        b = u % blocks
        lo, hi = b * n_items // blocks, (b + 1) * n_items // blocks
        k = per_user
        own = rng.choice(np.arange(lo, hi), size=min(k * 3 // 4, hi - lo),
                         replace=False)
        other = rng.integers(0, n_items, k - len(own))
        its = np.unique(np.concatenate([own, other])).astype(np.int32)
        rng.shuffle(its)
        cut = max(len(its) * 4 // 5, 1)
        train.append(np.sort(its[:cut]))
        test.append(np.sort(its[cut:]))
    return train, test, n_items


def latest_epoch_ckpt(save_dir, model):
    """Auto-resume convention (PinSAGE model.py:135-141): pick the highest
    model_epoch_*.ckpt in save_dir."""
    best, best_ep = None, -1
    for p in glob.glob(osp.join(save_dir, f"{model}_epoch_*.ckpt")):
        m = re.search(r"_epoch_(\d+)\.ckpt$", p)
        if m and int(m.group(1)) > best_ep:
            best, best_ep = p, int(m.group(1))
    return best, best_ep


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def hot_ids(embed_state) -> int:
    """Ids the CAFE part's sketch holds hot (0 for a full table)."""
    if "sketch" not in embed_state:
        return 0
    return int((embed_state["sketch"]["dic"] != 0).sum())


def _resume(args, model_name, state, device):
    from cafe_tpu_torch.train.checkpoint import load_tree
    start_ep = 0
    if args.save_dir:
        ck, ep = latest_epoch_ckpt(args.save_dir, model_name)
        if ck:
            state, _ = load_tree(ck, state, device)
            start_ep = ep + 1
            print(f"resumed from {ck} (epoch {ep})", flush=True)
    return state, start_ep


def lightgcn_model(args, train_pos, n_items, device):
    """The LightGCN of `args` over the train interactions' graph."""
    from cafe_tpu_torch.models.graphrec.lightgcn import (
        LightGCN, LightGCNConfig, build_bipartite_graph)
    users = np.concatenate([np.full(len(p), u, np.int32)
                            for u, p in enumerate(train_pos)])
    graph = build_bipartite_graph(users, np.concatenate(train_pos),
                                  len(train_pos), n_items)
    cfg = LightGCNConfig(latent_dim=args.dim, n_layers=args.layers,
                         lr=args.lr, weight_decay=args.weight_decay,
                         compress_rate=args.compress_rate,
                         hot_rate=args.hot_rate,
                         sketch_threshold=args.sketch_threshold,
                         seed=args.seed, optimizer=args.optimizer)
    return LightGCN(cfg, graph, device=device)


def _capture_record(step):
    """The run's record of how its steps ran: graphed or not, what kept
    them eager, the replays and capture seconds so far."""
    return {"graphed": step.graphed,
            "capture_blockers": list(step.capture_blockers),
            "replays": step.replays if step.graphed else 0,
            "capture_s": step.capture_s if step.graphed else 0.0}


def run_lightgcn(args, train_pos, test_pos, n_items, device, capture=True):
    from cafe_tpu_torch.models.graphrec.sampling import sample_negative
    from cafe_tpu_torch.train.checkpoint import save_tree

    n_users = len(train_pos)
    items = np.concatenate(train_pos)
    model = lightgcn_model(args, train_pos, n_items, device)
    state, start_ep = _resume(args, "lightgcn", model.init(), device)
    step = model.build_step(capture)

    out = {"epochs": [], "recall": float("nan")}
    if start_ep >= args.epochs:
        rec = model.recall_at_k(state, train_pos, test_pos, k=args.topk)
        out["recall"] = rec
        print(f"nothing to train (resumed epoch {start_ep} >= --epochs "
              f"{args.epochs}); recall@{args.topk} {rec:.4f}", flush=True)
    for ep in range(start_ep, args.epochs):
        t0 = time.time()
        triples = sample_negative(n_users, n_items, len(items), train_pos,
                                  seed=args.seed + ep)
        perm = np.random.default_rng(ep).permutation(len(triples))
        triples = triples[perm]
        # clamp so tiny datasets still take gradient steps; the tail
        # remainder smaller than the batch is dropped
        bb = min(args.bpr_batch, len(triples))
        # (user, pos, neg) rows as int64 device tensors, one copy an epoch
        cols = torch.from_numpy(np.ascontiguousarray(triples[:, :3].T)).to(
            model.device, torch.int64)
        t_sample = time.time() - t0
        losses = []
        cap0 = _capture_record(step)["capture_s"]
        _sync(model.device)
        t1 = time.perf_counter()
        for lo in range(0, len(triples) - bb + 1, bb):
            state, loss = step(state, *cols[:, lo:lo + bb])
            losses.append(loss.clone())   # a replay overwrites `loss`
        _sync(model.device)
        step_s = time.perf_counter() - t1
        cap = _capture_record(step)
        t2 = time.perf_counter()
        rec = model.recall_at_k(state, train_pos, test_pos, k=args.topk)
        eval_s = time.perf_counter() - t2
        mean_loss = float(np.mean(torch.stack(losses).double().cpu()
                                  .numpy()))
        print(f"epoch {ep}: bpr_loss {mean_loss:.4f} "
              f"recall@{args.topk} {rec:.4f} "
              f"({time.time() - t0:.1f}s)", flush=True)
        out["recall"] = rec
        out["epochs"].append({
            "epoch": ep, "loss": mean_loss, "recall": rec,
            "steps": len(losses), "sample_s": t_sample,
            "ms_per_step": step_s * 1e3 / max(len(losses), 1),
            "graphed": cap["graphed"], "capture_s": cap["capture_s"] - cap0,
            "eval_s": eval_s, "hot_ids": hot_ids(state)})
        if args.save_dir:
            save_tree(osp.join(args.save_dir, f"lightgcn_epoch_{ep}.ckpt"),
                      state, {"epoch": ep, "recall": rec})
    out["hot_ids"] = hot_ids(state)
    out.update(_capture_record(step))
    return out


def pinsage_hit_ndcg(reps, train_pos, test_pos, k=10):
    """Latest-item nearest-neighbor recommendation (PinSAGE
    evaluation.py:52-115): seed each user with their last train item,
    rank all items by representation dot product excluding interacted
    ones; hit@k = any held-out item in the top-k, NDCG with binary
    relevance (idcg = 1)."""
    discounts = 1.0 / np.log2(np.arange(2, k + 2))
    hits, ndcgs = [], []
    for u in range(len(train_pos)):
        if len(train_pos[u]) == 0 or len(test_pos[u]) == 0:
            continue
        seed = int(train_pos[u][-1])
        dist = reps[seed] @ reps.T
        dist[np.asarray(train_pos[u], dtype=int)] = -np.inf
        kk = min(k, len(dist) - 1)
        topk = np.argpartition(-dist, kk)[:kk]
        topk = topk[np.argsort(-dist[topk])]
        rel = np.isin(topk, test_pos[u])
        hits.append(bool(rel.any()))
        ndcgs.append(float((rel * discounts[: len(rel)]).sum()))
    if not hits:
        return 0.0, 0.0
    return float(np.mean(hits)), float(np.mean(ndcgs))


def pinsage_model(args, train_pos, n_items, device):
    """The PinSAGE of `args` and its random-walk sampler."""
    from cafe_tpu_torch.models.graphrec.pinsage import (
        PinSAGE, PinSAGEConfig, RandomWalkSampler)
    cfg = PinSAGEConfig(hidden_dims=args.dim, n_layers=min(args.layers, 2),
                        lr=args.lr, compress_ratio=args.compress_ratio,
                        sketch_threshold=args.sketch_threshold,
                        seed=args.seed, optimizer=args.optimizer)
    item_users = [[] for _ in range(n_items)]
    for u, its in enumerate(train_pos):
        for it in its:
            item_users[int(it)].append(u)
    item_users = [np.asarray(us, dtype=np.int32) for us in item_users]
    return (PinSAGE(cfg, n_items, device=device),
            RandomWalkSampler(train_pos, item_users, seed=args.seed))


def run_pinsage(args, train_pos, test_pos, n_items, device, capture=True):
    from cafe_tpu_torch.models.graphrec.pinsage import block_args
    from cafe_tpu_torch.train.checkpoint import save_tree

    model, sampler = pinsage_model(args, train_pos, n_items, device)
    state, start_ep = _resume(args, "pinsage", model.init(), device)
    step = model.build_train_step(args.lr, capture)
    rep_step = model.build_representation_step(capture)

    batches = max(args.steps_per_epoch, 1)
    out = {"epochs": [], "loss": float("nan")}
    if start_ep >= args.epochs:
        print(f"nothing to train: resumed epoch {start_ep} >= "
              f"--epochs {args.epochs}", flush=True)
    for ep in range(start_ep, args.epochs):
        t0 = time.time()
        losses = []
        host_s = dev_s = 0.0
        cap0 = _capture_record(step)["capture_s"]
        for _ in range(batches):
            t1 = time.perf_counter()
            batch = model.make_batch(sampler, args.bpr_batch)
            _sync(model.device)
            t2 = time.perf_counter()
            state, loss = step(state, *block_args(batch), args.lr)
            losses.append(loss.clone())   # a replay overwrites `loss`
            _sync(model.device)
            host_s += t2 - t1
            dev_s += time.perf_counter() - t2
        cap = _capture_record(step)
        t3 = time.perf_counter()
        reps = model.represent_items(state, sampler, step=rep_step)
        hit, nd = pinsage_hit_ndcg(reps, train_pos, test_pos, k=args.topk)
        eval_s = time.perf_counter() - t3
        mean_loss = float(np.mean(torch.stack(losses).double().cpu()
                                  .numpy()))
        print(f"epoch {ep}: margin_loss {mean_loss:.4f} "
              f"hit@{args.topk} {hit:.4f} ndcg {nd:.4f} "
              f"({time.time() - t0:.1f}s)", flush=True)
        out["loss"] = mean_loss
        out["epochs"].append({
            "epoch": ep, "loss": mean_loss, "hit": hit, "ndcg": nd,
            "steps": batches, "ids_per_step": int(batch["ids"].shape[0]),
            "sampler_ms_per_step": host_s * 1e3 / batches,
            "ms_per_step": dev_s * 1e3 / batches,
            "graphed": cap["graphed"], "capture_s": cap["capture_s"] - cap0,
            "eval_s": eval_s, "hot_ids": hot_ids(state["embed"])})
        if args.save_dir:
            save_tree(osp.join(args.save_dir, f"pinsage_epoch_{ep}.ckpt"),
                      state, {"epoch": ep, "loss": mean_loss,
                              "hit": hit, "ndcg": nd})
    out["hot_ids"] = hot_ids(state["embed"])
    out.update(_capture_record(step))
    out["representation"] = _capture_record(rep_step)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", choices=["lightgcn", "pinsage"],
                   default="lightgcn")
    p.add_argument("--data_path", default="",
                   help="dir with train.txt/test.txt (gowalla format)")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--bpr_batch", type=int, default=2048)
    p.add_argument("--steps_per_epoch", type=int, default=50,
                   help="pinsage only")
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--lr", type=float, default=0.001,
                   help="the reference's Adam regime (world.py:48-49, "
                        "PinSAGE model.py:133); use ~0.1 with sgd/adagrad")
    p.add_argument("--optimizer", choices=["sgd", "adagrad", "adam"],
                   default="adam",
                   help="dense params get dense Adam, embedding tables "
                        "rows-Adam (ops/sparse.py); matches the reference "
                        "(PinSAGE/model.py:133, LightGCN/code/utils.py:39)")
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--topk", type=int, default=20)
    # CAFE knobs (world.py:48-49 defaults; compress_rate 1.0 = full table)
    p.add_argument("--compress_rate", type=float, default=1.0)
    p.add_argument("--hot_rate", type=float, default=0.7)
    p.add_argument("--compress_ratio", type=int, default=1,
                   help="pinsage CAFE knob (layers.py:81-90); >1 enables")
    p.add_argument("--sketch_threshold", type=float, default=500.0)
    p.add_argument("--save_dir", default="")
    p.add_argument("--seed", type=int, default=2020)
    # synthetic graph knobs
    p.add_argument("--synthetic_users", type=int, default=600)
    p.add_argument("--synthetic_items", type=int, default=1200)
    p.add_argument("--force_platform", default="",
                   help="cpu runs on the CPU (the kernels' plain "
                        "versions); anything else needs the CUDA card")
    return p.parse_args(argv)


def main(argv=None, capture=True):
    """Train and evaluate the model of `argv`; `capture` False keeps the
    steps eager on the card (module docstring). Returns the run's
    numbers."""
    args = parse_args(argv)
    from cafe_tpu_torch.device import resolve_device
    device = resolve_device("cpu" if args.force_platform == "cpu"
                            else "cuda")

    if args.data_path:
        train_pos, n1 = load_gowalla_txt(osp.join(args.data_path,
                                                  "train.txt"))
        test_pos, n2 = load_gowalla_txt(osp.join(args.data_path,
                                                 "test.txt"))
        # pad BOTH ways so cold-start users present only in test.txt are
        # still counted by recall@k (with empty train history)
        while len(test_pos) < len(train_pos):
            test_pos.append(np.empty(0, np.int32))
        while len(train_pos) < len(test_pos):
            train_pos.append(np.empty(0, np.int32))
        n_items = max(n1, n2)
    else:
        train_pos, test_pos, n_items = make_synthetic_interactions(
            args.synthetic_users, args.synthetic_items, seed=args.seed)
    print(f"{args.model}: {len(train_pos)} users, {n_items} items, "
          f"{sum(len(p) for p in train_pos)} train interactions", flush=True)

    run = run_lightgcn if args.model == "lightgcn" else run_pinsage
    return run(args, train_pos, test_pos, n_items, device, capture)


if __name__ == "__main__":
    main()
