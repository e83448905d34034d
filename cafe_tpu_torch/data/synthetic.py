"""Synthetic CTR streams — the test backbone (a copy of
cafe_tpu/data/synthetic.py, numpy only, kept so the port imports nothing
of `cafe_tpu`).

The reference keeps an (unreachable) synthetic path, RandomDataset +
distribution generators (dlrm_data_pytorch.py:759-1404); here synthetic data
is a first-class citizen: every unit/integration test and the benchmark can
fabricate a Criteo-shaped stream with a controllable skew, and the generator
can also *write* the binary dataset format so the whole preprocessing →
training path is exercised without the real 60 GB datasets.

Four id distributions, matching the reference's generator designs:
  zipf      — inverse-CDF Zipf(s) over each field's vocabulary (the standard
              skew model; CTR streams are heavily skewed, CAFE's premise)
  uniform   — round(U(0,1) * (vocab-1))   (generate_dist_input_batch:1133)
  gaussian  — clip(N(mu, sigma), 0, vocab-1)  (generate_dist_input_batch:1127)
  trace     — stack-distance LRU model (trace_profile:1313 /
              trace_generate_lru:1254): profile a real id trace into a
              reuse-distance distribution, then synthesize an arbitrarily
              long stream with the same temporal-locality profile.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from .datasets import CTRArrays


def _zipf_ids(rng: np.random.Generator, n: int, vocab: int,
              s: float, perm_seed: int = 0) -> np.ndarray:
    """Zipf-distributed ids in [0, vocab) via inverse-CDF on ranks.

    Ranks are then permuted (seeded by vocab and perm_seed) so hot ids are
    scattered over the id space like real label-encoded data rather than
    clustered at 0.
    """
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-s)
    probs /= probs.sum()
    cdf = np.cumsum(probs)
    u = rng.random(n)
    idx = np.searchsorted(cdf, u).astype(np.int64)
    perm = np.random.RandomState(
        (vocab + 7919 * perm_seed) % (2**31 - 1)).permutation(vocab)
    return perm[np.minimum(idx, vocab - 1)].astype(np.int32)


def _uniform_ids(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    return np.round(rng.random(n) * (vocab - 1)).astype(np.int32)


def _gaussian_ids(rng: np.random.Generator, n: int, vocab: int,
                  mu: float = -1.0, sigma: float = -1.0) -> np.ndarray:
    if mu < 0:
        mu = (vocab - 1) / 2.0
    if sigma < 0:
        sigma = vocab / 4.0
    r = np.round(rng.normal(mu, sigma, n))
    return np.clip(r, 0, vocab - 1).astype(np.int32)


# --- stack-distance trace model (dlrm_data_pytorch.py:1232-1404) -----------

def trace_profile(trace: np.ndarray):
    """Profile an id trace into (line_accesses, list_sd, cumm_sd).

    The stack distance of an access is the number of *distinct* ids touched
    since that id's previous access (inclusive); 0 marks a first-time
    reference. Computed in O(n log n) with a Fenwick tree over last-access
    positions instead of the reference's O(n²) list scan
    (trace_profile:1312-1345); same definition (consecutive repeats have
    distance 1).

    Returns: unique ids in first-seen order, the sorted unique distances,
    and their cumulative probability (the sampling tables
    read_dist_from_file builds).
    """
    trace = np.asarray(trace).ravel()
    n = len(trace)
    bit = np.zeros(n + 1, dtype=np.int64)

    def bit_add(i, v):
        i += 1
        while i <= n:
            bit[i] += v
            i += i & (-i)

    def bit_sum(i):  # prefix sum of [0, i]
        i += 1
        s = 0
        while i > 0:
            s += bit[i]
            i -= i & (-i)
        return s

    last = {}
    sds = np.empty(n, dtype=np.int64)
    first_seen = []
    for t, x in enumerate(trace):
        x = int(x)
        p = last.get(x)
        if p is None:
            sds[t] = 0
            first_seen.append(x)
        else:
            sds[t] = (bit_sum(t - 1) - bit_sum(p)) + 1
            bit_add(p, -1)
        bit_add(t, 1)
        last[x] = t
    list_sd, counts = np.unique(sds, return_counts=True)
    cumm_sd = np.cumsum(counts / counts.sum())
    return np.asarray(first_seen, dtype=np.int64), list_sd, cumm_sd


def generate_stack_distance(list_sd, cumm_sd, max_sd, i, u):
    """Sample one stack distance by inverse CDF; while fewer than max_sd
    distinct refs have been emitted the support is shrunk so only feasible
    distances (≤ i) are drawn (generate_stack_distance:1232-1247)."""
    if i < max_sd:
        j = np.searchsorted(list_sd, i, side="right") - 1
        u = u * cumm_sd[j]
    return list_sd[np.searchsorted(cumm_sd, u, side="left")]


def trace_generate_lru(line_accesses, list_sd, cumm_sd, out_len: int,
                       rng: np.random.Generator) -> np.ndarray:
    """Synthesize a trace with the profiled reuse-distance distribution via
    an explicit LRU stack (trace_generate_lru:1254-1283): distance 0 pulls
    the coldest unseen line; distance d re-references the d-th most
    recently used line and moves it to the top."""
    stack = list(np.asarray(line_accesses).tolist())
    l = len(stack)
    max_sd = int(list_sd[-1])
    out = np.empty(out_len, dtype=np.int64)
    us = rng.random(out_len)
    i = 0
    for t in range(out_len):
        sd = int(generate_stack_distance(list_sd, cumm_sd, max_sd, i, us[t]))
        sd = min(sd, l)
        if sd == 0:
            ref = stack.pop(0)
            stack.append(ref)
            i += 1
        else:
            ref = stack.pop(l - sd)
            stack.append(ref)
        out[t] = ref
    return out


def make_trace_ids(rng: np.random.Generator, n: int, vocab: int,
                   trace: np.ndarray) -> np.ndarray:
    """Ids for one field: profile `trace`, then generate n accesses with the
    same temporal-locality profile (mod-guard against out-of-range lines,
    generate_synthetic_input_batch:1216-1218)."""
    lines, list_sd, cumm_sd = trace_profile(trace)
    out = trace_generate_lru(lines, list_sd, cumm_sd, n, rng)
    if out.min() < 0 or out.max() >= vocab:
        out = out % vocab
    return out.astype(np.int32)


def make_synthetic_arrays(rows: int = 65536, fields: int = 8,
                          vocab: int = 100000, dense: int = 13,
                          zipf: float = 1.05, seed: int = 0,
                          label_from_ids: bool = True,
                          dist: str = "zipf",
                          trace: np.ndarray = None,
                          shift_at: float = 0.0,
                          vocab_spread: float = 1.0) -> CTRArrays:
    """Build an in-memory CTR dataset.

    If `label_from_ids`, labels correlate with a fixed random per-id logit so
    a model can actually learn (AUC > 0.5) — needed for end-to-end learning
    tests; otherwise labels are fair coin flips.

    `dist` picks the id distribution (zipf | uniform | gaussian | trace);
    "trace" profiles the given id trace (or, if None, a self-generated Zipf
    stream) and synthesizes ids with the same reuse-distance profile.

    `shift_at` in (0, 1) injects a DISTRIBUTION SHIFT at that fraction of
    the stream: the Zipf rank->id mapping is re-drawn, so the hot set
    changes completely mid-stream (the adaptivity scenario CAFE's online
    promotion/demotion — and CAFE+'s adaptive threshold — exist for).

    `vocab_spread` < 1 gives fields log-spaced vocabularies from `vocab`
    down to `vocab * vocab_spread` — real CTR vocabularies span orders of
    magnitude (Criteo: 3 .. 10M), and per-field spread is what MDE's
    dimension assignment and the per-field sizing formulas exploit; equal
    vocabs degenerate them.
    """
    rng = np.random.default_rng(seed)
    if not 0.0 < vocab_spread <= 1.0:
        raise ValueError(f"vocab_spread must be in (0, 1], got {vocab_spread}")
    if vocab_spread < 1.0 and fields > 1:
        ratios = vocab_spread ** (np.arange(fields) / (fields - 1))
        counts = np.maximum((vocab * ratios).astype(np.int64), 2).astype(
            np.int32)
    else:
        counts = np.full(fields, vocab, dtype=np.int32)
    if 0.0 < shift_at < 1.0 and dist != "zipf":
        raise ValueError(
            f"shift_at is only defined for dist='zipf' (got {dist!r})")
    if dist == "zipf" and 0.0 < shift_at < 1.0:
        cut = int(rows * shift_at)
        cols = [np.concatenate([
            _zipf_ids(rng, cut, int(v), zipf, perm_seed=0),
            _zipf_ids(rng, rows - cut, int(v), zipf, perm_seed=1)])
            for v in counts]
    elif dist == "zipf":
        cols = [_zipf_ids(rng, rows, int(v), zipf) for v in counts]
    elif dist == "uniform":
        cols = [_uniform_ids(rng, rows, int(v)) for v in counts]
    elif dist == "gaussian":
        cols = [_gaussian_ids(rng, rows, int(v)) for v in counts]
    elif dist == "trace":
        if trace is None:
            trace = _zipf_ids(rng, min(rows, 16384), vocab, zipf)
        # profile ONCE; each field then synthesizes its own stream from
        # the shared reuse-distance tables
        lines, list_sd, cumm_sd = trace_profile(trace)
        cols = []
        for v in counts:
            out = trace_generate_lru(lines, list_sd, cumm_sd, rows, rng)
            if out.min() < 0 or out.max() >= int(v):
                out = out % int(v)
            cols.append(out.astype(np.int32))
    else:
        raise ValueError(f"unknown synthetic dist {dist!r}")
    sparse = np.stack(cols, axis=1)
    dense_arr = None
    if dense > 0:
        dense_arr = np.log1p(rng.gamma(2.0, 2.0, size=(rows, dense))
                             ).astype(np.float32)
    if label_from_ids:
        logits = np.zeros(rows, dtype=np.float32)
        for f in range(fields):
            id_logit = rng.normal(0.0, 1.0,
                                  size=int(counts[f])).astype(np.float32)
            logits += id_logit[sparse[:, f]]
        logits /= np.sqrt(fields)
        p = 1.0 / (1.0 + np.exp(-logits))
        label = (rng.random(rows) < p).astype(np.int32)
    else:
        label = (rng.random(rows) < 0.5).astype(np.int32)
    return CTRArrays(sparse.astype(np.int32), dense_arr, label, counts)


def write_synthetic_dataset(path: str, **kwargs) -> CTRArrays:
    """Write a synthetic dataset in the reference binary format."""
    os.makedirs(path, exist_ok=True)
    a = make_synthetic_arrays(**kwargs)
    a.sparse.tofile(osp.join(path, "processed_sparse_sep.bin"))
    if a.dense is not None:
        a.dense.tofile(osp.join(path, "processed_dense.bin"))
    a.label.astype(np.int32).tofile(osp.join(path, "processed_label.bin"))
    a.counts.tofile(osp.join(path, "processed_count.bin"))
    return a
