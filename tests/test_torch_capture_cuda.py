"""The CUDA-graph steps on the card (train/capture.py), with no JAX in the
process: `cuda` tests that skip here and run on a card with

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_capture_cuda.py

* a replayed train step equals the eager step bit for bit over 10 steps
  with a tail and an empty batch, on the deterministic dense apply (K3)
  with frequency scores; so do the 2-step dispatch and the eval step;
* a call with another state (a reload) copies it in before the replay
  and leaves the caller's tensors alone;
* the kernels' launch counts grow by the captured launches at every
  replay.
"""

import numpy as np
import pytest
import torch

from cafe_tpu_torch.bridge import from_reference, to_numpy
from cafe_tpu_torch.config import Config
from cafe_tpu_torch.kernels import land, rowsum
from cafe_tpu_torch.train import build_all, build_multi_step, get_dataset
from cafe_tpu_torch.train.capture import WARMUP_CALLS, GraphedStep

torch.set_num_threads(1)

B = 256
KW = dict(dataset="synthetic", synthetic_rows=8192, synthetic_fields=6,
          synthetic_vocab=5000, synthetic_dense=4, synthetic_zipf=1.2,
          embedding_dim=16, mini_batch_size=B, compress_method="cafe",
          compress_rate=0.05, cafe_sketch_threshold=3.0, cafe_use_freq=True,
          learning_rate=0.1, bf16=True, sparse_apply_impl="dense")
# valid counts of the 10 steps: full batches, a tail, an empty batch
VALIDS = [B, B, B, B - 37, B, 0, B, B, B - 1, B]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _setup(k=1, **kw):
    """(cfg, graphed step, eager step, graphed eval, eager eval, start
    state as numpy, batches of k * B rows on the card)."""
    cfg = Config(**dict(KW, **kw))
    data = get_dataset(cfg, "train")
    _, _, state, g_step, g_eval = build_all(cfg, data, device="cuda")
    _, _, _, e_step, e_eval = build_all(cfg, data, device="cuda",
                                        capture=False)
    if k > 1:
        g_step = build_multi_step(g_step, k, donate=True)
        e_step = build_multi_step(e_step, k, donate=True)
    rows = k * B
    batches = [tuple(torch.from_numpy(np.ascontiguousarray(a[i:i + rows]))
                     .cuda() for a in (data.dense, data.sparse, data.label))
               for i in range(0, len(data) - rows + 1, rows)]
    return cfg, g_step, e_step, g_eval, e_eval, to_numpy(state), batches


def _run(step, state, batches, valids):
    metrics = []
    for i, v in enumerate(valids):
        state, m = step(state, *batches[i % len(batches)], v)
        metrics.append({name: x.clone() for name, x in m.items()})
    torch.cuda.synchronize()
    return state, metrics


def _assert_equal(a, b):
    np.testing.assert_equal(to_numpy(a), to_numpy(b))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_replayed_steps_equal_eager_steps_bitwise(k):
    _card()
    _, g_step, e_step, g_eval, e_eval, start, batches = _setup(k)
    assert g_step.graphed and isinstance(g_step, GraphedStep)
    assert not e_step.graphed
    valids = [k * v for v in VALIDS]
    e_state, e_m = _run(e_step, from_reference(start, "cuda"), batches,
                        valids)
    g_state, g_m = _run(g_step, from_reference(start, "cuda"), batches,
                        valids)
    assert g_step.replays == len(valids) - WARMUP_CALLS
    _assert_equal(g_state, e_state)
    for em, gm in zip(e_m, g_m):
        assert set(em) == set(gm)
        for name in em:
            assert torch.equal(em[name], gm[name]), name
    assert sum(float(m["cafe_promotions"]) for m in g_m) > 0
    # eval on the trained state: graphed scores equal eager ones
    for dense, sparse, _ in batches[:4]:
        got = g_eval(g_state, dense[:B], sparse[:B]).clone()
        want = e_eval(e_state, dense[:B], sparse[:B])
        assert torch.equal(got, want)
    assert g_eval.graphed and g_eval.replays == 4 - WARMUP_CALLS


@pytest.mark.cuda
def test_a_different_state_is_copied_in():
    """After the graph has run on one state, a call with a state loaded
    from elsewhere replays on that state's values, and the loaded
    tensors stay as they were."""
    _card()
    _, g_step, e_step, _, _, start, batches = _setup()
    state = from_reference(start, "cuda")
    for i in range(WARMUP_CALLS + 2):
        state, _ = g_step(state, *batches[i], B)
    assert g_step.replays == 2
    loaded = from_reference(start, "cuda")
    loaded_before = to_numpy(loaded)
    got, gm = g_step(loaded, *batches[5], B - 9)
    want, em = e_step(from_reference(start, "cuda"), *batches[5], B - 9)
    torch.cuda.synchronize()
    _assert_equal(got, want)
    assert float(gm["loss"]) == float(em["loss"])
    np.testing.assert_equal(to_numpy(loaded), loaded_before)
    assert got is g_step.state and got is not loaded


@pytest.mark.cuda
def test_launch_counts_grow_per_replay():
    _card()
    _, g_step, _, _, _, start, batches = _setup()
    state = from_reference(start, "cuda")
    l0, r0 = land.KERNEL.launches, rowsum.KERNEL.launches
    g0 = land.KERNEL.graph_launches
    n = 12
    for i in range(n):
        state, _ = g_step(state, *batches[i % len(batches)], B)
    torch.cuda.synchronize()
    assert g_step.launches_per_replay() == {"land_max": 1, "rowsum": 1}
    assert land.KERNEL.launches - l0 == n
    assert rowsum.KERNEL.launches - r0 == n
    assert land.KERNEL.graph_launches - g0 == n - WARMUP_CALLS
    assert land.KERNEL.captured >= 1 and g_step.capture_s > 0
