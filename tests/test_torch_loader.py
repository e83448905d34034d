"""data/loader.device_prefetch, with no JAX in the process.

On the CPU it only converts (read-only memmap slices included). On the
card (`cuda` marker; run with `python3 -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_loader.py`) every batch must
arrive whole behind a slow copy stream and stay whole for a slow
consumer: without the per-batch event wait a step could read a
half-copied batch, and without `record_stream` the caching allocator
could hand a batch's memory to a later copy while the consumer's queued
kernels still read it.
"""

import numpy as np
import pytest
import torch

from cafe_tpu_torch.data import CTRArrays, batch_iterator
from cafe_tpu_torch.data.loader import device_prefetch

torch.set_num_threads(1)


def _batches(n, b, seed=0, dense=True):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield ((rng.random((b, 13)).astype(np.float32) if dense else None),
               rng.integers(0, 1 << 30, (b, 26)).astype(np.int32),
               rng.integers(0, 2, b).astype(np.float32), b - 1)


@pytest.mark.parametrize("dense", [True, False])
def test_cpu_prefetch_converts(dense):
    got = list(device_prefetch(_batches(5, 64, dense=dense), "cpu"))
    want = list(_batches(5, 64, dense=dense))
    assert len(got) == 5
    for g, w in zip(got, want):
        assert g[3] == w[3] == 63
        for a, c in zip(g[:3], w[:3]):
            if c is None:
                assert a is None
            else:
                assert isinstance(a, torch.Tensor)
                np.testing.assert_array_equal(a.numpy(), c)


def test_cpu_prefetch_of_read_only_memmap(tmp_path):
    path = tmp_path / "sparse.bin"
    np.arange(40 * 3, dtype=np.int32).reshape(40, 3).tofile(path)
    sparse = np.memmap(path, dtype=np.int32, mode="r").reshape(40, 3)
    data = CTRArrays(sparse, None, np.zeros(40, np.int32),
                     np.full(3, 200, np.int32))
    got = list(device_prefetch(batch_iterator(data, 16), "cpu"))
    assert [v for *_, v in got] == [16, 16, 8]
    np.testing.assert_array_equal(got[0][1].numpy(), sparse[:16])


N_CARD, B_CARD = 16, 1 << 16      # 6.8 MB of ids a batch


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _sums(dense, sparse, label):
    """Device checksums of one batch, queued on the consumer's stream
    (reductions that allocate only their scalar outputs)."""
    return (sparse.sum(dtype=torch.int64), dense.sum(dtype=torch.float64),
            label.sum(dtype=torch.float64))


def _check_sums(sums, seed):
    torch.cuda.synchronize()
    assert len(sums) == N_CARD
    for (s, d, l), (wd, ws, wl, _) in zip(sums, _batches(N_CARD, B_CARD,
                                                         seed)):
        assert int(s) == int(ws.astype(np.int64).sum())
        assert float(d) == pytest.approx(float(wd.astype(np.float64).sum()),
                                         rel=1e-12)
        assert float(l) == float(wl.sum())


def _consume(batches, sleep_cycles=0):
    """Queue each batch's checksums, behind `sleep_cycles` of device work,
    and drop the batch at once."""
    sums = []
    for dense, sparse, label, valid in batches:
        assert sparse.is_cuda and valid == B_CARD - 1
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        sums.append(_sums(dense, sparse, label))
        del dense, sparse, label
    return sums


def _copy_stream_is(monkeypatch, side):
    """Make device_prefetch's `torch.cuda.Stream(dev)` return `side`.
    Only that positional call: torch.cuda.current_stream() builds its
    answer with Stream(stream_id=..., ...), so a factory that returned
    `side` for every call would make every stream look like `side`, the
    consumer would queue its reads behind the copies, and the tests
    below could not fail."""
    make_stream = torch.cuda.Stream
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda *a, **k: side if a and not k
                        else make_stream(*a, **k))


@pytest.mark.cuda
def test_card_prefetch_waits_for_a_slow_copy(monkeypatch):
    """The side stream is held up before every copy (~50 ms, longer than
    the host takes to make a batch) while the consumer reads at once:
    every batch must still arrive whole."""
    _card()
    side = torch.cuda.Stream()
    _copy_stream_is(monkeypatch, side)

    def slow_copies():
        for batch in _batches(N_CARD, B_CARD, 1):
            with torch.cuda.stream(side):
                torch.cuda._sleep(100_000_000)
            yield batch

    _check_sums(_consume(device_prefetch(slow_copies(), "cuda", depth=1)),
                1)


# The first pass fills the caching allocators (an allocation serialises
# the streams, which would hide a missing record_stream); the passes draw
# other data, so a block that still holds the first pass's batch cannot
# pass for the second's.
@pytest.mark.cuda
def test_card_prefetch_keeps_batches_alive_for_a_slow_consumer():
    """The consumer's reads wait behind ~25 ms of queued work and it drops
    each batch at once: only record_stream keeps the allocator from
    handing that memory to a later copy before the reads run."""
    _card()
    for seed in (1, 2):
        _check_sums(_consume(device_prefetch(
            _batches(N_CARD, B_CARD, seed), "cuda", depth=1), 50_000_000),
            seed)


def _warm_allocators(side, n):
    """Cache, before a pass of `n` batches: n device blocks of each batch
    array on the copy stream, n pinned host blocks of each, and the
    consumer's checksum outputs. With every block cached no allocation
    in the pass reaches cudaMalloc or cudaHostAlloc, either of which
    could wait for the card and so order the streams by accident."""
    dense, sparse, label, _ = next(_batches(1, B_CARD))
    arrays = [torch.from_numpy(a) for a in (dense, sparse, label)]
    pinned = [a.pin_memory() for a in arrays for _ in range(n)]
    with torch.cuda.stream(side):
        blocks = [a.to("cuda", non_blocking=True) for a in pinned]
    _sums(*blocks[::n])
    torch.cuda.synchronize()
    del pinned, blocks


@pytest.mark.cuda
def test_card_prefetch_waits_for_each_copy_event(monkeypatch):
    """The slow-copy test with the consumer on a stream of its own, the
    batches made beforehand and warm caching allocators: the host then
    stages every batch within microseconds, no allocation waits for the
    card, and the consumer's stream waits for no other by itself, so
    only its wait on each batch's copy event keeps it from reading a
    batch the side stream has not copied yet (~100 ms behind). Without
    that wait this test fails."""
    _card()
    consumer, side = torch.cuda.Stream(), torch.cuda.Stream()
    _copy_stream_is(monkeypatch, side)
    made = list(_batches(N_CARD, B_CARD, 3))

    def slow_copies():
        for batch in made:
            with torch.cuda.stream(side):
                torch.cuda._sleep(200_000_000)
            yield batch

    with torch.cuda.stream(consumer):
        _warm_allocators(side, 2 * N_CARD)
        assert torch.cuda.current_stream() == consumer
        sums = _consume(device_prefetch(slow_copies(), "cuda", depth=1))
    _check_sums(sums, 3)
