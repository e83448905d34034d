"""Port kernels (kernels/land.py K1, kernels/scatter_add.py K2,
kernels/rowsum.py K3, kernels/a2a.py K5) against numpy oracles, with no
JAX in the process.

The plain versions run here on the CPU. The CUDA kernels have no CPU
mode: the `cuda` tests skip without a card and run on one with
`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_kernels.py` (tests/conftest.py imports jax, which the
card's machine need not have).
"""

import numpy as np
import pytest
import torch

import torch_dist_worker as w
from cafe_tpu_torch.kernels import a2a, land, rowsum, scatter_add

torch.set_num_threads(1)


def _land_case(seed, b, c, n, kind="random"):
    rng = np.random.default_rng(seed)
    if kind == "all_dropped":
        keys = np.sort(rng.integers(n, n + 50, b))
    elif kind == "key_eq_n":
        keys = np.sort(np.concatenate([rng.integers(0, n, b - 8),
                                       np.full(8, n)]))
    elif kind == "sparse_rows":       # most rows empty
        keys = np.sort(rng.choice(np.arange(0, n, 7), b))
    else:
        keys = np.sort(rng.integers(0, n + 7, b))
    keys = keys.astype(np.int32)
    enc = np.where(rng.random((b, c)) < 0.6,
                   rng.integers(0, 1 << 30, (b, c)), -1).astype(np.int32)
    want = np.full((n, c), -1, np.int64)
    m = keys < n
    if m.any():
        np.maximum.at(want, keys[m], enc[m])
    return keys, enc, want


LAND_CASES = [
    (1024, 4, 300, "random"),
    (100, 4, 128, "random"),          # B not a multiple of any block
    (53248 // 16, 5, 9646 // 16, "random"),
    (512, 2, 64, "all_dropped"),
    (333, 5, 97, "key_eq_n"),
    (256, 3, 4096, "sparse_rows"),
]


@pytest.mark.parametrize("b,c,n,kind", LAND_CASES)
def test_land_plain_vs_oracle(b, c, n, kind):
    keys, enc, want = _land_case(b + n, b, c, n, kind)
    got = land.land_max_plain(torch.from_numpy(enc), torch.from_numpy(keys),
                              n)
    np.testing.assert_array_equal(got.numpy(), want)


def _oracle_add(table, ids, upd):
    want = table.copy()
    m = (ids >= 0) & (ids < table.shape[0])
    np.add.at(want, ids[m], upd[m])
    return want


def _dup_case(n, d, b, group, seed=5):
    """ids with one `group`-lane duplicate group spread over the whole
    batch, plus dropped lanes (negative and >= n)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (n, d)).astype(np.float32)
    ids = rng.integers(0, n, b).astype(np.int32)
    ids[rng.permutation(b)[:group]] = 9
    ids[::11] = -1
    ids[5::17] = n
    upd = rng.normal(0, 0.1, (b, d)).astype(np.float32)
    return table, ids, upd


def test_scatter_add_plain_vs_oracle():
    table, ids, upd = _dup_case(512, 64, 4096, 1000)
    got = scatter_add.scatter_add_plain_(torch.from_numpy(table.copy()),
                                         torch.from_numpy(ids),
                                         torch.from_numpy(upd))
    np.testing.assert_allclose(got.numpy(), _oracle_add(table, ids, upd),
                               rtol=1e-6, atol=1000 * 0.1 * 1e-6)


def _zipf_case(n, d, b, seed=7):
    """Zipf ids with runs of thousands of lanes, negative and >= n lanes
    (both dropped), and dyadic values (multiples of 2^-10, sums far below
    2^14), which f32 adds exactly in any order."""
    rng = np.random.default_rng(seed)
    table = np.round(rng.normal(0, 1, (n, d)) * 1024) / 1024
    ids = ((rng.random(b) ** 6 * n).astype(np.int64) * 1000000007 % n)
    ids = ids.astype(np.int32)
    ids[::13] = -1
    ids[5::29] = n + 3
    upd = np.round(rng.normal(0, 0.05, (b, d)) * 1024) / 1024
    return table.astype(np.float32), ids, upd.astype(np.float32)


def test_rowsum_plain_vs_oracle():
    table, ids, upd = _zipf_case(1000, 16, 5000)
    assert np.bincount(ids[(ids >= 0) & (ids < 1000)]).max() > 1000
    got = rowsum.sparse_add_dense_(torch.from_numpy(table.copy()),
                                   torch.from_numpy(ids),
                                   torch.from_numpy(upd))
    np.testing.assert_array_equal(got.numpy(), _oracle_add(table, ids, upd))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,n,kind", LAND_CASES)
def test_land_kernel_on_card(card, b, c, n, kind):
    keys, enc, want = _land_case(b + n, b, c, n, kind)
    got = land.land_max(torch.from_numpy(enc).to(card),
                        torch.from_numpy(keys).to(card), n)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_scatter_add_kernel_on_card(card):
    table, ids, upd = _dup_case(4096, 128, 8192, 2000)
    got = scatter_add.scatter_add_(torch.from_numpy(table).to(card),
                                   torch.from_numpy(ids).to(card),
                                   torch.from_numpy(upd).to(card))
    # atomics sum in no fixed order: f32 error grows with the group size
    np.testing.assert_allclose(got.cpu().numpy(),
                               _oracle_add(table, ids, upd),
                               rtol=1e-5, atol=2000 * 0.1 * 2e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,b", [(1000, 16, 5000), (27136, 16, 53248),
                                   (512, 128, 16384), (64, 8, 3)])
def test_rowsum_kernel_on_card(card, n, d, b):
    """Dyadic values: the kernel must match the oracle bit for bit, and
    two launches must agree bit for bit (no atomics)."""
    table, ids, upd = _zipf_case(n, d, b)
    args = [torch.from_numpy(x).to(card) for x in (ids, upd)]
    before = rowsum.KERNEL.launches
    got = rowsum.sparse_add_dense_(torch.from_numpy(table).to(card), *args)
    again = rowsum.sparse_add_dense_(torch.from_numpy(table).to(card), *args)
    torch.cuda.synchronize()
    assert rowsum.KERNEL.launches == before + 2
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _oracle_add(table, ids, upd))
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_a2a_kernel_n1_on_card(card):
    """K5 at n = 1 is the local copy: bit-equal to its input (the plain
    version at n = 1), one launch a call, for the exchange's int32 ids,
    f32 rows and a payload whose size is no multiple of 16 bytes."""
    from cafe_tpu_torch.parallel import Mesh
    mesh = Mesh(size=1, rank=0, device=card, group=None)
    gen = torch.Generator(device="cpu").manual_seed(3)
    cases = [torch.randint(0, 2**31 - 1, (1, 53248), dtype=torch.int32,
                           generator=gen),
             torch.randn((1, 53248, 16), generator=gen),
             torch.randint(-128, 127, (1, 1001), dtype=torch.int8,
                           generator=gen)]
    before = a2a.KERNEL.launches
    for x in cases:
        x = x.to(card)
        got = a2a.all_to_all(x, mesh)
        torch.cuda.synchronize()
        assert got.data_ptr() != x.data_ptr() and torch.equal(got, x)
    assert a2a.KERNEL.launches == before + len(cases)


@pytest.mark.cuda
def test_a2a_kernel_processes_one_card(card, tmp_path):
    """K5 between 4 processes on one card through CUDA IPC (the mechanism
    that rides NVLink between cards), over 3 successive calls of each
    leg, so a rank that runs ahead into the next call on the same
    workspace would show: every rank's output bit-equal to what the
    seeded inputs of all ranks say it must receive."""
    n, chunk, dim, epochs, seed = 4, 13312, 16, 3, 5
    res = w.run_ranks(w.kernel_a2a_epochs, n, tmp_path, chunk, dim, epochs,
                      seed, device="cuda:0")
    for rank, r in enumerate(res):
        assert r["launches"] == 2 * epochs
        for e, (ids, rows) in enumerate(r["outs"]):
            want_ids, want_rows = w.expected_a2a(n, chunk, dim, seed + e,
                                                 rank)
            np.testing.assert_array_equal(ids, want_ids)
            np.testing.assert_array_equal(rows, want_rows)
