"""Port kernels (kernels/land.py K1, kernels/scatter_add.py K2,
kernels/rowsum.py K3, kernels/gather.py K4, kernels/a2a.py K5) against
numpy oracles, with no JAX in the process.

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
from cafe_tpu_torch.kernels import a2a, gather, land, rowsum, scatter_add

torch.set_num_threads(1)


def _land_keys(rng, b, n, kind):
    """Sorted int32 keys [b] of one K1 case kind."""
    if kind == "all_dropped":            # every lane below 0 or >= n
        keys = np.concatenate([rng.integers(-60, 0, b // 3),
                               rng.integers(n, n + 50, b - b // 3)])
    elif kind == "key_eq_n":
        keys = np.concatenate([rng.integers(0, n, b - 8), np.full(8, n)])
    elif kind == "many_eq_n":            # half the lanes keyed to n
        keys = np.concatenate([rng.integers(0, n, b - b // 2),
                               np.full(b // 2, n)])
    elif kind == "sparse_rows":       # most rows empty
        keys = rng.choice(np.arange(0, n, 7), b)
    elif kind == "band":              # empty rows before and after
        keys = rng.integers(n // 3, 2 * n // 3, b)
    elif kind == "hot_run":           # one row holds 20,000 lanes
        keys = np.concatenate([rng.integers(0, n, b - 20000),
                               np.full(20000, n // 2)])
    elif kind == "rows_zero":         # n == 0: every lane dropped
        keys = rng.integers(-5, 50, b)
    else:
        keys = rng.integers(0, n + 7, b)
    return np.sort(keys).astype(np.int32)


def _land_oracle(keys, enc, n):
    want = np.full((n, enc.shape[1]), -1, np.int64)
    m = (keys >= 0) & (keys < n)
    if m.any():
        np.maximum.at(want, keys[m], enc[m])
    return want


def _land_case(seed, b, c, n, kind="random"):
    rng = np.random.default_rng(seed)
    keys = _land_keys(rng, b, n, kind)
    enc = np.where(rng.random((b, c)) < 0.6,
                   rng.integers(0, 1 << 30, (b, c)), -1).astype(np.int32)
    return keys, enc, _land_oracle(keys, enc, n)


LAND_CASES = [
    (1024, 4, 300, "random"),
    (100, 4, 128, "random"),          # B not a multiple of any block
    (53248 // 16, 5, 9646 // 16, "random"),
    (512, 2, 64, "all_dropped"),
    (333, 5, 97, "key_eq_n"),
    (256, 3, 4096, "sparse_rows"),
    (30000, 5, 5000, "hot_run"),      # a run over many lane rounds
    (4096, 5, 200000, "band"),        # 66,667 empty rows at each end
    (777, 5, 0, "rows_zero"),
    (2000, 4, 1000, "many_eq_n"),
    (36864, 5, 1543432, "random"),    # the sibling's landing shape
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


def _gather_cases(device="cpu"):
    """(name, table, ids, tile) on `device`: K4's shapes and layouts. The
    views make the kernel copy in 4-byte words (a 516-byte row stride, a
    4-byte offset) and in bytes (a 130-byte stride, a 2-byte offset)."""
    gen = torch.Generator().manual_seed(11)
    f32 = torch.randn((4096, 128), generator=gen).to(device)
    words = torch.randn((4096, 129), generator=gen).to(device)
    halves = torch.randn((4096, 65), generator=gen).to(torch.bfloat16)
    ids = torch.randint(0, 4096, (1024,), dtype=torch.int32, generator=gen)
    ids[:4] = torch.tensor([0, 4095, 4095, 17], dtype=torch.int32)
    ids = ids.to(device)
    return [("f32", f32, ids, 256),
            ("bf16", f32.to(torch.bfloat16), ids, 256),
            ("view_words", words[:, 1:], ids, 256),
            ("view_bytes", halves.to(device)[:, 1:], ids, 128),
            ("b_eq_tile", f32, ids[:256], 256)]


@pytest.mark.parametrize("case", range(5))
def test_gather_plain_vs_oracle(case):
    name, table, ids, tile = _gather_cases()[case]
    got = gather.gather_plain(table, ids, tile)
    want = table.float().numpy()[ids.numpy()]
    np.testing.assert_array_equal(got.float().numpy(), want, err_msg=name)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,n,kind", LAND_CASES)
def test_land_kernel_on_card(card, b, c, n, kind):
    """Bit-equal to the oracle, one launch a call, and two launches
    bit-equal to each other."""
    keys, enc, want = _land_case(b + n, b, c, n, kind)
    tk, te = torch.from_numpy(keys).to(card), torch.from_numpy(enc).to(card)
    before = land.KERNEL.launches
    got = land.land_max(te, tk, n)
    again = land.land_max(te, tk, n)
    torch.cuda.synchronize()
    assert land.KERNEL.launches == before + 2
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,run", [(9646, 5, 4096), (9646, 5, 9000),
                                     (1543432, 5, 4096), (5000, 2, 20000),
                                     (300, 33, 4096)])
def test_land_kernel_hot_runs_at_tile_edges(card, n, c, run):
    """Runs of `run` lanes on the last row of the first row tile the
    kernel picks, the first row of the next and the last row of the
    second: each crosses many lane rounds of its block and sits at a
    block edge, beside random lanes and dropped ones."""
    r = land.rows_per_block(n, c)
    rng = np.random.default_rng(n + run)
    hot = [x for x in (r - 1, r, 2 * r - 1) if x < n]
    keys = np.sort(np.concatenate(
        [rng.integers(-3, n + 3, 5000)]
        + [np.full(run, x) for x in hot])).astype(np.int32)
    enc = np.where(rng.random((keys.size, c)) < 0.7,
                   rng.integers(0, 1 << 30, (keys.size, c)),
                   -1).astype(np.int32)
    got = land.land_max(torch.from_numpy(enc).to(card),
                        torch.from_numpy(keys).to(card), n)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _land_oracle(keys, enc, n))


@pytest.mark.cuda
def test_land_kernel_traps_on_a_descent(card, tmp_path):
    """Unsorted keys trip the kernel's device-side assert: the process's
    next synchronize raises instead of returning a landing. Run in a
    child process, since a device assert ends the CUDA context."""
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    script = tmp_path / "descent.py"
    script.write_text(
        "import sys, torch\n"
        f"sys.path.insert(0, {str(repo)!r})\n"
        "from cafe_tpu_torch.kernels import land\n"
        "keys = torch.arange(4096, dtype=torch.int32, device='cuda')\n"
        "keys[2000] = 5\n"
        "enc = torch.zeros((4096, 3), dtype=torch.int32, device='cuda')\n"
        "land.land_max(enc, keys, 4096)\n"
        "torch.cuda.synchronize()\n"
        "print('LANDED')\n")
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and "LANDED" not in res.stdout
    assert "assert" in (res.stdout + res.stderr).lower()


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
@pytest.mark.parametrize("n,d,b,one_row", [
    (1000, 16, 5000, False), (27136, 16, 53248, False),
    (512, 128, 16384, False), (64, 8, 3, False),
    (1000, 16, 300 * 256 + 17, True),      # one run over 301 tiles
    (1000, 128, 300 * 256 + 17, True),     # ... and 10 fix-up chunks
    (4096, 64, 20000, False), (2048, 128, 30000, False),
    (2048, 256, 20000, False),             # more channels than fix-up threads
    (27136, 16, 262144, False), (196608, 8, 53248, False)])
def test_rowsum_kernel_on_card(card, n, d, b, one_row):
    """Dyadic values: the kernel must match the oracle bit for bit, and
    two launches must agree bit for bit (no atomics), the second with
    the same ids as int64."""
    table, ids, upd = _zipf_case(n, d, b)
    if one_row:
        ids = np.where((ids >= 0) & (ids < n), 7, ids).astype(np.int32)
    tids, tupd = (torch.from_numpy(x).to(card) for x in (ids, upd))
    before = rowsum.KERNEL.launches
    got = rowsum.sparse_add_dense_(torch.from_numpy(table).to(card), tids,
                                   tupd)
    again = rowsum.sparse_add_dense_(torch.from_numpy(table).to(card),
                                     tids.long(), tupd)
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
@pytest.mark.parametrize("nbytes,offset", [(1, 0), (13, 0), (4096, 0),
                                           (213000, 0), (213000, 1),
                                           (53248 * 64, 0)])
def test_a2a_kernel_n1_sizes_on_card(card, nbytes, offset):
    """K5 at n = 1 over chunks of 1, 13, 4,096 and 213,000 bytes (16-byte
    vectors with a byte tail; a view one byte off alignment, copied in
    bytes) and the headline's rows leg (3.4 MB): bit-equal, one launch a
    call."""
    from cafe_tpu_torch.parallel import Mesh
    mesh = Mesh(size=1, rank=0, device=card, group=None)
    gen = torch.Generator(device="cpu").manual_seed(nbytes + offset)
    base = torch.randint(0, 256, (1, nbytes + offset), dtype=torch.uint8,
                         generator=gen).to(card)
    x = base[:, offset:]
    before = a2a.KERNEL.launches
    got = a2a.all_to_all(x, mesh)
    torch.cuda.synchronize()
    assert a2a.KERNEL.launches == before + 1
    assert got.shape == x.shape and torch.equal(got, x)


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(5))
def test_gather_kernel_on_card(card, case):
    """K4 copies rows bit for bit at every vector width, one launch a
    call."""
    name, table, ids, tile = _gather_cases(card)[case]
    before = gather.KERNEL.launches
    got = gather.gather(table, ids, tile)
    torch.cuda.synchronize()
    assert gather.KERNEL.launches == before + 1
    want = gather.gather_plain(table, ids, tile)
    assert got.dtype == table.dtype and got.is_contiguous()
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), name
