"""K3's tile, carry and fix-up decomposition (kernels/rowsum.cu) on the CPU.

`rowsum.add_sorted_tiled_plain_` follows the kernel's decomposition: runs
summed per tile in lane order, a head carry for a run that crosses a
tile's start, a tail carry for one that starts in a tile and crosses its
end, and a fix-up that adds a crossing run's carries in tile order. At
small tiles (4, 8, 32 lanes) it must equal `sparse_add_dense_plain_`
within 1e-6 on random payloads and bit for bit on dyadic ones (multiples
of 2^-10, every partial sum far below 2^14, which f32 adds exactly in
any order), in the layouts where a tiled sum can go wrong: a run
crossing one tile edge, a run spanning many tiles, one key for every
lane, every lane dropped, dropped keys filling the last tiles,
B = T*k +- 1, and D in {8, 16, 64}. The lanes reach the model through
`sort_lanes` in a shuffled batch order, so the lane order is exercised
too.
"""

import numpy as np
import pytest
import torch

from cafe_tpu_torch.kernels import rowsum

torch.set_num_threads(1)

N_ROWS = 4096


def _fill(rng, target, longest):
    """Run lengths in [1, longest] that sum to exactly `target`."""
    lengths = []
    while sum(lengths) < target:
        lengths.append(int(rng.integers(1, longest + 1)))
    lengths[-1] -= sum(lengths) - target
    return [x for x in lengths if x > 0]


def _layout(kind, tile, rng):
    """(run lengths in key order, dropped lanes, dim) of a layout."""
    if kind == "cross_one_edge":       # lanes tile-2 .. tile+1 share a key
        return [tile - 2, 4] + _fill(rng, 2 * tile, 3), 0, 16
    if kind == "span_many":            # a run over 7 tiles and more
        return [3, 7 * tile + 5] + _fill(rng, 2 * tile, 4), 0, 16
    if kind == "one_key":
        return [5 * tile + 3], 0, 16
    if kind == "all_dropped":
        return [], 3 * tile + 1, 16
    if kind == "dropped_tail":         # key N over the last three tiles
        return _fill(rng, 2 * tile - 1, 5), 3 * tile + 2, 16
    if kind == "b_tk_plus_1":
        return _fill(rng, 4 * tile + 1, 2 * tile), 0, 16
    if kind == "b_tk_minus_1":
        return _fill(rng, 4 * tile - 1, 2 * tile), 0, 16
    dim = int(kind[1:])                # "d8", "d16", "d64"
    return _fill(rng, 3 * tile + 2, tile + 3), 5, dim


def _case(kind, tile, seed):
    rng = np.random.default_rng(seed)
    lengths, dropped, d = _layout(kind, tile, rng)
    rows = np.sort(rng.choice(N_ROWS, len(lengths), replace=False))
    ids = np.concatenate([np.repeat(rows, lengths),
                          rng.choice([-1, -7, N_ROWS, N_ROWS + 3], dropped)])
    ids = ids[rng.permutation(ids.shape[0])].astype(np.int32)
    b = ids.shape[0]
    table = rng.normal(0, 1, (N_ROWS, d)).astype(np.float32)
    upd = rng.normal(0, 0.01, (b, d)).astype(np.float32)
    return table, ids, upd


KINDS = ["cross_one_edge", "span_many", "one_key", "all_dropped",
         "dropped_tail", "b_tk_plus_1", "b_tk_minus_1", "d8", "d16", "d64"]


@pytest.mark.parametrize("tile", [4, 8, 32])
@pytest.mark.parametrize("kind", KINDS)
def test_tiled_model_matches_plain(kind, tile):
    table, ids, upd = _case(kind, tile, seed=KINDS.index(kind) * 100 + tile)
    b = ids.shape[0]
    if kind == "b_tk_plus_1":
        assert b == 4 * tile + 1
    if kind == "b_tk_minus_1":
        assert b == 4 * tile - 1
    idx = torch.from_numpy(ids)
    keys, perm = rowsum.sort_lanes(N_ROWS, idx)
    k = keys.numpy()
    if kind == "cross_one_edge":
        assert k[tile - 2] == k[tile + 1] != k[tile - 3]
    if kind == "span_many":
        assert k[3] == k[3 + 7 * tile + 4]
    if kind == "dropped_tail":
        assert (k[-3 * tile:] == N_ROWS).all()
    for dyadic in (False, True):
        t0, u = torch.from_numpy(table), torch.from_numpy(upd)
        if dyadic:
            t0 = torch.round(t0 * 1024) / 1024
            u = torch.round(u * 1024 * 8) / 1024
        want = rowsum.sparse_add_dense_plain_(t0.clone(), idx, u)
        got = rowsum.add_sorted_tiled_plain_(t0.clone(), keys, perm, u, tile)
        if dyadic:
            assert torch.equal(got, want), (kind, tile)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{kind} T={tile}")
        if kind == "all_dropped":
            assert torch.equal(got, t0)


def test_sort_lanes_is_stable_and_drops():
    """Keys in [0, N] with dropped lanes at N, sorted; within a key the
    lanes keep their batch order (the order each run is summed in)."""
    ids = torch.tensor([5, -1, 3, 5, 9, 3, 12, 5, -3, 0], dtype=torch.int64)
    keys, perm = rowsum.sort_lanes(10, ids)
    assert keys.dtype == torch.int32
    assert keys.tolist() == [0, 3, 3, 5, 5, 5, 9, 10, 10, 10]
    assert perm.tolist() == [9, 2, 5, 0, 3, 7, 4, 1, 6, 8]
