"""The two-level ("dcn", "ici") mesh and its hierarchical exchange: 4 gloo
ranks laid out as a (2, 2) mesh against the JAX package's
make_mesh(4, inner=2) step from one bridged state (the counterparts of
tests/test_mesh2.py), and against the port's flat 4-rank mesh.

The (2, 2) mesh keeps the flat mesh's row ownership, batch slices and
shard-local sketch; only the explicit exchange's row legs change: ids
and grads combine over "ici" before they cross "dcn".

Tolerances: integer state (the sketch, routed rows, hot flags, promotion
counts) EXACT. Tables, dense params and loss within 1e-5 of the JAX
package (the ranks' sums run in another order than XLA's) and the loss
within 1e-6 relative of the flat mesh: the hierarchical apply coalesces
over the host's lanes, which reorders the f32 sums of duplicate rows.
The compact run's tables within 1e-6 of the full-size run's.
"""

import numpy as np
import pytest
import torch

import torch_dist_worker as w
from test_torch_sharded import SHARD, STEPS, _close, _jax_run

torch.set_num_threads(1)

N, INNER = 4, 2
HASH = dict(SHARD, compress_method="hash", compress_rate=0.2,
            synthetic_vocab=20000, mesh_shape=N, mesh_inner=INNER)
JAXED = {
    "cafe": dict(SHARD, mesh_shape=N, mesh_inner=INNER),
    "hash": HASH,
    "full": dict(HASH, compress_method="full"),
}
SKETCH = ("val", "cnt", "dic", "free", "free_top", "tot")
# a larger batch for the compact legs: a host's 512 lanes hold about 230
# distinct rows
COMPACT = dict(HASH, mini_batch_size=256, synthetic_rows=2048)
OTHERS = {
    "qr": dict(HASH, compress_method="qr", compress_rate=0.05),
    "off": dict(HASH, compress_method="off", compress_rate=0.05),
    "ada": dict(HASH, compress_method="ada", compress_rate=0.3),
}


@pytest.fixture(scope="module")
def mesh2(tmp_path_factory):
    jax_out, runs = {}, []
    for name, kw in JAXED.items():
        jax_out[name], batches = _jax_run(kw, N, "explicit", STEPS, INNER)
        modes = ("explicit", "pallas") if name == "cafe" else ("explicit",)
        runs.append((kw, jax_out[name]["init"], batches, modes))
    _, cbatches = _jax_run(COMPACT, N, "explicit", 1, INNER)
    for frac in (0.0, 0.5, 0.25):
        runs.append((dict(COMPACT, shard_unique_frac=frac), None, cbatches,
                     ("explicit",)))
    for kw in OTHERS.values():
        runs.append((kw, None, batches, ("explicit",)))
    tmp = tmp_path_factory.mktemp("ranks")
    two = w.run_ranks(w.train_runs, N, tmp / "two", runs, inner=INNER)[0]
    flat = w.run_ranks(w.train_runs, N, tmp / "flat", runs[:1])[0]
    return jax_out, two, flat[0]


def _check(port, ref):
    assert port["parts"] == ref["parts"]
    for i, (pm, jm) in enumerate(zip(port["metrics"], ref["metrics"])):
        assert set(pm) == set(jm)
        for k in jm:
            if k == "loss":
                np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5,
                                           atol=1e-5, err_msg=f"step {i}")
            elif k.endswith("_frac"):
                np.testing.assert_allclose(pm[k], jm[k], rtol=2.4e-7)
            else:
                assert pm[k] == jm[k], (k, i, pm[k], jm[k])
    ps, js = port["state"], ref["state"]
    _close(ps["params"], js["params"], 1e-5, "params")
    for key, part in js["embed"].items():
        got = ps["embed"][key]
        for f in SKETCH if "sketch" in part else ():
            np.testing.assert_array_equal(got["sketch"][f],
                                          part["sketch"][f], err_msg=f)
        np.testing.assert_allclose(got["table"], part["table"], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    for key in ref["routing"]:
        np.testing.assert_array_equal(port["routing"][key],
                                      ref["routing"][key])


def test_the_mesh_is_two_by_two(tmp_path):
    """make_mesh(4, inner=2): rank r at (r // 2, r % 2); its rows and
    columns; a mesh_inner that does not divide raises."""
    got = w.run_ranks(w.mesh_layout, N, tmp_path, inner=INNER)
    for r, m in enumerate(got):
        assert m["axis_names"] == ("dcn", "ici")
        assert m["shape"] == (2, 2)
        assert m["ici"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert m["dcn"] == [r % 2, r % 2 + 2]
        assert m["bad_inner"].startswith("ValueError") \
            and "does not divide" in m["bad_inner"]


@pytest.mark.parametrize("name,mode", [("cafe", "explicit"),
                                       ("cafe", "pallas"),
                                       ("hash", "explicit"),
                                       ("full", "explicit")])
def test_steps_match_jax_two_level(mesh2, name, mode):
    jax_out, two, _ = mesh2
    _check(two[list(JAXED).index(name)][mode], jax_out[name])


def test_two_level_equals_the_flat_mesh(mesh2):
    """The (2, 2) mesh is the flat 4-rank exchange with the host's lanes
    combined first: same promotions, dic exact, loss within 1e-6."""
    _, two, flat = mesh2
    a, b = two[0]["explicit"], flat["explicit"]
    for ma, mb in zip(a["metrics"], b["metrics"]):
        np.testing.assert_allclose(ma["loss"], mb["loss"], rtol=1e-6)
        assert ma["cafe_promotions"] == mb["cafe_promotions"]
    assert sum(m["cafe_promotions"] for m in a["metrics"]) > 0
    for f in SKETCH:
        np.testing.assert_array_equal(
            a["state"]["embed"]["part1"]["sketch"][f],
            b["state"]["embed"]["part1"]["sketch"][f], err_msg=f)
    np.testing.assert_allclose(a["state"]["embed"]["part1"]["table"],
                               b["state"]["embed"]["part1"]["table"],
                               rtol=1e-6, atol=1e-6)


def _bytes(records, axis):
    return sum(b for step in records for op, ax, b in step if ax == axis)


def test_hierarchical_compact_equals_full_size(mesh2):
    """Hash on the (2, 2) mesh at unique fraction 0.5 (C = unique_cap of
    the host's 512 lanes = 256 holds their distinct rows: compact legs),
    0.25 (C = 128: every leg overflows to the full-size path) and 0: one
    state."""
    _, two, _ = mesh2
    full, compact, over = (two[i]["explicit"] for i in (3, 4, 5))
    assert full["branches"] == {}
    assert compact["branches"] == {"fetch_compact": 1, "apply_compact": 1}
    assert over["branches"] == {"fetch_full": 1, "apply_full": 1}
    for run in (compact, over):
        np.testing.assert_allclose(run["metrics"][0]["loss"],
                                   full["metrics"][0]["loss"], rtol=1e-6)
        np.testing.assert_allclose(run["state"]["embed"]["part0"]["table"],
                                   full["state"]["embed"]["part0"]["table"],
                                   rtol=1e-6, atol=1e-6)


def test_outer_traffic_stays_below_inner(mesh2):
    """The recorder's bytes by axis (tests/test_mesh2.py's HLO audit): on
    the compact run the dcn legs carry no more than the ici legs, and
    its dcn bytes are at most half the full-size run's. (The full-size
    run's dcn legs carry both hosts' combined buffers: 57,344 bytes
    against the ici legs' 53,248 here.)"""
    _, two, _ = mesh2
    full, compact = two[3]["explicit"], two[4]["explicit"]
    assert 0 < _bytes(compact["records"], "dcn") \
        <= _bytes(compact["records"], "ici")
    assert 2 * _bytes(compact["records"], "dcn") \
        <= _bytes(full["records"], "dcn")


@pytest.mark.parametrize("name", list(OTHERS))
def test_qr_off_ada_run_on_two_levels(mesh2, name):
    _, two, _ = mesh2
    run = two[6 + list(OTHERS).index(name)]["explicit"]
    assert any(sharded for _, sharded in run["parts"]), run["parts"]
    assert all(np.isfinite(m["loss"]) for m in run["metrics"])


def test_a2a_falls_back_to_the_explicit_legs(mesh2):
    """On the (2, 2) mesh the pallas mode takes the explicit hierarchical
    legs, as the JAX package's a2a legs do: the same numbers, no
    all-to-all."""
    _, two, _ = mesh2
    e, p = two[0]["explicit"], two[0]["pallas"]
    assert e["metrics"] == p["metrics"]
    assert not any(op == "all-to-all" for step in p["records"]
                   for op, _, _ in step)
