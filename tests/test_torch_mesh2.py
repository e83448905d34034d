"""The two-level ("dcn", "ici") mesh and its hierarchical exchange: 4 gloo
ranks laid out as a (2, 2) mesh against the JAX package's
make_mesh(4, inner=2) step from one bridged state (the counterparts of
tests/test_mesh2.py), and against the port's flat 4-rank mesh.

The (2, 2) mesh keeps the flat mesh's row ownership, batch slices and
shard-local sketch; only the explicit exchange's row legs change: ids
and grads combine over "ici" before they cross "dcn". With a unique
fraction CAFE's id legs are hierarchical too (its route and insert
compact the host's distinct ids before they cross "dcn", the flat legs
when a host overflows): held against the JAX package's two-level runs
at fractions that hold the host's distinct ids and one that overflows.

Tolerances: integer state (the sketch, routed rows, hot flags, promotion
counts) EXACT. Tables, dense params and loss within 1e-5 of the JAX
package (the ranks' sums run in another order than XLA's) and the loss
within 1e-6 relative of the flat mesh: the hierarchical apply coalesces
over the host's lanes, which reorders the f32 sums of duplicate rows.
The compact run's tables within 1e-6 of the full-size run's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_dist_worker as w
from cafe_tpu.ops.sparse import unique_compact as junique_compact
from cafe_tpu.parallel import make_mesh as jmake_mesh
from cafe_tpu.parallel.exchange import unique_cap as junique_cap
from cafe_tpu.sketch.hotsketch import INVALID_ID
from test_torch_sharded import (SHARD, STEPS, JConfig, _close, _jax_run,
                                jbuild_all, jdata)

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
# CAFE's hierarchical id legs: 512-row batches of heavier-tailed ids, so
# a host's 768 lanes hold 169-181 distinct ids. C = 384 (0.5) and 192
# (0.25) hold them; C = 128 (0.125) does not, and every id leg overflows
CAFE_IDS = dict(SHARD, mesh_shape=N, mesh_inner=INNER, mini_batch_size=512,
                synthetic_rows=2048, synthetic_zipf=1.4)
ID_FRACS = (0.5, 0.25, 0.125)


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
    ids = {}
    for frac in ID_FRACS:
        kw = dict(CAFE_IDS, shard_unique_frac=frac)
        ids[frac], ibatches = _jax_run(kw, N, "explicit", STEPS, INNER)
        runs.append((kw, ids[frac]["init"], ibatches, ("explicit",)))
    # the full-size id legs on the same data and state: the dcn bytes
    runs.append((CAFE_IDS, ids[ID_FRACS[0]]["init"], ibatches,
                 ("explicit",)))
    ids["over"] = _jax_id_overflow(CAFE_IDS, ibatches)
    jax_out["ids"] = ids
    tmp = tmp_path_factory.mktemp("ranks")
    two = w.run_ranks(w.train_runs, N, tmp / "two", runs, inner=INNER)[0]
    flat = w.run_ranks(w.train_runs, N, tmp / "flat", runs[:1])[0]
    return jax_out, two, flat[0]


def _jax_id_overflow(kw, batches):
    """{frac: [over a step]} of the JAX package's id-leg predicate: the
    CAFE part's offset ids of each host's lanes through its
    unique_compact, any host past C = unique_cap(host lanes) (its
    pmax)."""
    cfg = JConfig(**dict(kw, shard_unique_frac=ID_FRACS[0]))
    _, embed, _, _, _ = jbuild_all(cfg, jdata(cfg, "train"),
                                   mesh=jmake_mesh(N, INNER))
    part = next(p for p in embed.parts if type(p).__name__ == "CafePart")
    fields, offs = np.asarray(part.field_idx), \
        np.asarray(part.global_offsets, dtype=np.int32)
    out = {}
    for frac in ID_FRACS:
        over = []
        for _, sparse, _, _ in batches:
            hosts = np.split(sparse[:, fields] + offs, N // INNER)
            cap = junique_cap(hosts[0].size, frac)
            over.append(any(
                int(junique_compact(jnp.asarray(h.reshape(-1)), cap,
                                    int(INVALID_ID))[2]) > cap
                for h in hosts))
        out[frac] = over
    return out


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


def _id_run(two, i):
    return two[6 + len(OTHERS) + i]["explicit"]


@pytest.mark.parametrize("frac", ID_FRACS)
def test_cafe_id_legs_match_jax_two_level(mesh2, frac):
    """CAFE's hierarchical route and insert against the JAX package's
    two-level run from one bridged state: the sketch's integers, the
    routed rows and the promotions exact, params and tables within 1e-5;
    the route and insert branch counts equal the JAX predicate's, and
    the row legs take one branch a step (the fetch's and the apply's
    the same)."""
    jax_out, two, _ = mesh2
    ids = jax_out["ids"]
    run = _id_run(two, ID_FRACS.index(frac))
    _check(run, ids[frac])
    assert sum(m["cafe_promotions"] for m in run["metrics"]) > 0
    over = ids["over"][frac]
    for leg in ("route", "insert"):
        want = {f"{leg}_full": sum(over), f"{leg}_compact": STEPS - sum(over)}
        assert {k: v for k, v in run["branches"].items()
                if k.startswith(leg)} == {k: v for k, v in want.items()
                                          if v}
    assert all(over) == (frac == 0.125) and not any(over) == (frac != 0.125)
    rows = {k[len("fetch_"):]: v for k, v in run["branches"].items()
            if k.startswith("fetch_")}
    assert sum(rows.values()) == STEPS
    assert {k[len("apply_"):]: v for k, v in run["branches"].items()
            if k.startswith("apply_")} == rows


def test_cafe_compact_id_legs_halve_the_outer_bytes(mesh2):
    """The compact runs' dcn bytes against the full-size run's on the
    same data: at 0.25 at most half (C = a quarter of the host's
    lanes); at 0.5 below it but not half, since C is then half the
    host's lanes, so the row legs alone halve and the id legs' own
    C-lane buffers (route ids, insert pairs) come on top (156,672
    against 258,048 bytes over the 3 steps here). The full-size run's
    route and insert cross the flat group. Each compact run's dcn legs
    carry no more than its ici legs."""
    _, two, _ = mesh2
    full = _id_run(two, len(ID_FRACS))
    assert full["branches"] == {}
    full_dcn = _bytes(full["records"], "dcn")
    for i, frac in enumerate(ID_FRACS[:2]):
        run = _id_run(two, i)
        dcn = _bytes(run["records"], "dcn")
        assert 0 < dcn <= _bytes(run["records"], "ici"), frac
        assert (2 * dcn if frac == 0.25 else dcn) <= full_dcn, frac


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
