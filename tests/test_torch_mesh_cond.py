"""The mesh step's device branches (utils/cond.cond under a mesh: the JAX
package's lax.conds under shard_map), at 4 gloo ranks against the JAX
package's sharded step on its virtual 4-device CPU mesh.

* The exchange's branches, each forced both ways: the unique-compact legs
  at a capacity that holds the batch's distinct ids and at one that
  overflows, the all-to-all legs at a slack that holds every peer's
  requests and at one that overflows. On every rank the branch counts
  (parallel/exchange.exchange_branches, read from utils/cond.branch_runs)
  equal the branch the JAX package's predicate picks: its own
  unique_compact / route_to_owners on each rank's slice, reduced over the
  ranks as its pmax does. The fetch and the apply equal the JAX
  package's exchange.
* The sharded CAFE insert at cafe_insert_interval 8 over 16 steps from
  one bridged state: the insert branch's runs equal the JAX predicate's
  (tick % 8 == 0), the sketch's integers and every step's promotions are
  exact (frequency scores).
* AdaEmbed sharded over CHECK_EVERY + 1 steps with the decay: both
  packages' CHECK_EVERY and DECAY_EVERY are set to 4 for the run, so
  steps 1 and 4 check and step 4 decays (the decay a device branch, the
  checks host steps). Each check rebuilds whatever its sample: the ids
  with importance are fewer than the check's top share, so the sampled
  k-th largest importance is 0 and every sampled id not admitted counts
  as churn.
* capture_blockers names nothing of a mesh of one rank, nothing of a
  flat mesh of 4 ranks on one host (the bodies hold K5's device
  collectives), and on a two-level mesh or ranks of two hosts the
  device branches whose bodies hold collectives (the a2a and pallas
  legs, the unique-compact legs, CAFE's hierarchical id legs, the
  sharded insert interval), which keep NCCL's there; the
  mesh's steps (train, K-step and eval; every exchange mode, the
  unique-compact legs, the insert interval, CAFE+, AdaEmbed's ordinary
  steps, auto and the two-level mesh) run under
  tests/test_torch_capture.py's no-host-read mode at world size 1, a
  gloo group in this process.

Tolerances: fetches, branch counts, routing, sketch integers, promotion
counts, AdaEmbed's dic and step EXACT (integer logic and data movement).
Tables, optimizer slots, dense params, loss and scores within 1e-5: the
ranks' duplicate rows and dense gradients sum in another order than
XLA's. AdaEmbed's sample key is left out (tests/test_torch_sharded_methods.py).
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker as w
from cafe_tpu.embeddings import ada as jada
from cafe_tpu.ops.sparse import coalesce as jcoalesce
from cafe_tpu.ops.sparse import init_slots as jinit_slots
from cafe_tpu.ops.sparse import unique_compact as junique_compact
from cafe_tpu.parallel import exchange as jex
from cafe_tpu.parallel import make_mesh as jmake_mesh
from cafe_tpu_torch.config import Config as TConfig
from cafe_tpu_torch.parallel import make_mesh, maybe_init_distributed
from cafe_tpu_torch.train import build_all, get_dataset
from cafe_tpu_torch.train.step import (build_multi_step, capture_blockers,
                                       nccl_branches)
from test_torch_capture import NoCaptureBreaks
from test_torch_sharded import SHARD, _jax_run
from test_torch_sharded_methods import METHODS, _same
from test_torch_unique_compact import _ids

torch.set_num_threads(1)

N = 4
DROP = int(jex.DROP_ROW)

# (leg, knob, ids, the branch it forces). The unique legs at fractions
# of the 512 lanes a rank holds: C = 256 holds the skewed ids' 100
# distinct rows, C = 64 does not. The a2a legs at a slack of 1.5 on
# uniform ids (a 256-lane cap a peer against ~128 lanes, ~100 once
# coalesced) and at 0.3 on ids that all belong to owner 0 (512 lanes,
# ~220 distinct, against a 128-lane cap).
BRANCH_CASES = [("unique", 0.5, "skewed", "compact"),
                ("unique", 0.125, "skewed", "full"),
                ("a2a", 1.5, "uniform", "a2a"),
                ("a2a", 0.3, "owner0", "a2a_full")]
INTERVAL, INTERVAL_STEPS = 8, 16
ADA_EVERY = 4


def _branch_case(leg, knob, kind, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (1024, 16)).astype(np.float32)
    if kind == "owner0":       # owner 0 holds rows [0, 256)
        idx = _ids("uniform", 256 * 8, seed) % 256
        idx[7::41] = DROP
    else:
        idx = _ids(kind, 256 * 8, seed)
    idx = idx.reshape(256, 8)
    grad = rng.normal(0, 1, (256, 8, 16)).astype(np.float32)
    return leg, table, idx, grad, 0.1, "sgd", knob


def _jax_over(leg, table, idx, grad, knob):
    """The branch the JAX package takes: (fetch over, apply over), each
    its predicate on every rank's slice, any rank's (pmax)."""
    n = N
    rows_l = table.shape[0] // n
    fetch, apply = False, False
    for r in range(n):
        i_l = jnp.asarray(idx[r * 64:(r + 1) * 64].reshape(-1))
        g_l = jnp.asarray(grad[r * 64:(r + 1) * 64].reshape(-1, 16))
        m = i_l.shape[0]
        if leg == "unique":
            cap = jex.unique_cap(m, knob)
            nu = int(junique_compact(i_l, cap, DROP)[2])
            fetch |= nu > cap
            apply |= nu > cap
        else:
            cap = jex.a2a_cap(m, n, knob)
            fetch |= bool(jex.route_to_owners(i_l, rows_l, n, cap)[3])
            fi, _ = jcoalesce(i_l, g_l, DROP)
            apply |= bool(jex.route_to_owners(fi, rows_l, n, cap)[3])
    return fetch, apply


@pytest.fixture(scope="module")
def branch_runs(tmp_path_factory):
    cases = [_branch_case(leg, knob, kind, seed=i)
             for i, (leg, knob, kind, _) in enumerate(BRANCH_CASES)]
    ports = w.run_ranks(w.branch_exchanges, N,
                        tmp_path_factory.mktemp("branches"), cases)
    jmesh = jmake_mesh(N)
    out = []
    for k, (leg, table, idx, grad, lr, opt, knob) in enumerate(cases):
        def ref(jt, ji, jg):
            if leg == "unique":
                return (jex.sharded_fetch(jmesh, jt, ji, knob),
                        jex.sharded_apply(jmesh, jt, jinit_slots(jt, opt),
                                          ji, jg, lr, opt, knob))
            return (jex.sharded_fetch_a2a(jmesh, jt, ji, slack=knob),
                    jex.sharded_apply_a2a(jmesh, jt, jinit_slots(jt, opt),
                                          ji, jg, lr, opt, slack=knob))

        want = jax.device_get(jax.jit(ref)(*map(jnp.asarray,
                                                (table, idx, grad))))
        out.append(([p[k] for p in ports], want,
                    _jax_over(leg, table, idx, grad, knob)))
    return out


@pytest.mark.parametrize("case", range(len(BRANCH_CASES)),
                         ids=[f"{leg}-{knob}" for leg, knob, *_ in
                              BRANCH_CASES])
def test_exchange_branches_match_jax(branch_runs, case):
    """Every rank's branch counts equal the JAX predicate's branch (and
    the branch the case forces); the fetch exact, the apply within 1e-5
    of the JAX package's exchange."""
    ranks, (fetch, (table, _)), (j_fetch_over, j_apply_over) = \
        branch_runs[case]
    leg, _, _, forced = BRANCH_CASES[case]
    sides = {"unique": ("compact", "full"), "a2a": ("a2a", "a2a_full")}[leg]
    want = {f"fetch_{sides[j_fetch_over]}": 1,
            f"apply_{sides[j_apply_over]}": 1}
    assert want == {f"fetch_{forced}": 1, f"apply_{forced}": 1}
    for r in ranks:
        assert r["branches"] == want
    np.testing.assert_array_equal(
        np.concatenate([r["fetch"] for r in ranks]), np.asarray(fetch))
    np.testing.assert_allclose(
        np.concatenate([r["table"] for r in ranks]), np.asarray(table),
        rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ whole steps

def _interval_kw():
    return dict(SHARD, mesh_shape=N, synthetic_rows=2560,
                cafe_insert_interval=INTERVAL)


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    kw = _interval_kw()
    jax_int, batches = _jax_run(kw, N, "explicit", INTERVAL_STEPS)
    assert len(batches) == INTERVAL_STEPS
    akw = METHODS["ada"]
    saved = jada.CHECK_EVERY, jada.DECAY_EVERY
    jada.CHECK_EVERY = jada.DECAY_EVERY = ADA_EVERY
    try:
        jax_ada, abatches = _jax_run(akw, N, "explicit", ADA_EVERY + 1)
    finally:
        jada.CHECK_EVERY, jada.DECAY_EVERY = saved
    todo = [("train_steps", (kw, jax_int["init"], batches, ("explicit",))),
            ("with_constants", (
                "cafe_tpu_torch.embeddings.ada",
                {"CHECK_EVERY": ADA_EVERY, "DECAY_EVERY": ADA_EVERY},
                "train_steps", akw, jax_ada["init"], abatches,
                ("explicit",)))]
    port = w.run_ranks(w.calls, N, tmp_path_factory.mktemp("steps"),
                       todo)
    return ({"interval": jax_int, "ada": jax_ada},
            [{"interval": r[0]["explicit"], "ada": r[1]["explicit"]}
             for r in port])


def _metrics_equal(port, ref):
    assert len(port) == len(ref)
    for i, (pm, jm) in enumerate(zip(port, ref)):
        assert set(pm) == set(jm)
        for k in jm:
            if k == "loss":
                np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5,
                                           atol=1e-5, err_msg=f"step {i}")
            elif k.endswith("_frac"):
                np.testing.assert_allclose(pm[k], jm[k], rtol=2.4e-7,
                                           err_msg=f"{k} step {i}")
            else:
                assert pm[k] == jm[k], (k, i, pm[k], jm[k])


def test_sharded_insert_interval_matches_jax(step_runs):
    """16 steps at interval 8: the insert branch runs at ticks 0 and 8 on
    every rank, as the JAX predicate picks; promotions, the sketch's
    integers and the tick exact, the rest of the state within 1e-5."""
    jax_out, ranks = step_runs
    ref = jax_out["interval"]
    ticks = np.arange(INTERVAL_STEPS)
    want = [int((ticks % INTERVAL != 0).sum()),
            int((ticks % INTERVAL == 0).sum())]
    assert [int(p["tick"]) for p in ref["init"]["embed"].values()
            if "tick" in p] == [0]
    for r in ranks:
        assert r["interval"]["conds"] == {"cafe_insert": want}
        assert r["interval"]["branches"] == {}
    port = ranks[0]["interval"]
    _metrics_equal(port["metrics"], ref["metrics"])
    promos = [m["cafe_promotions"] for m in port["metrics"]]
    assert sum(promos) > 0
    assert all(p == 0 for i, p in enumerate(promos) if i % INTERVAL)
    _same(port["state"], ref["state"])
    _same(port["aux"], ref["aux"], "aux")


def test_ada_sharded_check_and_decay_match_jax(step_runs):
    """CHECK_EVERY + 1 steps with CHECK_EVERY = DECAY_EVERY = 4: the
    decay branch runs once (step 4) on every rank; dic, admitted counts
    and the step exact, grad_norm and the pool within 1e-5 of the JAX
    package's."""
    jax_out, ranks = step_runs
    ref = jax_out["ada"]
    for r in ranks:
        assert r["ada"]["conds"]["ada_decay"] == [ADA_EVERY, 1]
    port = ranks[0]["ada"]
    _metrics_equal(port["metrics"], ref["metrics"])
    _same(port["state"], ref["state"])
    key = f"part{[c for c, _ in port['parts']].index('AdaPart')}"
    assert int(port["state"]["embed"][key]["step"]) == ADA_EVERY + 1
    assert port["metrics"][-1]["ada_admitted"] > 0


# ------------------------------------------ capture_blockers and the mode

MESH_KW = dict(SHARD, mesh_shape=1, synthetic_rows=512)
MESH_CASES = {
    "explicit": {},
    "a2a": {"shard_exchange": "a2a"},
    "pallas": {"shard_exchange": "pallas"},
    "unique": {"compress_method": "hash", "compress_rate": 0.2,
               "synthetic_vocab": 20000, "shard_unique_frac": 0.5},
    "interval": {"cafe_insert_interval": 2},
    "cafe_plus": {"cafe_plus": True, "cafe_sketch_threshold": 1.0},
    "ada": {"compress_method": "ada", "compress_rate": 0.5},
    "auto": {"shard_exchange": "auto"},
    "two_level": {"mesh_inner": 1, "shard_unique_frac": 0.5},
}


@pytest.fixture(scope="module")
def mesh1():
    own = maybe_init_distributed(TConfig(), "cpu")
    meshes = {}
    try:
        yield meshes
    finally:
        for m in meshes.values():
            m.close()
        if own:
            dist.destroy_process_group()


def _mesh_of(meshes, inner):
    if inner not in meshes:
        meshes[inner] = make_mesh(1, inner=inner, device="cpu")
    return meshes[inner]


# the configurations whose branch bodies hold collectives: K5's device
# collectives on a flat mesh of one host, NCCL's on a two-level mesh or
# across hosts (which the card refuses to capture on more than one rank)
NCCL_IN_BRANCHES = {"a2a", "pallas", "unique", "interval", "two_level"}


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_mesh_steps_have_no_blocker_and_no_host_read(mesh1, name):
    """The mesh blocks no capture (donate_state False still does, with
    its reason), and one train step, one K = 2 dispatch and one eval of
    the mesh run under the no-host-read mode after an eager call each;
    AdaEmbed's ordinary steps do (its check steps are host steps)."""
    kw = dict(MESH_KW, **MESH_CASES[name])
    cfg = TConfig(**kw)
    mesh = _mesh_of(mesh1, cfg.mesh_inner)
    data = get_dataset(cfg, "train")
    _, embed, state, step, eval_step = build_all(cfg, data, device="cpu",
                                                 mesh=mesh)
    assert capture_blockers(cfg, embed, mesh) == []
    off = TConfig(**dict(kw, donate_state=False))
    assert [b.split(":")[0] for b in capture_blockers(off, embed, mesh)] \
        == ["donate_state False"]
    # on 4 ranks of one host only the two-level mesh's bodies hold NCCL
    # collectives; on ranks of two hosts every branch that holds a
    # collective blocks, the train step's and (but for the insert
    # interval) the eval step's
    one_host = types.SimpleNamespace(size=4, inner=cfg.mesh_inner,
                                     hosts=("h",) * 4)
    two_hosts = types.SimpleNamespace(size=4, inner=0,
                                      hosts=("a", "a", "b", "b"))
    assert len(capture_blockers(cfg, embed, one_host)) == (
        name == "two_level")
    held = capture_blockers(cfg, embed, two_hosts)
    assert len(held) == (name in NCCL_IN_BRANCHES)
    assert all(b.startswith("a mesh of 4 ranks with NCCL collectives")
               for b in held)
    assert bool(nccl_branches(embed, two_hosts, "eval")) == (
        name in NCCL_IN_BRANCHES - {"interval"})
    b = cfg.mini_batch_size
    batch = [torch.from_numpy(np.ascontiguousarray(a[:b]))
             for a in (data.dense, data.sparse, data.label)]
    two = [torch.cat([x, x]) for x in batch]
    valid = torch.tensor(b - 3, dtype=torch.int32)
    multi = build_multi_step(step, 2, donate=True, mesh_size=1)
    # eager calls first (AdaEmbed's step 1 is its check), as a graph's
    # warm-up makes its constants
    state, _ = step(state, *batch, valid)
    state, _ = multi(state, *two, valid)
    eval_step(state, batch[0], batch[1])
    with NoCaptureBreaks():
        state, m = step(state, *batch, valid)
        state, _ = multi(state, *two, valid)
        p = eval_step(state, batch[0], batch[1])
    assert torch.isfinite(m["loss"]) and p.shape == (b,)
