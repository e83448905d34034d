"""The mesh's device branches without NCCL in their bodies, at 4 gloo
ranks on the CPU (one host): the leg a normal step takes runs its
collectives before the branch, the rare leg runs K5's device
collectives (kernels/a2a.all_gather / psum_scatter, their plain versions
here) inside the body, so that a CUDA graph captures every branch on
more than one rank.

* The device all-gather and reduce-scatter's plain versions equal the
  process group's (parallel/exchange.all_gather / psum_scatter) bit for
  bit on the flat group, on int32 and one-owner f32 inputs (every lane
  non-zero on one rank only, as the exchange's owner answers are), and
  the recorder notes them under the same op, axis and bytes.
* The pallas, a2a and unique-compact legs, each forced both ways (as
  tests/test_torch_mesh_cond.py's BRANCH_CASES force them), equal the
  JAX package's exchange: the fetch exactly, the apply within 1e-5; the
  branch counts equal the JAX predicate's. A body records only device
  collectives, and only on the overflow side (the leg a normal step
  takes holds local work alone).
* Whole steps on the mesh (pallas, a2a, the unique-compact legs at a
  capacity that holds and one that overflows, the insert every 8 ticks)
  record no process-group collective inside a body.
* capture_blockers at 4 one-host ranks is empty for those
  configurations, train and eval steps alike; on a (2, 2) two-level mesh
  and on ranks that report two host names it names the NCCL bodies.

Tolerances: fetches, branch counts and integer collectives EXACT; the
apply within 1e-5 (the ranks' duplicate rows sum in another order than
XLA's).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_dist_worker as w
from cafe_tpu.ops.sparse import init_slots as jinit_slots
from cafe_tpu.parallel import exchange as jex
from cafe_tpu.parallel import make_mesh as jmake_mesh
from test_torch_mesh_cond import _branch_case, _jax_over
from test_torch_sharded import SHARD

torch.set_num_threads(1)

N = 4
DROP = int(jex.DROP_ROW)
# (leg, knob, ids, the branch it forces, all-to-all impl)
CASES = [("unique", 0.5, "skewed", "compact", "lax"),
         ("unique", 0.125, "skewed", "full", "lax"),
         ("a2a", 1.5, "uniform", "a2a", "lax"),
         ("a2a", 0.3, "owner0", "a2a_full", "lax"),
         ("a2a", 1.5, "uniform", "a2a", "pallas"),
         ("a2a", 0.3, "owner0", "a2a_full", "pallas"),
         ("a2a", 0.3, "owner_last", "a2a_full", "pallas")]
# 512 lanes a rank: C = 256 at 0.5 holds their ~230 distinct rows, C =
# 64 at 0.05 does not
HASH = dict(compress_method="hash", compress_rate=0.2,
            synthetic_vocab=20000, mini_batch_size=512, synthetic_rows=2048)
CONFIGS = {
    "pallas": {"shard_exchange": "pallas"},
    "a2a": {"shard_exchange": "a2a"},
    "unique": dict(HASH, shard_unique_frac=0.5),
    "unique_overflow": dict(HASH, shard_unique_frac=0.05),
    "interval": {"cafe_insert_interval": 8},
}
STEPS = 2


def _kw(name):
    return dict(SHARD, mesh_shape=N, **CONFIGS[name])


def _case(leg, knob, kind, seed):
    """_branch_case's inputs; "owner_last": its owner-0 ids moved onto
    the last owner's rows, so that the lanes past a peer's capacity
    index past the routed buffer's end unless they are kept inside."""
    if kind != "owner_last":
        return _branch_case(leg, knob, kind, seed)
    leg, table, idx, *rest = _branch_case(leg, knob, "owner0", seed)
    last = table.shape[0] - table.shape[0] // N
    return (leg, table, np.where(idx == DROP, idx, idx + last), *rest)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [_case(leg, knob, kind, seed=i) + (impl,)
             for i, (leg, knob, kind, _, impl) in enumerate(CASES)]
    kws = {name: _kw(name) for name in CONFIGS}
    todo = [("device_collectives", (7,)),
            ("body_exchanges", (cases,)),
            ("step_blockers", (kws, 2)),
            ("body_exchanges", (cases, True))]
    batches = {}
    from cafe_tpu_torch.config import Config
    from cafe_tpu_torch.data import batch_iterator
    from cafe_tpu_torch.train import get_dataset
    for name, kw in kws.items():
        batches[name] = list(batch_iterator(
            get_dataset(Config(**kw), "train"), kw["mini_batch_size"],
            drop_last=True))[:STEPS]
        mode = kw.get("shard_exchange", "explicit")
        todo.append(("train_steps", (kw, None, batches[name], (mode,))))
    got = w.run_ranks(w.calls, N, tmp_path_factory.mktemp("bodies"), todo)
    return cases, got


@pytest.fixture(scope="module")
def jax_refs(ranks):
    cases, _ = ranks
    jmesh = jmake_mesh(N)
    out = []
    for leg, table, idx, grad, lr, opt, knob, _ in cases:
        def ref(jt, ji, jg):
            if leg == "unique":
                return (jex.sharded_fetch(jmesh, jt, ji, knob),
                        jex.sharded_apply(jmesh, jt, jinit_slots(jt, opt),
                                          ji, jg, lr, opt, knob))
            return (jex.sharded_fetch_a2a(jmesh, jt, ji, slack=knob),
                    jex.sharded_apply_a2a(jmesh, jt, jinit_slots(jt, opt),
                                          ji, jg, lr, opt, slack=knob))

        out.append((jax.device_get(jax.jit(ref)(*map(
            jnp.asarray, (table, idx, grad)))),
            _jax_over(leg, table, idx, grad, knob)))
    return out


@pytest.mark.parametrize("case", ["gather_int32", "gather_f32",
                                  "scatter_int32", "scatter_f32"])
def test_device_collectives_equal_the_group(ranks, case):
    """On every rank: the device collective, its plain version, the
    process group's and the exchange's device transport, bit for bit."""
    _, got = ranks
    for r in got:
        outs = r[0]["out"][case]
        for o in outs[1:]:
            assert o.dtype == outs[0].dtype and o.shape == outs[0].shape
            np.testing.assert_array_equal(o.view(np.int32),
                                          outs[0].view(np.int32))


def test_device_collectives_record_as_the_group(ranks):
    """The device transport records the op, axis and bytes of the
    collective it stands for."""
    _, got = ranks
    for r in got:
        recs = r[0]["records"]
        group = [x[:3] for x in recs if x[3] == "group"]
        device = [x[:3] for x in recs if x[3] == "device"]
        assert group == device and len(group) == 4
        assert {op for op, *_ in group} == {"all-gather", "reduce-scatter"}


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{leg}-{impl}-{knob}" for leg, knob, _, _,
                              impl in CASES])
def test_forced_legs_match_jax(ranks, jax_refs, case):
    """Every rank's branch counts equal the JAX predicate's; the fetch
    exact, the apply within 1e-5 of the JAX package's exchange; a body
    holds device collectives only, and only on the overflow side."""
    _, got = ranks
    (fetch, (table, _)), (j_fetch_over, j_apply_over) = jax_refs[case]
    leg, _, _, forced, _ = CASES[case]
    sides = {"unique": ("compact", "full"), "a2a": ("a2a", "a2a_full")}[leg]
    want = {f"fetch_{sides[j_fetch_over]}": 1,
            f"apply_{sides[j_apply_over]}": 1}
    assert want == {f"fetch_{forced}": 1, f"apply_{forced}": 1}
    outs = [r[1][case] for r in got]
    for o in outs:
        assert o["branches"] == want
        if forced in ("compact", "a2a"):
            assert o["bodies"] == []
        else:
            assert o["bodies"] and all(t == "device"
                                       for *_, t in o["bodies"])
            # the full fetch's ids and rows, the full apply's ids and
            # grads
            assert [op for op, *_ in o["bodies"]] == [
                "all-gather", "reduce-scatter", "all-gather", "all-gather"]
    np.testing.assert_array_equal(
        np.concatenate([o["fetch"] for o in outs]), np.asarray(fetch))
    np.testing.assert_allclose(
        np.concatenate([o["table"] for o in outs]), np.asarray(table),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{leg}-{impl}-{knob}" for leg, knob, _, _,
                              impl in CASES])
def test_warm_up_spares_leave_the_legs_alone(ranks, case):
    """As a graph's warm-up runs them (each branch not taken also runs,
    on clones: the routed legs on a step that overflows them, so their
    gathers must stay inside the buffers), the legs give what they give
    without the spares, bit for bit, and take the same branches."""
    _, got = ranks
    for r in got:
        plain, warm = r[1][case], r[3][case]
        assert warm["branches"] == plain["branches"]
        for key in ("fetch", "table"):
            np.testing.assert_array_equal(warm[key], plain[key])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_steps_record_no_nccl_in_bodies(ranks, name):
    """STEPS train steps: finite losses, the branches the configuration
    forces, and no process-group collective recorded inside a body (the
    overflow and insert bodies record K5's device collectives)."""
    _, got = ranks
    k = 4 + list(CONFIGS).index(name)
    for r in got:
        run = next(iter(r[k].values()))
        assert all(np.isfinite(m["loss"]) for m in run["metrics"])
        bodies = [x for step in run["bodies"] for x in step]
        assert all(t == "device" for *_, t in bodies), bodies
        if name == "unique_overflow":
            assert run["branches"] == {"fetch_full": STEPS,
                                       "apply_full": STEPS}
            assert bodies
        elif name == "unique":
            assert run["branches"] == {"fetch_compact": STEPS,
                                       "apply_compact": STEPS}
            assert not bodies
        elif name == "interval":
            # the insert at tick 0 only: its candidate all-gather
            assert run["conds"] == {"cafe_insert": [STEPS - 1, 1]}
            assert [op for op, *_ in bodies] == ["all-gather"]
        else:
            assert set(run["branches"]) == {"fetch_a2a", "apply_a2a"}
            assert not bodies


def test_one_host_blocks_nothing(ranks):
    """A flat mesh of 4 ranks on one host: no blocker, train or eval."""
    _, got = ranks
    for r in got:
        res = r[2]
        assert len(set(res["hosts"])) == 1
        for name, (train, evals, _) in res["flat"].items():
            assert train == [] and evals == [], name


def test_two_hosts_and_two_levels_name_their_nccl_bodies(ranks):
    """Ranks that report two host names, and the (2, 2) two-level mesh,
    keep NCCL collectives in the bodies: the train step names them."""
    _, got = ranks
    for r in got:
        res = r[2]
        for name in CONFIGS:
            spread = res["flat"][name][2]
            assert len(spread) == 1 and "ranks on 2 hosts" in spread[0], \
                name
        for name, held in res["two_level"].items():
            # the two-level mesh takes no a2a leg: only its compact legs
            # and the insert interval hold collectives
            if name in ("pallas", "a2a"):
                assert held == [], name
            else:
                assert len(held) == 1 and "two-level mesh" in held[0], name
