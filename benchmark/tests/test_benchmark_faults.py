"""The check against the faults a cell can have: a run whose timed path
is broken underneath (its state unchanged, half its batch, its sketch's
decay) comes out not correct, and the control (the reference a
precision step lower, in the program's place) and the faults planted in
the reference fail the limits too. The look for a card is skipped: the
runs drive the port's CPU path at the tiny size."""

import time

import pytest


from benchmark import check
from benchmark.cell import Run
from benchmark.tests import tiny


def _unchanged(sysm):
    """The step returns its state unchanged (it computes, on a copy)."""
    from cafe_tpu_torch.train.step import clone_state
    real = sysm.train

    def train(k, dense, ids, labels):
        keep = sysm.state
        sysm.state = clone_state(keep)
        m = real(k, dense, ids, labels)
        sysm.state = keep
        return m

    sysm.train = train


def _half_batch(sysm):
    """Half the batch left out, the mean taken over the rest."""
    def train(k, dense, ids, labels):
        step = sysm.train_step(k)
        sysm.state, m = step(sysm.state, dense, ids, labels,
                             int(ids.shape[0]) // 2)
        return m

    sysm.train = train


def _no_decay(sysm):
    """The sketch's decay multiplies by 1 (counts never decay, hot ids
    are never demoted)."""
    from cafe_tpu_torch.embeddings import CafePart
    for p in sysm.embed.parts:
        if isinstance(p, CafePart):
            p.sketch_cfg = p.sketch_cfg._replace(decay=1.0)


def _run(traffic, limits, wrap=None, readings=False):
    name = "c"
    man = tiny.manifest([name])
    run = Run(man, {"name": name}, tiny.TINY_CONF, traffic, limits,
              2**32 + 11, 0.2, False, "cpu", time.perf_counter(), wrap=wrap,
              readings=readings)
    return run.run()


@pytest.mark.parametrize("traffic,wrap", [
    (tiny.train_traffic(), _unchanged),
    (tiny.train_traffic(k=2, interval=2), _unchanged),
    (tiny.train_traffic(), _half_batch),
    (tiny.train_traffic(), _no_decay),
    (tiny.train_traffic(k=2, interval=2), _no_decay),
], ids=["unchanged", "unchanged_k2", "half_batch", "no_decay",
        "no_decay_k2"])
def test_benchmark_broken_timed_path_is_not_correct(traffic, wrap):
    res = _run(traffic, tiny.TRAIN_LIMITS, wrap)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("traffic", [tiny.train_traffic(),
                                     tiny.train_traffic(k=2, interval=2)],
                         ids=["k1", "k2"])
def test_benchmark_control_and_faults_fail_the_limits(traffic):
    limits = tiny.TRAIN_LIMITS
    res = _run(traffic, limits, readings=True)
    assert res["correct"] is True, res["checks"]
    assert set(res["readings"]) == {"control_fp8", "fault_half_batch",
                                    "fault_no_decay"}
    for name, numbers in res["readings"].items():
        compared = {k: v for k, v in numbers.items() if k in limits}
        assert not check.judge(compared, limits), (name, numbers)


def test_benchmark_judge_refuses_nan_and_missing_limits():
    assert check.judge({"a": 0.1}, {"a": 0.2})
    assert not check.judge({"a": float("nan")}, {"a": 0.2})
    assert not check.judge({"a": 0.1}, {})
    assert not check.judge({"a": 0.3}, {"a": 0.2})


def test_benchmark_leaf_rule_leaves_out_unmoved_leaves():
    ref = {"loss": [1.0], "promotions": 4,
           "d1": {"a": 1.0, "b": 2.0, "c": 1e-9},
           "d3": {"a": 1.0, "b": 2.0, "c": 1e-9}}
    prog = {"loss": [1.0], "promotions": 1,
            "d1": {"a": 1.0, "b": 2.0, "c": 5.0},
            "d3": {"a": 1.0, "b": 4.0, "c": 5.0}}
    assert check.left_out(ref) == ["c"]
    nums = check.train_numbers(prog, ref)
    assert nums["grad_gap"] == 0.0
    assert nums["change_gap"] == 1.0
    # a leaf left unmoved reads 1 by the measure
    prog["d1"]["b"] = 0.0
    assert check.train_numbers(prog, ref)["grad_gap"] == 1.0
    assert check.promo_gap(prog, ref) == 0.75



def test_benchmark_migrated_leaf_is_left_out_of_grad_gap_only():
    ref = {"loss": [1.0], "promotions": 4,
           "d1": {"a": 1.0, "b": 2.0, "t": 3.0},
           "d3": {"a": 1.0, "b": 2.0, "t": 3.0}}
    prog = {"loss": [1.0], "promotions": 4,
            "d1": {"a": 1.0, "b": 2.0, "t": 3.3},
            "d3": {"a": 1.0, "b": 2.0, "t": 3.3}}
    assert abs(check.train_numbers(prog, ref)["grad_gap"] - 0.1) < 1e-12
    nums = check.train_numbers(prog, ref, migrated=("t",))
    assert nums["grad_gap"] == 0.0
    assert abs(nums["change_gap"] - 0.1) < 1e-12
    lines = check.worst_leaves(prog, ref, migrated=("t",))
    assert "worst leaf t" not in lines[0] and "worst leaf t" in lines[1]
    assert lines[2].startswith("d1 of t (not in grad_gap)")
