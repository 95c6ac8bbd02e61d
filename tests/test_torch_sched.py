"""The port's scheduling package (``sched/``) against the reference's.

Each case drives the same calls through both packages' modules and
compares what they return: WFQ picks, their explain records, per-tenant
stats, the tenant, stream and worker label buckets, ``parse_tenant_map``
and the placement verdicts. The sequences of queue operations are drawn
from a numpy generator whose seed hypothesis draws. Everything here is
exact: the scheduler's virtual times are sums and quotients of the same
floats in the same order, so the comparisons use ``==``.
"""

import math

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from distributed_backtesting_exploration_tpu import sched as ref_sched
from distributed_backtesting_exploration_tpu.sched import (
    placement as ref_placement, tenancy as ref_tenancy)
from distributed_backtesting_exploration_tpu_torch import sched as port_sched
from distributed_backtesting_exploration_tpu_torch.sched import (
    placement as port_placement, tenancy as port_tenancy)

PKGS = (ref_sched, port_sched)
TENANTS = ("default", "whale", "small", "t3", "t4")


def _ops(seed: int, n_ops: int = 80) -> list[tuple]:
    """A random sequence of scheduler calls, a pure function of ``seed``."""
    rng = np.random.default_rng(seed)
    ops, parked, picked, n = [], [], [], 0
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.45 or not (parked or picked):
            jid = f"j{n}"
            n += 1
            t = TENANTS[int(rng.integers(len(TENANTS)))]
            cost = float(rng.choice([1.0, 4.0, 50.0, 400.0]))
            ops.append(("push", jid, t, cost))
            parked.append(jid)
        elif r < 0.70:
            ops.append(("pick", int(rng.integers(1, 5))))
        elif r < 0.80 and parked:
            ops.append(("discard", parked[int(rng.integers(len(parked)))]))
        elif r < 0.92 and picked:
            ops.append(("release", picked[int(rng.integers(len(picked)))]))
        else:
            jid = f"j{n}"
            n += 1
            ops.append(("requeue_front",
                        [(jid, TENANTS[int(rng.integers(len(TENANTS)))],
                          float(rng.choice([1.0, 8.0])))]))
        if ops[-1][0] == "pick":
            picked.extend(f"j{i}" for i in range(max(0, n - 3), n))
    return ops


def _run(pkg, ops, weights, quotas) -> list:
    s = pkg.WfqScheduler(weights=dict(weights), quotas=dict(quotas))
    trace = []
    for op in ops:
        kind = op[0]
        if kind == "push":
            s.push(op[1], op[2], op[3])
        elif kind == "pick":
            explain = []
            got = s.pick(op[1], explain)
            trace.append(("pick", got, [e.as_dict() for e in explain]))
        elif kind == "discard":
            trace.append(("discard", s.discard(op[1])))
        elif kind == "release":
            s.release(op[1])
        else:
            s.requeue_front(op[1])
        trace.append(("state", s.pending(), s.tenants(), s.stats()))
    return trace


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**32 - 1),
       quota=st.sampled_from([None, 10.0, 100.0, 500.0]),
       whale_weight=st.sampled_from([1.0, 0.25, 4.0]))
def test_wfq_picks_explains_and_stats_match_the_reference(seed, quota,
                                                          whale_weight):
    ops = _ops(seed)
    weights = {"whale": whale_weight, "*": 1.0}
    quotas = {} if quota is None else {"whale": quota}
    ref, port = (_run(pkg, ops, weights, quotas) for pkg in PKGS)
    assert port == ref


@pytest.mark.parametrize("n_pick", [1, 3, 16])
def test_wfq_weighted_interleave_matches_the_reference(n_pick):
    out = []
    for pkg in PKGS:
        s = pkg.WfqScheduler(weights={"a": 3.0, "b": 1.0}, quotas={})
        for i in range(12):
            s.push(f"a{i}", "a", 1.0)
            s.push(f"b{i}", "b", 1.0)
        picks = []
        while s.pending():
            explain = []
            picks.append((s.pick(n_pick, explain),
                          [e.as_dict() for e in explain]))
        out.append(picks)
    assert out[1] == out[0]


@pytest.mark.parametrize("spec", [
    "", "whale:4,small:1,*:2", " a : 1.5 , b:0.25 ", "x:1,x:3", "ns:a:2",
    "bad", ":3", "a:x", "a:1,,b:2"])
def test_parse_tenant_map_matches_the_reference(spec):
    got = []
    for pkg in PKGS:
        try:
            got.append(("ok", pkg.parse_tenant_map(spec)))
        except ValueError as e:
            got.append(("err", str(e)))
    assert got[1] == got[0]


@pytest.mark.parametrize("weights", [{"a": 0.0}, {"a": -1.0}])
def test_wfq_rejects_the_weights_the_reference_rejects(weights):
    for pkg in PKGS:
        with pytest.raises(ValueError):
            pkg.WfqScheduler(weights=weights, quotas={})


@pytest.mark.parametrize("fn,env", [
    ("tenant_bucket", "DBX_TENANT_LABEL_MAX"),
    ("stream_bucket", "DBX_STREAM_LABEL_MAX"),
    ("worker_bucket", "DBX_WORKER_LABEL_MAX")])
def test_label_buckets_match_the_reference(monkeypatch, fn, env):
    monkeypatch.setenv(env, "5")
    rng = np.random.default_rng(7)
    keys = [f"{int(k):032x}" for k in rng.integers(0, 9, size=40)] + ["", ""]
    got = []
    for mod in (ref_tenancy, port_tenancy):
        mod.reset_tenant_buckets()
        try:
            got.append([getattr(mod, fn)(k) for k in keys])
        finally:
            mod.reset_tenant_buckets()
    assert got[1] == got[0]
    assert port_tenancy.OVERFLOW_BUCKET in got[1]


def test_held_explain_and_default_tenant_match_the_reference():
    assert port_sched.held_explain("j7") == ref_sched.held_explain("j7")
    assert port_sched.DEFAULT_TENANT == ref_sched.DEFAULT_TENANT


_COSTS = [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, math.inf, math.nan, -1.0]


@pytest.mark.parametrize("cap", [0, 1, 2, 5])
def test_placement_verdicts_match_the_reference(cap):
    for skips in range(0, 7):
        assert (port_placement.should_wait_for_parent(skips, cap)
                == ref_placement.should_wait_for_parent(skips, cap))
        for mine in _COSTS:
            for best in _COSTS:
                assert (port_placement.should_defer(mine, best, skips, cap)
                        == ref_placement.should_defer(mine, best, skips,
                                                      cap)), (mine, best)


@pytest.mark.parametrize("placement,cap", [
    (None, None), ("0", None), ("off", "3"), ("1", "x"), ("true", "-2")])
def test_placement_knobs_match_the_reference(monkeypatch, placement, cap):
    for name, val in (("DBX_PLACEMENT", placement),
                      ("DBX_PLACEMENT_DEFER_CAP", cap)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    assert port_placement.enabled() == ref_placement.enabled()
    assert port_placement.defer_cap() == ref_placement.defer_cap()
    assert port_placement.PLACEMENT_RATIO == ref_placement.PLACEMENT_RATIO
