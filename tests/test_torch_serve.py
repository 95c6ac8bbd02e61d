"""The port's live signal fan-out (``serve/``, ``streaming/delta.py``)
against the reference's.

The same hub script runs through both packages' ``SubscriptionHub``
(subscribe, ticks, advances, results, pulls, quota demotion, a slow
subscriber, a raced older completion, a malformed block, catch-up from
the result cache, unsubscribe) and must give the same plans, fan-out
counts, pushed items and registry stats. ``PushItem.tick_unix`` is the
wall clock at the tick, so it is dropped; every other field is compared
exactly. ``metric_delta`` is held to the reference's on DBXM blocks that
differ in chosen lanes, NaN included.
"""

import dataclasses

import numpy as np
import pytest

from distributed_backtesting_exploration_tpu import obs as ref_obs
from distributed_backtesting_exploration_tpu import serve as ref_serve
from distributed_backtesting_exploration_tpu.ops.metrics import (
    Metrics as RefMetrics)
from distributed_backtesting_exploration_tpu.rpc import wire as ref_wire
from distributed_backtesting_exploration_tpu.rpc.dispatcher import (
    STREAMABLE_STRATEGIES as REF_STREAMABLE)
from distributed_backtesting_exploration_tpu.streaming import (
    delta as ref_delta)
from distributed_backtesting_exploration_tpu_torch import obs as port_obs
from distributed_backtesting_exploration_tpu_torch import serve as port_serve
from distributed_backtesting_exploration_tpu_torch.rpc.dispatcher import (
    STREAMABLE_STRATEGIES as PORT_STREAMABLE)
from distributed_backtesting_exploration_tpu_torch.streaming import (
    delta as port_delta, recurrent as port_recurrent)

PKGS = ((ref_serve, ref_obs), (port_serve, port_obs))
GRID = {"fast": np.float32([3, 4]), "slow": np.float32([10, 12])}
GRID2 = {"fast": np.float32([7, 8])}


def _blk(v, n=4, nan_lane=None):
    planes = [np.full(n, float(v), np.float32) for _ in RefMetrics._fields]
    if nan_lane is not None:
        planes[0][nan_lane] = np.nan
    return ref_wire.metrics_to_bytes(RefMetrics(*planes))


def _item(it) -> dict:
    d = dataclasses.asdict(it)
    d.pop("tick_unix")
    return d


def _plan(p) -> tuple:
    return (p.chain, sorted(s.key for s in p.advances), p.template_live)


def _script(serve, obs, monkeypatch) -> list:
    """One hub history; returns everything observable, in order."""
    monkeypatch.setenv("DBX_TENANT_SUB_QUOTA", "whale:2,*:100")
    reg = obs.Registry()
    hub = serve.SubscriptionHub(registry=reg, queue_max=2,
                                streamable=PORT_STREAMABLE)
    spec = serve.StreamSpec("sma_crossover", GRID, 0.0, 252, digest="d0")
    spec2 = serve.StreamSpec("sma_crossover", GRID2, 1e-3, 365,
                             digest="d0")
    out = []
    subs = [hub.subscribe(f"c{i}", "default", [spec]) for i in range(3)]
    subs.append(hub.subscribe("c3", "default", [spec2]))
    w1 = hub.subscribe("w1", "whale", [spec, spec])
    w2 = hub.subscribe("w2", "whale", [spec])
    out.append(("demoted", [s.demoted for s in subs + [w1, w2]]))
    out.append(("stats", hub.stats()))
    parent = "d0"
    for i in range(1, 5):
        digest = f"d{i}"
        plan = hub.on_tick(parent, digest, 100 + i,
                           template_key=spec.key if i == 2 else "")
        out.append(("plan", _plan(plan)))
        out.append(("dup", _plan(hub.on_tick(parent, digest, 100 + i))))
        for s in plan.advances:
            hub.register_advance(f"j{i}-{s.key[:6]}", plan.chain, s.key,
                                 digest, 100 + i, float(i))
        if plan.template_live:
            hub.register_advance(f"j{i}-{spec.key[:6]}", plan.chain,
                                 spec.key, digest, 100 + i, float(i))
        out.append(("has", hub.has_advances()))
        for s in (spec, spec2):
            jid = f"j{i}-{s.key[:6]}"
            blob = (b"not a dbxm block" if i == 3 and s is spec2
                    else _blk(i if i != 2 else 1, nan_lane=i % 4))
            out.append(("result", jid, hub.on_result(jid, blob)))
        parent = digest
    # A raced older advance completing after a newer one: suppressed.
    plan = hub.on_tick("d4", "d5", 105)
    hub.register_advance("old", plan.chain, spec.key, "d5", 105, 5.0)
    plan = hub.on_tick("d5", "d6", 106)
    hub.register_advance("new", plan.chain, spec.key, "d6", 106, 6.0)
    out.append(("race", hub.on_result("new", _blk(6)),
                hub.on_result("old", _blk(5))))
    out.append(("unknown", hub.on_result("nobody", _blk(0))))
    for s in subs + [w1, w2]:
        out.append(("pull", s.subscriber_id, s.dropped,
                    [_item(it) for it in s.pull(timeout=0.5)]))
    late = hub.subscribe("late", "default", [spec])
    out.append(("catch_up", [_item(it) for it in late.pull(timeout=0.5)]))
    hub.cache.pop(("d6", spec.key))
    later = hub.subscribe("later", "default", [spec])
    out.append(("miss", [_item(it) for it in later.pull(timeout=0.1)]))
    out.append(("cache", hub.cache.stats()))
    for s in subs + [w1, w2, late, later]:
        hub.unsubscribe(s)
    out.append(("stats", hub.stats()))
    out.append(("counters", sorted(
        (k, v) for k, v in reg.summaries().items()
        if k.startswith(("dbx_sub_", "dbx_result_cache"))
        and "seconds" not in k)))
    hub.close()
    return out


def test_hub_history_matches_the_reference(monkeypatch):
    ref, port = (_script(serve, obs, monkeypatch) for serve, obs in PKGS)
    assert port == ref


@pytest.mark.parametrize("grid,cost,ppy", [
    (GRID, 0.0, 252), (GRID2, 1e-3, 365), ({}, 0.5, 12)])
@pytest.mark.parametrize("strategy", ["sma_crossover", "rsi", "macd"])
def test_stream_key_matches_the_reference_and_the_carry_key(
        strategy, grid, cost, ppy):
    key = port_serve.stream_key(strategy, grid, cost, ppy)
    assert key == ref_serve.stream_key(strategy, grid, cost, ppy)
    assert key == port_recurrent.stream_key(strategy, grid, cost, ppy)


def test_streamable_strategies_match_the_reference():
    assert PORT_STREAMABLE == REF_STREAMABLE


@pytest.mark.parametrize("prev,new", [
    (None, _blk(1)),
    (_blk(1), _blk(1)),
    (_blk(1), _blk(2)),
    (_blk(1, nan_lane=2), _blk(1, nan_lane=2)),
    (_blk(1, nan_lane=2), _blk(1, nan_lane=3)),
    (_blk(1, n=3), _blk(1, n=4)),
    (b"garbage", _blk(1)),
])
def test_metric_delta_matches_the_reference(prev, new):
    assert port_delta.metric_delta(prev, new) == ref_delta.metric_delta(
        prev, new)


@pytest.mark.parametrize("env,val", [
    ("DBX_RESULT_CACHE_MB", "0.001"), ("DBX_SUB_QUEUE_MAX", "3")])
def test_serve_knobs_match_the_reference(monkeypatch, env, val):
    monkeypatch.setenv(env, val)
    assert (port_serve.registry.result_cache_max_bytes()
            == ref_serve.registry.result_cache_max_bytes())
    assert port_serve.registry.sub_queue_max() == \
        ref_serve.registry.sub_queue_max()
