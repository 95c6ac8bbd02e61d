"""The port's backend on a mesh: the ticker-sharded route and the
time-sharded long-context route (the counterparts of
``tests/test_multichip_backend.py`` and ``tests/test_timeshard_wire.py``).

``TorchSweepBackend(mesh=make_mesh(["cpu"] * 4))`` against the meshless
``TorchSweepBackend(device="cpu")`` on the same JobSpecs: every block
bit-equal on the mesh route (each shard runs the group's runner on its
rows, the same per-row computation), for fused, multi-field, ragged,
generic, pairs, walk-forward, top-k and best-returns groups; a mixed batch
also against the JAX meshless backend under ``torch_parity``'s flip rule.
The long-context route (trigger shrunk on the instance, as the reference's
tests shrink theirs) against the meshless backend at the reference's
``_assert_same_payloads`` tolerance, rtol=3e-4, atol=3e-5 (rtol=2e-3,
atol=2e-4 for pairs): the positions agree and the metrics' sums add in
shard order.
"""

import logging

import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.rpc import (
    backtesting_pb2 as ref_pb, compute as ref_compute, wire as ref_wire)
from distributed_backtesting_exploration_tpu.rpc.dispatcher import (
    parse_grid, synthetic_jobs)
from distributed_backtesting_exploration_tpu_torch.parallel import sharding
from distributed_backtesting_exploration_tpu_torch.rpc import compute, wire

from test_torch_compute import GRIDS, PAIRS_GRID, TOL, _decoded, _stack
from torch_parity import ATOL, RTOL, assert_metrics_match

MESH = sharding.make_mesh(["cpu"] * 4)


def _specs(recs, **extra):
    return [ref_pb.JobSpec(id=r.id, strategy=r.strategy, ohlcv=r.ohlcv,
                           ohlcv2=r.ohlcv2 or b"",
                           grid=ref_wire.grid_to_proto(r.grid), cost=r.cost,
                           periods_per_year=252, trace_id=f"t-{r.id}",
                           **extra) for r in recs]


def _run(backend, specs) -> dict:
    return {c.job_id: c.metrics for c in backend.process(specs)}


def _bit_equal(specs, **attrs):
    """The mesh backend's blocks against the meshless backend's, bytes
    equal; returns the mesh backend's blocks."""
    mesh, one = (compute.TorchSweepBackend(mesh=MESH),
                 compute.TorchSweepBackend(device="cpu"))
    for b in (mesh, one):
        for k, v in attrs.items():
            setattr(b, k, v)
    got, want = _run(mesh, specs), _run(one, specs)
    assert set(got) == {s.id for s in specs} == set(want)
    for jid in want:
        assert got[jid] == want[jid], jid
    return got


def _close(got: dict, want: dict, rtol=3e-4, atol=3e-5) -> None:
    assert set(got) == set(want)
    for jid in want:
        a, b = wire.metrics_from_bytes(got[jid]), wire.metrics_from_bytes(
            want[jid])
        for name in a._fields:
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{jid}/{name}")


def _mixed(n: int, bars: int, seed: int) -> list:
    recs = []
    for k, (strategy, grid) in enumerate(GRIDS.items()):
        recs += synthetic_jobs(n, bars, strategy, grid, cost=1e-3,
                               seed=seed + k)
    return recs + synthetic_jobs(n, bars, "pairs", PAIRS_GRID, cost=1e-3,
                                 seed=seed + 99)


def test_mesh_route_is_bit_equal_and_holds_to_the_jax_backend():
    # 5 jobs a family on 4 shards: 3 repeat-last pad rows a group.
    specs = _specs(_mixed(5, 100, 60))
    got = _decoded([compute.Completion(k, v, 0.0) for k, v in
                    _bit_equal(specs).items()])
    want = _decoded(ref_compute.JaxSweepBackend(use_fused=True).process(
        specs))
    for strategy in [*GRIDS, "pairs"]:
        ids = [s.id for s in specs if s.strategy == strategy]
        rtol, atol = TOL.get(strategy, (RTOL, ATOL))
        if strategy == "pairs":
            rtol, atol = 2e-3, 2e-4
        assert_metrics_match(_stack(got, ids), _stack(want, ids), rtol=rtol,
                             atol=atol)


def test_ragged_groups_split_their_lengths_by_shard():
    # Two payload lengths in one length bucket: every group ragged, t_real
    # split with its rows.
    recs = []
    for k, (strategy, grid) in enumerate(GRIDS.items()):
        for n in (110, 125):
            recs += synthetic_jobs(3, n, strategy, grid, cost=1e-3,
                                   seed=200 + 2 * k + n)
    for n in (100, 120):
        recs += synthetic_jobs(3, n, "pairs", PAIRS_GRID, cost=1e-3,
                               seed=300 + n)
    _bit_equal(_specs(recs))


@pytest.mark.parametrize("strategy,grid", [
    ("bollinger", {"window": np.float32([9.5, 20.0]),
                   "k": np.float32([1.0, 2.0])}),
    ("momentum", {"lookback": np.float32([4.5, 12.0])}),
    ("pairs", {"lookback": np.float32([7.5, 12.0]),
               "z_entry": np.float32([1.0, 2.0])}),
], ids=["generic-bollinger", "generic-momentum", "generic-pairs"])
def test_generic_groups(strategy, grid, caplog):
    recs = synthetic_jobs(5, 90, strategy, grid, cost=1e-3, seed=7)
    with caplog.at_level(logging.WARNING, logger="dbx.torch.compute"):
        _bit_equal(_specs(recs))
    assert any("generic path" in r.message for r in caplog.records)


def test_top_k_and_best_returns_groups():
    recs = (synthetic_jobs(5, 100, "sma_crossover", GRIDS["sma_crossover"],
                           cost=1e-3, seed=11)
            + synthetic_jobs(3, 100, "pairs", PAIRS_GRID, cost=1e-3,
                             seed=12))
    got = _bit_equal(_specs(recs, top_k=3, rank_metric="sortino"))
    assert {wire.result_kind(b) for b in got.values()} == {"topk"}
    series = []
    for t in (90, 100, 128, 97, 111):
        series += synthetic_jobs(1, t, "bollinger", GRIDS["bollinger"],
                                 cost=1e-3, seed=t)
    got = _bit_equal(_specs(series, best_returns=True, rank_metric="sharpe"))
    assert {wire.result_kind(b) for b in got.values()} == {"returns"}


@pytest.mark.parametrize("route", ["fused-train", "generic", "ragged",
                                   "pairs"])
def test_walk_forward_groups(route):
    if route == "pairs":
        recs = synthetic_jobs(5, 200, "pairs", PAIRS_GRID, cost=1e-3, seed=3)
    elif route == "ragged":
        recs = (synthetic_jobs(2, 200, "momentum", GRIDS["momentum"],
                               cost=1e-3, seed=4)
                + synthetic_jobs(3, 230, "momentum", GRIDS["momentum"],
                                 cost=1e-3, seed=5))
    else:
        recs = synthetic_jobs(5, 200, "rsi", GRIDS["rsi"], cost=1e-3, seed=6)
    specs = _specs(recs, wf_train=80, wf_test=30, wf_metric="sharpe")
    got = _bit_equal(specs, _WF_FUSED_MIN_COMBOS=(
        1 if route == "fused-train" else 10 ** 6))
    for b in got.values():
        assert wire.metrics_from_bytes(b).sharpe.shape == (1,)


def test_pad_rows_are_never_reported():
    backend = compute.TorchSweepBackend(mesh=MESH)
    specs = _specs(synthetic_jobs(5, 100, "sma_crossover",
                                  GRIDS["sma_crossover"], cost=1e-3, seed=8))
    done = backend.process(specs)
    assert [c.job_id for c in done] == [s.id for s in specs]
    P = wire.grid_n_combos(specs[0].grid)
    assert all(wire.metrics_from_bytes(c.metrics).sharpe.shape == (P,)
               for c in done)
    seen = []

    def runner(blks, tr, dev):
        seen.append((blks[0].shape[0], None if tr is None else tr.tolist()))
        return (blks[0][:, :1],)

    rows = torch.arange(10.0).reshape(5, 2)
    out = backend._mesh_call(runner, [rows], np.int32([5, 6, 7, 8, 9]))
    assert seen == [(2, [5, 6]), (2, [7, 8]), (2, [9, 9]), (2, [9, 9])]
    assert torch.equal(out[0], rows[:, :1])


def test_chips_count_distinct_devices_and_the_default_is_meshless():
    assert compute.TorchSweepBackend(mesh=MESH).chips == 1
    assert sharding.Mesh((torch.device("cpu", 0), torch.device("cpu", 1),
                          torch.device("cpu", 0))).distinct == 2
    one = compute.TorchSweepBackend(device="cpu")
    assert one.mesh is None and one.chips == 1
    assert compute.default_mesh("cpu") is None
    mesh_backend = compute.TorchSweepBackend(mesh=MESH)
    assert mesh_backend.device == torch.device("cpu")
    assert not mesh_backend.use_paged
    with pytest.raises(ValueError, match="first device"):
        compute.TorchSweepBackend(device="cpu", mesh=sharding.Mesh(
            (torch.device("cpu", 1),) * 2))


def _ts_backend():
    b = compute.TorchSweepBackend(mesh=MESH)
    b._LONG_CONTEXT_BARS = 192      # instance override, as the tests of the
    return b                        # reference shrink _FUSED_MAX_BARS


def test_long_context_routes_and_matches(caplog):
    # T = 517 does not divide by 4: the repeat-last pad and t_real are on
    # the path.
    specs = _specs(synthetic_jobs(1, 517, "sma_crossover",
                                  {"fast": np.float32([5, 8]),
                                   "slow": np.float32([21.0])},
                                  cost=1e-3, seed=31))
    with caplog.at_level(logging.INFO, logger="dbx.torch.compute"):
        got = _run(_ts_backend(), specs)
    assert any("time-sharded long-context path" in r.message
               for r in caplog.records)
    one = compute.TorchSweepBackend(device="cpu")
    _close(got, _run(one, specs))
    ref = _run(ref_compute.JaxSweepBackend(use_fused=True), specs)
    for jid in ref:
        assert_metrics_match(wire.metrics_from_bytes(got[jid]),
                             ref_wire.metrics_from_bytes(ref[jid]))


@pytest.mark.parametrize("strategy", sorted(compute._TIMESHARD_STRATEGIES))
def test_long_context_families(strategy):
    recs = synthetic_jobs(2, 400, strategy, GRIDS[strategy], cost=1e-3,
                          seed=130)
    specs = _specs(recs)
    backend = _ts_backend()
    assert compute.timeshard_route_reason(
        strategy, wire.grid_from_proto(specs[0].grid), [400], 4) is None
    got = _run(backend, specs)
    want = _run(compute.TorchSweepBackend(device="cpu"), specs)
    if strategy not in TOL:
        _close(got, want)
        return
    # macd, trix and keltner: the time-sharded EMAs are f64 scans, the
    # fused route's f32 ladders, so a signal at its line can cross a bar
    # apart; the flip rule with the reference's flip-aware tolerance.
    ids = [s.id for s in specs]
    rtol, atol = TOL[strategy]
    assert_metrics_match(_stack(_decoded([compute.Completion(
        k, v, 0.0) for k, v in got.items()]), ids), _stack(_decoded([
            compute.Completion(k, v, 0.0) for k, v in want.items()]), ids),
        rtol=rtol, atol=atol)


def test_long_context_pairs(caplog):
    specs = _specs(synthetic_jobs(2, 400, "pairs", PAIRS_GRID, cost=1e-3,
                                  seed=140))
    with caplog.at_level(logging.INFO, logger="dbx.torch.compute"):
        got = _run(_ts_backend(), specs)
    assert any("(pairs) routed to the time-sharded" in r.message
               for r in caplog.records)
    _close(got, _run(compute.TorchSweepBackend(device="cpu"), specs), 2e-3,
           2e-4)


def test_long_context_regates_job_by_job(caplog):
    # 260 and 300 bars share a length bucket; a 70-bar window fits the
    # 75-bar blocks of 300 bars but not the 65-bar blocks of 260: the group
    # gate refuses, the long job alone routes, the other keeps the fused
    # route.
    grid = {"window": np.float32([10.0, 70.0])}
    recs = (synthetic_jobs(1, 300, "donchian", grid, cost=1e-3, seed=1)
            + synthetic_jobs(1, 260, "donchian", grid, cost=1e-3, seed=2))
    specs = _specs(recs)
    backend = _ts_backend()
    with caplog.at_level(logging.INFO, logger="dbx.torch.compute"):
        got = _run(backend, specs)
    routed = [r.message for r in caplog.records
              if "time-sharded long-context path" in r.message]
    assert len(routed) == 1 and recs[0].id in routed[0]
    assert "take the other routes" in routed[0]
    one = _run(compute.TorchSweepBackend(device="cpu"), specs)
    assert got[recs[1].id] == one[recs[1].id]
    _close(got, one)


def test_long_context_gates():
    axes = {"fast": np.float32([5.0]), "slow": np.float32([21.0])}
    assert compute.timeshard_route_reason("sma_crossover", axes, [400],
                                          4) is None
    assert "no time-sharded" in compute.timeshard_route_reason(
        "pairs", axes, [400], 4)
    assert "fast >= slow" in compute.timeshard_route_reason(
        "sma_crossover", {"fast": np.float32([30.0]),
                          "slow": np.float32([21.0])}, [400], 4)
    assert "exceeds" in compute.timeshard_route_reason(
        "sma_crossover", {"fast": np.float32([5.0]),
                          "slow": np.float32([150.0])}, [400], 4)
    assert "cap" in compute.timeshard_route_reason(
        "momentum", {"lookback": np.arange(1, 200, dtype=np.float32)},
        [4000], 4)
    assert compute.timeshard_route_reason(
        "trix", {"span": np.float32([150.0]), "signal": np.float32([9.0])},
        [400], 4) is None          # EMA state: no halo bound
    assert compute.timeshard_combos("macd", parse_grid(
        "fast=5:8:2,slow=20,signal=9")) == ((5, 20, 9), (7, 20, 9))
    # A short group, or as many tickers as shards, keeps the other routes.
    b = _ts_backend()
    assert not b._long_context([1] * 4, [400])
    assert not b._long_context([1], [192])
    assert b._long_context([1] * 3, [193])
