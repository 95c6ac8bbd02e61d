"""The port's worker backend and worker loop against the reference.

``TorchSweepBackend(device="cpu").process`` against
``JaxSweepBackend(use_fused=True).process`` on the same JobSpecs (DBXM
blocks decoded and held to the flip rule of ``torch_parity``), for every
strategy the port serves; the backend's panel cache and digest-only
payloads; and one in-process reference dispatcher drained by the port's
gRPC worker. Top-k, best-returns, walk-forward and the pipelined worker
have files of their own (``test_torch_topk.py``,
``test_torch_best_returns.py``, ``test_torch_walkforward.py``,
``test_torch_pipeline.py``).
"""

import threading
import time

import numpy as np
import pytest

from distributed_backtesting_exploration_tpu.rpc import (
    backtesting_pb2 as ref_pb, compute as ref_compute, wire as ref_wire)
from distributed_backtesting_exploration_tpu.rpc.dispatcher import (
    Dispatcher, DispatcherServer, JobQueue, PeerRegistry, parse_grid,
    synthetic_jobs)
from distributed_backtesting_exploration_tpu_torch.models import get_strategy
from distributed_backtesting_exploration_tpu_torch.ops.metrics import Metrics
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.rpc import (
    compute, panel_store, wire)
from distributed_backtesting_exploration_tpu_torch.rpc.worker import Worker
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import ATOL, RTOL, assert_metrics_match

GRID = parse_grid("fast=3:5,slow=10:14:2")
# A small grid of each strategy the port serves.
GRIDS = {
    "sma_crossover": GRID,
    "bollinger": parse_grid("window=10:20:5,k=1:3"),
    "bollinger_touch": parse_grid("window=8:16:4,k=1:3"),
    "stochastic": parse_grid("window=10:14:2,band=20:40:10"),
    "momentum": parse_grid("lookback=5:21:8"),
    "donchian": parse_grid("window=10:30:10"),
    "donchian_hl": parse_grid("window=8:24:8"),
    "rsi": parse_grid("period=7:21:7,band=15:30:10"),
    "keltner": parse_grid("window=10:20:5,k=1:3"),
    "macd": parse_grid("fast=5:13:4,slow=20:40:10,signal=5:13:4"),
    "trix": parse_grid("span=5:13:4,signal=4:14:5"),
    "obv_trend": parse_grid("window=6:30:8"),
    "vwap_reversion": parse_grid("window=8:20:6,k=1:3"),
}
PAIRS_GRID = parse_grid("lookback=8:20:6,z_entry=1:3")
# The reference's flip-aware budget for the families whose signal EMA or
# cumsums round differently in the two packages (test_torch_fused_ema.py);
# the default torch_parity tolerances for the others.
TOL = {"macd": (2e-3, 2e-4), "trix": (2e-3, 2e-4), "keltner": (2e-3, 2e-4)}


def _specs(recs):
    return [ref_pb.JobSpec(id=r.id, strategy=r.strategy, ohlcv=r.ohlcv,
                           ohlcv2=r.ohlcv2 or b"",
                           grid=ref_wire.grid_to_proto(r.grid), cost=r.cost,
                           periods_per_year=252, trace_id=f"t-{r.id}")
            for r in recs]


def _decoded(completions):
    return {c.job_id: wire.metrics_from_bytes(c.metrics) for c in completions}


def _stack(by_id, ids):
    """Per-job DBXM rows -> one Metrics of (jobs, P) fields."""
    return Metrics(*(np.stack([getattr(by_id[i], f) for i in ids])
                     for f in Metrics._fields))


@pytest.mark.parametrize("bars", [[96], [150, 200]], ids=["uniform", "ragged"])
def test_backend_matches_jax_backend(bars):
    recs = []
    for k, n in enumerate(bars):
        recs += synthetic_jobs(3, n, "sma_crossover", GRID, cost=1e-3,
                               seed=10 + k)
    specs = _specs(recs)
    got = compute.TorchSweepBackend(device="cpu").process(specs)
    want = ref_compute.JaxSweepBackend(use_fused=True).process(specs)
    assert sorted(c.job_id for c in got) == sorted(r.id for r in recs)
    assert all(c.trace_id == f"t-{c.job_id}" for c in got)
    ids = [r.id for r in recs]
    assert_metrics_match(_stack(_decoded(got), ids),
                         _stack(_decoded(want), ids))


def test_backend_routes_mixed_batch_of_ported_strategies():
    # One batch of all thirteen strategies, two payload lengths each in one
    # power-of-two length bucket (2200 and 2500 bytes), so every group is
    # ragged: each takes its fused sweep with t_real, and every block
    # matches the reference backend's.
    recs = []
    for k, (strategy, grid) in enumerate(GRIDS.items()):
        for n in (110, 125):
            recs += synthetic_jobs(1, n, strategy, grid, cost=1e-3,
                                   seed=40 + 2 * k + n)
    specs = _specs(recs)
    got = _decoded(compute.TorchSweepBackend(device="cpu").process(specs))
    want = _decoded(
        ref_compute.JaxSweepBackend(use_fused=True).process(specs))
    assert set(got) == {r.id for r in recs}
    for strategy in GRIDS:
        ids = [r.id for r in recs if r.strategy == strategy]
        rtol, atol = TOL.get(strategy, (RTOL, ATOL))
        assert_metrics_match(_stack(got, ids), _stack(want, ids), rtol=rtol,
                             atol=atol)


@pytest.mark.parametrize("strategy,grid", [
    ("bollinger", {"window": np.float32([9.5, 20.0]),
                   "k": np.float32([1.0, 2.0])}),
    ("momentum", {"lookback": np.float32([4.5, 12.0])}),
    ("donchian_hl", {"window": np.float32([10.0, 300.0])}),
], ids=["non-integral-window", "non-integral-lookback",
        "beyond-view-bound"])
def test_backend_demotes_what_the_kernels_do_not_take(strategy, grid,
                                                      caplog):
    recs = synthetic_jobs(2, 90, strategy, grid, cost=1e-3, seed=8)
    specs = _specs(recs)
    with caplog.at_level("WARNING", logger="dbx.torch.compute"):
        got = compute.TorchSweepBackend(device="cpu").process(specs)
    assert "take the generic path" in caplog.text
    want = ref_compute.JaxSweepBackend(use_fused=True).process(specs)
    ids = [r.id for r in recs]
    assert_metrics_match(_stack(_decoded(got), ids),
                         _stack(_decoded(want), ids))


def test_backend_non_integral_grid_takes_generic_path():
    grid = {"fast": np.float32([3.5, 5.0]), "slow": np.float32([12.25])}
    recs = synthetic_jobs(2, 80, "sma_crossover", grid, cost=1e-3, seed=3)
    specs = _specs(recs)
    got = compute.TorchSweepBackend(device="cpu").process(specs)
    want = ref_compute.JaxSweepBackend(use_fused=True).process(specs)
    ids = [r.id for r in recs]
    assert_metrics_match(_stack(_decoded(got), ids),
                         _stack(_decoded(want), ids))


def _refuse(spec, field, value):
    setattr(spec, field, value)


def _assert_serves_around(refused, good, what, caplog):
    """A batch [refused, good]: the good job's DBXM bytes equal a solo
    run's, the refused job gets no completion, and the log names it and
    why."""
    backend = compute.TorchSweepBackend(device="cpu")
    (solo,) = backend.process([good])
    with caplog.at_level("WARNING", logger="dbx.torch.compute"):
        out = backend.process([refused, good])
    assert [c.job_id for c in out] == [good.id]
    assert out[0].metrics == solo.metrics and out[0].metrics
    refusal = [r.getMessage() for r in caplog.records
               if r.getMessage().startswith(f"job {refused.id} refused")]
    assert len(refusal) == 1 and what in refusal[0]


@pytest.mark.parametrize("field,value,what", [
    ("strategy", "no_such_strategy", "strategy 'no_such_strategy'"),
    ("panel_digest2", "abc", "second leg"),
    ("ohlcv2", b"DBX1", "pairs"),
])
def test_backend_refuses_what_it_does_not_serve(field, value, what, caplog):
    # A refused job no longer blocks its batch: the servable job beside it
    # completes, the refused one stays leased (no completion).
    refused, good = _specs(synthetic_jobs(2, 64, "sma_crossover", GRID))
    _refuse(refused, field, value)
    _assert_serves_around(refused, good, what, caplog)


def test_backend_batch_of_refused_jobs_returns_nothing(caplog):
    specs = _specs(synthetic_jobs(3, 64, "sma_crossover", GRID))
    for spec, (field, value) in zip(specs, [("panel_digest2", "abc"),
                                            ("strategy", "no_such_strategy"),
                                            ("strategy", "nope")]):
        _refuse(spec, field, value)
    with caplog.at_level("WARNING", logger="dbx.torch.compute"):
        assert compute.TorchSweepBackend(device="cpu").process(specs) == []
    assert caplog.text.count("refused") == 3


# Pairs jobs against the reference backend: the reference's pairs budget
# (tests/test_fused.py `_check_pairs`: at most max(1, 1%) flipped cells, the
# rest at rtol=2e-3, atol=2e-4).
def _pairs_match(got, want, ids):
    return assert_metrics_match(_stack(got, ids), _stack(want, ids),
                                rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("bars,grid", [
    ([96], PAIRS_GRID),
    ([110, 125], PAIRS_GRID),
    ([96], {"lookback": np.float32([8.5, 12.0]),
            "z_entry": np.float32([1.0, 2.0])}),
    ([110, 125], {"lookback": np.float32([8.5, 12.0]),
                  "z_entry": np.float32([1.0, 2.0]),
                  "z_exit": np.float32([0.0, 0.5, 0.0, 0.5])}),
], ids=["uniform", "ragged", "demoted-uniform", "demoted-ragged"])
def test_backend_pairs_matches_jax_backend(bars, grid, caplog):
    # Uniform and ragged pairs groups take the fused pairs sweep (with
    # t_real when ragged); non-integral lookbacks take the generic
    # run_pairs_sweep, one job at a time when ragged.
    recs = []
    for k, n in enumerate(bars):
        recs += synthetic_jobs(2, n, "pairs", grid, cost=1e-3, seed=30 + k)
    specs = _specs(recs)
    with caplog.at_level("WARNING", logger="dbx.torch.compute"):
        got = _decoded(compute.TorchSweepBackend(device="cpu").process(specs))
    assert ("take the generic path" in caplog.text) == (
        not float(grid["lookback"][0]).is_integer())
    want = _decoded(
        ref_compute.JaxSweepBackend(use_fused=True).process(specs))
    _pairs_match(got, want, [r.id for r in recs])


def test_backend_completes_malformed_pairs_jobs_empty(caplog):
    # The reference's malformed-pairs case (tests/test_rpc_integration.py):
    # no second leg, or legs of unequal length, completes with an empty
    # metric block and a logged error; the good job is computed.
    grid = {"lookback": np.asarray([8.0], np.float32),
            "z_entry": np.asarray([1.0], np.float32)}
    good = synthetic_jobs(1, 96, "pairs", grid, cost=1e-3, seed=13)[0]
    no_leg = synthetic_jobs(1, 96, "pairs", grid, cost=1e-3, seed=14)[0]
    uneven = synthetic_jobs(1, 96, "pairs", grid, cost=1e-3, seed=16)[0]
    short = data.synthetic_ohlcv(1, 50, seed=15)
    no_leg.ohlcv2 = None
    uneven.ohlcv2 = data.to_wire_bytes(data.OHLCV(*(f[0] for f in short)))
    specs = _specs([good, no_leg, uneven])
    with caplog.at_level("ERROR", logger="dbx.torch.compute"):
        out = {c.job_id: c for c in
               compute.TorchSweepBackend(device="cpu").process(specs)}
    assert set(out) == {good.id, no_leg.id, uneven.id}
    assert out[no_leg.id].metrics == b"" and out[uneven.id].metrics == b""
    assert "no second leg" in caplog.text and "differ in length" in caplog.text
    got = wire.metrics_from_bytes(out[good.id].metrics)
    assert got.sharpe.shape == (1,) and np.isfinite(got.sharpe).all()
    want = ref_compute.JaxSweepBackend(use_fused=True).process(specs)
    want = {c.job_id: c.metrics for c in want}
    assert want[no_leg.id] == b"" and want[uneven.id] == b""
    _pairs_match({good.id: got},
                 {good.id: wire.metrics_from_bytes(want[good.id])},
                 [good.id])


def test_backend_refuses_digest_only_payload():
    # A digest-only payload that no cache holds and no fetcher serves
    # raises (the worker leaves the lease; the re-dispatch ships bytes).
    (spec,) = _specs(synthetic_jobs(1, 64, "sma_crossover", GRID))
    spec.ohlcv = b""
    spec.panel_digest = "d" * 32
    backend = compute.TorchSweepBackend(device="cpu")
    with pytest.raises(ValueError, match="not fetchable"):
        backend.process([spec])
    backend.payload_fetcher = lambda digest: b""
    with pytest.raises(ValueError, match="not fetchable"):
        backend.process([spec])


def _digest_specs(recs, **kw):
    specs = _specs(recs)
    for s in specs:
        s.panel_digest = panel_store.panel_digest(s.ohlcv)
        s.panel_bytes_len = len(s.ohlcv)
        if s.ohlcv2:
            s.panel_digest2 = panel_store.panel_digest(s.ohlcv2)
            s.panel_bytes_len2 = len(s.ohlcv2)
        for k, v in kw.items():
            setattr(s, k, v)
    return specs


def _digest_only(specs):
    out = []
    for s in specs:
        d = type(s)()
        d.CopyFrom(s)
        d.ohlcv = d.ohlcv2 = b""
        out.append(d)
    return out


@pytest.mark.parametrize("strategy,grid,bars", [
    ("sma_crossover", GRID, [96]),
    ("keltner", GRIDS["keltner"], [110, 125]),
    ("pairs", PAIRS_GRID, [96]),
], ids=["sma", "keltner-ragged", "pairs"])
def test_digest_only_batch_is_served_from_the_cache(strategy, grid, bars):
    recs = []
    for i, n in enumerate(bars):
        recs += synthetic_jobs(3, n, strategy, grid, cost=1e-3, seed=80 + i)
    specs = _digest_specs(recs)
    backend = compute.TorchSweepBackend(device="cpu")
    first = backend.process(specs)
    legs = 2 if strategy == "pairs" else 1
    assert backend.decodes == legs * len(specs)
    again = backend.process(_digest_only(specs))
    assert backend.decodes == legs * len(specs)       # no decode at all
    assert [c.metrics for c in again] == [c.metrics for c in first]
    st = backend.panel_cache.stats()
    assert st["hits"]["host"] == legs * len(specs)
    if strategy != "pairs":     # the fused single-asset path stacks on
        assert st["hits"]["device"] == len(specs)     # the device level
        assert st["misses"]["device"] == len(specs)
    assert [c.metrics for c in first] == [
        c.metrics for c in compute.TorchSweepBackend(device="cpu").process(
            _specs(recs))]


def test_digest_only_batch_is_fetched_after_an_eviction():
    recs = synthetic_jobs(3, 96, "sma_crossover", GRID, cost=1e-3, seed=90)
    specs = _digest_specs(recs)
    one_panel = 5 * 96 * 4          # a decoded panel: 5 f32 rows of 96
    backend = compute.TorchSweepBackend(
        device="cpu", panel_cache=compute.PanelCache(max_bytes=one_panel))
    first = backend.process(specs)
    st = backend.panel_cache.stats()
    assert st["host_panels"] == 1 and st["device_panels"] == 1
    blobs = {s.panel_digest: s.ohlcv for s in specs}
    fetched = []
    backend.payload_fetcher = lambda d: fetched.append(d) or blobs[d]
    again = backend.process(_digest_only(specs))
    assert [c.metrics for c in again] == [c.metrics for c in first]
    # The cache keeps one panel: each fetch evicts the next job's.
    assert fetched == [s.panel_digest for s in specs]
    assert backend.decodes == 2 * len(specs)


def test_prefetch_fills_the_host_level_only():
    specs = _digest_specs(synthetic_jobs(3, 80, "sma_crossover", GRID,
                                         seed=91))
    backend = compute.TorchSweepBackend(device="cpu")
    assert backend.prefetch(specs + specs) == 3
    assert backend.prefetch(specs) == 0
    st = backend.panel_cache.stats()
    assert st["host_panels"] == 3 and st["device_panels"] == 0
    backend.process(_digest_only(specs))
    assert backend.decodes == 0
    assert compute.TorchSweepBackend(
        device="cpu", panel_cache=compute.PanelCache(max_bytes=0)).prefetch(
            specs) == 0


@pytest.mark.parametrize("lengths", [[7, 7, 7], [5, 9, 3, 9]],
                         ids=["uniform", "ragged"])
def test_device_stack_equals_the_host_stack(lengths):
    # The device level's stack (hits and misses mixed, ragged groups by one
    # gather) equals _stack_field_ragged's repeat-last host stack exactly.
    panels = [data.OHLCV(*(f[0] for f in data.synthetic_ohlcv(1, T,
                                                              seed=i)))
              for i, T in enumerate(lengths)]
    specs = [ref_pb.JobSpec(id=f"j{i}", panel_digest=f"{i:032x}")
             for i in range(len(panels))]
    backend = compute.TorchSweepBackend(device="cpu")
    fields = ("close", "high", "volume")
    for half in (specs[:1], specs):       # the second call mixes hits in
        n = len(half)
        got = backend._device_fields(half, panels[:n], fields, lengths[:n])
        for f in fields:
            want = compute._stack_field_ragged(panels[:n], max(lengths[:n]),
                                               f)
            np.testing.assert_array_equal(np.asarray(got[f]), want)
    assert backend.panel_cache.stats()["hits"]["device"] == 1


@pytest.mark.parametrize("lengths", [[7, 7, 7, 7], [5, 9, 3, 9]],
                         ids=["uniform", "ragged"])
def test_device_level_holds_only_the_bytes_it_charges(lengths):
    # A group of misses is uploaded in one copy; after the level evicts
    # part of the group, the storage its blocks keep alive must be the
    # bytes it charges (a view of the upload would keep all of it).
    panels = [data.OHLCV(*(f[0] for f in data.synthetic_ohlcv(1, T,
                                                              seed=i)))
              for i, T in enumerate(lengths)]
    specs = [ref_pb.JobSpec(id=f"j{i}", panel_digest=f"{i:032x}")
             for i in range(len(panels))]
    budget = 5 * 4 * sum(lengths[-2:])        # the last two blocks
    cache = compute.PanelCache(max_bytes=budget)
    backend = compute.TorchSweepBackend(device="cpu", panel_cache=cache)
    backend._device_fields(specs, panels, ("close",), lengths)
    st = cache.stats()
    assert st["device_panels"] == 2 and st["device_bytes"] == budget
    blocks = [cache.get_device(s.panel_digest) for s in specs[-2:]]
    storages = {b.untyped_storage().data_ptr(): b.untyped_storage().nbytes()
                for b in blocks}
    assert len(storages) == 2
    assert sum(storages.values()) == st["device_bytes"] <= budget
    assert all(b.untyped_storage().nbytes() == b.nbytes for b in blocks)


def test_panel_cache_survives_concurrent_use():
    # More threads than cores, a short switch interval: every get is
    # counted once, and the byte accounting matches what is resident.
    import sys

    cache = compute.PanelCache(max_bytes=40 * 24)
    panels = [data.OHLCV(*(np.zeros(6, np.float32) for _ in range(5)))
              for _ in range(64)]
    gets = 0
    lock = threading.Lock()

    def hammer(seed):
        nonlocal gets
        rng = np.random.default_rng(seed)
        for _ in range(300):
            d = f"{int(rng.integers(64)):032x}"
            if cache.get_series(d) is None:
                cache.put_series(d, panels[int(d, 16)])
            cache.put_device(d, object(), 24)
            cache.get_device(d)
            with lock:
                gets += 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    st = cache.stats()
    assert st["hits"]["host"] + st["misses"]["host"] == gets
    assert st["hits"]["device"] + st["misses"]["device"] == gets
    assert st["host_bytes"] == 120 * st["host_panels"] <= 40 * 24
    assert st["device_bytes"] == 24 * st["device_panels"] <= 40 * 24


def test_panel_cache_budget_is_read_when_made(monkeypatch):
    monkeypatch.setenv("DBX_PANEL_CACHE_MB", "0.5")
    assert compute.cache_max_bytes() == 512 * 1024
    assert compute.PanelCache().max_bytes == 512 * 1024
    monkeypatch.delenv("DBX_PANEL_CACHE_MB")
    assert compute.PanelCache().max_bytes == 256 * 1024 * 1024


def test_stack_field_ragged_repeats_last_bar():
    series = [data.OHLCV(*(f[0] for f in data.synthetic_ohlcv(1, T, seed=T)))
              for T in (5, 3)]
    out = compute._stack_field_ragged(series, 6)
    np.testing.assert_array_equal(out[1, :3], series[1].close)
    assert (out[1, 3:] == series[1].close[-1]).all()
    assert (out[0, 5:] == series[0].close[-1]).all()


def test_worker_drains_reference_dispatcher():
    recs = synthetic_jobs(5, 128, "sma_crossover", GRID, cost=1e-3, seed=5)
    recs += synthetic_jobs(2, 128, "bollinger", GRIDS["bollinger"],
                           cost=1e-3, seed=6)
    queue = JobQueue()
    for rec in recs:
        queue.enqueue(rec)
    disp = Dispatcher(queue, PeerRegistry(prune_window_s=10.0))
    srv = DispatcherServer(disp, bind="localhost:0",
                           prune_interval_s=0.1).start()
    w = Worker(f"localhost:{srv.port}",
               compute.TorchSweepBackend(device="cpu"), poll_interval_s=0.02,
               status_interval_s=0.05, jobs_per_chip=2)
    t = threading.Thread(target=lambda: w.run(max_idle_polls=10),
                         daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 60.0
        while not queue.drained and time.monotonic() < deadline:
            time.sleep(0.02)
        assert queue.drained, queue.stats()
    finally:
        w.stop()
        t.join(timeout=10)
        srv.stop()
    assert not t.is_alive()
    s = queue.stats()
    assert s["jobs_completed"] == 7 and s["jobs_pending"] == 0
    assert w.jobs_completed == 7 and w.completions_dropped == 0

    # The stored DBXM blocks equal a direct sweep of the same jobs.
    for rec in recs:
        series = data.from_wire_bytes(rec.ohlcv)
        axes = dict(sorted(rec.grid.items()))   # canonical DBXM order
        want = sweep.run_sweep(data.OHLCV(*(f[None, :] for f in series)),
                               get_strategy(rec.strategy),
                               sweep.product_grid(**axes), cost=1e-3,
                               device="cpu")
        got = wire.metrics_from_bytes(disp.results[rec.id])
        assert_metrics_match(Metrics(*(f[None, :] for f in got)), want)


def test_worker_drains_reference_dispatcher_volume_and_pairs():
    # The port's worker drains obv_trend, vwap_reversion and pairs jobs
    # (second legs included) from a reference dispatcher; every stored
    # block matches the reference backend on the same jobs.
    recs = synthetic_jobs(3, 128, "obv_trend", GRIDS["obv_trend"],
                          cost=1e-3, seed=21)
    recs += synthetic_jobs(2, 128, "vwap_reversion",
                           GRIDS["vwap_reversion"], cost=1e-3, seed=22)
    recs += synthetic_jobs(2, 128, "pairs", PAIRS_GRID, cost=1e-3, seed=23)
    queue = JobQueue()
    for rec in recs:
        queue.enqueue(rec)
    disp = Dispatcher(queue, PeerRegistry(prune_window_s=10.0))
    srv = DispatcherServer(disp, bind="localhost:0",
                           prune_interval_s=0.1).start()
    w = Worker(f"localhost:{srv.port}",
               compute.TorchSweepBackend(device="cpu"), poll_interval_s=0.02,
               status_interval_s=0.05, jobs_per_chip=4)
    t = threading.Thread(target=lambda: w.run(max_idle_polls=10),
                         daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 60.0
        while not queue.drained and time.monotonic() < deadline:
            time.sleep(0.02)
        assert queue.drained, queue.stats()
    finally:
        w.stop()
        t.join(timeout=10)
        srv.stop()
    assert not t.is_alive()
    assert queue.stats()["jobs_completed"] == len(recs)
    assert w.jobs_completed == len(recs) and w.completions_dropped == 0

    got = {r.id: wire.metrics_from_bytes(disp.results[r.id]) for r in recs}
    want = _decoded(
        ref_compute.JaxSweepBackend(use_fused=True).process(_specs(recs)))
    for strategy in ("obv_trend", "vwap_reversion"):
        ids = [r.id for r in recs if r.strategy == strategy]
        assert_metrics_match(_stack(got, ids), _stack(want, ids))
    _pairs_match(got, want, [r.id for r in recs if r.strategy == "pairs"])
