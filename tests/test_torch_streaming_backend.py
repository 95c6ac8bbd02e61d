"""Streaming append jobs through the port's backend and worker.

``TorchSweepBackend(device="cpu")`` serves an append chain (a checkpoint
miss repriced in full, then a carry hit advanced in O(ΔT), then a retried
delivery served as stored) with blocks held against
``JaxSweepBackend(use_fused=True)`` on the same JobSpecs under
``torch_parity``'s flip rule and against the port's cold build; pairs
appends, unknown families and grids a family cannot price complete empty
with the reference's logged error; a delta-only append is spliced onto the
cached base panel, and the worker does not fetch its extended panel. Last,
the JAX dispatcher's ``AppendBars`` chain on ``localhost:0`` drained by
the port's gRPC worker (the reference's
``tests/test_rpc_integration.py::test_append_bars_stream_serves_carry_hits_and_matches_cold``).
"""

import threading
import time

import numpy as np
import pytest

from distributed_backtesting_exploration_tpu.rpc import (
    backtesting_pb2 as ref_pb, compute as ref_compute, service as ref_service,
    wire as ref_wire)
from distributed_backtesting_exploration_tpu.rpc.dispatcher import (
    Dispatcher, DispatcherServer, JobQueue, JobRecord, PeerRegistry,
    parse_grid)
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.rpc import (
    compute, panel_store, wire)
from distributed_backtesting_exploration_tpu_torch.rpc.worker import Worker
from distributed_backtesting_exploration_tpu_torch.streaming import (
    CarryStore, recurrent as rc)
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import assert_metrics_match

GRIDS = {"sma_crossover": parse_grid("fast=3:5,slow=10:14:2"),
         "rsi": parse_grid("period=5:9:3,band=10:30:10"),
         "macd": parse_grid("fast=3:6:2,slow=8:13:4,signal=4:5")}
BASE, DT = 128, 16
_FULL = data.synthetic_ohlcv(1, BASE + 2 * DT, seed=42)


def _cut(lo, hi, full=_FULL):
    return data.to_wire_bytes(
        data.OHLCV(*(np.asarray(f[0, lo:hi]) for f in full)))


def _append_spec(job_id, strategy, hi, *, delta_only=False, cost=1e-3,
                 full=_FULL, grid=None):
    """The append job the dispatcher makes for bars ``[hi - DT, hi)``."""
    lo = hi - DT
    ext = _cut(0, hi, full)
    return ref_pb.JobSpec(
        id=job_id, strategy=strategy, ohlcv=b"" if delta_only else ext,
        panel_digest=panel_store.panel_digest(ext),
        append_parent_digest=panel_store.panel_digest(_cut(0, lo, full)),
        append_base_len=lo, append_delta=_cut(lo, hi, full),
        grid=ref_wire.grid_to_proto(grid or GRIDS[strategy]), cost=cost,
        periods_per_year=252)


def _cold(strategy, n_bars, cost=1e-3):
    grid = sweep.product_grid(**wire.grid_from_proto(
        ref_wire.grid_to_proto(GRIDS[strategy])))
    fields = {f: np.asarray(getattr(_FULL, f))[:, :n_bars]
              for f in rc.stream_fields(strategy)}
    return rc.finalize(rc.build_carry(strategy, fields, grid, cost=cost,
                                      device="cpu"))


def _metrics(completion):
    return wire.metrics_from_bytes(completion.metrics)


def _row(m):
    return type(m)(*(np.asarray(f)[None] for f in m))


@pytest.mark.parametrize("strategy", sorted(GRIDS))
def test_append_chain_miss_hit_retry(strategy):
    specs = [_append_spec("a1", strategy, BASE + DT),
             _append_spec("a2", strategy, BASE + 2 * DT)]
    backend = compute.TorchSweepBackend(device="cpu")
    (c1,) = backend.process(specs[:1])
    assert backend.appends == {"carry_hit": 0, "full_reprice": 1}
    (c2,) = backend.process(specs[1:])
    assert backend.appends == {"carry_hit": 1, "full_reprice": 1}
    assert backend.advances == 1
    (again,) = backend.process(specs[1:])         # a retried delivery
    assert backend.appends == {"carry_hit": 2, "full_reprice": 1}
    assert backend.advances == 1
    assert again.metrics == c2.metrics
    # One checkpoint a stream: the advanced parent was dropped.
    st = backend.stats()
    assert st["carry"]["device_carries"] == 1 == st["carry"]["host_carries"]
    assert st["appends"] == backend.appends
    grid = {k: v.numpy() for k, v in sweep.product_grid(
        **wire.grid_from_proto(specs[0].grid)).items()}
    skey = rc.stream_key(strategy, grid, 1e-3, 252)
    assert backend.carry_store.get((specs[1].panel_digest, skey)) is not None
    assert backend.carry_store.get((specs[0].panel_digest, skey)) is None

    ref = {c.job_id: c.metrics for c in
           ref_compute.JaxSweepBackend(use_fused=True).process(specs)}
    for c, n_bars in ((c1, BASE + DT), (c2, BASE + 2 * DT)):
        got = _metrics(c)
        assert_metrics_match(_row(got), _row(ref_wire.metrics_from_bytes(
            ref[c.job_id])))
        cold = _cold(strategy, n_bars)
        assert_metrics_match(_row(got), type(got)(
            *(f.numpy() for f in cold)))


def test_append_after_an_eviction_is_a_counted_full_reprice():
    specs = [_append_spec("e1", "sma_crossover", BASE + DT),
             _append_spec("e2", "sma_crossover", BASE + 2 * DT)]
    keep = compute.TorchSweepBackend(device="cpu")
    want = keep.process(specs[:1]) + keep.process(specs[1:])
    none = compute.TorchSweepBackend(
        device="cpu", carry_store=CarryStore(max_bytes=0, device="cpu"))
    got = none.process(specs[:1]) + none.process(specs[1:])
    assert none.appends == {"carry_hit": 0, "full_reprice": 2}
    assert keep.appends == {"carry_hit": 1, "full_reprice": 1}
    assert got[0].metrics == want[0].metrics
    assert_metrics_match(_row(_metrics(got[1])), _row(_metrics(want[1])))


def test_invalid_appends_complete_empty(caplog):
    pairs = _append_spec("p1", "sma_crossover", BASE + DT)
    pairs.strategy = "pairs"
    unknown = _append_spec("u1", "sma_crossover", BASE + DT)
    unknown.strategy = "no_such_family"
    bad_grid = _append_spec("g1", "sma_crossover", BASE + DT,
                            grid=parse_grid("window=5:9:2"))
    good = _append_spec("ok", "sma_crossover", BASE + DT)
    backend = compute.TorchSweepBackend(device="cpu")
    with caplog.at_level("ERROR", logger="dbx.torch.compute"):
        out = backend.process([pairs, unknown, bad_grid, good])
    by_id = {c.job_id: c.metrics for c in out}
    assert set(by_id) == {"p1", "u1", "g1", "ok"}
    assert by_id["p1"] == by_id["u1"] == by_id["g1"] == b""
    assert wire.result_kind(by_id["ok"]) == "metrics"
    text = caplog.text
    assert "append job p1: strategy 'pairs' is not streamable" in text
    assert "append job u1: strategy 'no_such_family' is not streamable" \
        in text
    assert "append job g1:" in text and "completing with empty" in text
    assert backend.appends == {"carry_hit": 0, "full_reprice": 1}


def test_delta_only_append_is_spliced_onto_the_cached_base():
    inline = _append_spec("i1", "sma_crossover", BASE + DT)
    delta_only = _append_spec("d1", "sma_crossover", BASE + DT,
                              delta_only=True)
    (want,) = compute.TorchSweepBackend(device="cpu").process([inline])
    backend = compute.TorchSweepBackend(device="cpu")
    # The base panel reached this worker earlier (a plain job of it).
    base = _cut(0, BASE)
    backend.process([ref_pb.JobSpec(
        id="base", strategy="sma_crossover", ohlcv=base,
        panel_digest=panel_store.panel_digest(base),
        grid=ref_wire.grid_to_proto(GRIDS["sma_crossover"]))])
    decodes = backend.decodes
    (got,) = backend.process([delta_only])
    assert got.metrics == want.metrics
    assert backend.decodes == decodes           # spliced, not decoded
    assert backend.panel_cache.contains_series(delta_only.panel_digest)
    # Without the base, a delta-only append cannot be served: it raises
    # and its lease re-queues it.
    with pytest.raises(ValueError, match="digest-only"):
        compute.TorchSweepBackend(device="cpu").process([delta_only])


def test_prefetch_skips_append_jobs():
    backend = compute.TorchSweepBackend(device="cpu")
    assert backend.prefetch([_append_spec("x", "sma_crossover",
                                          BASE + DT)]) == 0
    assert backend.panel_cache.stats()["host_panels"] == 0


def test_resolve_payloads_does_not_fetch_a_delta_only_extension():
    backend = compute.TorchSweepBackend(device="cpu")
    w = Worker("localhost:1", backend)
    fetched = []
    w._fetch_payload = lambda stub, digest: fetched.append(digest) or b"X"
    job = _append_spec("d", "sma_crossover", BASE + DT, delta_only=True)
    w._resolve_payloads(None, [job])           # base not cached: fetch
    assert fetched == [job.panel_digest] and job.ohlcv == b"X"
    job = _append_spec("d", "sma_crossover", BASE + DT, delta_only=True)
    backend.panel_cache.put_series(job.append_parent_digest,
                                   data.from_wire_bytes(_cut(0, BASE)))
    w._resolve_payloads(None, [job])           # base cached: the splice
    assert len(fetched) == 1 and job.ohlcv == b""


def _wait(pred, timeout=60.0, msg="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def test_worker_serves_the_dispatchers_append_bars_chain(tmp_path):
    """The reference dispatcher's AppendBars chain drained by the port's
    worker: the cold job leaves no checkpoint, so append 1 reprices in full
    (and stores its carry), append 2 advances it; both match the cold
    build at their lengths."""
    grid = GRIDS["sma_crossover"]
    full = data.synthetic_ohlcv(1, 160, seed=42)
    rec = JobRecord(id="stream-base", strategy="sma_crossover", grid=grid,
                    ohlcv=_cut(0, 128, full))
    queue = JobQueue()
    queue.enqueue(rec)
    disp = Dispatcher(queue, PeerRegistry(prune_window_s=10.0),
                      results_dir=str(tmp_path / "results"))
    srv = DispatcherServer(disp, bind="localhost:0",
                           prune_interval_s=0.1).start()
    backend = compute.TorchSweepBackend(device="cpu")
    w = Worker(f"localhost:{srv.port}", backend, poll_interval_s=0.02,
               status_interval_s=0.05)
    t = threading.Thread(target=w.run, daemon=True)
    t.start()
    import grpc
    channel = grpc.insecure_channel(
        f"localhost:{srv.port}",
        options=ref_service.default_channel_options())
    stub = ref_service.DispatcherStub(channel)
    tmpl = ref_pb.JobSpec(strategy="sma_crossover",
                          grid=ref_wire.grid_to_proto(grid), cost=0.0,
                          periods_per_year=252)
    try:
        _wait(lambda: queue.drained, msg="base job drained")
        r1 = stub.AppendBars(ref_pb.AppendRequest(
            worker_id="feed", panel_digest=rec.panel_digest, base_len=128,
            delta=_cut(128, 144, full), job=tmpl))
        assert r1.ok and r1.new_len == 144
        _wait(lambda: queue.drained, msg="append 1 drained")
        r2 = stub.AppendBars(ref_pb.AppendRequest(
            worker_id="feed", panel_digest=r1.panel_digest, base_len=144,
            delta=_cut(144, 160, full), job=tmpl))
        assert r2.ok and r2.new_len == 160
        _wait(lambda: queue.drained, msg="append 2 drained")
    finally:
        w.stop()
        t.join(timeout=30)
        channel.close()
        srv.stop()
    assert not t.is_alive()
    assert queue.stats()["jobs_failed"] == 0
    assert backend.appends == {"carry_hit": 1, "full_reprice": 1}
    g = sweep.product_grid(**wire.grid_from_proto(
        ref_wire.grid_to_proto(grid)))
    for reply, n_bars in ((r1, 144), (r2, 160)):
        got = wire.metrics_from_bytes(
            (tmp_path / "results" / f"{reply.job_id}.dbxm").read_bytes())
        want = rc.finalize(rc.build_carry(
            "sma_crossover", {"close": np.asarray(full.close)[:, :n_bars]},
            g, device="cpu"))
        for name in want._fields:
            np.testing.assert_allclose(
                np.asarray(getattr(got, name)),
                getattr(want, name).numpy()[0], rtol=2e-5, atol=2e-6,
                err_msg=f"{n_bars}:{name}")
