"""The port worker's CLI and channel parity with the reference worker, on
the CPU.

- ``make_backend``'s choices (``torch``, ``instant``, ``sleep``), and the
  CLI's ``--backend``, ``--param-chunk``, ``--fused`` and ``--mesh``
  mapped as the reference's ``main`` maps them.
- ``--fused off``: every group on the generic sweep, bit-equal to
  ``run_sweep`` on the same stack and within ``tests/torch_parity.py``'s
  flip rule of the JAX ``JaxSweepBackend(use_fused=False)``; walk-forward
  groups on the generic refit, pairs generic, no scenario spec batches.
- ``--param-chunk`` (chunks where they divide the grid, bit-equal to
  ``chunked_sweep`` on the same stack) and ``--mesh off``.
- ``_Channel`` on the native queue: batches and completions round-trip
  bit for bit, as through the reference's, and it is bounded.
- Deferred completions on the reference's fake stubs: a ``CompleteJobs``
  that fails twice then succeeds is delivered after its backoff, the
  ``dbx_worker_deferred_completions`` gauge rising and falling, nothing
  dropped; one that always fails is dropped after its last retry, counted
  as the reference counts it.
- One log line per disconnect and reconnect edge.
"""

import queue
import time
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

from distributed_backtesting_exploration_tpu import obs as ref_obs
from distributed_backtesting_exploration_tpu.rpc import (
    backtesting_pb2 as ref_pb, compute as ref_compute, wire as ref_wire,
    worker as ref_worker)
from distributed_backtesting_exploration_tpu_torch import obs
from distributed_backtesting_exploration_tpu_torch.models import (
    get_strategy)
from distributed_backtesting_exploration_tpu_torch.parallel import (
    sharding, sweep)
from distributed_backtesting_exploration_tpu_torch.rpc import (
    backtesting_pb2 as pb, compute, wire, worker)
from distributed_backtesting_exploration_tpu_torch.runtime import _core
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import assert_metrics_match, reference_native_core

AXES = {"fast": np.arange(3.0, 7.0, dtype=np.float32),
        "slow": np.arange(10.0, 18.0, 2.0, dtype=np.float32)}   # 16 combos
N, BARS, COST = 4, 96, 1e-3


def _specs(strategy="sma_crossover", axes=AXES, n=N, bars=BARS, seed=5,
           **kw) -> list:
    panel = data.synthetic_ohlcv(n, bars, seed=seed)
    return [pb.JobSpec(id=f"j{i}", strategy=strategy,
                       ohlcv=data.to_wire_bytes(data.OHLCV(
                           *(np.asarray(f[i]) for f in panel))),
                       grid=wire.grid_to_proto(axes), cost=COST,
                       periods_per_year=252, **kw) for i in range(n)]


def _ref(specs) -> list:
    return [ref_pb.JobSpec.FromString(s.SerializeToString()) for s in specs]


def _blocks(backend, specs) -> dict:
    return {c.job_id: c.metrics for c in backend.process(specs)}


class _Unavailable(grpc.RpcError):
    def code(self):
        return grpc.StatusCode.UNAVAILABLE


# --- the backend and the CLI ----------------------------------------------


def test_make_backend_choices():
    b = worker.make_backend("torch", device="cpu", use_fused=False,
                            use_mesh=False, param_chunk=4)
    assert isinstance(b, compute.TorchSweepBackend)
    assert b.use_fused is False and b.param_chunk == 4 and b.mesh is None
    auto = worker.make_backend("torch", device="cpu")
    assert auto.use_fused is True and auto.param_chunk is None
    assert isinstance(worker.make_backend("instant"), compute.InstantBackend)
    sleep = worker.make_backend("sleep", delay_s=0.01)
    assert isinstance(sleep, compute.SleepBackend) and sleep.delay_s == 0.01
    with pytest.raises(ValueError, match="unknown backend"):
        worker.make_backend("jax")
    # The reference forwards the same flags to its engine.
    ref = ref_worker.make_backend("jax", use_fused=False, use_mesh=False,
                                  param_chunk=4)
    assert ref.use_fused is False and ref.param_chunk == 4


def test_sleep_backend_is_the_references():
    specs = _specs(n=2)
    t0 = time.perf_counter()
    got = compute.SleepBackend(0.02).process(specs)
    assert time.perf_counter() - t0 >= 0.04
    want = ref_compute.SleepBackend(0.02).process(_ref(specs))
    assert ([(c.job_id, c.metrics, c.elapsed_s) for c in got]
            == [(c.job_id, c.metrics, c.elapsed_s) for c in want])


@pytest.mark.parametrize("argv, want", [
    ([], ("torch", dict(device="cuda", param_chunk=None, use_fused=None,
                        use_mesh=None))),
    (["--backend", "torch", "--device", "cpu", "--fused", "off", "--mesh",
      "on", "--param-chunk", "4"],
     ("torch", dict(device="cpu", param_chunk=4, use_fused=False,
                    use_mesh=True))),
    (["--backend", "instant", "--fused", "on", "--mesh", "off"],
     ("instant", dict(device="cuda", param_chunk=None, use_fused=True,
                      use_mesh=False))),
], ids=["defaults", "torch-flags", "instant"])
def test_cli_maps_its_flags_as_the_reference_does(monkeypatch, argv, want):
    seen = {}

    def record(mod):
        def make(name, **kw):
            seen[mod] = (name, kw)
            return compute.InstantBackend()
        return make

    monkeypatch.setattr(worker, "make_backend", record("port"))
    monkeypatch.setattr(worker.Worker, "run", lambda self, **kw: None)
    worker.main(["--connect", "localhost:1", *argv])
    assert seen["port"] == want
    # The reference's CLI, given the same flags (its backend named jax),
    # maps --fused, --mesh and --param-chunk the same way.
    monkeypatch.setattr(ref_worker, "make_backend", record("ref"))
    monkeypatch.setattr(ref_worker.Worker, "run", lambda self, **kw: None)
    ref_argv = [a for a in argv if a not in ("--device", "cpu")]
    ref_argv = ["jax" if a == "torch" else a for a in ref_argv]
    ref_worker.main(["--connect", "localhost:1", *ref_argv])
    name, kw = seen["ref"]
    assert name == ("jax" if want[0] == "torch" else want[0])
    assert kw == {k: v for k, v in want[1].items() if k != "device"}


def test_fused_off_takes_the_generic_sweep(monkeypatch):
    specs = _specs()
    backend = compute.TorchSweepBackend(device="cpu", use_fused=False)

    def no_fused(*a, **k):
        raise AssertionError("use_fused=False ran a fused sweep")

    monkeypatch.setattr(backend, "_submit_fused", no_fused)
    got = _blocks(backend, specs)
    series = [data.from_wire_bytes(s.ohlcv) for s in specs]
    batch, _, mask = data.pad_and_stack(series)
    m = sweep.run_sweep(batch, get_strategy("sma_crossover"),
                        sweep.product_grid(**AXES), cost=COST, bar_mask=mask,
                        device="cpu")
    for i, s in enumerate(specs):
        row = wire.metrics_from_bytes(got[s.id])
        for f, g in zip(row, m):
            np.testing.assert_array_equal(f, g[i].numpy())
    ref = _blocks(ref_compute.JaxSweepBackend(use_fused=False), _ref(specs))
    for jid, blob in got.items():
        assert_metrics_match(wire.metrics_from_bytes(blob),
                             ref_wire.metrics_from_bytes(ref[jid]))
    # The fused route gives the same combos another way.
    fused_blocks = _blocks(compute.TorchSweepBackend(device="cpu"), specs)
    for jid, blob in got.items():
        assert_metrics_match(wire.metrics_from_bytes(blob),
                             wire.metrics_from_bytes(fused_blocks[jid]))


def test_fused_off_routes_walkforward_pairs_and_scenarios(monkeypatch):
    backend = compute.TorchSweepBackend(device="cpu", use_fused=False)
    backend._WF_FUSED_MIN_COMBOS = 1
    assert backend.accepts_scenario_batch is False
    assert backend.use_paged is False
    assert backend.telemetry()["caps"]["fused"] is False
    called = []
    from distributed_backtesting_exploration_tpu_torch.ops import fused
    from distributed_backtesting_exploration_tpu_torch.parallel import (
        walkforward)
    monkeypatch.setattr(walkforward, "walk_forward_fused",
                        lambda *a, **k: called.append("wf_fused"))
    monkeypatch.setattr(fused, "fused_pairs_sweep",
                        lambda *a, **k: called.append("pairs_fused"))
    wf = _specs(n=2, bars=160, wf_train=60, wf_test=20, wf_metric="sharpe")
    out = backend.process(wf)
    assert len(out) == 2 and all(c.metrics for c in out)
    legs = data.synthetic_ohlcv(4, BARS, seed=9)

    def leg(i):
        return data.to_wire_bytes(data.OHLCV(*(np.asarray(f[i])
                                               for f in legs)))

    pairs = [pb.JobSpec(id=f"p{i}", strategy="pairs", ohlcv=leg(2 * i),
                        ohlcv2=leg(2 * i + 1), grid=wire.grid_to_proto(
                            {"lookback": np.asarray([10.0, 20.0],
                                                    np.float32),
                             "z_entry": np.asarray([1.0, 2.0], np.float32)}),
                        cost=COST, periods_per_year=252) for i in range(2)]
    out = backend.process(pairs)
    assert len(out) == 2 and all(c.metrics for c in out)
    assert called == []


def test_param_chunk_splits_the_generic_sweep_where_it_divides():
    specs = _specs()
    whole = _blocks(compute.TorchSweepBackend(device="cpu", use_fused=False),
                    specs)
    calls = []
    real = sweep.chunked_sweep

    def spy(*a, **k):
        calls.append(k["param_chunk"])
        return real(*a, **k)

    chunked = compute.TorchSweepBackend(device="cpu", use_fused=False,
                                        param_chunk=4)
    sweep.chunked_sweep = spy
    try:
        got = _blocks(chunked, specs)
        # 16 combos: a chunk of 5 does not divide them, so no chunks (the
        # reference's rule).
        odd = _blocks(compute.TorchSweepBackend(
            device="cpu", use_fused=False, param_chunk=5), specs)
    finally:
        sweep.chunked_sweep = real
    assert calls == [4]
    assert odd == whole
    # Bit-equal to the chunked sweep called directly on the same stack;
    # torch's CPU reductions take another order on another grid width, so
    # against the whole grid within the flip rule.
    series = [data.from_wire_bytes(s.ohlcv) for s in specs]
    batch, _, mask = data.pad_and_stack(series)
    m = real(batch, get_strategy("sma_crossover"), sweep.product_grid(**AXES),
             param_chunk=4, cost=COST, bar_mask=mask, device="cpu")
    for i, s in enumerate(specs):
        row = wire.metrics_from_bytes(got[s.id])
        for f, g in zip(row, m):
            np.testing.assert_array_equal(f, g[i].numpy())
        assert_metrics_match(row, wire.metrics_from_bytes(whole[s.id]))
    ref = _blocks(ref_compute.JaxSweepBackend(use_fused=False,
                                              param_chunk=4), _ref(specs))
    for jid, blob in got.items():
        assert_metrics_match(wire.metrics_from_bytes(blob),
                             ref_wire.metrics_from_bytes(ref[jid]))


def test_mesh_off_gives_no_mesh_where_auto_gives_one(monkeypatch):
    mesh = sharding.make_mesh(["cpu"] * 2)
    monkeypatch.setattr(compute, "default_mesh", lambda device: mesh)
    assert compute.TorchSweepBackend(device="cpu").mesh is mesh
    assert compute.TorchSweepBackend(device="cpu", use_mesh=True).mesh is mesh
    off = compute.TorchSweepBackend(device="cpu", use_mesh=False)
    assert off.mesh is None and off.chips == 1
    with pytest.raises(ValueError, match="use_mesh=False"):
        compute.TorchSweepBackend(device="cpu", mesh=mesh, use_mesh=False)
    # A meshed backend's chunked generic sweep agrees with the meshless
    # one's (torch's CPU reductions order by the shard's shape).
    specs = _specs()
    meshed = compute.TorchSweepBackend(device="cpu", use_fused=False,
                                       param_chunk=4)
    assert meshed.mesh is mesh
    got = _blocks(meshed, specs)
    want = _blocks(compute.TorchSweepBackend(device="cpu", use_fused=False,
                                             use_mesh=False), specs)
    assert got.keys() == want.keys()
    for jid, blob in got.items():
        assert_metrics_match(wire.metrics_from_bytes(blob),
                             wire.metrics_from_bytes(want[jid]))


# --- the channels ---------------------------------------------------------


@pytest.mark.skipif(not _core.available(),
                    reason="the native core needs g++")
def test_channel_is_native_and_round_trips_bit_for_bit():
    reference_native_core()
    w = worker.Worker("localhost:1", compute.InstantBackend())
    ref = ref_worker.Worker("localhost:1", ref_compute.InstantBackend())
    assert w._in.backend == w._out.backend == "native" == ref._in.backend
    assert w.stats()["channel"] == "native"
    batch = _specs(n=3, top_k=2, rank_metric="sharpe")
    w._in.put(batch)
    ref._in.put(_ref(batch))
    got, want = w._in.get(), ref._in.get()

    def wire_bytes(jobs):
        # Deterministic: a map field's entries serialize in key order.
        return [j.SerializeToString(deterministic=True) for j in jobs]

    assert wire_bytes(got) == wire_bytes(batch) == wire_bytes(want)
    w._in.put(None)
    assert w._in.get() is None
    done = [compute.Completion("a", b"\x00\x01blob", 0.25, trace_id="t1"),
            compute.Completion("b", b"", 0.0)]
    for c in done:
        w._out.put(c)
        ref._out.put(ref_compute.Completion(c.job_id, c.metrics, c.elapsed_s,
                                            trace_id=c.trace_id))
    for c in done:
        g, r = w._out.get_nowait(), ref._out.get_nowait()
        assert ((g.job_id, g.metrics, g.elapsed_s, g.trace_id)
                == (c.job_id, c.metrics, c.elapsed_s, c.trace_id)
                == (r.job_id, r.metrics, r.elapsed_s, r.trace_id))
    with pytest.raises(queue.Empty):
        w._out.get_nowait()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_channel_is_bounded_as_the_references(monkeypatch, native):
    if native and not _core.available():
        pytest.skip("the native core needs g++")
    if native:
        reference_native_core()
    else:
        monkeypatch.setattr(worker.native_core, "available", lambda: False)
        monkeypatch.setattr(ref_worker.native_core, "available",
                            lambda: False)
    port = worker._Channel(2, worker._encode_batch, worker._decode_batch)
    ref = ref_worker._Channel(2, ref_worker._encode_batch,
                              ref_worker._decode_batch)
    assert port.backend == ref.backend == ("native" if native else "python")
    seen = []
    for ch in (port, ref):
        states = [(ch.full(), ch.empty(), ch.qsize() if ch is port
                   else ch.depth())]
        for _ in range(2):
            ch.put([])
            states.append((ch.full(), ch.empty(),
                           ch.qsize() if ch is port else ch.depth()))
        seen.append(states)
    assert seen[0] == seen[1] == [(False, True, 0), (False, False, 1),
                                  (True, False, 2)]


# --- deferred completions ------------------------------------------------


class _FlakyStub:
    def __init__(self, fail: int, reply):
        self.fail = fail
        self.reply = reply
        self.calls = []

    def CompleteJobs(self, req, timeout=None):
        self.calls.append([i.id for i in req.items])
        if self.fail:
            self.fail -= 1
            raise _Unavailable()
        return self.reply(accepted=len(req.items), unknown_ids=[])


def _force_due(w):
    w._deferred = [(time.monotonic() - 1, a, c) for _, a, c in w._deferred]


def _port_worker():
    w = worker.Worker("localhost:1", compute.InstantBackend(),
                      registry=obs.Registry())
    w._start_gauges()
    return w


def _deferred_gauge(w) -> float:
    w._collect_gauges(w.obs)
    return w._gauges["deferred"].value


def test_a_completion_failing_twice_is_delivered_after_its_backoff():
    w = _port_worker()
    ref = ref_worker.Worker("localhost:1", ref_compute.InstantBackend(),
                            registry=ref_obs.Registry())
    ref._next_status = time.monotonic() + 60.0     # its heartbeat not due
    stubs = (_FlakyStub(2, SimpleNamespace), _FlakyStub(2, SimpleNamespace))
    gauges = []
    try:
        for wk, stub, comp in ((w, stubs[0], compute.Completion),
                               (ref, stubs[1], ref_compute.Completion)):
            wk._out.put(comp("j1", b"", 0.0))
            t0 = time.monotonic()
            wk._drain_completions(stub)          # attempt 1 fails: parks
            assert time.monotonic() - t0 < 0.2, "the drain must not sleep"
            assert len(wk._deferred) == 1 and wk.jobs_completed == 0
            due = wk._deferred[0][0] - time.monotonic()
            assert 0.0 < due <= wk._COMPLETION_BACKOFF_S[0]
            if wk is w:
                gauges.append(_deferred_gauge(w))
            wk._drain_completions(stub)          # not due yet: no attempt
            assert len(stub.calls) == 1
            _force_due(wk)
            wk._drain_completions(stub)          # attempt 2 fails: parks
            _force_due(wk)
            wk._drain_completions(stub)          # attempt 3 succeeds
            assert wk.jobs_completed == 1 and not wk._deferred
            assert wk.completions_dropped == 0
            if wk is w:
                gauges.append(_deferred_gauge(w))
    finally:
        w._stop_gauges()
    assert stubs[0].calls == stubs[1].calls == [["j1"]] * 3
    assert gauges == [1.0, 0.0]
    assert w._c_dropped.value == 0
    assert worker.Worker._COMPLETION_BACKOFF_S == (
        ref_worker.Worker._COMPLETION_BACKOFF_S) == (0.5, 1.0, 2.0)
    assert worker.Worker._COMPLETION_BATCH == (
        ref_worker.Worker._COMPLETION_BATCH) == 256


def test_a_completion_always_failing_is_dropped_as_the_reference_drops():
    w = _port_worker()
    ref = ref_worker.Worker("localhost:1", ref_compute.InstantBackend(),
                            registry=ref_obs.Registry())
    ref._next_status = time.monotonic() + 60.0
    stubs = (_FlakyStub(10 ** 6, SimpleNamespace),
             _FlakyStub(10 ** 6, SimpleNamespace))
    try:
        for wk, stub, comp in ((w, stubs[0], compute.Completion),
                               (ref, stubs[1], ref_compute.Completion)):
            for i in range(3):
                wk._out.put(comp(f"j{i}", b"", 0.0))
            for _ in range(1 + len(wk._COMPLETION_BACKOFF_S)):
                wk._drain_completions(stub)
                _force_due(wk)
            assert not wk._deferred
        gauge = _deferred_gauge(w)
    finally:
        w._stop_gauges()
    assert w.completions_dropped == ref.completions_dropped == 3
    assert w._c_dropped.value == ref._c_dropped.value == 3
    # The first attempt and three retries, each of the three completions.
    assert stubs[0].calls == stubs[1].calls == [["j0", "j1", "j2"]] * 4
    assert gauge == 0.0


def test_completions_report_in_batches_of_the_references_size():
    w = _port_worker()
    stub = _FlakyStub(0, SimpleNamespace)
    try:
        for i in range(600):
            w._out.put(compute.Completion(f"j{i}", b"", 0.0))
        w._drain_completions(stub)
    finally:
        w._stop_gauges()
    assert [len(c) for c in stub.calls] == [256, 256, 88]
    assert w.jobs_completed == 600


# --- reconnect logging ----------------------------------------------------


class _PollStub:
    """Fails ``RequestJobs`` where ``script`` says False."""

    def __init__(self, script, reply):
        self.script = list(script)
        self.reply = reply

    def RequestJobs(self, req, timeout=None):
        if not self.script.pop(0):
            raise _Unavailable()
        return self.reply


def test_one_log_line_per_disconnect_and_reconnect_edge(caplog):
    script = [False, False, False, True, True, False, True]
    port = worker.Worker("localhost:1", compute.InstantBackend(),
                         registry=obs.Registry())
    ref = ref_worker.Worker("localhost:1", ref_compute.InstantBackend(),
                            registry=ref_obs.Registry())
    lines = {}
    for name, wk, poll, reply in (
            ("dbx.torch.worker", port, port._poll, pb.JobsReply()),
            ("dbx.worker", ref, ref._poll_jobs, ref_pb.JobsReply())):
        caplog.clear()
        stub = _PollStub(script, reply)
        with caplog.at_level("INFO", logger=name):
            for _ in script:
                poll(stub)
        lines[name] = [r.getMessage() for r in caplog.records
                       if r.name == name and "dispatcher" in r.getMessage()]
    port_lines = lines["dbx.torch.worker"]
    assert [m.split(":")[0] for m in port_lines] == [
        m.split(":")[0] for m in lines["dbx.worker"]] == [
        "dispatcher unreachable", "dispatcher reachable again"] * 2
    assert "UNAVAILABLE" in port_lines[0]
