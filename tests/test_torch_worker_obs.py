"""The worker's observability against the reference's, on the CPU.

Every input is made from a numpy seed at a small size: 8 tickers x 300
bars and a 40-combo sma grid. Only deterministic counters are compared by
value; timing counters (polls, RPC seconds) by name and label only.

- The codec: the same encode and decode sequence through both packages'
  ``wire`` gives equal deltas of ``dbx_wire_*`` and equal bytes.
- The caches: the same put and get sequence through both ``PanelCache``,
  ``CarryStore`` and ``PagePool`` gives equal counters, and the port's
  ``stats()`` keeps its keys.
- The backend: one inline group, its digest-only repeat, a two-step append
  and an 8-spec scenario carrier through ``JaxSweepBackend(use_fused=True)``
  (interpret mode, paging off so that both route the groups ``fused``) and
  ``TorchSweepBackend(device="cpu")`` give the same metric families and
  label sets (apart from ``dbx_jit_call_seconds``, which has no
  counterpart: the port has no jit), equal deterministic counters, and the
  same worker span names with equal ``jobs``, ``bars`` and ``combos``.
- The executor: a failing collect fires one ``collect_fail`` bundle and
  leaves its jobs without completions; ``DBX_PREFETCH=0`` never calls the
  backend's ``prefetch`` and the blocks are equal.
"""

import os
import threading
import time

import numpy as np
import pytest

from distributed_backtesting_exploration_tpu.obs import (
    registry as ref_registry, trace as ref_trace)
from distributed_backtesting_exploration_tpu.ops.metrics import (
    Metrics as RefMetrics)
from distributed_backtesting_exploration_tpu.rpc import (
    compute as ref_compute, page_pool as ref_page_pool, wire as ref_wire)
from distributed_backtesting_exploration_tpu.streaming import (
    recurrent as ref_rc, store as ref_store)
from distributed_backtesting_exploration_tpu.utils import data as ref_data
from distributed_backtesting_exploration_tpu_torch import obs
from distributed_backtesting_exploration_tpu_torch.obs import flight
from distributed_backtesting_exploration_tpu_torch.ops.metrics import Metrics
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.rpc import (
    backtesting_pb2 as pb, compute, dispatcher, page_pool, panel_store, wire)
from distributed_backtesting_exploration_tpu_torch.rpc.executor import (
    Executor)
from distributed_backtesting_exploration_tpu_torch.rpc.journal import Journal
from distributed_backtesting_exploration_tpu_torch.rpc.worker import Worker
from distributed_backtesting_exploration_tpu_torch.scenarios import synth
from distributed_backtesting_exploration_tpu_torch.streaming import (
    recurrent as rc, store)
from distributed_backtesting_exploration_tpu_torch.utils import data

N, BARS = 8, 300
GRID = dispatcher.parse_grid("fast=5:13,slow=30:50:4")     # 8 x 5 = 40
SCN = {"n_bars": 64, "block": 8, "regimes": 2, "vol_scale": 1.5,
       "shock": 0.01}
APPEND_DT = 16


def _values(reg, prefixes) -> dict:
    """``{(family, labels): value}`` of the families named by
    ``prefixes``; a histogram's value is its count."""
    out = {}
    for name, fam in reg.snapshot().items():
        if not name.startswith(prefixes):
            continue
        for label, v in fam["values"].items():
            out[(name, label)] = (v["count"] if fam["type"] == "histogram"
                                  else v)
    return out


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _panel(n=N, bars=BARS, seed=0):
    return data.synthetic_ohlcv(n, bars, seed=seed)


def _blob(panel, i, hi=None, lo=0):
    return data.to_wire_bytes(data.OHLCV(*(np.asarray(f[i, lo:hi])
                                           for f in panel)))


# ---------------------------------------------------------------------------
# The codec and the caches
# ---------------------------------------------------------------------------

def _codec_sequence(w, metrics_cls, blocks):
    rng = np.random.default_rng(5)
    planes = rng.standard_normal((9, N, 40)).astype(np.float32)
    out = list(blocks(planes))
    for b in out:
        w.metrics_from_bytes(b)
    row = metrics_cls(*planes[:, 0, :4])
    out.append(w.topk_to_bytes(np.arange(4), row, "sharpe"))
    w.topk_from_bytes(out[-1])
    out.append(w.best_returns_to_bytes(
        3, metrics_cls(*planes[:, 0, 3:4]),
        rng.standard_normal(BARS).astype(np.float32), "max_drawdown"))
    w.best_returns_from_bytes(out[-1])
    out.append(w.metrics_to_bytes(row))
    return out


def test_codec_counters_match_the_reference():
    names = ("dbx_wire_blocks_total", "dbx_wire_bytes_total")
    ref0 = _values(ref_registry.get_registry(), names)
    want = _codec_sequence(ref_wire, RefMetrics, lambda p: [
        ref_wire.metrics_to_bytes(RefMetrics(*p[:, i]))
        for i in range(p.shape[1])])
    ref_d = _delta(ref0, _values(ref_registry.get_registry(), names))
    port0 = _values(obs.get_registry(), names)
    got = _codec_sequence(wire, Metrics, wire.metrics_blocks)
    port_d = _delta(port0, _values(obs.get_registry(), names))
    assert got == want
    assert port_d == ref_d
    assert port_d[("dbx_wire_blocks_total",
                   "direction=encode,kind=metrics")] == N + 1


def _panel_sequence(cache, series, block):
    cache.get_series("a")                 # miss
    cache.put_series("a", series)
    assert cache.contains_series("a")     # a probe counts nothing
    cache.get_series("a")                 # hit
    cache.get_device("a")                 # miss
    cache.put_device("a", block, 5 * 4 * BARS)
    cache.get_device("a")                 # hit
    cache.get_device("b")                 # miss
    return cache.stats()


def _carry_sequence(cache, carry):
    key = ("d", "s")
    cache.get(key)                        # both levels miss
    cache.put(key, carry)
    cache.get(key)                        # device hit
    cache.evict_device(key)
    cache.get(key)                        # host hit, re-primed
    cache.get(key)                        # device hit
    return cache.stats()


def _page_sequence(pool, panel):
    series = [data.OHLCV(*(np.asarray(f[i]) for f in panel))
              for i in range(3)]
    fields = ("close", "volume")
    pool.prepare(["p0", "p1"], series[:2], fields)      # misses
    pool.prepare(["p0", "p1", "p2"], series, fields)    # hits and misses
    big = data.synthetic_ohlcv(1, 64 * BARS, seed=9)
    assert pool.prepare(["big"], [data.OHLCV(*(np.asarray(f[0])
                                               for f in big))],
                        fields) is None                 # rejected
    return pool.stats()


@pytest.mark.parametrize("cache", ["panel", "carry", "pages"])
def test_cache_counters_match_the_reference(cache):
    panel = _panel()
    ref_reg, port_reg = ref_registry.Registry(), obs.Registry()
    if cache == "panel":
        blob = _blob(panel, 0)
        ref_st = _panel_sequence(
            ref_compute.PanelCache(registry=ref_reg),
            ref_data.from_wire_bytes(blob), np.zeros((5, BARS), np.float32))
        st = _panel_sequence(
            compute.PanelCache(device="cpu", registry=port_reg),
            data.from_wire_bytes(blob), data.from_wire_bytes(blob))
        prefix = "dbx_panel_cache"
        assert st["hits"] == {"host": 1, "device": 1}
        assert st["misses"] == {"host": 1, "device": 2}
        assert set(st) == {"host_panels", "host_bytes", "device_panels",
                           "device_bytes", "max_bytes", "hits", "misses",
                           "page_pool"}
    elif cache == "carry":
        g = {k: v.numpy() for k, v in sweep.product_grid(
            **dispatcher.parse_grid("lookback=5:21:8")).items()}
        carry = rc.build_carry("momentum", {"close": panel.close[:2]}, g,
                               device="cpu")
        ref_st = _carry_sequence(ref_store.CarryStore(registry=ref_reg),
                                 ref_rc.carry_from_bytes(
                                     rc.carry_to_bytes(carry)))
        st = _carry_sequence(store.CarryStore(device="cpu",
                                              registry=port_reg), carry)
        prefix = "dbx_carry_cache"
        assert st["hits"] == {"host": 1, "device": 2}
        assert st["misses"] == {"host": 1, "device": 2}
    else:
        kw = dict(page_bars=64, max_bytes=64 * 4 * 64)
        ref_st = _page_sequence(ref_page_pool.PagePool(registry=ref_reg,
                                                       **kw), panel)
        st = _page_sequence(page_pool.PagePool(device="cpu",
                                               registry=port_reg, **kw),
                            panel)
        prefix = "dbx_page_pool"
        assert st["rejects"] == 1
        assert sum(st["hits"].values()) > 0 < sum(st["misses"].values())
    want = _values(ref_reg, prefix)
    got = _values(port_reg, prefix)
    if cache == "carry":
        # The carry's bytes are each runtime's own arrays.
        want = {k: v for k, v in want.items() if "bytes" not in k[0]}
        got = {k: v for k, v in got.items() if "bytes" not in k[0]}
    assert got == want
    for k in set(ref_st) & set(st):
        if cache != "carry" or "bytes" not in k:
            assert st[k] == ref_st[k], k
    # The port's plain counts are the registry's, this cache being its only
    # writer.
    for kind in ("hits", "misses"):
        for label, v in st[kind].items():
            lab = ("level" if cache != "pages" else "field") + "=" + label
            assert got[(f"{prefix}_{kind}_total", lab)] == v


# ---------------------------------------------------------------------------
# The backend
# ---------------------------------------------------------------------------

def _batches():
    """The four batches: an inline group of jobs with digests, its
    digest-only repeat, a two-step append chain, an 8-spec scenario
    carrier."""
    panel = _panel()
    grid = wire.grid_to_proto(GRID)
    inline, repeat = [], []
    for i in range(N):
        blob = _blob(panel, i)
        d = panel_store.panel_digest(blob)
        kw = dict(strategy="sma_crossover", grid=grid, cost=1e-3,
                  periods_per_year=252, panel_digest=d,
                  panel_bytes_len=len(blob), trace_id=f"{i:032x}")
        inline.append(pb.JobSpec(id=f"in-{i}", ohlcv=blob, **kw))
        repeat.append(pb.JobSpec(id=f"re-{i}", **kw))
    full = _panel(1, BARS + 2 * APPEND_DT, seed=42)
    appends = []
    for step, hi in enumerate((BARS + APPEND_DT, BARS + 2 * APPEND_DT)):
        lo = hi - APPEND_DT
        ext = _blob(full, 0, hi)
        appends.append([pb.JobSpec(
            id=f"ap-{step}", strategy="sma_crossover", ohlcv=ext,
            panel_digest=panel_store.panel_digest(ext),
            append_parent_digest=panel_store.panel_digest(
                _blob(full, 0, lo)),
            append_base_len=lo, append_delta=_blob(full, 0, hi, lo),
            grid=grid, cost=1e-3, periods_per_year=252,
            trace_id=f"{100 + step:032x}")])
    base = _blob(_panel(1, 96, seed=3), 0)
    digest = panel_store.panel_digest(base)
    carrier = pb.JobSpec(id="sc", strategy="sma_crossover", ohlcv=base,
                         grid=grid, cost=1e-3, periods_per_year=252,
                         panel_digest=digest, panel_bytes_len=len(base))
    for i in range(8):
        p = synth.ScenarioParams(**{**SCN, "seed": i})
        carrier.scenario_batch.add(
            base_digest=digest, n_bars=p.n_bars, block=p.block,
            regimes=p.regimes, vol_scale=p.vol_scale, shock=p.shock,
            seed=synth.seed_to_int64(synth.scenario_seed(digest, p)),
            id=f"sc-{i}", trace_id=f"{200 + i:032x}")
    return [inline, repeat, *appends, [carrier]]


# The families the backend and its caches count into.
BACKEND_FAMILIES = (
    "dbx_compute_", "dbx_backtests_total", "dbx_pad_bars_total",
    "dbx_worker_append_total", "dbx_scenario_route_total",
    "dbx_kernel_submit_seconds", "dbx_fused_substrate", "dbx_panel_cache_",
    "dbx_wire_", "dbx_jit_call_seconds")
# Counted by value: each is a function of the batches alone.
DETERMINISTIC = ("dbx_backtests_total", "dbx_compute_decode_bytes_total",
                 "dbx_compute_d2h_bytes_total", "dbx_wire_",
                 "dbx_panel_cache_hits_total", "dbx_panel_cache_misses_total",
                 "dbx_worker_append_total", "dbx_scenario_route_total",
                 "dbx_pad_bars_total", "dbx_kernel_submit_seconds",
                 "dbx_compute_decode_seconds", "dbx_compute_collect_seconds")
# A reference family with no counterpart in the port (ROADMAP, "Findings
# that are not faults").
NOT_PORTED = ("dbx_jit_call_seconds",)


def _drive(backend, reg, trace_mod, batches):
    spans = []
    key = f"worker-obs-test-{id(backend)}"
    trace_mod.add_span_listener(key, lambda rec: spans.append(rec)
                                if rec["name"].startswith("worker.")
                                else None)
    before = _values(reg, BACKEND_FAMILIES)
    try:
        blocks = [[(c.job_id, c.metrics) for c in backend.process(b)]
                  for b in batches]
    finally:
        trace_mod.remove_span_listener(key)
    after = _values(reg, BACKEND_FAMILIES)
    return blocks, _delta(before, after), after, spans


def test_backend_metrics_and_spans_match_the_reference(monkeypatch):
    monkeypatch.setenv("DBX_PAGED", "0")
    batches = _batches()
    want_blocks, want_d, want_all, want_spans = _drive(
        ref_compute.JaxSweepBackend(use_fused=True),
        ref_registry.get_registry(), ref_trace, batches)
    backend = compute.TorchSweepBackend(device="cpu")
    blocks, got_d, got_all, spans = _drive(
        backend, obs.get_registry(), obs.trace, batches)
    assert [[i for i, _ in b] for b in blocks] == \
        [[i for i, _ in b] for b in want_blocks]
    assert all(m for b in blocks for _, m in b)

    def families(values):
        return {(name, frozenset(part.split("=")[0]
                                 for part in label.split(",") if part))
                for name, label in values}

    ref_fams = {f for f in families(want_all)
                if not f[0].startswith(NOT_PORTED)}
    assert families(got_all) == ref_fams
    det = {k: v for k, v in want_d.items() if k[0].startswith(DETERMINISTIC)}
    assert {k: v for k, v in got_d.items()
            if k[0].startswith(DETERMINISTIC)} == det
    combos = wire.grid_n_combos(batches[0][0].grid)
    assert got_d[("dbx_backtests_total", "")] == (2 * N + 2 + 8) * combos
    assert got_d[("dbx_worker_append_total", "outcome=carry_hit")] == 1
    assert got_d[("dbx_scenario_route_total", "mode=fused")] == 8
    assert got_d[("dbx_kernel_submit_seconds",
                  "kernel=fused:sma_crossover,phase=compile")] == 1
    st = backend.stats()
    assert st["appends"] == {"carry_hit": 1, "full_reprice": 1}
    assert st["scenarios"] == {"fused": 8, "materialized": 0}

    def shape(recs):
        return [(r["name"], r.get("jobs"), r.get("bars"), r.get("combos"))
                for r in recs]

    assert shape(spans) == shape(want_spans)
    assert [r["name"] for r in spans][:3] == [
        "worker.decode", "worker.compile", "worker.d2h"]
    assert any(r["name"] == "worker.append" and r["carry_hit"]
               for r in spans)
    assert [r for r in spans if r["name"] == "worker.compile"][0][
        "kernel"] == "fused:sma_crossover"


def test_decode_span_reports_a_cache_hit():
    inline, repeat = _batches()[:2]
    backend = compute.TorchSweepBackend(device="cpu")
    spans = []
    obs.add_span_listener("decode-hit", lambda r: spans.append(r)
                          if r["name"] == "worker.decode" else None)
    try:
        backend.process(inline)
        backend.process(repeat)
    finally:
        obs.remove_span_listener("decode-hit")
    assert [(r["cache_hit"], r["cache_hits"]) for r in spans] == [
        (False, 0), (True, N)]


# ---------------------------------------------------------------------------
# The executor and the worker's legs
# ---------------------------------------------------------------------------

class _FailingCollect(compute.TorchSweepBackend):
    """Raises on the first ``fail`` collects."""

    def __init__(self, fail=1, **kw):
        super().__init__(**kw)
        self.fail = fail

    def collect(self, pending):
        if self.fail:
            self.fail -= 1
            raise RuntimeError("injected collect failure")
        return super().collect(pending)


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["serial", "pipelined"])
def test_collect_fail_fires_one_bundle_and_leaves_the_jobs(
        tmp_path, monkeypatch, pipelined):
    monkeypatch.setenv("DBX_FLIGHT_DIR", str(tmp_path))
    flight.reset()
    inline = _batches()[0]
    backend = _FailingCollect(device="cpu")
    if not pipelined:
        backend.process = lambda jobs: backend.collect(backend.submit(jobs))
    spans = []
    obs.add_span_listener("ex-test", lambda r: spans.append(r["name"]))
    ex = Executor(backend, pipelined=pipelined, worker_id="w-fail")
    try:
        ex.start()
        ex.inbox.put(inline)
        ex.inbox.put(inline)
        assert ex.close(timeout=60)
        assert flight.get_recorder().flush(10.0)
    finally:
        obs.remove_span_listener("ex-test")
        flight.reset()
    done = ex.take_completions()
    assert [c.job_id for c in done] == [j.id for j in inline]
    bundles = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(bundles) == 1 and "collect_fail" in bundles[0]
    names = ({"worker.submit", "worker.collect", "worker.inflight"}
             if pipelined else {"worker.process"})
    assert names <= set(spans)


def _loop_blocks(prefetch: str, monkeypatch, tmp_path):
    monkeypatch.setenv("DBX_PREFETCH", prefetch)
    calls = []

    class Counted(compute.TorchSweepBackend):
        def prefetch(self, jobs):
            calls.append(len(jobs))
            return super().prefetch(jobs)

    recs = dispatcher.synthetic_jobs(N, 64, "sma_crossover", GRID,
                                     cost=1e-3, seed=4)
    q = dispatcher.JobQueue(Journal(None), device="cpu")
    d = dispatcher.Dispatcher(q, dispatcher.PeerRegistry(),
                              results_dir=str(tmp_path / prefetch),
                              registry=obs.Registry())
    srv = dispatcher.DispatcherServer(d, bind="localhost:0",
                                      prune_interval_s=0.2).start()
    w = Worker(f"localhost:{srv.port}", Counted(device="cpu"),
               poll_interval_s=0.005, status_interval_s=0.2,
               jobs_per_chip=4, registry=obs.Registry())
    t = threading.Thread(target=w.run, daemon=True)
    t.start()
    try:
        q.enqueue_many(recs)
        deadline = time.monotonic() + 60
        while not q.drained and time.monotonic() < deadline:
            time.sleep(0.01)
        assert q.drained, q.stats()
    finally:
        w.stop()
        t.join(timeout=30)
        srv.stop()
    assert not t.is_alive()
    return [(tmp_path / prefetch / f"{r.id}.dbxm").read_bytes()
            for r in recs], calls


def test_prefetch_kill_switch(monkeypatch, tmp_path):
    on, on_calls = _loop_blocks("1", monkeypatch, tmp_path)
    off, off_calls = _loop_blocks("0", monkeypatch, tmp_path)
    assert on_calls and not off_calls
    assert on == off
