"""The port's observability planes against the reference's.

Spans and their JSONL events, timeline merges, flight bundles, the fleet
fold, decision records and cost-model residuals: each case runs the same
inputs through both packages' modules and compares the outputs. Fields
that carry the wall clock or the process (``ts``, ``t0``, ``dur_s`` of a
live span, ``t_wall``, ``pid``, ``thread``) are named and dropped; random
span and trace ids are replaced by their order of first appearance. The
cost model's units are injected into both packages (the port's prior is
the card's op count, not the reference's, by design), so the residual
arithmetic itself is compared exactly.
"""

import json
import math

import numpy as np
import pytest

from distributed_backtesting_exploration_tpu import obs as ref_obs
from distributed_backtesting_exploration_tpu.obs import (
    costmodel as ref_costmodel, decisions as ref_decisions,
    events as ref_events, fleet as ref_fleet, flight as ref_flight,
    timeline as ref_timeline, trace as ref_trace)
from distributed_backtesting_exploration_tpu_torch import obs as port_obs
from distributed_backtesting_exploration_tpu_torch.obs import (
    costmodel as port_costmodel, decisions as port_decisions,
    events as port_events, fleet as port_fleet, flight as port_flight,
    timeline as port_timeline, trace as port_trace)

REF = dict(obs=ref_obs, costmodel=ref_costmodel, decisions=ref_decisions,
           events=ref_events, fleet=ref_fleet, flight=ref_flight,
           timeline=ref_timeline, trace=ref_trace)
PORT = dict(obs=port_obs, costmodel=port_costmodel,
            decisions=port_decisions, events=port_events, fleet=port_fleet,
            flight=port_flight, timeline=port_timeline, trace=port_trace)

# Fields that carry the wall clock, the process or the thread.
WALL = ("ts", "t0", "dur_s", "t_wall", "pid", "thread")
IDS = ("span_id", "parent_id", "trace_id")


def _canon(recs: list) -> list:
    """``recs`` with the wall fields dropped and ids renumbered in order
    of first appearance."""
    ids: dict = {}

    def cid(v):
        if not v:
            return v
        return ids.setdefault(v, f"id{len(ids)}")

    out = []
    for r in recs:
        r = {k: v for k, v in r.items() if k not in WALL}
        for k in IDS:
            if k in r:
                r[k] = cid(r[k])
        if "traces" in r:
            r["traces"] = [[cid(t), cid(p)] for t, p in r["traces"]]
        out.append(r)
    return out


# ---------------------------------------------------------------------------
# Spans and events
# ---------------------------------------------------------------------------

def _span_history(m, path) -> tuple:
    m["events"].configure(str(path))
    got = []
    key = "parity-tap"
    m["trace"].add_span_listener(key, got.append)
    try:
        with m["trace"].trace_context("t" * 32, "p" * 16):
            with m["trace"].span("worker.submit", jobs=3):
                with m["trace"].span("worker.execute", kernel="k:sma",
                                     bars=64, combos=8):
                    pass
                m["trace"].emit_span("worker.compile", 100.0, 0.25,
                                     cold=True)
        m["trace"].emit_span("job.queue_wait", 50.0, 1.5,
                             pairs=[("a" * 32, "b" * 16),
                                    ("c" * 32, "")])
        try:
            with m["trace"].span("worker.decode"):
                raise KeyError("boom")
        except KeyError:
            pass
        m["events"].emit("custom_event", job="j1", n=2)
    finally:
        m["trace"].remove_span_listener(key)
        m["events"].configure(None)
    with open(path) as fh:
        logged = [json.loads(ln) for ln in fh]
    return _canon(got), _canon(logged)


def test_spans_and_events_match_the_reference(tmp_path):
    ref = _span_history(REF, tmp_path / "ref.jsonl")
    port = _span_history(PORT, tmp_path / "port.jsonl")
    assert port == ref
    assert len(port[0]) == 5 and len(port[1]) == 6


def test_span_ids_and_job_trace_pairs_match_the_reference():
    class J:
        def __init__(self, t, p):
            self.trace_id, self.parent_span_id = t, p

    jobs = [J("a" * 32, "b" * 16), J("", ""), J("c" * 32, "")]
    assert (port_trace.job_trace_pairs(jobs)
            == ref_trace.job_trace_pairs(jobs))
    for m in (ref_trace, port_trace):
        assert len(m.new_trace_id()) == 32 and len(m.new_span_id()) == 16


# ---------------------------------------------------------------------------
# Timeline merges
# ---------------------------------------------------------------------------

def _events(seed: int) -> list:
    """Span events of ``seed``'s jobs: a dispatcher's queue wait and
    dispatch, a worker's decode/compile/execute/d2h/report (some cache
    and carry hits, a multi-job batch span) and each job's e2e span."""
    rng = np.random.default_rng(seed)
    evs = []
    tids = [f"{i:032x}" for i in range(12)]
    t = 1000.0
    for i, tid in enumerate(tids):
        t0 = t + float(rng.random())
        dur = 0.5 + float(rng.random()) * (8.0 if i == 5 else 1.0)
        evs.append({"ev": "span", "name": "job", "t0": t0, "dur_s": dur,
                    "trace_id": tid, "span_id": f"e{i}", "job": f"j{i}",
                    "worker": f"w{i % 3}", "pid": 1})
        cur = t0
        for name in ("job.queue_wait", "job.dispatch", "worker.decode",
                     "worker.compile", "worker.execute", "worker.d2h",
                     "worker.append", "worker.report", "job.push"):
            d = dur * float(rng.random()) * 0.15
            rec = {"ev": "span", "name": name, "t0": cur, "dur_s": d,
                   "trace_id": tid, "span_id": f"{name}{i}",
                   "parent_id": f"e{i}", "pid": 2 if "worker" in name
                   else 1, "worker": f"w{i % 3}"}
            if name == "worker.decode" and i % 4 == 0:
                rec["cache_hit"] = True
            if name == "worker.append" and i % 3 == 0:
                rec["carry_hit"] = True
            evs.append(rec)
            cur += d * 1.1
        t += 0.7
    evs.append({"ev": "span", "name": "worker.inflight", "t0": 1002.0,
                "dur_s": 3.0, "span_id": "batch", "parent_id": "",
                "traces": [[tids[1], "e1"], [tids[2], "e2"]], "pid": 2})
    evs.append({"ev": "other", "name": "ignored"})
    evs.append({"ev": "span", "name": "job.dispatch", "ts": 1010.0,
                "dur_s": 0.5, "trace_id": tids[3], "span_id": "old"})
    return evs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("overlap", [False, True])
def test_timeline_merge_matches_the_reference(seed, overlap):
    evs = _events(seed)
    got = []
    for m in (REF, PORT):
        tl = m["timeline"]
        tls = tl.reconstruct(evs)
        paths = {k: tl.critical_path(v) for k, v in sorted(tls.items())}
        summary = tl.summarize(tls, min_straggler_jobs=4, overlap=overlap)
        got.append((paths, json.dumps(summary, sort_keys=True),
                    tl.render_text(summary),
                    json.dumps(tl.summarize_spans(evs), sort_keys=True)))
    assert got[1] == got[0]


def test_timeline_reads_the_reference_logs_files(tmp_path):
    paths = []
    for i in range(2):
        p = tmp_path / f"log{i}.jsonl"
        evs = _events(i)
        p.write_text("\n".join(json.dumps(e) for e in evs)
                     + "\n{torn line\n")
        paths.append(str(p))
    assert (port_timeline.parse_events(paths)
            == ref_timeline.parse_events(paths))


# ---------------------------------------------------------------------------
# Flight bundles
# ---------------------------------------------------------------------------

def _bundle(m, monkeypatch, tmp_path, spans) -> tuple:
    monkeypatch.setattr(m["trace"], "recent_spans", lambda n=None: spans)
    monkeypatch.setenv("DBX_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("DBX_FLIGHT_DEDUPE_S", "10")
    now = [100.0]
    reg = m["obs"].Registry()
    rec = m["flight"].FlightRecorder(registry=reg, clock=lambda: now[0])
    rec.add_source("queue", lambda: {"jobs_pending": 3})
    rec.add_source("broken", lambda: 1 / 0)
    rec.add_source("gone", lambda: 1)
    rec.remove_source("gone")
    doc = rec._build_bundle("job_failed", "j3", {"job": "j3", "why": "x"})
    path = rec.capture_now("slo", "tenant-a", {"p95": 2.0})
    with open(path) as fh:
        written = json.load(fh)
    for kind, subject in (("residual", "a"), ("residual", "a"),
                          ("nope", "b")):
        rec.trigger(kind, subject)
    now[0] += 11.0
    rec.trigger("residual", "a")
    assert rec.flush(timeout=20)
    rec.close()
    rec.trigger("residual", "closed")
    counters = sorted((k, v) for k, v in reg.summaries().items()
                      if k.startswith("dbx_flight"))
    drop = ("t_wall", "pid")
    return ({k: v for k, v in doc.items() if k not in drop},
            {k: v for k, v in written.items() if k not in drop},
            counters, m["flight"].trigger_bucket("nope"),
            sorted(m["flight"].known_kinds()))


def test_flight_bundles_match_the_reference(monkeypatch, tmp_path):
    spans = [e for e in _events(3) if e.get("ev") == "span"]
    for e in spans:
        if e["name"] == "job" and e["job"] == "j3":
            e["ok"] = False
    got = [_bundle(m, monkeypatch, tmp_path / name, spans)
           for name, m in (("ref", REF), ("port", PORT))]
    assert got[1] == got[0]
    assert got[1][0]["jobs"] and got[1][0]["sources"]["broken"]["error"]


# ---------------------------------------------------------------------------
# The fleet fold
# ---------------------------------------------------------------------------

def _frame(gen="g1", pid=1, seq=1, t=1000.0, jobs=10, rate=2.5,
           stages=None, proc=None, caches=None, proc_id=None,
           costmodel=None):
    doc = {
        "v": 1, "gen": gen, "pid": pid, "seq": seq, "t": t,
        "uptime_s": 5.0, "busy": 1, "inflight": 1,
        "pipeline": {"on": True, "depth": 2},
        "jobs_completed": jobs, "completions_dropped": 0, "polls": seq,
        "jobs_per_s": rate, "caps": {"backend": "test", "chips": 1},
        "caches": caches or {}, "proc": proc or {},
        "stages": stages or {}}
    if proc_id is not None:
        doc["proc_id"] = proc_id
    if costmodel is not None:
        doc["costmodel"] = costmodel
    return json.dumps(doc, sort_keys=True)


def _fleet_history(m) -> tuple:
    st = m["fleet"]._StageStats()
    for d in (0.0001, 0.004, 0.02, 0.3, 1.2):
        st.observe({"name": "worker.execute", "dur_s": d})
        st.observe({"name": "worker.decode", "dur_s": d / 3})
    stages = st.snapshot()
    now = [50.0]
    reg = m["obs"].Registry()
    fv = m["fleet"].FleetView(registry=reg, clock=lambda: now[0],
                              stale_s_override=30.0)
    frames = [
        ("w-a", _frame(gen="a1", seq=1, t=1000.0, jobs=5, stages=stages)),
        ("w-a", _frame(gen="a1", seq=3, t=1002.0, jobs=20, stages=stages,
                       caches={"panel_topk": [{"d": "ab" * 6, "b": 9}]})),
        ("w-a", _frame(gen="a1", seq=2, t=1001.0, jobs=12)),
        ("w-a", _frame(gen="a2", seq=1, t=1005.0, jobs=2, stages=stages,
                       costmodel={"n": 4, "ewma": 0.5,
                                  "buckets": [0, 1, 2, 1, 0, 0, 0, 0, 0,
                                              0, 0], "blowouts": 1})),
        ("w-b", _frame(gen="b1", pid=2, seq=1, t=1000.5, jobs=7,
                       rate=0.1, proc={"rss_b": 10})),
        ("w-c", _frame(gen="c1", pid=1, seq=1, t=1000.5, jobs=3,
                       proc_id="tok")),
        ("w-d", "{not json"),
        ("w-e", json.dumps({"v": 99})),
        ("w-f", _frame(gen="f1", pid=3, seq=1, t=999.0, jobs=1,
                       rate=float("nan"))),
    ]
    accepted = [fv.update(w, f) for w, f in frames]
    fv.observe_slo(True)
    fv.observe_slo(False)
    snap0 = fv.snapshot(now=50.0)
    now[0] = 75.0
    fv.forget("w-c")
    pruned = fv.prune()
    snap1 = fv.snapshot(now=75.0)
    return (accepted, json.dumps(snap0, sort_keys=True, default=str),
            m["fleet"].render_text(snap0),
            json.dumps(fv.placement_view(now=50.0), sort_keys=True,
                       default=str),
            pruned, json.dumps(snap1, sort_keys=True, default=str),
            sorted(fv.frame_sizes()))


def test_fleet_fold_matches_the_reference():
    ref, port = (_fleet_history(m) for m in (REF, PORT))
    assert port == ref
    assert sum(port[0]) >= 5


# ---------------------------------------------------------------------------
# Decision records
# ---------------------------------------------------------------------------

class _FakeFleet:
    def __init__(self, workers):
        self.workers = workers

    def snapshot(self, now=None):
        return {"workers": self.workers}


_DIGEST = "ab" * 32


def _raw(jid, worker, route, **over):
    raw = {"jid": jid, "trace_id": jid + "-tr", "worker": worker,
           "tenant": "default", "strategy": "sma_crossover",
           "combos": 4.0, "affinity_skips": 0, "wfq": None,
           "digest": _DIGEST, "panel_b": 200_000_000, "append_parent": "",
           "base_len": 0, "bars": 512, "t_take": 1.0, "route": route}
    raw.update(over)
    return raw


def _units(family, bars, combos):
    if family == "unmodelable":
        raise ValueError(family)
    return 3.0 * bars * combos + (7.0 if family == "rsi" else 0.0)


def _decision_history(m, monkeypatch) -> tuple:
    monkeypatch.setattr(m["costmodel"], "_model_units", _units)
    m["decisions"]._units_memo.clear()
    fleet = _FakeFleet({
        "fast": {"stale": False, "age_s": 0.25,
                 "caches": {"panel_topk": [{"d": _DIGEST[:12], "b": 1}]}},
        "slow": {"stale": False, "age_s": 0.5, "caches": {}},
        "old": {"stale": True, "age_s": 40.0, "caches": {},
                "straggler": True}})
    now = [10.0]
    plane = m["decisions"].DecisionPlane(
        fleet=fleet, registry=m["obs"].Registry(), clock=lambda: now[0])
    try:
        plane.submit([_raw("c1", "slow", "full"),
                      _raw("c2", "fast", "digest_only"),
                      _raw("c3", "old", "delta", append_parent="pp",
                           base_len=500, bars=520)],
                     worker="slow", t_take=1.0)
        plane.observe_completion("fast", "c2", elapsed_s=2.0)
        assert plane.flush()
        plane.submit([_raw("c4", "fast", "digest_only"),
                      _raw("c5", "slow", "scenario", strategy="rsi"),
                      _raw("c6", "slow", "full", strategy="unmodelable")])
        assert plane.flush()
        recs = [{k: v for k, v in r.items() if k not in WALL}
                for r in plane.recent()]
        snap = {k: v for k, v in plane.snapshot().items()
                if k not in ("t_wall",)}
        return (json.dumps(recs, sort_keys=True, default=str),
                json.dumps(snap, sort_keys=True, default=str))
    finally:
        plane.close()


def test_decision_records_match_the_reference(monkeypatch):
    ref, port = (_decision_history(m, monkeypatch) for m in (REF, PORT))
    assert port == ref
    assert len(json.loads(port[0])) == 6


@pytest.mark.parametrize("kw", [
    dict(units=10.0, spu=0.01),
    dict(units=10.0, spu=0.01, panel_b=4_000_000, resident=False),
    dict(units=10.0, spu=0.01, carry_hit=True, frac=0.25),
    dict(units=5.0, spu=1e-3, family_warm=False, penalty=4.0),
    dict(units=5.0, spu=1e-3, panel_b=10, rate=1e3, cold=2.0)])
def test_placement_cost_matches_the_reference(kw):
    assert (port_decisions.placement_cost(**kw)
            == ref_decisions.placement_cost(**kw))


@pytest.mark.parametrize("rec", [
    dict(strategy="sma_crossover", combos=400, append_parent="",
         append_base_len=0, ohlcv=b"x" * 4000, scenario=None,
         panel_digest="d1"),
    dict(strategy="rsi", combos=0, append_parent="base",
         append_base_len=100, ohlcv=None, scenario=None, panel_digest=""),
    dict(strategy="macd", combos=8, append_parent="", append_base_len=0,
         ohlcv=None, scenario={"n_bars": 252}, panel_digest="d2")])
def test_placement_ctx_matches_the_reference(monkeypatch, rec):
    class R:
        pass

    r = R()
    r.__dict__.update(rec)
    got = []
    for m in (REF, PORT):
        monkeypatch.setattr(m["costmodel"], "_model_units", _units)
        m["decisions"]._units_memo.clear()
        got.append(m["decisions"].placement_ctx(r))
    assert got[1] == got[0]


# ---------------------------------------------------------------------------
# Cost-model residuals
# ---------------------------------------------------------------------------

def _exec_spans(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(60):
        fam = ("sma_crossover", "rsi", "unmodelable")[i % 3]
        bars = int(rng.integers(64, 2000))
        combos = int(rng.integers(1, 400))
        slow = 40.0 if i in (30, 41) else 1.0
        out.append({"name": "worker.execute",
                    "kernel": f"fused:{fam}" if i != 7 else "nokernel",
                    "dur_s": slow * 1e-9 * bars * combos
                    * float(rng.uniform(0.8, 1.25)),
                    "bars": bars, "combos": combos, "jobs": 1 + i % 2})
    out.append({"name": "worker.execute", "kernel": "fused:rsi",
                "dur_s": 0.0, "bars": 5, "combos": 5})
    out.append({"name": "worker.decode", "dur_s": 1.0})
    out.append({"name": "worker.execute", "kernel": "fused:rsi",
                "dur_s": "bad", "bars": 5, "combos": 5})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_costmodel_residuals_match_the_reference(monkeypatch, seed):
    monkeypatch.setenv("DBX_COSTMODEL_WARMUP", "4")
    got = []
    for m in (REF, PORT):
        monkeypatch.setattr(m["costmodel"], "_model_units", _units)
        blow = []
        tr = m["costmodel"].CostModelTracker(
            registry=m["obs"].Registry(),
            on_blowout=lambda *a: blow.append(a))
        for rec in _exec_spans(seed):
            tr.observe(rec)
        got.append((tr.frame(), tr.snapshot(), blow,
                    [m["costmodel"].residual_quantile(
                        tr.frame()["buckets"], q) for q in (0.5, 0.95)]))
    assert got[1] == got[0]
    assert got[1][0]["n"] > 0 and got[1][2]


def test_costmodel_units_call_the_ports_prior():
    """Unpatched, the port's units are the card's prior
    (``tune.autotune.modeled_cost``) times the cell-bars: finite and
    positive, and not the reference's (its model is the TPU's)."""
    units = port_costmodel._model_units("sma_crossover", 1260, 2000)
    assert units > 0.0 and math.isfinite(units)
    from distributed_backtesting_exploration_tpu_torch.tune import autotune

    per = autotune.modeled_cost(
        "sma_crossover", autotune.default_substrates("sma_crossover"),
        n_bars=1260, n_combos=2000)
    assert units == per * 1260.0 * 2000.0


def test_device_profile_writes_a_chrome_trace(tmp_path):
    import torch

    with port_trace.device_profile(str(tmp_path / "prof")) as prof:
        torch.ones(64).cumsum(0)
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert doc["traceEvents"] and prof is not None
