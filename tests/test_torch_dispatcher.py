"""The port's dispatcher (``rpc/dispatcher.py``) against the reference's.

- Take, complete, lease-expiry and requeue sequences drawn from a numpy
  seed give the reference's leases, outcomes, requeues and stats, on the
  pure-Python state substrate under an injected lease clock and on the
  native substrate (``libdbx_core.so``, built with g++ from ``cpp/``)
  with already-expired leases.
- The RPC handlers, called directly with the same requests and no gRPC
  context, give the reference's replies: ``RequestJobs`` (full, then
  digest-only legs), ``CompleteJobs``, ``CompleteJob``, ``SendStatus``,
  ``FetchPayload``, ``AppendBars``, ``GetStats``, ``OfferCompiled``,
  ``FetchCompiled`` and ``TriggerDump``.
- The command line parses as the reference's, plus ``--device``.

Trace and span ids are minted at random and an append job's id is a
``uuid4``; they are replaced by their order of first appearance.
"""

import json

import numpy as np
import pytest
from google.protobuf import json_format

from distributed_backtesting_exploration_tpu import obs as ref_obs
from distributed_backtesting_exploration_tpu.rpc import (
    backtesting_pb2 as ref_pb, dispatcher as ref_disp)
from distributed_backtesting_exploration_tpu_torch import obs as port_obs
from distributed_backtesting_exploration_tpu_torch.ops.metrics import Metrics
from distributed_backtesting_exploration_tpu_torch.rpc import (
    backtesting_pb2 as pb, dispatcher as port_disp, wire)
from distributed_backtesting_exploration_tpu_torch.runtime import _core
from distributed_backtesting_exploration_tpu_torch.utils import data

GRID = {"fast": np.float32([3, 4]), "slow": np.float32([10, 12])}
PKGS = {"ref": (ref_disp, ref_obs), "port": (port_disp, port_obs)}


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _panel(seed: int, n_bars: int = 48) -> bytes:
    s = data.synthetic_ohlcv(1, n_bars, seed=seed)
    return data.to_wire_bytes(data.OHLCV(*(np.asarray(f[0]) for f in s)))


def _queue(disp, *, native, clock=None, lease_s=30.0):
    kw = {"device": "cpu"} if disp is port_disp else {}
    return disp.JobQueue(lease_s=lease_s, use_native=native, clock=clock,
                         **kw)


def _sequence(disp, seed: int, native: bool, lease_s: float) -> list:
    """A seeded queue history. The Python substrate runs on an injected
    lease clock that each expiry step moves 31 s on; the native one keeps
    its clock C-side, so it runs with ``lease_s=0`` (every lease already
    expired), which the Python one then takes too."""
    rng = np.random.default_rng(seed)
    clock = _Clock()
    q = _queue(disp, native=native, clock=None if native else clock,
               lease_s=lease_s)
    assert q.substrate == ("native" if native else "python")
    out, n, leased = [], 0, []
    for _ in range(60):
        r = rng.random()
        if r < 0.3:
            k = int(rng.integers(1, 4))
            q.enqueue_many([disp.JobRecord(
                id=f"j{n + i}", strategy="sma_crossover", grid=GRID,
                ohlcv=_panel((n + i) % 3)) for i in range(k)])
            n += k
        elif r < 0.55:
            w = f"w{int(rng.integers(3))}"
            got = [rec.id for rec, _ in q.take(int(rng.integers(1, 4)), w)]
            leased += got
            out.append(("take", w, got))
        elif r < 0.75 and leased:
            ids = [leased[int(i)] for i in
                   rng.integers(len(leased), size=int(rng.integers(1, 3)))]
            ids.append(f"unknown{n}")
            out.append(("complete", q.complete_batch(ids, "w0")))
        elif r < 0.85:
            clock.t += 31.0
            out.append(("expired", sorted(q.requeue_expired())))
        else:
            w = f"w{int(rng.integers(3))}"
            out.append(("requeue_worker", w, sorted(q.requeue_worker(w))))
        out.append(("stats", {k: v for k, v in q.stats().items()
                              if k != "backtests_per_sec"}, q.drained))
    out.append(("completed", sorted(q.completed_ids())))
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_queue_sequences_match_the_reference(seed, native):
    """The port's queue on either substrate against the reference's
    pure-Python one, which its own tests hold to its native core (the
    reference's library is left unbuilt here: its cmake build would race
    other test processes)."""
    # The native substrate needs g++ to build ``libdbx_core.so``.
    assert not native or _core.available()
    ref = _sequence(ref_disp, seed, False, lease_s=0.0 if native else 30.0)
    port = _sequence(port_disp, seed, native,
                     lease_s=0.0 if native else 30.0)
    assert port == ref
    assert any(op[0] == "take" and op[2] for op in port)


def _canon(msg) -> dict:
    return json_format.MessageToDict(msg, preserving_proto_field_name=True)


def _canon_ids(obj, ids: dict):
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in ("trace_id", "parent_span_id") and v:
                v = ids.setdefault(v, f"{k}{len(ids)}")
            elif k in ("id", "job_id") and isinstance(v, str) \
                    and len(v) == 36:
                v = ids.setdefault(v, f"uuid{len(ids)}")
            out[k] = _canon_ids(v, ids)
        return out
    if isinstance(obj, list):
        return [_canon_ids(v, ids) for v in obj]
    return obj


def _blk(n):
    return wire.metrics_to_bytes(Metrics(*(
        np.full(n, 0.5, np.float32) for _ in Metrics._fields)))


def _handlers(disp, obs, pbm, tmp_path, monkeypatch) -> list:
    monkeypatch.setenv("DBX_FLIGHT_DIR", str(tmp_path / "flight"))
    q = _queue(disp, native=False)
    d = disp.Dispatcher(q, disp.PeerRegistry(prune_window_s=30.0),
                        registry=obs.Registry())
    out = []
    ids: dict = {}

    def rec(name, reply):
        out.append((name, _canon_ids(_canon(reply), ids)))

    try:
        q.enqueue_many([disp.JobRecord(
            id=f"a{i}", strategy="sma_crossover", grid=GRID, cost=1e-3,
            ohlcv=_panel(i % 2)) for i in range(4)])
        rec("status", d.SendStatus(pbm.StatusRequest(worker_id="w1"),
                                   None))
        r1 = d.RequestJobs(pbm.JobsRequest(
            worker_id="w1", chips=1, jobs_per_chip=3,
            accepts_digest_only=True), None)
        rec("jobs1", r1)
        rec("complete", d.CompleteJobs(pbm.CompleteBatch(
            worker_id="w1", items=[pbm.CompleteItem(
                id=j.id, metrics=_blk(4), elapsed_s=0.5,
                trace_id=j.trace_id) for j in r1.jobs] + [
                pbm.CompleteItem(id="nobody", metrics=_blk(4))]), None))
        q.enqueue_many([disp.JobRecord(
            id=f"b{i}", strategy="sma_crossover", grid=GRID, cost=1e-3,
            ohlcv=_panel(i % 2)) for i in range(3)])
        r2 = d.RequestJobs(pbm.JobsRequest(
            worker_id="w1", chips=1, jobs_per_chip=4,
            accepts_digest_only=True), None)
        rec("jobs2", r2)
        rec("complete1", d.CompleteJob(pbm.CompleteRequest(
            id=r2.jobs[0].id, worker_id="w1", metrics=_blk(4),
            elapsed_s=0.25), None))
        rec("complete1_dup", d.CompleteJob(pbm.CompleteRequest(
            id=r2.jobs[0].id, worker_id="w1", metrics=_blk(4)), None))
        dig = r2.jobs[1].panel_digest
        rec("fetch", d.FetchPayload(pbm.PayloadRequest(
            worker_id="w2", digest=dig), None))
        rec("fetch_gone", d.FetchPayload(pbm.PayloadRequest(
            worker_id="w2", digest="0" * 32), None))
        full = data.synthetic_ohlcv(1, 56, seed=0)
        delta = data.to_wire_bytes(data.OHLCV(*(
            np.asarray(f[0, 48:]) for f in full)))
        tmpl = pbm.JobSpec(strategy="sma_crossover",
                           grid=wire.grid_to_proto(GRID), cost=1e-3,
                           periods_per_year=252)
        for name, req in (
                ("append", pbm.AppendRequest(
                    worker_id="feed", panel_digest=dig, base_len=48,
                    delta=delta, job=tmpl)),
                ("append_missing", pbm.AppendRequest(
                    worker_id="feed", panel_digest="1" * 32, base_len=48,
                    delta=delta, job=tmpl)),
                ("append_len", pbm.AppendRequest(
                    worker_id="feed", panel_digest=dig, base_len=47,
                    delta=delta, job=tmpl)),
                ("append_pairs", pbm.AppendRequest(
                    worker_id="feed", panel_digest=dig, base_len=48,
                    delta=delta, job=pbm.JobSpec(strategy="pairs"))),
                ("append_tick", pbm.AppendRequest(
                    worker_id="feed", panel_digest=dig, base_len=48,
                    delta=delta))):
            rec(name, d.AppendBars(req, None))
        r3 = d.RequestJobs(pbm.JobsRequest(
            worker_id="w1", chips=1, jobs_per_chip=8,
            accepts_digest_only=True), None)
        rec("jobs3", r3)
        rec("offer", d.OfferCompiled(pbm.CompiledOffer(
            worker_id="w1", entries=[pbm.CompiledEntry(
                key="k" * 16, name="libdbx_x-0123456789abcdef.so",
                payload=b"\x7fELF" + b"0" * 60)]), None))
        rec("fetch_compiled_list", d.FetchCompiled(
            pbm.CompiledRequest(worker_id="w1"), None))
        rec("fetch_compiled", d.FetchCompiled(pbm.CompiledRequest(
            worker_id="w1", keys=["k" * 16, "missing"]), None))
        dump = d.TriggerDump(pbm.DumpRequest(subject="s", reason="r"),
                             None)
        out.append(("dump", (dump.ok, dump.bundle.endswith(".json"))))
        stats = _canon(d.GetStats(pbm.StatsRequest(), None))
        stats.pop("backtests_per_sec", None)
        stats.pop("obs_json")
        out.append(("stats", stats))
        out.append(("results", sorted(
            (k, len(v)) for k, v in d.results.items())))
        out.append(("queue", {k: v for k, v in q.stats().items()
                              if k != "backtests_per_sec"}))
    finally:
        d.close()
    return out


def test_handlers_give_the_reference_replies(tmp_path, monkeypatch):
    ref = _handlers(ref_disp, ref_obs, ref_pb, tmp_path / "ref",
                    monkeypatch)
    port = _handlers(port_disp, port_obs, pb, tmp_path / "port",
                     monkeypatch)
    assert [name for name, _ in port] == [name for name, _ in ref]
    for (name, got), (_, want) in zip(port, ref):
        assert got == want, name
    jobs2 = dict(port)["jobs2"]["jobs"]
    assert all(not j.get("ohlcv") and j["panel_digest"] for j in jobs2)


@pytest.mark.parametrize("argv", [
    [], ["--synthetic", "12", "--device", "cpu"],
    ["--strategy", "rsi", "--grid", "window=5:15:5", "--top-k", "4",
     "--tenant", "t1", "--jobs-per-chip", "8"]])
def test_cli_parses_as_the_reference(argv):
    ref_args = vars(ref_disp.make_parser().parse_args(
        [a for a in argv if a not in ("--device", "cpu")]))
    port_args = vars(port_disp.make_parser().parse_args(argv))
    want_device = "cpu" if "--device" in argv else "cuda"
    assert port_args.pop("device") == want_device
    assert port_args == ref_args


@pytest.mark.parametrize("spec", [
    "fast=5:25,slow=30:130:5", "window=10;20;30,k=1:3:0.5", ""])
def test_parse_grid_matches_the_reference(spec):
    got, want = port_disp.parse_grid(spec), ref_disp.parse_grid(spec)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_build_dispatcher_takes_the_device_to_the_queue(tmp_path):
    args = port_disp.make_parser().parse_args(
        ["--synthetic", "3", "--bars", "32", "--device", "cpu",
         "--results-dir", str(tmp_path / "res"),
         "--journal", str(tmp_path / "q.jsonl")])
    d = port_disp.build_dispatcher(args)
    try:
        assert d.queue.device == "cpu"
        assert d.queue.stats()["jobs_pending"] == 3
    finally:
        d.close()
        d.queue._journal.close()


def test_build_dispatcher_checks_the_device_before_compacting(
        tmp_path, monkeypatch):
    """A start on a device the host lacks raises before the journal on
    disk is rewritten (compaction would otherwise drop a finished job's
    payload first)."""
    jp = str(tmp_path / "q.jsonl")
    q = port_disp.JobQueue(port_disp.Journal(jp), device="cpu")
    q.enqueue_many([port_disp.JobRecord(
        id="j0", strategy="sma_crossover", grid=GRID, ohlcv=_panel(0))])
    ids = [rec.id for rec, _ in q.take(1, "w0")]
    assert q.complete_batch(ids, "w0")
    q._journal.close()
    before = open(jp, "rb").read()
    monkeypatch.setattr(port_disp.device_mod.torch.cuda, "is_available",
                        lambda: False)
    args = port_disp.make_parser().parse_args(
        ["--device", "cuda", "--journal", jp])
    with pytest.raises(RuntimeError, match="cuda"):
        port_disp.build_dispatcher(args)
    assert open(jp, "rb").read() == before
    # The same journal does shrink once the device resolves.
    port_disp.Journal.compact(jp)
    assert open(jp, "rb").read() != before


def test_synthetic_and_scenario_jobs_match_the_reference():
    a = port_disp.synthetic_jobs(3, 40, "pairs", GRID, cost=1e-3, seed=4)
    b = ref_disp.synthetic_jobs(3, 40, "pairs", GRID, cost=1e-3, seed=4)
    assert [(r.ohlcv, r.ohlcv2, r.cost) for r in a] == \
        [(r.ohlcv, r.ohlcv2, r.cost) for r in b]
    s1 = port_disp.scenario_jobs("ab" * 16, 3, "sma_crossover", GRID,
                                 params={"n_bars": 64, "seed": 5})
    s2 = ref_disp.scenario_jobs("ab" * 16, 3, "sma_crossover", GRID,
                                params={"n_bars": 64, "seed": 5})
    assert [r.scenario for r in s1] == [r.scenario for r in s2]
    for fn in (port_disp.scenario_jobs, ref_disp.scenario_jobs):
        with pytest.raises(ValueError):
            fn("ab" * 16, 1, "pairs", GRID)
        with pytest.raises(ValueError):
            fn("ab" * 16, 1, "sma_crossover", GRID, params={"bogus": 1})


def test_port_dispatcher_stats_json_names_its_substrate():
    q = _queue(port_disp, native=False)
    d = port_disp.Dispatcher(q, registry=port_obs.Registry())
    try:
        reply = d.GetStats(pb.StatsRequest(), None)
        assert reply.substrate == "python"
        summary = json.loads(reply.obs_json)
        assert "dbx_completions_total{outcome=new}" in summary
        assert any(k.startswith("dbx_rpc_seconds") for k in summary)
    finally:
        d.close()


def test_server_serves_metrics_and_stats_json():
    import urllib.request

    q = _queue(port_disp, native=False)
    d = port_disp.Dispatcher(q, registry=port_obs.Registry())
    srv = port_disp.DispatcherServer(d, bind="localhost:0",
                                     metrics_port=0,
                                     metrics_host="127.0.0.1").start()
    try:
        d.GetStats(pb.StatsRequest(), None)
        base = f"http://127.0.0.1:{srv.metrics.port}"
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            text = r.read().decode()
        with urllib.request.urlopen(f"{base}/stats.json", timeout=10) as r:
            stats = json.loads(r.read())
    finally:
        srv.stop()
    assert "dbx_rpc_seconds" in text and "dbx_queue" in text
    assert stats and isinstance(stats, dict)
