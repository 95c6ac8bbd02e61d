"""The torch worker in the fleet view: its telemetry frames, over loopback
gRPC, against both packages' dispatchers.

- A torch worker (``TorchSweepBackend(device="cpu")``) drains small sma
  jobs from the port's dispatcher and from the JAX package's: in both
  fleet views it is listed, not stale, with the four stages ``decode``,
  ``compile``, ``execute`` and ``d2h``, and the fleet's execute histogram
  is the fold of the workers' rows (the reference bench's rule).
- The port's worker and the reference's, each with its ``InstantBackend``,
  drain the same jobs from the port's dispatcher: the worker-side metric
  families and labels, the telemetry frame's keys and the counts of jobs
  received and of ``CompleteJobs`` bytes are equal.
- The port versions of ``tests/test_fleet.py``'s
  ``test_stopped_worker_goes_stale_then_evicted``,
  ``test_straggler_flagged_on_slowed_worker`` and
  ``test_fleet_gossip_under_lockdep_is_violation_free`` (the last under the
  port's lockdep, in an interpreter of its own with JAX blocked: the two
  packages' lockdeps patch the same factories).
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from distributed_backtesting_exploration_tpu.obs import (
    registry as ref_registry)
from distributed_backtesting_exploration_tpu.rpc import (
    compute as ref_compute, dispatcher as ref_disp, worker as ref_worker)
from distributed_backtesting_exploration_tpu_torch import bench, obs
from distributed_backtesting_exploration_tpu_torch.obs import fleet
from distributed_backtesting_exploration_tpu_torch.rpc import (
    compute, dispatcher)
from distributed_backtesting_exploration_tpu_torch.rpc.journal import Journal
from distributed_backtesting_exploration_tpu_torch.rpc.worker import Worker

REPO = Path(__file__).resolve().parent.parent
GRID = {"fast": np.arange(5.0, 9.0, dtype=np.float32)}
SMA_GRID = dispatcher.parse_grid("fast=3:7,slow=12:20:4")


def _wait(pred, timeout=60.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _port_dispatcher(tmp_path, name="res", prune_window_s=30.0,
                     prune_interval_s=0.2):
    q = dispatcher.JobQueue(Journal(None), device="cpu")
    d = dispatcher.Dispatcher(
        q, dispatcher.PeerRegistry(prune_window_s=prune_window_s),
        results_dir=str(tmp_path / name), registry=obs.Registry())
    srv = dispatcher.DispatcherServer(
        d, bind="localhost:0", prune_interval_s=prune_interval_s).start()
    return q, d, srv


def _ref_dispatcher(tmp_path):
    q = ref_disp.JobQueue()
    d = ref_disp.Dispatcher(q, ref_disp.PeerRegistry(prune_window_s=30.0),
                            results_dir=str(tmp_path / "ref-res"))
    srv = ref_disp.DispatcherServer(d, bind="localhost:0",
                                    prune_interval_s=0.2).start()
    return q, d, srv


def _run(workers):
    threads = [threading.Thread(target=w.run, daemon=True) for w in workers]
    for t in threads:
        t.start()
    return threads


def _stop(workers, threads, srv):
    for w in workers:
        w.stop()
    for t in threads:
        t.join(timeout=30)
    srv.stop()
    assert not any(t.is_alive() for t in threads)


def test_torch_worker_frames_in_both_fleet_views(tmp_path, monkeypatch):
    monkeypatch.setenv("DBX_FLEET_FRAME_MIN_S", "0.02")
    monkeypatch.setenv("DBX_FLEET_HEARTBEAT_S", "0.05")
    views = {}
    for pkg in ("port", "ref"):
        q, d, srv = (_port_dispatcher(tmp_path) if pkg == "port"
                     else _ref_dispatcher(tmp_path))
        wid = f"torch-{pkg}"
        w = Worker(f"localhost:{srv.port}",
                   compute.TorchSweepBackend(device="cpu"), worker_id=wid,
                   poll_interval_s=0.01, status_interval_s=0.2,
                   jobs_per_chip=4, registry=obs.Registry())
        threads = _run([w])
        try:
            recs = dispatcher.synthetic_jobs(12, 96, "sma_crossover",
                                             SMA_GRID, cost=1e-3, seed=7)
            if pkg == "ref":
                recs = [ref_disp.JobRecord(**{
                    f.name: getattr(r, f.name)
                    for f in dataclasses.fields(r)}) for r in recs]
            for r in recs:
                q.enqueue(r)
            _wait(lambda: q.drained, msg=f"{pkg} drain")
            _wait(lambda: all(
                d.fleet.snapshot()["workers"].get(wid, {}).get(
                    "stages", {}).get(s, {}).get("n", 0) > 0
                for s in fleet.TELEMETRY_STAGES),
                msg=f"{pkg} fleet view with the four stages")
            views[pkg] = d.fleet.snapshot()
        finally:
            _stop([w], threads, srv)
    for pkg, snap in views.items():
        row = snap["workers"][f"torch-{pkg}"]
        assert row["stale"] is False
        assert set(fleet.TELEMETRY_STAGES) <= set(row["stages"])
        assert row["caps"]["backend"] == "torch"
        assert bench.fleet_merge_exact(snap), pkg


def _worker_families(reg) -> set:
    return {(name, label) for name, fam in reg.snapshot().items()
            if name.startswith("dbx_worker_")
            for label in fam["values"]}


def test_port_worker_counts_as_the_reference_worker(tmp_path):
    n = 24
    recs = [dataclasses.replace(r, id=f"job-{i:04d}")
            for i, r in enumerate(dispatcher.synthetic_jobs(
                n, 32, "sma_crossover", GRID, seed=3))]
    out = {}
    for pkg in ("port", "ref"):
        q, d, srv = _port_dispatcher(tmp_path, name=pkg)
        reg = obs.Registry() if pkg == "port" else ref_registry.Registry()
        cls, backend = ((Worker, compute.InstantBackend()) if pkg == "port"
                        else (ref_worker.Worker, ref_compute.InstantBackend()))
        w = cls(f"localhost:{srv.port}", backend, worker_id=f"w-{pkg}",
                poll_interval_s=0.005, status_interval_s=0.2,
                jobs_per_chip=8, registry=reg)
        threads = _run([w])
        try:
            q.enqueue_many([dataclasses.replace(r, id=f"{r.id}-{pkg[0]}")
                            for r in recs])
            _wait(lambda: q.drained, msg=f"{pkg} drain")
            _wait(lambda: w.jobs_completed == n, msg="reports")
            frame = w._telemetry.frame()
        finally:
            _stop([w], threads, srv)
        snap = reg.snapshot()

        def value(name, **labels):
            key = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            v = snap[name]["values"][key]
            return v["count"] if isinstance(v, dict) else v

        rpcs = value("dbx_worker_rpc_seconds", method="CompleteJobs")
        out[pkg] = {
            "families": _worker_families(reg),
            # "costmodel" rides a frame only while the process's cost-model
            # tracker holds residuals (spans of earlier work in it).
            "frame": set(frame) - {"costmodel"},
            "jobs_in": value("dbx_worker_jobs_received_total"),
            # The CompleteJobs bytes less each RPC's header (the worker id,
            # tag and length): the items alone, whatever the batching.
            "complete_items": value("dbx_worker_wire_bytes_total",
                                    method="CompleteJobs",
                                    direction="request")
            - rpcs * (2 + len(f"w-{pkg}"))}
    assert out["port"]["families"] == out["ref"]["families"]
    assert out["port"]["frame"] == out["ref"]["frame"]
    assert out["port"]["jobs_in"] == out["ref"]["jobs_in"] == n
    assert out["port"]["complete_items"] == out["ref"]["complete_items"] > 0


def test_stopped_worker_goes_stale_then_evicted(tmp_path, monkeypatch):
    monkeypatch.setenv("DBX_FLEET_STALE_S", "0.6")
    monkeypatch.setenv("DBX_FLEET_FRAME_MIN_S", "0.05")
    monkeypatch.setenv("DBX_FLEET_HEARTBEAT_S", "0.1")
    q, disp, srv = _port_dispatcher(tmp_path, prune_window_s=60.0,
                                    prune_interval_s=0.1)
    workers = [Worker(f"localhost:{srv.port}", compute.InstantBackend(),
                      worker_id=f"st-{i}", poll_interval_s=0.05,
                      status_interval_s=0.5, jobs_per_chip=8)
               for i in range(2)]
    threads = _run(workers)
    try:
        q.enqueue_many(dispatcher.synthetic_jobs(16, 32, "sma_crossover",
                                                 GRID, seed=3))
        _wait(lambda: q.drained, msg="drain")
        _wait(lambda: set(disp.fleet.snapshot()["workers"])
              == {"st-0", "st-1"}, msg="both workers in the fleet view")
        workers[1].stop()
        threads[1].join(timeout=20)
        assert not threads[1].is_alive()
        _wait(lambda: disp.fleet.snapshot()["workers"]
              .get("st-1", {}).get("stale") is True,
              msg="stopped worker flagged stale")
        snap = disp.fleet.snapshot()
        assert snap["workers"]["st-0"]["stale"] is False
        assert snap["fleet"]["live"] == 1
        assert snap["fleet"]["stale"] == 1
        _wait(lambda: "st-1" not in disp.fleet.snapshot()["workers"],
              msg="stale entry evicted by the prune path")
        assert "st-0" in disp.fleet.snapshot()["workers"]
        assert disp.obs.counter(
            "dbx_fleet_workers_evicted_total").value >= 1
    finally:
        _stop(workers, threads, srv)


def _frame(gen, pid, stages):
    return json.dumps({
        "v": 1, "gen": gen, "pid": pid, "seq": 1, "t": 1000.0,
        "uptime_s": 5.0, "busy": 1, "inflight": 1,
        "pipeline": {"on": False, "depth": 2}, "jobs_completed": 10,
        "completions_dropped": 0, "polls": 1, "jobs_per_s": 2.5,
        "caps": {"backend": "torch", "chips": 1}, "caches": {}, "proc": {},
        "stages": stages}, sort_keys=True)


def _stage_frame_stats(durs):
    st = fleet._StageStats()
    for d in durs:
        st.observe({"name": "worker.execute", "dur_s": d})
    return st.snapshot()


def test_straggler_flagged_on_slowed_worker():
    fast = _stage_frame_stats([0.001] * 100)
    slow = _stage_frame_stats([0.8] * 4)
    fv = fleet.FleetView(registry=obs.Registry(), clock=lambda: 0.0)
    fv.update("w-fast", _frame("f", 1, fast))
    fv.update("w-slow", _frame("s", 2, slow))
    snap = fv.snapshot(now=0.0)
    assert snap["workers"]["w-slow"]["stragglers"] == ["execute"]
    assert snap["workers"]["w-fast"]["stragglers"] == []
    reg = obs.Registry()
    fv2 = fleet.FleetView(registry=reg, clock=lambda: 0.0)
    fv2.update("w-fast", _frame("f", 1, fast))
    fv2.update("w-slow", _frame("s", 2, slow))
    fv2.collect(reg)
    fv2.collect(reg)
    assert reg.counter("dbx_fleet_straggler_flags_total",
                       stage="execute").value == 1


_LOCKDEP_GOSSIP = """
import os, sys, tempfile, threading, time
sys.modules["jax"] = None
os.environ["DBX_FLEET_FRAME_MIN_S"] = "0.02"
os.environ["DBX_FLEET_HEARTBEAT_S"] = "0.05"
import numpy as np
from distributed_backtesting_exploration_tpu_torch.analysis import lockdep
lockdep.install()
lockdep.reset()
from distributed_backtesting_exploration_tpu_torch import obs
from distributed_backtesting_exploration_tpu_torch.rpc import (
    compute, dispatcher)
from distributed_backtesting_exploration_tpu_torch.rpc.journal import Journal
from distributed_backtesting_exploration_tpu_torch.rpc.worker import Worker
q = dispatcher.JobQueue(Journal(None), device="cpu")
disp = dispatcher.Dispatcher(q, dispatcher.PeerRegistry(prune_window_s=60.0),
                             results_dir=tempfile.mkdtemp(),
                             registry=obs.Registry())
assert isinstance(disp.fleet._lock, lockdep._LockdepLock)
srv = dispatcher.DispatcherServer(disp, bind="localhost:0",
                                  prune_interval_s=0.1).start()
w = Worker(f"localhost:{srv.port}", compute.InstantBackend(),
           worker_id="ld-0", poll_interval_s=0.02, status_interval_s=0.5,
           jobs_per_chip=8)
t = threading.Thread(target=w.run, daemon=True)
t.start()
def wait(pred):
    deadline = time.monotonic() + 60
    while not pred():
        assert time.monotonic() < deadline
        time.sleep(0.02)
try:
    q.enqueue_many(dispatcher.synthetic_jobs(
        24, 32, "sma_crossover", {"fast": np.arange(5.0, 9.0)}, seed=9))
    wait(lambda: q.drained)
    wait(lambda: "ld-0" in disp.fleet.snapshot()["workers"])
    for _ in range(5):
        disp.fleet.snapshot()
        disp.obs.render_prometheus()
        w.obs.render_prometheus()
        time.sleep(0.02)
finally:
    w.stop()
    t.join(timeout=20)
    srv.stop()
assert not t.is_alive()
rep = lockdep.report()
assert rep["violations"] == [], rep["violations"]
assert any("FleetView" in cls for cls in rep["held"]), rep["held"]
print("ok")
"""


def test_fleet_gossip_under_lockdep_is_violation_free():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "DBX_LOCKDEP")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", _LOCKDEP_GOSSIP], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"
