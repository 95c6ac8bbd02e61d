"""The port's ``obs.dump`` and ``obs.why`` against the reference's, and the
``utils.trace`` shim.

A small drain (the port's dispatcher and one port worker on the CPU, 8 sma
jobs of 96 bars) writes its span and decision events to a JSONL log. Both
packages' CLIs, run in-process on that log (alone, with a second log, with
a malformed line), on a served ``/stats.json`` and on the live
dispatcher's ``/decisions.json`` and span ring, must print the same bytes
and exit with the same code: 0, or 2 where nothing parses or no decision
record matches the job.
"""

import contextlib
import importlib
import io
import sys
import threading
import time

import pytest

from distributed_backtesting_exploration_tpu.obs import (
    dump as ref_dump, why as ref_why)
from distributed_backtesting_exploration_tpu_torch import obs
from distributed_backtesting_exploration_tpu_torch.obs import (
    dump, events, trace, why)
from distributed_backtesting_exploration_tpu_torch.rpc import (
    compute, dispatcher)
from distributed_backtesting_exploration_tpu_torch.rpc.journal import Journal
from distributed_backtesting_exploration_tpu_torch.rpc.worker import Worker

GRID = dispatcher.parse_grid("fast=3:7,slow=12:20:4")


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _same(port_main, ref_main, argv, rc=0):
    got = _run(port_main, argv)
    want = _run(ref_main, argv)
    assert got == want
    assert got[0] == rc, got
    return got[1]


@pytest.fixture(scope="module")
def drain(tmp_path_factory):
    """The JSONL log of a drain, the job ids and the live dispatcher's
    metrics URL (the server is stopped after the module)."""
    root = tmp_path_factory.mktemp("obs-cli")
    log = root / "events.jsonl"
    prior = events.configured_path()
    events.configure(str(log))
    q = dispatcher.JobQueue(Journal(None), device="cpu")
    d = dispatcher.Dispatcher(q, dispatcher.PeerRegistry(),
                              results_dir=str(root / "res"),
                              registry=obs.Registry())
    srv = dispatcher.DispatcherServer(d, bind="localhost:0",
                                      prune_interval_s=0.2, metrics_port=0,
                                      metrics_host="127.0.0.1").start()
    w = Worker(f"localhost:{srv.port}",
               compute.TorchSweepBackend(device="cpu"), worker_id="cli-w",
               poll_interval_s=0.005, status_interval_s=0.2,
               jobs_per_chip=4, registry=obs.Registry())
    t = threading.Thread(target=w.run, daemon=True)
    t.start()
    recs = dispatcher.synthetic_jobs(8, 96, "sma_crossover", GRID,
                                     cost=1e-3, seed=2)
    try:
        q.enqueue_many(recs)
        deadline = time.monotonic() + 60
        while not q.drained:
            assert time.monotonic() < deadline, q.stats()
            time.sleep(0.01)
    finally:
        w.stop()
        t.join(timeout=30)
        events.configure(prior)
    assert not t.is_alive()
    yield {"log": str(log), "ids": [r.id for r in recs],
           "url": f"http://127.0.0.1:{srv.metrics.port}", "root": root}
    srv.stop()


def test_dump_matches_the_reference_on_jsonl(drain):
    text = _same(dump.main, ref_dump.main, [drain["log"]])
    assert "worker.decode" in text and "worker.d2h" in text
    second = drain["root"] / "second.jsonl"
    lines = open(drain["log"]).read().splitlines()
    second.write_text("\n".join(lines[:5]) + "\n{torn line\n")
    text = _same(dump.main, ref_dump.main,
                 [drain["log"], "--jsonl", str(second)])
    assert "1 malformed line(s) skipped" in text


def test_dump_exits_2_without_events(tmp_path):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    _same(dump.main, ref_dump.main, [str(empty)], rc=2)


def test_dump_matches_the_reference_on_a_served_snapshot():
    reg = obs.Registry()
    reg.counter("dbx_backtests_total").inc(2000)
    reg.counter("dbx_wire_bytes_total", direction="encode",
                kind="metrics").inc(72012)
    h = reg.histogram("dbx_worker_rpc_seconds", method="RequestJobs")
    for v in (0.001, 0.004, 0.02):
        h.observe(v)
    reg.gauge("dbx_worker_busy", worker="w0").set(1)
    srv = obs.MetricsServer(0, registry=reg, bind="127.0.0.1").start()
    try:
        text = _same(dump.main, ref_dump.main,
                     [f"http://127.0.0.1:{srv.port}"])
    finally:
        srv.stop()
    assert "dbx_worker_rpc_seconds" in text and "72012" in text


def test_why_matches_the_reference(drain):
    job = drain["ids"][3]
    text = _same(why.main, ref_why.main, [job, "--jsonl", drain["log"]])
    assert job in text
    _same(why.main, ref_why.main,
          [job, "--jsonl", drain["log"], "--format", "json"])
    _same(why.main, ref_why.main, ["no-such-job", "--jsonl", drain["log"]],
          rc=2)
    _same(why.main, ref_why.main, [job, "--url", drain["url"]])


def test_why_exits_2_without_events(tmp_path):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    _same(why.main, ref_why.main, ["j", "--jsonl", str(empty)], rc=2)


def test_utils_trace_shim_warns_and_reexports():
    name = "distributed_backtesting_exploration_tpu_torch.utils.trace"
    sys.modules.pop(name, None)
    with pytest.warns(DeprecationWarning, match="obs"):
        shim = importlib.import_module(name)
    for attr in ("StepTimer", "device_profile", "span", "timed"):
        assert getattr(shim, attr) is getattr(trace, attr)
