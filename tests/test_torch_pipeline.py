"""The port's two-phase backend, its pipelined executor and the worker's
digest-only intake.

``submit`` then ``collect`` gives the bytes ``process`` gives; the
executor's pipeline (depths 1-3) and its serial loop give them too, in
order, and a batch whose submit or collect raises leaves the rest
running. Then the port's gRPC worker drains a JAX ``DispatcherServer`` on
``localhost:0`` of top-k and best-returns jobs, twice over the same panels
so the second pass ships digest-only, serially (the default,
``DBX_PIPELINE=0``), pipelined at depth 2, and with a cache that keeps nothing (every
digest-only panel through ``FetchPayload``): every job completes, with
blocks matching the JAX backend's on the same jobs.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

from distributed_backtesting_exploration_tpu.ops import metrics as ref_metrics
from distributed_backtesting_exploration_tpu.rpc import (
    backtesting_pb2 as ref_pb, compute as ref_compute, wire as ref_wire)
from distributed_backtesting_exploration_tpu.rpc.dispatcher import (
    Dispatcher, DispatcherServer, JobQueue, PeerRegistry, parse_grid,
    synthetic_jobs)
from distributed_backtesting_exploration_tpu_torch.ops.metrics import Metrics
from distributed_backtesting_exploration_tpu_torch.rpc import (
    compute, executor, wire)
from distributed_backtesting_exploration_tpu_torch.rpc.worker import Worker

from torch_parity import assert_metrics_match

SMA = parse_grid("fast=3:5,slow=10:14:2")
PAIRS = parse_grid("lookback=8:20:6,z_entry=1:3")


def _specs(recs):
    return [ref_pb.JobSpec(id=r.id, strategy=r.strategy, ohlcv=r.ohlcv,
                           ohlcv2=r.ohlcv2 or b"",
                           grid=ref_wire.grid_to_proto(r.grid), cost=r.cost,
                           periods_per_year=252, top_k=r.top_k,
                           rank_metric=r.rank_metric,
                           best_returns=r.best_returns, trace_id=f"t-{r.id}")
            for r in recs]


def _mixed_batch():
    """Plain, top-k and best-returns sma jobs, pairs plain and top-k, and a
    validated-bad top-k job, in one batch."""
    recs = synthetic_jobs(2, 80, "sma_crossover", SMA, cost=1e-3, seed=1)
    recs += synthetic_jobs(2, 80, "sma_crossover", SMA, cost=1e-3, seed=2,
                           top_k=3, rank_metric="max_drawdown")
    recs += synthetic_jobs(2, 90, "sma_crossover", SMA, cost=1e-3, seed=3,
                           best_returns=True, rank_metric="sharpe")
    recs += synthetic_jobs(2, 80, "pairs", PAIRS, cost=1e-3, seed=4)
    recs += synthetic_jobs(2, 80, "pairs", PAIRS, cost=1e-3, seed=5, top_k=2)
    recs += synthetic_jobs(1, 80, "sma_crossover", SMA, seed=6, top_k=2,
                           rank_metric="alpha")
    return _specs(recs)


def _blocks(completions):
    return [(c.job_id, c.metrics, c.trace_id) for c in completions]


def test_submit_then_collect_gives_process_bytes():
    specs = _mixed_batch()
    want = compute.TorchSweepBackend(device="cpu").process(specs)
    backend = compute.TorchSweepBackend(device="cpu")
    handle = backend.submit(specs)
    got = backend.collect(handle)
    assert _blocks(got) == _blocks(want)
    kinds = sorted(wire.result_kind(c.metrics) for c in got)
    assert kinds == sorted(["metrics"] * 4 + ["topk"] * 4 + ["returns"] * 2
                           + ["empty"])


@pytest.mark.parametrize("pipelined,depth", [(False, 1), (True, 1),
                                             (True, 2), (True, 3)])
def test_executor_gives_process_bytes_in_order(pipelined, depth):
    batches = [_specs(synthetic_jobs(2, 64 + 8 * i, "sma_crossover", SMA,
                                     cost=1e-3, seed=10 + i,
                                     top_k=2 * (i % 2)))
               for i in range(5)]
    backend = compute.TorchSweepBackend(device="cpu")
    want = [c for b in batches for c in backend.process(b)]
    ex = executor.Executor(compute.TorchSweepBackend(device="cpu"),
                           pipelined=pipelined, depth=depth)
    assert ex.pipelined is pipelined and ex.depth == depth
    ex.start()
    for b in batches:
        ex.inbox.put(b)
    assert ex.close(timeout=60.0)
    assert not ex.busy.is_set()
    assert _blocks(ex.take_completions()) == _blocks(want)


class _Flaky:
    """A two-phase backend whose second batch fails in ``fail``."""

    def __init__(self, fail: str):
        self.fail = fail
        self.calls = 0
        self.inflight = 0
        self.max_inflight = 0

    def submit(self, batch):
        self.calls += 1
        if self.fail == "submit" and self.calls == 2:
            raise RuntimeError("submit failed")
        self.inflight += 1
        self.max_inflight = max(self.max_inflight, self.inflight)
        return (self.calls, batch)

    def collect(self, handle):
        n, batch = handle
        time.sleep(0.01)
        self.inflight -= 1
        if self.fail == "collect" and n == 2:
            raise RuntimeError("collect failed")
        return [compute.Completion(j, b"", 0.0) for j in batch]


@pytest.mark.parametrize("fail", ["submit", "collect"])
def test_executor_leaves_a_failed_batch_and_keeps_running(fail, caplog):
    backend = _Flaky(fail)
    ex = executor.Executor(backend, pipelined=True, depth=2)
    ex.start()
    for i in range(4):
        ex.inbox.put([f"b{i}-a", f"b{i}-b"])
    with caplog.at_level("ERROR", logger="dbx.torch.executor"):
        assert ex.close(timeout=30.0)
    ids = [c.job_id for c in ex.take_completions()]
    assert ids == ["b0-a", "b0-b", "b2-a", "b2-b", "b3-a", "b3-b"]
    assert f"{fail}" in caplog.text and "re-queue" in caplog.text
    assert backend.max_inflight <= 2 and not ex.busy.is_set()


def test_executor_runs_a_process_only_backend_serially():
    class ProcessOnly:
        def process(self, batch):
            return [compute.Completion(j, b"x", 0.0) for j in batch]

    ex = executor.Executor(ProcessOnly(), pipelined=True)
    assert not ex.pipelined
    ex.start()
    ex.inbox.put(["a", "b"])
    assert ex.close()
    assert [c.job_id for c in ex.take_completions()] == ["a", "b"]


def test_pipeline_knobs_are_read_as_the_reference_reads_them(monkeypatch):
    monkeypatch.delenv("DBX_PIPELINE", raising=False)
    monkeypatch.delenv("DBX_PIPELINE_DEPTH", raising=False)
    # Unset, the serial loop (the pipeline was the slower on the H100).
    assert not executor.pipeline_enabled() and executor.pipeline_depth() == 2
    assert not executor.Executor(
        compute.TorchSweepBackend(device="cpu")).pipelined
    for off in ("0", "off", "FALSE"):
        monkeypatch.setenv("DBX_PIPELINE", off)
        assert not executor.pipeline_enabled()
    monkeypatch.setenv("DBX_PIPELINE", "yes")
    assert executor.pipeline_enabled()
    monkeypatch.setenv("DBX_PIPELINE_DEPTH", "0")
    assert executor.pipeline_depth() == 1
    monkeypatch.setenv("DBX_PIPELINE_DEPTH", "3")
    ex = executor.Executor(compute.TorchSweepBackend(device="cpu"))
    assert ex.pipelined and ex.depth == 3


def _wait_completed(queue, n_jobs):
    deadline = time.monotonic() + 90.0
    while (queue.stats()["jobs_completed"] < n_jobs
           and time.monotonic() < deadline):
        time.sleep(0.02)
    assert queue.stats()["jobs_completed"] == n_jobs, queue.stats()


class _Recording(compute.TorchSweepBackend):
    """The port's backend, counting the digest-only legs it is handed."""

    digest_only = 0

    def submit(self, jobs):
        self.digest_only += sum(1 for j in jobs
                                if j.panel_digest and not j.ohlcv)
        return super().submit(jobs)


@pytest.mark.parametrize("pipeline,depth,cache_mb", [
    ("0", "2", "256"), ("1", "2", "256"), ("1", "2", "0")],
    ids=["serial", "pipelined", "fetch-every-panel"])
def test_worker_drains_topk_best_returns_and_digest_only_jobs(
        monkeypatch, pipeline, depth, cache_mb):
    monkeypatch.setenv("DBX_PIPELINE", pipeline)
    monkeypatch.setenv("DBX_PIPELINE_DEPTH", depth)
    monkeypatch.setenv("DBX_PANEL_CACHE_MB", cache_mb)
    first = synthetic_jobs(3, 96, "sma_crossover", SMA, cost=1e-3, seed=31,
                           top_k=8, rank_metric="sharpe")
    first += synthetic_jobs(2, 96, "bollinger", parse_grid(
        "window=10:20:5,k=1:3"), cost=1e-3, seed=32, top_k=8,
        rank_metric="max_drawdown")
    first += synthetic_jobs(3, 96, "sma_crossover", SMA, cost=1e-3, seed=33,
                            best_returns=True, rank_metric="sharpe")
    first += synthetic_jobs(2, 96, "pairs", PAIRS, cost=1e-3, seed=34,
                            top_k=8)
    # The same panels again under new ids: the dispatcher has delivered
    # them to this worker, so it ships these digest-only.
    second = [dataclasses.replace(r, id=f"again-{r.id}") for r in first]
    queue = JobQueue()
    disp = Dispatcher(queue, PeerRegistry(prune_window_s=10.0))
    srv = DispatcherServer(disp, bind="localhost:0",
                           prune_interval_s=0.1).start()
    backend = _Recording(device="cpu")
    w = Worker(f"localhost:{srv.port}", backend, poll_interval_s=0.02,
               status_interval_s=0.05, jobs_per_chip=3)
    # The worker runs until stopped (no idle exit between the passes).
    t = threading.Thread(target=w.run, daemon=True)
    t.start()
    try:
        for rec in first:
            queue.enqueue(rec)
        _wait_completed(queue, len(first))
        decodes = backend.decodes
        for rec in second:
            queue.enqueue(rec)
        _wait_completed(queue, len(first) + len(second))
        assert queue.drained, queue.stats()
    finally:
        w.stop()
        t.join(timeout=30)
        srv.stop()
    assert not t.is_alive()
    recs = first + second
    assert queue.stats()["jobs_completed"] == len(recs)
    assert w.jobs_completed == len(recs) and w.completions_dropped == 0
    assert backend.payload_fetcher is None
    legs = sum(2 if r.strategy == "pairs" else 1 for r in second)
    if cache_mb == "0":
        # Nothing kept: the control thread fetched every digest-only leg
        # (once a digest a batch) and the backend got the bytes inline.
        assert w.payload_fetches >= len(second) and backend.decodes >= legs
    else:
        # The second pass came digest-only and was served from the host
        # cache: no fetch, and no decode on the compute thread (the first
        # pass's panels were decoded there or by the prefetch thread).
        assert backend.digest_only >= len(second)
        assert w.payload_fetches == 0 and backend.decodes == decodes

    want = {c.job_id: c.metrics for c in
            ref_compute.JaxSweepBackend(use_fused=True).process(
                _specs(first))}
    for r in recs:
        got = disp.results[r.id]
        ref = want[r.id.removeprefix("again-")]
        assert wire.result_kind(got) == ref_wire.result_kind(ref)
        if r.best_returns:
            g, gm, gr, _ = wire.best_returns_from_bytes(got)
            w_, wm, wr, _ = ref_wire.best_returns_from_bytes(ref)
            assert g == w_
            np.testing.assert_allclose(gr, wr, rtol=2e-4, atol=2e-5)
            assert_metrics_match(
                Metrics(*(np.float32([v]) for v in gm)),
                ref_metrics.Metrics(*(np.float32([v]) for v in wm)))
        else:
            gi, gm, _ = wire.topk_from_bytes(got)
            wi, wm, _ = ref_wire.topk_from_bytes(ref)
            np.testing.assert_array_equal(gi, wi)
            assert_metrics_match(
                gm, wm, **({"rtol": 2e-3, "atol": 2e-4}
                           if r.strategy == "pairs" else {}))
