"""The port's worker backend and worker loop against the reference.

``TorchSweepBackend(device="cpu").process`` against
``JaxSweepBackend(use_fused=True).process`` on the same JobSpecs (DBXM
blocks decoded and held to the flip rule of ``torch_parity``), and one
in-process reference dispatcher drained by the port's gRPC worker.
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
from distributed_backtesting_exploration_tpu_torch.rpc import compute, wire
from distributed_backtesting_exploration_tpu_torch.rpc.worker import Worker
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import assert_metrics_match

GRID = parse_grid("fast=3:5,slow=10:14:2")


def _specs(recs):
    return [ref_pb.JobSpec(id=r.id, strategy=r.strategy, ohlcv=r.ohlcv,
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


def test_backend_non_integral_grid_takes_generic_path():
    grid = {"fast": np.float32([3.5, 5.0]), "slow": np.float32([12.25])}
    recs = synthetic_jobs(2, 80, "sma_crossover", grid, cost=1e-3, seed=3)
    specs = _specs(recs)
    got = compute.TorchSweepBackend(device="cpu").process(specs)
    want = ref_compute.JaxSweepBackend(use_fused=True).process(specs)
    ids = [r.id for r in recs]
    assert_metrics_match(_stack(_decoded(got), ids),
                         _stack(_decoded(want), ids))


@pytest.mark.parametrize("field,value,what", [
    ("strategy", "bollinger", "strategy 'bollinger'"),
    ("top_k", 4, "top-k"),
    ("best_returns", True, "best-returns"),
    ("wf_train", 40, "walk-forward"),
    ("append_parent_digest", "abc", "append"),
    ("scenario_batch", True, "scenario"),
    ("ohlcv2", b"DBX1", "pairs"),
])
def test_backend_refuses_what_it_does_not_serve(field, value, what):
    (spec,) = _specs(synthetic_jobs(1, 64, "sma_crossover", GRID))
    if field == "scenario_batch":
        spec.scenario_batch.add()
    else:
        setattr(spec, field, value)
    with pytest.raises(NotImplementedError, match=what):
        compute.TorchSweepBackend(device="cpu").process([spec])


def test_backend_refuses_digest_only_payload():
    (spec,) = _specs(synthetic_jobs(1, 64, "sma_crossover", GRID))
    spec.ohlcv = b""
    spec.panel_digest = "d" * 32
    with pytest.raises(ValueError, match="inline"):
        compute.TorchSweepBackend(device="cpu").process([spec])


def test_stack_field_ragged_repeats_last_bar():
    series = [data.OHLCV(*(f[0] for f in data.synthetic_ohlcv(1, T, seed=T)))
              for T in (5, 3)]
    out = compute._stack_field_ragged(series, 6)
    np.testing.assert_array_equal(out[1, :3], series[1].close)
    assert (out[1, 3:] == series[1].close[-1]).all()
    assert (out[0, 5:] == series[0].close[-1]).all()


def test_worker_drains_reference_dispatcher():
    recs = synthetic_jobs(5, 128, "sma_crossover", GRID, cost=1e-3, seed=5)
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
    assert s["jobs_completed"] == 5 and s["jobs_pending"] == 0
    assert w.jobs_completed == 5 and w.completions_dropped == 0

    # The stored DBXM blocks equal a direct sweep of the same jobs.
    for rec in recs:
        series = data.from_wire_bytes(rec.ohlcv)
        axes = dict(sorted(rec.grid.items()))   # canonical DBXM order
        want = sweep.run_sweep(data.OHLCV(*(f[None, :] for f in series)),
                               get_strategy("sma_crossover"),
                               sweep.product_grid(**axes), cost=1e-3,
                               device="cpu")
        got = wire.metrics_from_bytes(disp.results[rec.id])
        assert_metrics_match(Metrics(*(f[None, :] for f in got)), want)
