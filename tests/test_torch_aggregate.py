"""The port's result read path (``rpc/aggregate.py``, ``rpc/journal.py``)
against the reference's, on one results directory and one journal that the
reference's dispatcher wrote (its ``Journal``, its ``wire`` blocks): sweep,
top-k, walk-forward and best-returns blocks, an all-NaN job and a
completed job whose block is missing. Both packages must report the same
thing."""

import json
import os

import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.rpc import (
    aggregate as ref_aggregate, backtesting_pb2 as ref_pb,
    compute as ref_compute, journal as ref_journal, wire as ref_wire)
from distributed_backtesting_exploration_tpu.rpc.dispatcher import (
    Dispatcher, JobQueue, parse_grid, synthetic_jobs)
from distributed_backtesting_exploration_tpu_torch.ops import metrics
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.rpc import (
    aggregate, journal)

GRID = parse_grid("fast=3:5,slow=10:14:2")


def _spec(r):
    return ref_pb.JobSpec(
        id=r.id, strategy=r.strategy, ohlcv=r.ohlcv,
        grid=ref_wire.grid_to_proto(r.grid), cost=r.cost,
        periods_per_year=252, top_k=r.top_k, rank_metric=r.rank_metric,
        best_returns=r.best_returns, wf_train=r.wf_train, wf_test=r.wf_test,
        wf_metric=r.wf_metric)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """``(results_dir, journal_path, jobs by kind)`` of a fleet run."""
    root = tmp_path_factory.mktemp("fleet")
    journal_path = str(root / "journal.jsonl")
    results_dir = str(root / "results")
    queue = JobQueue(ref_journal.Journal(journal_path))
    kinds = {
        "sweep": synthetic_jobs(3, 96, "sma_crossover", GRID, cost=1e-3,
                                seed=3),
        "topk": synthetic_jobs(2, 96, "sma_crossover", GRID, cost=1e-3,
                               seed=4, top_k=2, rank_metric="sharpe"),
        "walkforward": synthetic_jobs(2, 200, "sma_crossover", GRID,
                                      cost=1e-3, seed=5, wf_train=80,
                                      wf_test=30, wf_metric="sharpe"),
        "returns": synthetic_jobs(4, 96, "sma_crossover", GRID, cost=1e-3,
                                  seed=6, best_returns=True,
                                  rank_metric="sharpe"),
        "nan": synthetic_jobs(1, 96, "sma_crossover", GRID, seed=7),
        "missing": synthetic_jobs(1, 96, "sma_crossover", GRID, seed=8),
    }
    recs = [r for rs in kinds.values() for r in rs]
    for rec in recs:
        queue.enqueue(rec)
    disp = Dispatcher(queue, results_dir=results_dir)
    queue.take(len(recs), "w1")
    computed = [r for k, rs in kinds.items() if k != "nan" for r in rs]
    backend = ref_compute.JaxSweepBackend(use_fused=False)
    for c in backend.process([_spec(r) for r in computed]):
        disp._complete_one(c.job_id, "w1", c.metrics, c.elapsed_s)
    nan_row = ref_wire.metrics_to_bytes(ref_aggregate.Metrics(
        *(np.full(6, np.nan, np.float32)
          for _ in ref_aggregate.Metrics._fields)))
    disp._complete_one(kinds["nan"][0].id, "w1", nan_row, 0.0)
    os.remove(os.path.join(results_dir, f"{kinds['missing'][0].id}.dbxm"))
    return results_dir, journal_path, kinds


def _same(a, b):
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


@pytest.mark.parametrize("metric", ["sharpe", "max_drawdown", "total_return"])
def test_aggregate_matches_reference(fleet, metric):
    results_dir, journal_path, kinds = fleet
    got = aggregate.aggregate(results_dir, journal_path, metric=metric,
                              top=100)
    _same(got, ref_aggregate.aggregate(results_dir, journal_path,
                                       metric=metric, top=100))
    n = sum(len(v) for v in kinds.values())
    assert got["jobs_aggregated"] == n - 1 and got["jobs_missing"] == 1
    modes = {r["job"]: r["mode"] for r in got["best"]}
    for kind, mode in (("sweep", "sweep"), ("topk", "sweep_topk"),
                       ("walkforward", "walkforward_oos"),
                       ("returns", "sweep_best_returns")):
        assert {modes[r.id] for r in kinds[kind]} == {mode}
    # The all-NaN job ranks last, and walk-forward rows name no params.
    assert got["best"][-1]["job"] == kinds["nan"][0].id
    assert all(r["params"] == {} for r in got["best"]
               if r["mode"] == "walkforward_oos")


def test_aggregate_rejects_unknown_metric(fleet):
    with pytest.raises(ValueError, match="unknown metric"):
        aggregate.aggregate(*fleet[:2], metric="nope")


@pytest.mark.parametrize("weights", ["equal", "inverse_vol", "min_variance"])
def test_portfolio_matches_reference(fleet, weights):
    results_dir, journal_path, kinds = fleet
    got = aggregate.portfolio(results_dir, journal_path, weights=weights)
    _same(got, ref_aggregate.portfolio(results_dir, journal_path,
                                       weights=weights))
    assert got["legs_composed"] == len(kinds["returns"])
    # Every other block, and the completed job without one, is skipped.
    assert got["blocks_skipped"] == sum(
        len(v) for k, v in kinds.items() if k != "returns")


def test_portfolio_rejects_unknown_weights(fleet):
    with pytest.raises(ValueError, match="unknown weights scheme"):
        aggregate.portfolio(*fleet[:2], weights="nope")


@pytest.mark.parametrize("argv", [
    ["--metric", "sharpe", "--top", "3"], ["--metric", "max_drawdown"],
    ["--portfolio"], ["--portfolio", "min_variance", "--top", "2"]],
    ids=["ranking", "lower-is-better", "portfolio", "min-variance"])
def test_cli_json_matches_reference(fleet, capsys, argv):
    results_dir, journal_path, _ = fleet
    base = ["--results-dir", results_dir, "--journal", journal_path]
    aggregate.main(base + argv)
    got = capsys.readouterr().out
    ref_aggregate.main(base + argv)
    assert got == capsys.readouterr().out
    json.loads(got)      # strict JSON: the all-NaN job's value is null


def test_np_product_grid_matches_sweep_product_grid():
    axes = {"fast": np.float32([3, 4, 5]), "slow": np.float32([10, 12])}
    got = aggregate._np_product_grid(axes)
    want = sweep.product_grid(**axes)
    for k in axes:
        np.testing.assert_array_equal(got[k], want[k].numpy())


def test_np_portfolio_metrics_match_summary_metrics():
    # The reference's own check of its numpy twin (rel=2e-4, abs=1e-6),
    # here against the port's summary_metrics.
    r = np.random.default_rng(7).normal(0.0005, 0.01, 512).astype(np.float32)
    got = aggregate._np_portfolio_metrics(r)
    t = torch.as_tensor(r)
    want = metrics.summary_metrics(t, 1.0 + torch.cumsum(t, 0),
                                   torch.zeros_like(t))
    for name, v in got.items():
        assert v == pytest.approx(float(getattr(want, name)), rel=2e-4,
                                  abs=1e-6), name
    assert got == ref_aggregate._np_portfolio_metrics(r)


def test_min_variance_weights_match_reference():
    rng = np.random.default_rng(9)
    R = rng.normal(0, 0.01, (5, 200))
    R[3] = R[1]                      # bit-identical legs
    R[4] = 0.0                       # a dead leg
    live = R.std(axis=-1) > 0
    np.testing.assert_array_equal(aggregate._min_variance_weights(R, live),
                                  ref_aggregate._min_variance_weights(R, live))


# --- the journal's reader ---------------------------------------------------

def _replays_equal(a, b):
    for name in ("jobs", "completed", "failed", "corrupt_lines",
                 "total_lines", "deltas", "terminal_events", "pending"):
        assert getattr(a, name) == getattr(b, name), name


def test_replay_matches_reference(fleet):
    _, journal_path, kinds = fleet
    got = journal.Journal.replay(journal_path)
    _replays_equal(got, ref_journal.Journal.replay(journal_path))
    assert len(got.jobs) == sum(len(v) for v in kinds.values())
    assert got.pending == []


def _write(path, lines):
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")


def test_replay_of_events_matches_reference(tmp_path):
    events = [
        {"ev": "enqueue", "id": "a", "strategy": "sma_crossover"},
        {"ev": "enqueue", "id": "b", "strategy": "pairs"},
        {"ev": "digest", "id": "a", "pdig": "d1"},
        {"ev": "delta", "ndig": "d2", "pdig": "d1", "base": 10},
        {"ev": "complete", "id": "a", "worker": "w1"},
        {"ev": "complete", "id": "a", "worker": "w2"},
        {"ev": "fail", "id": "b", "reason": "bad"},
        {"ev": "enqueue", "id": "c"},
    ]
    path = str(tmp_path / "j.jsonl")
    _write(path, [json.dumps(e) for e in events])
    got = journal.Journal.replay(path)
    _replays_equal(got, ref_journal.Journal.replay(path))
    assert got.pending == ["c"] and got.jobs["a"]["pdig"] == "d1"
    assert [e["worker"] for e in got.terminal_events[:1]] == ["w1"]
    missing = journal.Journal.replay(str(tmp_path / "none.jsonl"))
    _replays_equal(missing,
                   ref_journal.Journal.replay(str(tmp_path / "none.jsonl")))


def test_replay_torn_tail_and_corrupt_interior_match_reference(tmp_path):
    good = [json.dumps({"ev": "enqueue", "id": i}) for i in "abc"]
    torn = str(tmp_path / "torn.jsonl")
    _write(torn, good + ['{"ev": "complete", "id"'])
    got = journal.Journal.replay(torn)
    _replays_equal(got, ref_journal.Journal.replay(torn))
    assert got.pending == ["a", "b", "c"] and got.corrupt_lines == 0

    corrupt = str(tmp_path / "corrupt.jsonl")
    _write(corrupt, good[:1] + ["{not json"] + good[1:])
    with pytest.raises(journal.JournalCorruptError, match=":2:"):
        journal.Journal.replay(corrupt)
    with pytest.raises(ref_journal.JournalCorruptError):
        ref_journal.Journal.replay(corrupt)
    got = journal.Journal.replay(corrupt, strict=False)
    _replays_equal(got, ref_journal.Journal.replay(corrupt, strict=False))
    assert got.corrupt_lines == 1 and len(got.jobs) == 3
