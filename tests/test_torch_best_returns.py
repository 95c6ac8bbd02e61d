"""The port's best-returns (DBXP) jobs against the reference.

``sweep.best_params`` against the reference's on crafted rows (ties, NaN,
+-inf and +-0) in both directions. Then ``TorchSweepBackend(device="cpu")``
against ``JaxSweepBackend`` on the same best-returns JobSpecs: the grid
index and the metric row under the flip rule of ``torch_parity`` (an index
may differ only where its cell flipped), the return series at rtol=2e-4
where the index agrees, trimmed to each job's own length; pairs and
unknown-metric requests complete empty in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.ops import metrics as ref_metrics
from distributed_backtesting_exploration_tpu.parallel import sweep as ref_sweep
from distributed_backtesting_exploration_tpu.rpc import (
    backtesting_pb2 as ref_pb, compute as ref_compute, wire as ref_wire)
from distributed_backtesting_exploration_tpu.rpc.dispatcher import (
    parse_grid, synthetic_jobs)
from distributed_backtesting_exploration_tpu_torch.models import get_strategy
from distributed_backtesting_exploration_tpu_torch.ops.metrics import Metrics
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.rpc import compute, wire
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import CRAFTED, assert_metrics_match


@pytest.mark.parametrize("metric", [None, "sharpe", "max_drawdown",
                                    "volatility"])
def test_best_params_matches_reference_on_crafted_rows(metric):
    grid = {"fast": np.arange(3, 11, dtype=np.float32)}
    best, chosen, idx = sweep.best_params(
        torch.from_numpy(CRAFTED), {k: torch.from_numpy(v)
                                    for k, v in grid.items()},
        metric=metric, return_index=True)
    rbest, rchosen, ridx = ref_sweep.best_params(
        jnp.asarray(CRAFTED), {k: jnp.asarray(v) for k, v in grid.items()},
        metric=metric, return_index=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(best.numpy(), np.asarray(rbest))
    np.testing.assert_array_equal(chosen["fast"].numpy(),
                                  np.asarray(rchosen["fast"]))
    two = sweep.best_params(torch.from_numpy(CRAFTED), grid, metric=metric)
    assert len(two) == 2
    np.testing.assert_array_equal(two[0].numpy(), best.numpy())


def test_best_params_ranks_nan_last_and_takes_the_first_tie():
    # +0 and -0 are equal for argmax (unlike top-k's total order).
    rows = torch.tensor([[np.nan, -0.0, 0.0, -1.0], [np.nan] * 4,
                         [2.0, np.nan, 2.0, 1.0]])
    _, _, idx = sweep.best_params(rows, {"w": np.arange(4)},
                                  metric="sharpe", return_index=True)
    assert idx.tolist() == [1, 0, 0]
    _, _, idx = sweep.best_params(rows, {"w": np.arange(4)},
                                  metric="turnover", return_index=True)
    assert idx.tolist() == [3, 0, 3]


def _specs(recs):
    return [ref_pb.JobSpec(id=r.id, strategy=r.strategy, ohlcv=r.ohlcv,
                           ohlcv2=r.ohlcv2 or b"",
                           grid=ref_wire.grid_to_proto(r.grid), cost=r.cost,
                           periods_per_year=252, best_returns=r.best_returns,
                           rank_metric=r.rank_metric, trace_id=f"t-{r.id}")
            for r in recs]


SMA = parse_grid("fast=3:6,slow=10:16:2")


@pytest.mark.parametrize("strategy,grid,metric,bars", [
    ("sma_crossover", SMA, "sharpe", [96]),
    ("sma_crossover", SMA, "max_drawdown", [80, 120]),
    ("bollinger", parse_grid("window=10:20:5,k=1:3"), "sortino", [96]),
    ("donchian_hl", parse_grid("window=8:24:8"), "total_return", [90, 100]),
], ids=["sma", "sma-drawdown-ragged", "bollinger", "donchian_hl-ragged"])
def test_backend_best_returns_matches_jax_backend(strategy, grid, metric,
                                                  bars):
    recs = []
    for i, n in enumerate(bars):
        recs += synthetic_jobs(3, n, strategy, grid, cost=1e-3, seed=70 + i,
                               best_returns=True, rank_metric=metric)
    specs = _specs(recs)
    got = compute.TorchSweepBackend(device="cpu").process(specs)
    want = ref_compute.JaxSweepBackend(use_fused=True).process(specs)
    assert sorted(c.job_id for c in got) == sorted(r.id for r in recs)
    got = {c.job_id: wire.best_returns_from_bytes(c.metrics) for c in got}
    want = {c.job_id: ref_wire.best_returns_from_bytes(c.metrics)
            for c in want}
    ids = [r.id for r in recs]
    n_bars = {r.id: data.from_wire_bytes(r.ohlcv).n_bars for r in recs}
    flips = assert_metrics_match(
        Metrics(*(np.float32([getattr(got[i][1], f) for i in ids])[:, None]
                  for f in Metrics._fields)),
        ref_metrics.Metrics(*(np.float32([getattr(want[i][1], f)
                                          for i in ids])[:, None]
                              for f in Metrics._fields)))
    same = [i for i in ids if got[i][0] == want[i][0]]
    assert len(ids) - len(same) <= flips
    for i in ids:
        assert got[i][3] == want[i][3] == metric
        assert got[i][2].shape == want[i][2].shape == (n_bars[i],)
    for i in same:
        np.testing.assert_allclose(got[i][2], want[i][2], rtol=2e-4,
                                   atol=2e-5)


def test_best_returns_row_and_series_are_the_generic_sweeps():
    # Port-internal: the DBXP row is the generic sweep's row at the index
    # best_params picks, and the series its combo repriced alone, bit for
    # bit (ragged lengths, so the held padding is exercised).
    # 70 and 100 bars: 1408 and 2008 payload bytes, one length bucket.
    specs = _specs([*synthetic_jobs(1, 70, "sma_crossover", SMA, cost=1e-3,
                                    seed=2, best_returns=True,
                                    rank_metric="sharpe"),
                    *synthetic_jobs(1, 100, "sma_crossover", SMA, cost=1e-3,
                                    seed=3, best_returns=True,
                                    rank_metric="sharpe")])
    out = compute.TorchSweepBackend(device="cpu").process(specs)
    series = [data.from_wire_bytes(s.ohlcv) for s in specs]
    batch, _, mask = data.pad_and_stack(series)
    grid = sweep.product_grid(**wire.grid_from_proto(specs[0].grid))
    strat = get_strategy("sma_crossover")
    m = sweep.run_sweep(batch, strat, grid, cost=1e-3, bar_mask=mask,
                        device="cpu")
    _, _, idx = sweep.best_params(m.sharpe, grid, metric="sharpe",
                                  return_index=True)
    for i, (s, c, one) in enumerate(zip(specs, out, series)):
        g, row, ret, _ = wire.best_returns_from_bytes(c.metrics)
        assert g == int(idx[i])
        assert [float(x) for x in row] == [float(getattr(m, f)[i, g])
                                           for f in Metrics._fields]
        params = {k: v[g:g + 1] for k, v in grid.items()}
        alone = sweep.reprice(data.OHLCV(*(f[None] for f in one)), strat,
                              params, cost=1e-3, device="cpu")
        np.testing.assert_array_equal(ret, alone[0].numpy())


@pytest.mark.parametrize("strategy,grid,metric,what", [
    ("pairs", parse_grid("lookback=8:20:6,z_entry=1:3"), "sharpe",
     "not supported for pairs"),
    ("sma_crossover", SMA, "alpha", "unknown best_returns rank metric"),
], ids=["pairs", "unknown-metric"])
def test_best_returns_validated_bad_completes_empty(strategy, grid, metric,
                                                    what, caplog):
    specs = _specs(synthetic_jobs(2, 64, strategy, grid, seed=6,
                                  best_returns=True, rank_metric=metric))
    with caplog.at_level("ERROR", logger="dbx.torch.compute"):
        got = compute.TorchSweepBackend(device="cpu").process(specs)
    want = ref_compute.JaxSweepBackend(use_fused=True).process(specs)
    assert sorted((c.job_id, c.metrics) for c in got) == sorted(
        (c.job_id, c.metrics) for c in want)
    assert len(got) == 2 and all(c.metrics == b"" for c in got)
    assert what in caplog.text
