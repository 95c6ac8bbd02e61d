"""The port's top-k (DBXS) jobs against the reference.

``compute._topk_reduce`` against the reference's ``_topk_reduce`` on
crafted rows (ties, NaN, +-inf and +-0, for a higher-is-better and a
lower-is-better metric): indices exact, rows bit-equal. Then
``TorchSweepBackend(device="cpu")`` against ``JaxSweepBackend`` on the same
top-k JobSpecs for sma, a band family and pairs: indices exact, rows under
the flip rule of ``torch_parity``, and each block's rows bit-equal to the
port's own full DBXM block at its indices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.ops import metrics as ref_metrics
from distributed_backtesting_exploration_tpu.rpc import (
    backtesting_pb2 as ref_pb, compute as ref_compute, wire as ref_wire)
from distributed_backtesting_exploration_tpu.rpc.dispatcher import (
    parse_grid, synthetic_jobs)
from distributed_backtesting_exploration_tpu_torch.ops.metrics import Metrics
from distributed_backtesting_exploration_tpu_torch.rpc import compute, wire

from torch_parity import CRAFTED, assert_metrics_match



def _fields(ranked: str, rows: np.ndarray, seed: int = 0) -> list:
    """Nine (N, P) planes: ``rows`` in the ranked field, random elsewhere."""
    rng = np.random.default_rng(seed)
    pos = Metrics._fields.index(ranked)
    return [rows if i == pos else
            rng.standard_normal(rows.shape).astype(np.float32)
            for i in range(9)]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("metric", ["sharpe", "max_drawdown", "turnover",
                                    "hit_rate"])
def test_topk_reduce_matches_reference_on_crafted_rows(metric, k):
    planes = _fields(metric, CRAFTED, seed=k)
    ref_idx, ref_m = ref_compute._topk_reduce(
        ref_metrics.Metrics(*(jnp.asarray(p) for p in planes)), metric, k)
    idx, m = compute._topk_reduce(
        Metrics(*(torch.from_numpy(p) for p in planes)), metric, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    for name in Metrics._fields:
        np.testing.assert_array_equal(
            _bits(getattr(m, name)), _bits(getattr(ref_m, name)),
            err_msg=name)


@pytest.mark.parametrize("metric,want", [
    ("sharpe", [2, 3, 1, 5, 0, 6, 4, 7]),
    ("max_drawdown", [4, 7, 0, 6, 1, 5, 2, 3]),
])
def test_topk_reduce_orders_signed_zeros_as_lax_top_k(metric, want):
    # The first crafted row: torch.sort(stable) gives [2 3 0 1 5 6 4 7] and
    # torch.topk [2 3 1 0 5 6 7 4]; lax.top_k puts +0 ahead of -0.
    planes = _fields(metric, CRAFTED[:1])
    idx, _ = compute._topk_reduce(
        Metrics(*(torch.from_numpy(p) for p in planes)), metric, 8)
    assert idx[0].tolist() == want
    ref_idx, _ = ref_compute._topk_reduce(
        ref_metrics.Metrics(*(jnp.asarray(p) for p in planes)), metric, 8)
    assert np.asarray(ref_idx)[0].tolist() == want


def _specs(recs):
    return [ref_pb.JobSpec(id=r.id, strategy=r.strategy, ohlcv=r.ohlcv,
                           ohlcv2=r.ohlcv2 or b"",
                           grid=ref_wire.grid_to_proto(r.grid), cost=r.cost,
                           periods_per_year=252, top_k=r.top_k,
                           rank_metric=r.rank_metric, trace_id=f"t-{r.id}")
            for r in recs]


SMA = parse_grid("fast=3:6,slow=10:16:2")
BOLL = parse_grid("window=10:20:5,k=1:3")
PAIRS = parse_grid("lookback=8:20:6,z_entry=1:3")


@pytest.mark.parametrize("strategy,grid,metric,bars", [
    ("sma_crossover", SMA, "sharpe", [96]),
    ("sma_crossover", SMA, "max_drawdown", [110, 125]),
    ("bollinger", BOLL, "sortino", [96]),
    ("pairs", PAIRS, "sharpe", [96]),
], ids=["sma-sharpe", "sma-drawdown-ragged", "bollinger", "pairs"])
def test_backend_topk_matches_jax_backend(strategy, grid, metric, bars):
    recs = []
    for i, n in enumerate(bars):
        recs += synthetic_jobs(3, n, strategy, grid, cost=1e-3, seed=60 + i,
                               top_k=4, rank_metric=metric)
    specs = _specs(recs)
    got = compute.TorchSweepBackend(device="cpu").process(specs)
    want = ref_compute.JaxSweepBackend(use_fused=True).process(specs)
    assert sorted(c.job_id for c in got) == sorted(r.id for r in recs)
    assert all(c.trace_id == f"t-{c.job_id}" for c in got)
    got = {c.job_id: wire.topk_from_bytes(c.metrics) for c in got}
    want = {c.job_id: ref_wire.topk_from_bytes(c.metrics) for c in want}
    ids = [r.id for r in recs]
    for i in ids:
        np.testing.assert_array_equal(got[i][0], want[i][0])
        assert got[i][2] == want[i][2] == metric
    assert_metrics_match(
        Metrics(*(np.stack([getattr(got[i][1], f) for i in ids])
                  for f in Metrics._fields)),
        ref_metrics.Metrics(*(np.stack([getattr(want[i][1], f) for i in ids])
                              for f in Metrics._fields)),
        **({"rtol": 2e-3, "atol": 2e-4} if strategy == "pairs" else {}))

    # Each block's rows are the full DBXM block's rows at its indices.
    for s in specs:
        s.top_k = 0
    full = {c.job_id: wire.metrics_from_bytes(c.metrics) for c in
            compute.TorchSweepBackend(device="cpu").process(specs)}
    for i in ids:
        for name in Metrics._fields:
            np.testing.assert_array_equal(
                _bits(getattr(got[i][1], name)),
                _bits(getattr(full[i], name)[got[i][0]]), err_msg=name)


def test_topk_larger_than_grid_takes_the_whole_grid():
    recs = synthetic_jobs(2, 80, "sma_crossover", SMA, cost=1e-3, seed=3,
                          top_k=100, rank_metric="sharpe")
    specs = _specs(recs)
    got = compute.TorchSweepBackend(device="cpu").process(specs)
    want = ref_compute.JaxSweepBackend(use_fused=True).process(specs)
    P = wire.grid_n_combos(specs[0].grid)
    for g, w in zip(sorted(got, key=lambda c: c.job_id),
                    sorted(want, key=lambda c: c.job_id)):
        gi = wire.topk_from_bytes(g.metrics)[0]
        assert gi.shape == (P,) and sorted(gi) == list(range(P))
        np.testing.assert_array_equal(gi, ref_wire.topk_from_bytes(
            w.metrics)[0])


def test_topk_unknown_rank_metric_completes_empty(caplog):
    recs = synthetic_jobs(2, 64, "sma_crossover", SMA, seed=4, top_k=3,
                          rank_metric="alpha")
    specs = _specs(recs)
    with caplog.at_level("ERROR", logger="dbx.torch.compute"):
        got = compute.TorchSweepBackend(device="cpu").process(specs)
    want = ref_compute.JaxSweepBackend(use_fused=True).process(specs)
    assert sorted((c.job_id, c.metrics) for c in got) == sorted(
        (c.job_id, c.metrics) for c in want)
    assert all(c.metrics == b"" for c in got) and len(got) == 2
    assert "unknown metric 'alpha'" in caplog.text


def test_topk_job_does_not_cobatch_with_a_plain_job():
    # Same grid, panel length and cost: only the top-k fields of the
    # grouping key keep the two apart.
    plain, topk = _specs(synthetic_jobs(2, 64, "sma_crossover", SMA, seed=5))
    topk.top_k, topk.rank_metric = 2, "sharpe"
    out = {c.job_id: c.metrics for c in
           compute.TorchSweepBackend(device="cpu").process([plain, topk])}
    assert wire.result_kind(out[plain.id]) == "metrics"
    assert wire.result_kind(out[topk.id]) == "topk"
    full = wire.metrics_from_bytes(out[plain.id])
    assert full.sharpe.shape == (wire.grid_n_combos(plain.grid),)
