"""The port's mesh (``parallel/sharding.py``) and the ticker-sharded
portfolio against the JAX package.

A mesh of ``["cpu"] * 4`` stands in for four cards (the counterpart of the
reference tests' virtual CPU devices). ``sharded_sweep`` is held bit-equal
to the port's one-device ``run_sweep`` (each shard runs the same code on
its rows) and to the JAX single-device sweep under ``torch_parity``'s flip
rule (rtol=2e-4, atol=2e-5); ``best_over_grid`` keeps ``jnp.argmax``'s rule
(first NaN, then first index) on crafted metric rows;
``sharded_portfolio_returns`` is held to ``portfolio_returns`` at
rtol=1e-6, atol=1e-7 (the shards' partial sums add in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.models import (
    base as ref_base)
from distributed_backtesting_exploration_tpu.parallel import (
    portfolio as ref_portfolio, sharding as ref_sharding, sweep as ref_sweep)
from distributed_backtesting_exploration_tpu_torch.models import base
from distributed_backtesting_exploration_tpu_torch.ops.metrics import Metrics
from distributed_backtesting_exploration_tpu_torch.parallel import (
    portfolio, sharding, sweep)
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import assert_metrics_match

MESH = sharding.make_mesh(["cpu"] * 4)
GRID = {"fast": np.float32([3, 5, 8]), "slow": np.float32([12, 20])}


def _bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_make_mesh_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: make_mesh() takes it")
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        sharding.make_mesh(["cuda:0"] * 2)


def test_mesh_lists_shards_and_counts_distinct_devices():
    assert MESH.size == 4 and MESH.distinct == 1
    assert MESH.devices == (torch.device("cpu"),) * 4
    assert MESH.axis_name == sharding.TICKER_AXIS
    with pytest.raises(ValueError, match="at least one"):
        sharding.make_mesh([])


@pytest.mark.parametrize("n,shards", [(5, 4), (8, 4), (1, 3), (7, 1)])
def test_pad_rows_and_tickers_match_the_reference(n, shards):
    a = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    n_pad = sharding.pad_tickers(n, shards)
    assert n_pad == ref_sharding.pad_tickers(n, shards)
    want = ref_sharding.pad_rows(a, n_pad)
    np.testing.assert_array_equal(sharding.pad_rows(a, n_pad), want)
    np.testing.assert_array_equal(
        sharding.pad_rows(torch.from_numpy(a), n_pad).numpy(), want)


def test_collectives_copy_what_they_receive():
    # On a mesh that repeats a device a move is a no-op, so a received halo
    # changed in place must not reach the sender's block.
    blocks = [torch.arange(4.0) + 10 * i for i in range(4)]
    halo = sharding.from_left(MESH, blocks, 2)
    assert torch.equal(halo[0], torch.zeros(2))
    for i in range(1, 4):
        assert torch.equal(halo[i], blocks[i - 1][-2:])
        halo[i].add_(100.0)
    assert torch.equal(blocks[0], torch.arange(4.0))
    total = sharding.psum(MESH, [torch.tensor(float(i)) for i in range(4)])
    assert [float(t) for t in total] == [6.0] * 4
    total[1].add_(1.0)
    assert float(total[0]) == 6.0
    assert torch.equal(sharding.gather(MESH, [b[None] for b in blocks]),
                       torch.stack(blocks))


@pytest.mark.parametrize("n", [6, 8], ids=["uneven", "even"])
def test_sharded_sweep_matches_the_single_device_sweeps(n):
    panel = data.synthetic_ohlcv(n, 160, seed=5)
    strat = base.get_strategy("sma_crossover")
    grid = sweep.product_grid(**GRID)
    got = sharding.sharded_sweep(MESH, panel, strat, grid, cost=1e-3)
    one = sweep.run_sweep(panel, strat, grid, cost=1e-3, device="cpu")
    assert got.sharpe.shape == (n, 6)
    assert _bits(got, one)
    ref = ref_sweep.run_sweep(
        type(panel)(*(jnp.asarray(f) for f in panel)),
        ref_base.get_strategy("sma_crossover"),
        {k: jnp.asarray(v) for k, v in ref_sweep.product_grid(
            **GRID).items()}, cost=1e-3)
    assert_metrics_match(got, ref)


def test_sharded_sweep_with_a_mask_and_param_chunks():
    series = [data.OHLCV(*(f[0, :t] for f in data.synthetic_ohlcv(
        1, t, seed=t))) for t in (90, 120, 128, 100, 111)]
    batch, _, mask = data.pad_and_stack(series)
    strat = base.get_strategy("bollinger")
    grid = sweep.product_grid(window=np.float32([10, 20]),
                              k=np.float32([1.0, 2.0]))
    one = sweep.run_sweep(batch, strat, grid, cost=1e-3, bar_mask=mask,
                          device="cpu")
    for chunk in (None, 1, 2):
        got = sharding.sharded_sweep(MESH, batch, strat, grid, cost=1e-3,
                                     bar_mask=mask, param_chunk=chunk)
        assert _bits(got, one), chunk


def _crafted_sweep(table: np.ndarray):
    """A stand-in for ``run_sweep`` whose sharpe rows are ``table``'s rows,
    picked by each ticker's first close (its row index)."""
    def run(panel, strategy, grid, *, device, **kw):
        rows = torch.as_tensor(panel.close)[:, 0].to(torch.int64)
        s = torch.from_numpy(table)[rows]
        return Metrics(*([s] * len(Metrics._fields)))
    return run


@pytest.mark.parametrize("rows,want", [
    ([[1., 2., 3.], [3., 0., 3.], [2., 3., 1.]], (0, 2)),       # first max
    ([[1., 2., 3.], [np.nan, 9., 1.], [2., np.nan, 1.]], (1, 0)),  # NaN first
    ([[1., 1., 1.], [1., 1., 1.], [1., 1., 1.]], (0, 0)),       # all equal
    ([[0., 0., 0.], [0., 0., 0.], [0., 0., 5.]], (2, 2)),       # last row
], ids=["first-max", "nan-first", "ties", "pad-after-real"])
def test_best_over_grid_keeps_the_argmax_rule(monkeypatch, rows, want):
    # 3 tickers on 4 shards: the repeat-last pad rows repeat the last
    # ticker's row after it, so they never win.
    table = np.float32(rows)
    monkeypatch.setattr(sharding.sweep_mod, "run_sweep", _crafted_sweep(table))
    close = np.repeat(np.arange(3, dtype=np.float32)[:, None], 8, axis=1)
    panel = data.OHLCV(*([close] * 5))
    grid = {"fast": np.float32([3, 4, 5]), "slow": np.float32([9, 9, 9])}
    value, ticker, chosen = sharding.best_over_grid(
        MESH, panel, base.get_strategy("sma_crossover"), grid)
    flat = table.reshape(-1)
    i = int(jnp.argmax(jnp.asarray(flat)))
    assert (int(ticker), i % 3) == want == divmod(i, 3)
    np.testing.assert_array_equal(value.numpy(), flat[i])
    assert float(chosen["fast"]) == grid["fast"][want[1]]


def test_best_over_grid_on_a_sweep_matches_the_jax_argmax():
    panel = data.synthetic_ohlcv(6, 200, seed=9)
    strat = base.get_strategy("sma_crossover")
    grid = sweep.product_grid(**GRID)
    value, ticker, chosen = sharding.best_over_grid(
        MESH, panel, strat, grid, metric="max_drawdown", cost=1e-3)
    m = sweep.run_sweep(panel, strat, grid, cost=1e-3, device="cpu")
    flat = -m.max_drawdown.reshape(-1).numpy()
    i = int(jnp.argmax(jnp.asarray(flat)))
    assert int(ticker) == i // 6
    assert float(value) == float(m.max_drawdown.reshape(-1)[i])
    assert float(chosen["slow"]) == float(grid["slow"][i % 6])


def test_sharded_portfolio_returns_matches_portfolio_returns():
    panel = data.synthetic_ohlcv(8, 150, seed=4)
    pos = np.sign(np.random.default_rng(4).standard_normal(
        (8, 150))).astype(np.float32)
    w = np.random.default_rng(5).uniform(-1, 1, 8).astype(np.float32)
    for weights in (None, w):
        got = portfolio.sharded_portfolio_returns(
            MESH, panel.close, pos, weights=weights, cost=1e-3)
        one = portfolio.portfolio_returns(panel.close, pos, weights=weights,
                                          cost=1e-3, device="cpu")
        ref = ref_portfolio.portfolio_returns(
            jnp.asarray(panel.close), jnp.asarray(pos),
            weights=None if weights is None else jnp.asarray(weights),
            cost=1e-3)
        for g, o, r in zip(got, one, ref):
            np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-7)
    with pytest.raises(ValueError, match="not divisible"):
        portfolio.sharded_portfolio_returns(MESH, panel.close[:6], pos[:6])
