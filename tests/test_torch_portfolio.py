"""The port's portfolio composition (``parallel/portfolio.py``) against the
reference's, on the same seed-made panels, at the reference tests'
tolerances (``tests/test_portfolio.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.models import (
    base as ref_base)
from distributed_backtesting_exploration_tpu.parallel import (
    portfolio as ref_portfolio, sweep as ref_sweep)
from distributed_backtesting_exploration_tpu.utils import data as ref_data
from distributed_backtesting_exploration_tpu_torch.models import get_strategy
from distributed_backtesting_exploration_tpu_torch.ops.metrics import Metrics
from distributed_backtesting_exploration_tpu_torch.parallel import (
    portfolio, sweep)

from torch_parity import to_np

CPU = {"device": "cpu"}


def _panels(n=4, T=220, seed=0):
    ohlcv = ref_data.synthetic_ohlcv(n, T, seed=seed)
    return ohlcv, type(ohlcv)(*(jnp.asarray(f) for f in ohlcv))


def _book(n=3, seed=1):
    ohlcv, panel = _panels(n=n, seed=seed)
    params = np.float32([5.0, 10.0, 20.0, 7.0])[:n]
    pos = portfolio.per_ticker_positions(
        ohlcv, get_strategy("momentum"), {"lookback": params}, **CPU)
    ref_pos = ref_portfolio.per_ticker_positions(
        panel, ref_base.get_strategy("momentum"),
        {"lookback": jnp.asarray(params)})
    return ohlcv, panel, pos, ref_pos


def test_per_ticker_positions_match_reference():
    _, _, pos, ref_pos = _book()
    assert pos.shape == (3, 220)
    np.testing.assert_array_equal(to_np(pos), np.asarray(ref_pos))


@pytest.mark.parametrize("weights", [None, [0.5, 0.3, 0.2], [1.0, -1.0, 0.5],
                                     [1.0, -2.0, -1.0]],
                         ids=["equal", "long", "long-short", "net-short"])
def test_portfolio_returns_match_reference(weights):
    ohlcv, panel, pos, ref_pos = _book()
    w = None if weights is None else np.float32(weights)
    got = portfolio.portfolio_returns(ohlcv.close, pos, weights=w, cost=1e-3,
                                      **CPU)
    want = ref_portfolio.portfolio_returns(panel.close, ref_pos, weights=w,
                                           cost=1e-3)
    for (a, b), (rtol, atol) in zip(zip(got, want), [(1e-4, 1e-6),
                                                     (1e-4, 1e-5),
                                                     (1e-5, 1e-6)]):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


def test_normalize_weights_by_gross_exposure():
    dev = torch.device("cpu")
    for w in ([1.0, -1.0], [1.0, -2.0], [0.2, 0.3, 0.5], [0.0, 0.0]):
        got = portfolio._normalize_weights(np.float32(w), len(w), dev)
        want = ref_portfolio._normalize_weights(np.float32(w), len(w))
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-7)
    np.testing.assert_allclose(
        to_np(portfolio._normalize_weights(np.float32([1, -1]), 2, dev)),
        [0.5, -0.5])
    np.testing.assert_array_equal(
        to_np(portfolio._normalize_weights(None, 4, dev)),
        np.asarray(ref_portfolio.equal_weights(4)))
    assert portfolio.equal_weights(3, **CPU).dtype == torch.float32


def test_long_short_book_on_identical_tickers():
    # Dollar-neutral [1, -1] on two copies of a ticker is flat; net-short
    # [1, -2] is -1/3 of the single book.
    one, _ = _panels(n=1, seed=9)
    two = type(one)(*(np.repeat(f, 2, axis=0) for f in one))
    pos = portfolio.per_ticker_positions(
        two, get_strategy("momentum"), {"lookback": np.float32([10, 10])},
        **CPU)
    net, _, expo = portfolio.portfolio_returns(
        two.close, pos, weights=np.float32([1.0, -1.0]), **CPU)
    assert torch.isfinite(net).all()
    np.testing.assert_allclose(to_np(net), 0.0, atol=1e-7)
    np.testing.assert_allclose(to_np(expo), 0.0, atol=1e-7)
    net_s, _, _ = portfolio.portfolio_returns(
        two.close, pos, weights=np.float32([1.0, -2.0]), **CPU)
    net_1, _, _ = portfolio.portfolio_returns(two.close[:1], pos[:1], **CPU)
    np.testing.assert_allclose(to_np(net_s), -to_np(net_1) / 3.0, rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("weights", [None, [3.0, 1.0, 1.0]],
                         ids=["equal", "weighted"])
def test_portfolio_backtest_matches_reference(weights):
    ohlcv, panel = _panels(n=3, seed=2)
    params = np.float32([5.0, 10.0, 20.0])
    w = None if weights is None else np.float32(weights)
    got = portfolio.portfolio_backtest(
        ohlcv, get_strategy("momentum"), {"lookback": params}, weights=w,
        cost=1e-3, **CPU)
    want = ref_portfolio.portfolio_backtest(
        panel, ref_base.get_strategy("momentum"),
        {"lookback": jnp.asarray(params)}, weights=w, cost=1e-3)
    for name in Metrics._fields:
        assert getattr(got, name).shape == ()
        np.testing.assert_allclose(to_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_select_best_params_matches_reference():
    vals = np.float32([[0.5, np.nan, 2.0], [np.nan, np.nan, np.nan],
                       [3.0, 1.0, -1.0], [-0.0, 0.0, 0.0]])
    grid = {"window": np.float32([10.0, 20.0, 30.0])}
    for metric in ("sharpe", "max_drawdown"):
        best, chosen = portfolio.select_best_params(
            torch.as_tensor(vals), grid, metric=metric)
        rbest, rchosen = ref_portfolio.select_best_params(
            jnp.asarray(vals), {"window": jnp.asarray(grid["window"])},
            metric=metric)
        np.testing.assert_array_equal(to_np(chosen["window"]),
                                      np.asarray(rchosen["window"]))
        np.testing.assert_array_equal(to_np(best), np.asarray(rbest))


def test_sweep_and_compose_matches_reference():
    ohlcv, panel = _panels(n=3, seed=3)
    axes = {"fast": np.float32([3.0, 5.0]), "slow": np.float32([13.0, 21.0])}
    grid = sweep.product_grid(**axes)
    pm, chosen = portfolio.sweep_and_compose(
        ohlcv, get_strategy("sma_crossover"), grid, cost=1e-3, **CPU)
    want_pm, want_chosen = ref_portfolio.sweep_and_compose(
        panel, ref_base.get_strategy("sma_crossover"),
        ref_sweep.product_grid(**{k: jnp.asarray(v) for k, v in axes.items()}),
        cost=1e-3)
    for k in axes:
        np.testing.assert_array_equal(to_np(chosen[k]),
                                      np.asarray(want_chosen[k]))
    for name in Metrics._fields:
        np.testing.assert_allclose(to_np(getattr(pm, name)),
                                   np.asarray(getattr(want_pm, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # The chosen params are best_params' of the generic sweep.
    m = sweep.run_sweep(ohlcv, get_strategy("sma_crossover"), grid,
                        cost=1e-3, **CPU)
    _, want = sweep.best_params(m.sharpe, grid, metric="sharpe")
    for k in axes:
        torch.testing.assert_close(chosen[k], want[k], rtol=0, atol=0)


def test_inverse_vol_weights_population_std():
    rng = np.random.default_rng(0)
    calm = 100.0 + np.cumsum(rng.normal(0, 0.1, 300))
    wild = 100.0 + np.cumsum(rng.normal(0, 2.0, 300))
    close = np.stack([calm, wild, calm[::-1]]).astype(np.float32)
    got = to_np(portfolio.inverse_vol_weights(close, **CPU))
    want = np.asarray(ref_portfolio.inverse_vol_weights(jnp.asarray(close)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    r = np.zeros_like(close, dtype=np.float64)
    r[:, 1:] = close[:, 1:].astype(np.float64) / close[:, :-1] - 1.0
    inv = 1.0 / r.std(axis=-1, ddof=0)
    np.testing.assert_allclose(got, inv / inv.sum(), rtol=1e-4)
    assert got.sum() == pytest.approx(1.0, abs=1e-5) and got[0] > got[1]


def test_correlation_matrix_matches_reference_and_numpy():
    rng = np.random.default_rng(1)
    r = rng.normal(size=(3, 400)).astype(np.float32)
    r[1] = 0.9 * r[0] + 0.1 * r[1]
    corr = portfolio.correlation_matrix(r, **CPU)
    want = np.corrcoef(r)
    np.testing.assert_allclose(to_np(corr), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        to_np(corr), np.asarray(ref_portfolio.correlation_matrix(
            jnp.asarray(r))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.diag(to_np(corr)), 1.0, atol=1e-5)
    avg = float(portfolio.avg_pairwise_correlation(corr))
    assert avg == pytest.approx((want.sum() - np.trace(want)) / 6, abs=1e-4)
    assert avg == pytest.approx(float(ref_portfolio.avg_pairwise_correlation(
        jnp.asarray(to_np(corr)))), abs=1e-6)


def test_book_turnover_uses_net_exposure():
    # Long one ticker, short an identical one: the book's turnover and
    # trades read 0 although each leg trades.
    one, _ = _panels(n=1, seed=7)
    two = type(one)(*(np.repeat(f, 2, axis=0) for f in one))
    pos = portfolio.per_ticker_positions(
        two, get_strategy("momentum"), {"lookback": np.float32([10, 10])},
        **CPU) * torch.tensor([[1.0], [-1.0]])
    net, equity, expo = portfolio.portfolio_returns(two.close, pos, **CPU)
    np.testing.assert_allclose(to_np(expo), 0.0, atol=1e-7)
    np.testing.assert_allclose(to_np(net), 0.0, atol=1e-7)
