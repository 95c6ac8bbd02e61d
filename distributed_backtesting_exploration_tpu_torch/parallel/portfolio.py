"""Portfolio composition of per-ticker backtests (the reference's
``parallel/portfolio.py``).

A sweep says which params fit each ticker; this module says what the
selected strategies earn together: per-ticker positions under each
ticker's own params, one weighted book of their post-cost returns, and the
cross-sectional correlation of a return panel.

Semantics: the book's net return per bar is ``sum_i w_i * net_i[t]``,
``net_i`` each ticker's post-cost return (:func:`~..ops.pnl
.backtest_prefix`) and ``w`` normalized to unit gross exposure; the book
is additive (equity ``1 + cumsum``), as the sweep engine's equity is. The
weighted sums and the ``(N, T) x (T, N)`` correlation product are plain
``einsum``/``matmul`` calls (TF32 is off, :mod:`..device`).
:func:`sharded_portfolio_returns` splits the book over a mesh of devices.
"""

from __future__ import annotations

from typing import Mapping

import torch

from .. import device as device_mod
from ..models.base import Strategy
from ..ops import metrics as metrics_mod
from ..ops import pnl as pnl_mod
from ..utils.data import OHLCV
from . import sweep as sweep_mod

Tensor = torch.Tensor


def equal_weights(n: int, *, device: str | torch.device =
                  device_mod.DEFAULT_DEVICE) -> Tensor:
    """``(n,)`` weights summing to 1."""
    return torch.full((n,), 1.0 / float(n), dtype=torch.float32,
                      device=device_mod.resolve(device))


def _normalize_weights(weights, n: int, dev: torch.device) -> Tensor:
    """Normalize to unit GROSS exposure: ``w / max(sum(|w|), 1e-12)``.

    A dollar-neutral ``[1, -1]`` becomes ``[0.5, -0.5]`` instead of a
    division by zero, and a net-short vector keeps its sign; for all-long
    weights this is the usual sum-to-1 normalization.
    """
    if weights is None:
        return equal_weights(n, device=dev)
    w = device_mod.as_tensor(weights, torch.float32, dev)
    return w / torch.clamp_min(w.abs().sum(), 1e-12)


def inverse_vol_weights(close, *, eps: float = 1e-12,
                        device: str | torch.device =
                        device_mod.DEFAULT_DEVICE) -> Tensor:
    """Full-sample inverse-volatility weights of a ``(N, T)`` close panel:
    ``w_i ∝ 1 / std(simple_returns_i)`` (the population std, as
    ``jnp.std``), normalized to sum to 1."""
    dev = device_mod.resolve(device)
    r = pnl_mod.simple_returns(device_mod.as_tensor(close, torch.float32,
                                                    dev))
    inv = 1.0 / (torch.std(r, dim=-1, correction=0) + eps)
    return inv / inv.sum()


def per_ticker_positions(ohlcv, strategy: Strategy,
                         params: Mapping[str, object], *,
                         device: str | torch.device =
                         device_mod.DEFAULT_DEVICE) -> Tensor:
    """``(N, T)`` positions: each ticker runs ``strategy`` with its own
    scalar params (``params`` maps each field name to an ``(N,)``
    array)."""
    dev = device_mod.resolve(device)
    fields = OHLCV(*(device_mod.as_tensor(f, torch.float32, dev)[:, None, :]
                     for f in ohlcv))
    cols = {k: device_mod.as_tensor(v, torch.float32, dev)[:, None, None]
            for k, v in params.items()}
    return strategy.positions(fields, cols)[:, 0]


def portfolio_returns(close, positions, *, weights=None, cost: float = 0.0,
                      device: str | torch.device =
                      device_mod.DEFAULT_DEVICE):
    """Aggregate an ``(N, T)`` book into one portfolio return series.

    Returns ``(portfolio_net (T,), portfolio_equity (T,), net_exposure
    (T,))``: each ticker's post-cost net returns weighted by ``weights``
    (normalized to unit gross exposure; default equal), their additive
    equity, and the weighted sum of the positions, the book's tilt.
    """
    dev = device_mod.resolve(device)
    close = device_mod.as_tensor(close, torch.float32, dev)
    positions = device_mod.as_tensor(positions, torch.float32, dev)
    w = _normalize_weights(weights, close.shape[0], dev)
    res = pnl_mod.backtest_prefix(close, positions, cost=cost)
    port_net = torch.einsum("n,nt->t", w, res.returns)
    port_equity = 1.0 + torch.cumsum(port_net, dim=-1)
    exposure = torch.einsum("n,nt->t", w, positions)
    return port_net, port_equity, exposure


def portfolio_backtest(ohlcv, strategy: Strategy,
                       params: Mapping[str, object], *, weights=None,
                       cost: float = 0.0, periods_per_year: int = 252,
                       device: str | torch.device =
                       device_mod.DEFAULT_DEVICE) -> metrics_mod.Metrics:
    """Scalar :class:`~..ops.metrics.Metrics` of the whole book; ``params``
    maps each strategy field to an ``(N,)`` per-ticker value (typically
    :func:`select_best_params`'). Turnover and trades are the book's net
    exposure's."""
    pos = per_ticker_positions(ohlcv, strategy, params, device=device)
    net, equity, exposure = portfolio_returns(
        ohlcv.close, pos, weights=weights, cost=cost, device=device)
    return metrics_mod.summary_metrics(net, equity, exposure,
                                       periods_per_year=periods_per_year)


def select_best_params(metric_values: Tensor, grid: Mapping[str, object],
                       *, metric: str | None = None):
    """Per-ticker best of a sweep's ``(N, P)`` metric panel, returns
    ``(best_values (N,), {field: (N,) best params})``: the direction-aware,
    NaN-last selection of :func:`~.sweep.best_params`, to which it
    delegates."""
    return sweep_mod.best_params(metric_values, grid, metric=metric)


def sweep_and_compose(ohlcv, strategy: Strategy, grid: Mapping[str, object],
                      *, metric: str = "sharpe", weights=None,
                      cost: float = 0.0, periods_per_year: int = 252,
                      device: str | torch.device =
                      device_mod.DEFAULT_DEVICE):
    """Sweep the grid, pick each ticker's best params, price the book.
    Returns ``(portfolio_metrics, chosen_params)``."""
    m = sweep_mod.run_sweep(ohlcv, strategy, grid, cost=cost,
                            periods_per_year=periods_per_year, device=device)
    _, chosen = select_best_params(getattr(m, metric), grid, metric=metric)
    pm = portfolio_backtest(ohlcv, strategy, chosen, weights=weights,
                            cost=cost, periods_per_year=periods_per_year,
                            device=device)
    return pm, chosen


def correlation_matrix(returns, *, eps: float = 1e-12,
                       device: str | torch.device =
                       device_mod.DEFAULT_DEVICE) -> Tensor:
    """``(N, N)`` Pearson correlation of an ``(N, T)`` return panel: the
    rows centered and scaled to unit norm, then one product."""
    r = device_mod.as_tensor(returns, torch.float32,
                             device_mod.resolve(device))
    rc = r - r.mean(dim=-1, keepdim=True)
    norm = torch.sqrt((rc * rc).sum(dim=-1, keepdim=True)) + eps
    rn = rc / norm
    return rn @ rn.T


def avg_pairwise_correlation(corr: Tensor) -> Tensor:
    """Mean off-diagonal correlation, the book's diversification scalar."""
    n = corr.shape[0]
    off = corr.sum() - torch.trace(corr)
    return off / float(max(n * (n - 1), 1))


def sharded_portfolio_returns(mesh, close, positions, *, weights=None,
                              cost: float = 0.0):
    """:func:`portfolio_returns` with the book's tickers split over a
    :class:`~.sharding.Mesh`: each shard prices its slice on its device and
    reduces it to a weighted partial sum, and one sum in shard order gives
    the portfolio series (the reference's ``psum``). ``N`` must divide by
    the mesh's size (pad the book with zero-weight tickers otherwise).
    Returns the same ``(net, equity, exposure)`` triple, on shard 0's
    device."""
    from . import sharding

    n = int(close.shape[0])
    if n % mesh.size:
        raise ValueError(
            f"N={n} tickers not divisible by the {mesh.size}-way "
            f"{mesh.axis_name!r} axis; pad the book with zero-weight tickers")
    cpu = torch.device("cpu")
    w = _normalize_weights(weights, n, cpu)
    closes = sharding.shard_rows(mesh, device_mod.as_tensor(close,
                                                            torch.float32,
                                                            cpu))
    pos = sharding.shard_rows(mesh, device_mod.as_tensor(positions,
                                                         torch.float32, cpu))
    ws = sharding.shard_rows(mesh, w)
    nets, exps = [], []
    for c, p, wb in zip(closes, pos, ws):
        res = pnl_mod.backtest_prefix(c, p, cost=cost)
        nets.append(torch.einsum("n,nt->t", wb, res.returns))
        exps.append(torch.einsum("n,nt->t", wb, p))
    net = sharding.total(mesh, nets)
    exposure = sharding.total(mesh, exps)
    return net, 1.0 + torch.cumsum(net, dim=-1), exposure
