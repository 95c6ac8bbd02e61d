"""Walk-forward optimization (the reference's ``parallel/walkforward.py``).

The out-of-sample protocol: slide a (train, test) window over the bar
history; in each window sweep the parameter grid on the train span, keep
each ticker's best parameter, and realize that parameter on the next
``test`` bars; then stitch the test spans into one series a ticker, whose
metrics are the honest performance estimate.

Where the reference scans the windows (``lax.scan``) with a ``vmap`` over
(ticker, param) inside each step, the port loops over the W windows on
the host and sweeps each window's grid in param chunks
(:func:`~.sweep.param_chunks`), keeping a running argmax across the chunks,
so no ``(N, P, span)`` tensor of the whole grid is ever live.
:func:`walk_forward_fused` is the reference's two-phase split: one fused
train sweep over all W train windows stacked, then only each ticker's
chosen parameter repriced.

The argmax is ``jnp.argmax``'s (:func:`argmax_nan_first`): a NaN train
metric wins, the first NaN among several, and among equal values the first
index wins. It is not :func:`~.sweep.best_params`'s NaN-last rule.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..models.base import Strategy
from ..ops import metrics as metrics_mod
from ..ops import pnl as pnl_mod
from ..utils.data import OHLCV
from . import sweep as sweep_mod

Tensor = torch.Tensor


class WalkForwardResult(NamedTuple):
    """Outputs of a walk-forward run.

    Attributes:
        oos_returns: ``(n_tickers, n_windows * test)`` stitched out-of-sample
            net returns under the per-window chosen params, including the
            rebalance cost at window boundaries.
        oos_positions: ``(n_tickers, n_windows * test)`` stitched positions.
        oos_metrics: :class:`~..ops.metrics.Metrics` over the stitched series,
            each field ``(n_tickers,)``.
        chosen: dict param name -> ``(n_tickers, n_windows)`` selected values.
        train_metric: ``(n_tickers, n_windows)`` best in-sample metric value.
    """

    oos_returns: Tensor
    oos_positions: Tensor
    oos_metrics: metrics_mod.Metrics
    chosen: Mapping[str, Tensor]
    train_metric: Tensor


def window_starts_np(T: int, train: int, test: int) -> np.ndarray:
    """The schedule, the one definition every route derives from: windows
    advance by ``test`` bars, and there are ``(T - train) // test`` of
    them, so every test bar is covered at most once and has a full train
    span behind it."""
    n = (T - train) // test
    if n <= 0:
        raise ValueError(f"history T={T} too short for train={train} test={test}")
    return np.arange(n) * test


def window_starts(T: int, train: int, test: int, *,
                  device: str | torch.device = device_mod.DEFAULT_DEVICE
                  ) -> Tensor:
    """:func:`window_starts_np` as an int64 tensor on ``device``."""
    return torch.as_tensor(window_starts_np(T, train, test),
                           device=device_mod.resolve(device))


def argmax_nan_first(score: Tensor, dim: int = -1) -> Tensor:
    """``jnp.argmax`` along ``dim``: the first NaN where a row has one,
    otherwise the first index of the maximum (+0 and -0 are equal)."""
    nan = torch.isnan(score)
    first_nan = torch.argmax(nan.to(torch.uint8), dim=dim)
    finite_max = torch.argmax(
        torch.where(nan, torch.full_like(score, -torch.inf), score), dim=dim)
    return torch.where(nan.any(dim), first_nan, finite_max)


def _take_param(a: Tensor, idx: Tensor) -> Tensor:
    """``a[n, idx[n], ...]`` of an ``(N, P, ...)`` tensor."""
    at = idx.reshape(idx.shape[0], 1, *([1] * (a.ndim - 2)))
    return torch.take_along_dim(a, at, dim=1).squeeze(1)


def _refit(grid: Mapping[str, object], row_elems: int, dev: torch.device,
           sign: float, one_chunk: Callable):
    """One window's refit over the param chunks of ``grid``.

    ``one_chunk(sub)`` returns ``(train_metric, *outputs)``, each
    ``(N, P_chunk, ...)``. Returns ``(best value, best flat index,
    *outputs at it)``, each ``(N, ...)``: a running :func:`argmax_nan_first`
    of ``sign * train_metric`` across the chunks, in which a later chunk
    takes over only with a NaN where the carry has none, or with a larger
    score, so the result is the argmax over the whole grid."""
    best = None
    for lo, sub in sweep_mod.param_chunks(grid, row_elems, dev):
        train_m, *outs = one_chunk(sub)
        idx = argmax_nan_first(sign * train_m)
        cand = (_take_param(train_m, idx), idx + lo,
                *(_take_param(o, idx) for o in outs))
        if best is None:
            best = cand
            continue
        carry, new = sign * best[0], sign * cand[0]
        take = ~torch.isnan(carry) & (torch.isnan(new) | (new > carry))
        best = tuple(torch.where(take.reshape(-1, *([1] * (c.ndim - 1))), c, b)
                     for b, c in zip(best, cand))
    return best


def walk_forward(
    ohlcv,
    strategy: Strategy,
    grid: Mapping[str, object],
    *,
    train: int,
    test: int,
    metric: str = "sharpe",
    cost: float = 0.0,
    periods_per_year: int = 252,
    device: str | torch.device = device_mod.DEFAULT_DEVICE,
) -> WalkForwardResult:
    """Walk-forward optimization over a ``(n_tickers, T)`` OHLCV panel.

    Per window: slice ``train + test`` bars, sweep the grid over the span,
    score each combo on the train span alone (positions at bar t use only
    bars <= t, so the span's first ``train`` bars are a train-only run),
    take each ticker's argmax, and keep that combo's test-span returns and
    positions from the same sweep.
    """
    dev = device_mod.resolve(device)
    panel = OHLCV(*(device_mod.as_tensor(f, torch.float32, dev)
                    for f in ohlcv))
    N, T = panel.close.shape
    span = train + test
    sign = metrics_mod.metric_sign(metric)
    outs = []
    for s0 in window_starts_np(T, train, test):
        win = OHLCV(*(f[:, None, s0:s0 + span] for f in panel))

        def one_chunk(sub, win=win):
            pos = strategy.positions(win, sub)               # (N, Pc, span)
            res = pnl_mod.backtest_prefix(win.close, pos, cost=cost)
            train_m = getattr(metrics_mod.summary_metrics(
                res.returns[..., :train], res.equity[..., :train],
                res.positions[..., :train],
                periods_per_year=periods_per_year), metric)
            return (train_m, res.returns[..., train:],
                    res.positions[..., train:], res.positions[..., train - 1])

        best = _refit(grid, N * span, dev, sign, one_chunk)
        rf = win.close[:, 0, train] / win.close[:, 0, train - 1] - 1.0
        outs.append((*best, rf))
    return _stitch_windows(outs, grid, dev, cost=cost,
                           periods_per_year=periods_per_year)


def walk_forward_pairs(
    y_close,
    x_close,
    grid: Mapping[str, object],
    *,
    train: int,
    test: int,
    metric: str = "sharpe",
    cost: float = 0.0,
    periods_per_year: int = 252,
    device: str | torch.device = device_mod.DEFAULT_DEVICE,
) -> WalkForwardResult:
    """Walk-forward optimization for the two-legged pairs strategy over
    ``(n_pairs, T)`` leg panels: the protocol of :func:`walk_forward`, with
    the pairs PnL (:func:`~..models.pairs.pair_net_returns`) recomputed
    within each window, the train equity ``1 + cumsum(net[:train])``, and
    the stitched boundary fix-up taking the incoming window's hedged return
    ``hr[train]`` as its return factor (each window re-hedges with its
    chosen beta)."""
    dev = device_mod.resolve(device)
    return _walk_forward_pairs(
        device_mod.as_tensor(y_close, torch.float32, dev),
        device_mod.as_tensor(x_close, torch.float32, dev), grid,
        train=train, test=test, metric=metric, cost=cost,
        periods_per_year=periods_per_year)


def _walk_forward_pairs(y: Tensor, x: Tensor, grid: Mapping[str, object], *,
                        train: int, test: int, metric: str = "sharpe",
                        cost: float = 0.0, periods_per_year: int = 252
                        ) -> WalkForwardResult:
    """:func:`walk_forward_pairs` on legs that are already tensors, in
    their own dtype and on their own device (an f64 run is the witness of
    the f32 one)."""
    from ..models import pairs as pairs_mod

    if x.shape != y.shape or y.ndim != 2:
        raise ValueError(f"y_close and x_close must be (n_pairs, T) of one "
                         f"shape; got {tuple(y.shape)} and {tuple(x.shape)}")
    N, T = y.shape
    span = train + test
    sign = metrics_mod.metric_sign(metric)
    outs = []
    for s0 in window_starts_np(T, train, test):
        yw, xw = y[:, None, s0:s0 + span], x[:, None, s0:s0 + span]

        def one_chunk(sub, yw=yw, xw=xw):
            pos, net, hr = pairs_mod.pair_net_returns(yw, xw, sub, cost=cost)
            equity_tr = 1.0 + torch.cumsum(net[..., :train], dim=-1)
            train_m = getattr(metrics_mod.summary_metrics(
                net[..., :train], equity_tr, pos[..., :train],
                periods_per_year=periods_per_year), metric)
            return (train_m, net[..., train:], pos[..., train:],
                    pos[..., train - 1], hr[..., train])

        outs.append(_refit(grid, N * span, y.device, sign, one_chunk))
    return _stitch_windows(outs, grid, y.device, cost=cost,
                           periods_per_year=periods_per_year)


def _stitch_windows(outs, grid, dev, *, cost, periods_per_year):
    """Per-window ``(best value, best index, oos returns, oos positions,
    prev position, return factor)`` tuples -> :class:`WalkForwardResult`."""
    train_best, best_idx, oos_r, oos_p, prev_in, rf = (
        torch.stack(f) for f in zip(*outs))                  # window-major
    chosen = {k: device_mod.as_tensor(v, torch.float32, dev)[best_idx].T
              for k, v in grid.items()}
    return _stitch(oos_r, oos_p, prev_in, rf, train_best, chosen, cost=cost,
                   periods_per_year=periods_per_year)


def _stitch(oos_r, oos_p, prev_in, rf, train_best, chosen, *, cost,
            periods_per_year) -> WalkForwardResult:
    """Window-major ``(W, N, ...)`` per-window outputs -> the stitched
    :class:`WalkForwardResult`.

    Boundary fix-up: each window's first test bar was priced against that
    window's own train-span position at ``train - 1`` (``prev_in``). A
    sequential deployment instead carries the previous window's last test
    position into it, and starts flat at window 0. Both the earnings and
    the cost term are swapped, in the reference's f32 order, so the
    stitched series prices exactly the positions it reports.
    """
    first_pos = oos_p[:, :, 0]                                # (W, N)
    prev_deployed = torch.cat(
        [torch.zeros_like(first_pos[:1]), oos_p[:-1, :, -1]], dim=0)
    c = torch.tensor(cost, dtype=oos_r.dtype, device=oos_r.device)
    adj = (prev_deployed - prev_in) * rf - c * (
        (first_pos - prev_deployed).abs() - (first_pos - prev_in).abs())
    oos_r = oos_r.clone()
    oos_r[:, :, 0] += adj

    n = oos_r.shape[1]
    oos_returns = oos_r.transpose(0, 1).reshape(n, -1)
    oos_positions = oos_p.transpose(0, 1).reshape(n, -1)
    equity = 1.0 + torch.cumsum(oos_returns, dim=-1)
    oos_metrics = metrics_mod.summary_metrics(
        oos_returns, equity, oos_positions, periods_per_year=periods_per_year)
    return WalkForwardResult(
        oos_returns=oos_returns,
        oos_positions=oos_positions,
        oos_metrics=oos_metrics,
        chosen=chosen,
        train_metric=train_best.T,
    )


def _stack_train_windows(field: Tensor, starts: np.ndarray,
                         train: int) -> Tensor:
    """All windows' train slices as one ``(W * n_tickers, train)`` panel,
    window-major."""
    return torch.stack([field[:, s0:s0 + train] for s0 in starts]
                       ).reshape(-1, train)


def _window_argmax(vals: Tensor, sign: float, W: int, n_tickers: int):
    """``(W * N, P)`` metric values -> each (window, ticker)'s argmax index
    and value, ``(W, N)`` each."""
    v = vals.reshape(W, n_tickers, -1)
    idx = argmax_nan_first(sign * v)
    return idx, torch.take_along_dim(v, idx[..., None], dim=-1)[..., 0]


def _reprice_chosen(panel: OHLCV, strategy: Strategy, chosen_per_window,
                    starts: np.ndarray, *, train: int, test: int,
                    cost: float):
    """Phase 2 of the fused walk-forward: every (window, ticker)'s chosen
    combo repriced over its span, all windows in one batch of ``W * N``
    rows with ``(W * N, 1, 1)`` params (:func:`~.sweep.reprice`'s form).
    Returns window-major ``(oos returns, oos positions, prev position,
    return factor)``."""
    span = train + test
    W, N = len(starts), panel.close.shape[0]
    dev = panel.close.device
    at = (torch.as_tensor(starts, device=dev)[:, None]
          + torch.arange(span, device=dev))                  # (W, span)
    win = OHLCV(*(f[:, at].transpose(0, 1).reshape(W * N, 1, span)
                  for f in panel))
    cols = {k: v.reshape(W * N, 1, 1) for k, v in chosen_per_window.items()}
    res = pnl_mod.backtest_prefix(win.close, strategy.positions(win, cols),
                                  cost=cost)
    close = win.close[:, 0]
    return (res.returns[:, 0, train:].reshape(W, N, test),
            res.positions[:, 0, train:].reshape(W, N, test),
            res.positions[:, 0, train - 1].reshape(W, N),
            (close[:, train] / close[:, train - 1] - 1.0).reshape(W, N))


def walk_forward_fused(
    ohlcv,
    strategy: Strategy,
    grid: Mapping[str, object],
    train_metrics_fn: Callable,
    *,
    train: int,
    test: int,
    metric: str = "sharpe",
    cost: float = 0.0,
    periods_per_year: int = 252,
    fields: tuple = ("close",),
    device: str | torch.device = device_mod.DEFAULT_DEVICE,
) -> WalkForwardResult:
    """Walk-forward with the train sweep on a fused kernel.

    Phase 1 is one call ``train_metrics_fn(*field_panels) -> Metrics`` over
    the W train windows of every field in ``fields`` (the columns the
    kernel takes, in its order), stacked window-major into
    ``(W * n_tickers, train)`` panels; each (window, ticker)'s argmax picks
    its combo. Phase 2 reprices only the chosen combos over their spans
    (:func:`_reprice_chosen`), and the result is stitched as
    :func:`walk_forward`'s. It matches :func:`walk_forward` wherever the
    fused and generic train metrics agree on the argmax; a knife-edge tie
    can flip a window's chosen combo.
    """
    dev = device_mod.resolve(device)
    panel = OHLCV(*(device_mod.as_tensor(f, torch.float32, dev)
                    for f in ohlcv))
    N, T = panel.close.shape
    starts = window_starts_np(T, train, test)
    W = len(starts)
    m = train_metrics_fn(*(_stack_train_windows(getattr(panel, f), starts,
                                                train) for f in fields))
    best_idx, train_best = _window_argmax(
        getattr(m, metric).to(dev), metrics_mod.metric_sign(metric), W, N)
    chosen_per_window = {
        k: device_mod.as_tensor(v, torch.float32, dev)[best_idx]
        for k, v in grid.items()}                            # (W, N)
    oos_r, oos_p, prev_in, rf = _reprice_chosen(
        panel, strategy, chosen_per_window, starts, train=train, test=test,
        cost=cost)
    return _stitch(oos_r, oos_p, prev_in, rf, train_best,
                   {k: v.T for k, v in chosen_per_window.items()},
                   cost=cost, periods_per_year=periods_per_year)
