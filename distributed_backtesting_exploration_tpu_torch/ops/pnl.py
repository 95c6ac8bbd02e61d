"""PnL engine for path-free strategies (PyTorch).

The part of the reference's ``ops/pnl.py`` the SMA sweep needs. Time is the
last axis; ``positions[t]`` is the exposure decided at the close of bar
``t`` and earns ``returns[t+1]``; transaction cost is charged on
``|delta position|``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class BacktestResult(NamedTuple):
    """Per-bar outputs of a backtest, each shaped ``(..., T)``."""

    returns: Tensor    # net strategy simple returns per bar
    equity: Tensor     # equity curve, starts at 1.0 implicitly before bar 0
    positions: Tensor  # target exposure per bar (echo of the input)


def simple_returns(close: Tensor) -> Tensor:
    """Per-bar simple returns ``close[t]/close[t-1] - 1``; ``r[0] = 0``."""
    prev = torch.cat([close[..., :1], close[..., :-1]], dim=-1)
    return close / prev - 1.0


def _lagged(x: Tensor) -> Tensor:
    """``x[t-1]`` with 0 at ``t=0``."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def backtest_prefix(close: Tensor, positions: Tensor, *,
                    cost: float = 0.0) -> BacktestResult:
    """Vectorized PnL for path-free position series.

    ``net[t] = positions[t-1] * r[t] - cost * |positions[t] - positions[t-1]|``
    with ``r`` the simple returns of ``close``; ``close`` broadcasts against
    ``positions`` (e.g. ``(N, 1, T)`` against ``(N, P, T)``). The equity
    curve is additive, ``1 + cumsum(net)``.
    """
    r = simple_returns(close)
    prev_pos = _lagged(positions)
    turnover = (positions - prev_pos).abs()
    net = prev_pos * r - torch.tensor(cost, dtype=r.dtype,
                                      device=r.device) * turnover
    equity = 1.0 + torch.cumsum(net, dim=-1)
    return BacktestResult(returns=net, equity=equity, positions=positions)
