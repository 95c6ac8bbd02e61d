"""PnL engines (PyTorch; the reference's ``ops/pnl.py``).

:func:`backtest_prefix` prices path-free position series with elementwise
ops and one cumsum; :func:`backtest_scan` runs a stateful per-bar machine
that a caller writes (hold until exit, stops) one bar at a time on the
caller's device, then prices its positions with :func:`backtest_prefix`.
Time is the last axis; ``positions[t]`` is the exposure decided at the
close of bar ``t`` and earns ``returns[t+1]``; transaction cost is charged
on ``|delta position|``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

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


def log_returns(close: Tensor) -> Tensor:
    """Per-bar log returns; ``r[0] = 0``."""
    prev = torch.cat([close[..., :1], close[..., :-1]], dim=-1)
    return torch.log(close) - torch.log(prev)


def _lagged(x: Tensor) -> Tensor:
    """``x[t-1]`` with 0 at ``t=0``."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def backtest_prefix(close: Tensor, positions: Tensor, *,
                    cost: float = 0.0, compound: bool = False
                    ) -> BacktestResult:
    """Vectorized PnL for path-free position series.

    ``net[t] = positions[t-1] * r[t] - cost * |positions[t] - positions[t-1]|``
    with ``r`` the simple returns of ``close``; ``close`` broadcasts against
    ``positions`` (e.g. ``(N, 1, T)`` against ``(N, P, T)``). The equity
    curve is additive, ``1 + cumsum(net)``, or with ``compound``
    ``exp(cumsum(log1p(net)))``.
    """
    r = simple_returns(close)
    prev_pos = _lagged(positions)
    turnover = (positions - prev_pos).abs()
    net = prev_pos * r - torch.tensor(cost, dtype=r.dtype,
                                      device=r.device) * turnover
    if compound:
        equity = torch.exp(torch.cumsum(torch.log1p(net), dim=-1))
    else:
        equity = 1.0 + torch.cumsum(net, dim=-1)
    return BacktestResult(returns=net, equity=equity, positions=positions)


def _bar(inputs, t: int):
    """Bar ``t`` of every tensor of ``inputs`` (a tensor, or a tuple, list
    or dict of them, nested), in the same structure."""
    if isinstance(inputs, Tensor):
        return inputs[..., t]
    if isinstance(inputs, dict):
        return {k: _bar(v, t) for k, v in inputs.items()}
    if isinstance(inputs, (tuple, list)):
        return type(inputs)(_bar(v, t) for v in inputs)
    raise TypeError(f"backtest_scan inputs hold a {type(inputs).__name__}; "
                    "want tensors in tuples, lists or dicts")


def _n_bars(inputs) -> int:
    if isinstance(inputs, Tensor):
        return inputs.shape[-1]
    leaves = inputs.values() if isinstance(inputs, dict) else inputs
    for v in leaves:
        return _n_bars(v)
    raise ValueError("backtest_scan inputs hold no tensor")


def backtest_scan(step: Callable, init_carry, inputs, close: Tensor, *,
                  cost: float = 0.0, compound: bool = False
                  ) -> BacktestResult:
    """Stateful engine: ``step(carry, inputs_t) -> (carry, position_t)``
    over the bars in order, then the positions priced by
    :func:`backtest_prefix`.

    ``inputs`` is a tensor, or a tuple, list or dict of tensors, with time
    on the last axis; ``step`` gets bar ``t`` of each in the same
    structure. The loop runs one bar at a time on the inputs' device, and
    the positions are stacked time-last.
    """
    carry, positions = init_carry, []
    for t in range(_n_bars(inputs)):
        carry, pos = step(carry, _bar(inputs, t))
        positions.append(pos)
    return backtest_prefix(close, torch.stack(positions, dim=-1), cost=cost,
                           compound=compound)
