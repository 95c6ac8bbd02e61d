"""Performance metrics over backtest return/equity series (PyTorch).

Mirrors the reference's ``ops/metrics.py``: the same nine fields in the
same order, the same formulas and the same float32 evaluation order where
the reference fixes one. Every metric reduces over the trailing time axis
and takes an optional boolean ``mask`` (padded bars of a ragged batch),
implemented as weighted reductions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

# Metrics where a *smaller* value is better; argmax-style selection must
# negate these (see metric_sign). Everything else is higher-is-better.
LOWER_IS_BETTER = frozenset({"max_drawdown", "volatility", "turnover"})

_EPS = 1e-12


def metric_sign(name: str) -> float:
    """+1.0 for higher-is-better metrics, -1.0 for lower-is-better ones."""
    if name not in Metrics._fields:
        raise KeyError(f"unknown metric {name!r}; one of {Metrics._fields}")
    return -1.0 if name in LOWER_IS_BETTER else 1.0


class Metrics(NamedTuple):
    """Scalar (per-series) performance summary; each field is ``(...)``."""

    sharpe: Tensor
    sortino: Tensor
    max_drawdown: Tensor
    total_return: Tensor
    cagr: Tensor
    volatility: Tensor
    hit_rate: Tensor
    n_trades: Tensor
    turnover: Tensor


def _f32(x: float, like: Tensor) -> Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _lagged(x: Tensor) -> Tensor:
    """``x[..., t-1]`` with 0 at ``t = 0``."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def _bar_count(x: Tensor, mask) -> Tensor:
    """The bars each series of ``x`` counts: ``T``, or its mask's sum."""
    if mask is None:
        return torch.full(x.shape[:-1], float(x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    return mask.to(x.dtype).sum(-1).expand(x.shape[:-1])


def _masked_moments(x: Tensor, mask):
    n = _bar_count(x, mask)
    if mask is None:
        s1 = x.sum(-1)
        s2 = (x * x).sum(-1)
    else:
        m = mask.to(x.dtype)
        s1 = (x * m).sum(-1)
        s2 = (x * x * m).sum(-1)
    mean = s1 / n.clamp_min(1.0)
    var = (s2 / n.clamp_min(1.0) - mean * mean).clamp_min(0.0)
    return mean, torch.sqrt(var), n


def _annualizer(periods_per_year: int, like: Tensor) -> Tensor:
    return torch.sqrt(_f32(float(periods_per_year), like))


def _cagr(equity: Tensor, n: Tensor, periods_per_year: int) -> Tensor:
    years = (n / float(periods_per_year)).clamp_min(_EPS)
    final = equity[..., -1].clamp_min(_EPS)
    return torch.pow(final, 1.0 / years) - 1.0


def sharpe(returns: Tensor, *, periods_per_year: int = 252, mask=None,
           eps: float = _EPS) -> Tensor:
    """Annualized Sharpe ratio of per-bar returns (risk-free = 0)."""
    mean, std, _ = _masked_moments(returns, mask)
    return mean / (std + eps) * _annualizer(periods_per_year, returns)


def sortino(returns: Tensor, *, periods_per_year: int = 252, mask=None,
            eps: float = _EPS) -> Tensor:
    """Annualized Sortino ratio: mean over downside deviation."""
    m = (torch.ones_like(returns) if mask is None
         else mask.to(returns.dtype).expand_as(returns))
    n = m.sum(-1).clamp_min(1.0)
    mean = (returns * m).sum(-1) / n
    downside = returns.clamp_max(0.0) * m
    dstd = torch.sqrt((downside * downside).sum(-1) / n)
    return mean / (dstd + eps) * _annualizer(periods_per_year, returns)


def max_drawdown(equity: Tensor) -> Tensor:
    """Max peak-to-trough drawdown fraction of an equity curve (>= 0). The
    running peak is a max, exact in any order, so ``cummax`` gives the
    reference's shift-doubling ladder's values."""
    peak = torch.cummax(equity, dim=-1).values
    return ((peak - equity) / peak.clamp_min(_EPS)).amax(-1)


def total_return(equity: Tensor) -> Tensor:
    """Final equity over the implicit starting equity of 1.0, minus 1."""
    return equity[..., -1] - 1.0


def cagr(equity: Tensor, *, periods_per_year: int = 252, mask=None
         ) -> Tensor:
    """Compound annual growth rate implied by the final equity value, over
    the bars counted (all of them, or the mask's)."""
    return _cagr(equity, _bar_count(equity, mask), periods_per_year)


def hit_rate(returns: Tensor, positions: Tensor, *, mask=None,
             eps: float = _EPS) -> Tensor:
    """Fraction of bars with positive net return, among bars with exposure
    (the position held into the bar); ``mask`` drops padded bars from the
    active set."""
    active = _lagged(positions).abs() > 0
    if mask is not None:
        active = active & mask
    active = active.to(returns.dtype)
    wins = (returns > 0).to(returns.dtype) * active
    return wins.sum(-1) / (active.sum(-1) + eps)


def turnover_total(positions: Tensor) -> Tensor:
    """Total absolute position change (round-trip trade = 2.0 for unit
    size)."""
    return (positions - _lagged(positions)).abs().sum(-1)


def n_trades(positions: Tensor) -> Tensor:
    """Approximate round-trip trade count: total turnover / 2."""
    return 0.5 * turnover_total(positions)


def metrics_from_reductions(*, s1, s2, downside_sq_sum, mdd, eq_final,
                            wins_sum, active_sum, turnover, n,
                            periods_per_year: int = 252,
                            eps: float = _EPS) -> Metrics:
    """Assemble a :class:`Metrics` from already-reduced per-series sums.

    The formulas are the definitions shared with the fused kernel's
    epilogue (reference ``ops/fused.py:_metrics_pack``): ``n`` is each
    series' real bar count.
    """
    n = torch.as_tensor(n, dtype=torch.float32, device=s1.device)
    mean = s1 / n
    std = torch.sqrt((s2 / n - mean * mean).clamp_min(0.0))
    dstd = torch.sqrt(downside_sq_sum / n)
    ppy = _f32(float(periods_per_year), s1)
    ann = torch.sqrt(ppy)
    years = (n / ppy).clamp_min(eps)
    final = eq_final.clamp_min(eps)
    return Metrics(
        sharpe=mean / (std + eps) * ann,
        sortino=mean / (dstd + eps) * ann,
        max_drawdown=mdd,
        total_return=eq_final - 1.0,
        cagr=torch.pow(final, 1.0 / years) - 1.0,
        volatility=std * ann,
        hit_rate=wins_sum / (active_sum + eps),
        n_trades=0.5 * turnover,
        turnover=turnover,
    )


def summary_metrics(returns: Tensor, equity: Tensor, positions: Tensor, *,
                    periods_per_year: int = 252, mask=None) -> Metrics:
    """All nine metrics of per-bar net ``returns``, their ``equity`` curve
    and the ``positions`` that produced them (reference
    ``summary_metrics``). The moments are taken once, for sharpe,
    volatility and cagr's bar count; every field is the standalone
    metric's value."""
    ann = _annualizer(periods_per_year, returns)
    mean, std, n = _masked_moments(returns, mask)
    turnover = turnover_total(positions)
    return Metrics(
        sharpe=mean / (std + _EPS) * ann,
        sortino=sortino(returns, periods_per_year=periods_per_year,
                        mask=mask),
        max_drawdown=max_drawdown(equity),
        total_return=total_return(equity),
        cagr=_cagr(equity, n, periods_per_year),
        volatility=std * ann,
        hit_rate=hit_rate(returns, positions, mask=mask),
        n_trades=0.5 * turnover,
        turnover=turnover,
    )
