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


def _masked_moments(x: Tensor, mask):
    if mask is None:
        n = torch.full(x.shape[:-1], float(x.shape[-1]), dtype=x.dtype,
                       device=x.device)
        s1 = x.sum(-1)
        s2 = (x * x).sum(-1)
    else:
        m = mask.to(x.dtype)
        n = m.sum(-1).expand(x.shape[:-1])
        s1 = (x * m).sum(-1)
        s2 = (x * x * m).sum(-1)
    mean = s1 / n.clamp_min(1.0)
    var = (s2 / n.clamp_min(1.0) - mean * mean).clamp_min(0.0)
    return mean, torch.sqrt(var), n


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
    ``summary_metrics``)."""
    ann = torch.sqrt(_f32(float(periods_per_year), returns))
    mean, std, n = _masked_moments(returns, mask)
    sharpe = mean / (std + _EPS) * ann

    m = (torch.ones_like(returns) if mask is None
         else mask.to(returns.dtype).expand_as(returns))
    n_s = m.sum(-1).clamp_min(1.0)
    mean_s = (returns * m).sum(-1) / n_s
    downside = returns.clamp_max(0.0) * m
    dstd = torch.sqrt((downside * downside).sum(-1) / n_s)
    sortino = mean_s / (dstd + _EPS) * ann

    peak = torch.cummax(equity, dim=-1).values
    mdd = ((peak - equity) / peak.clamp_min(_EPS)).amax(-1)

    years = (n / float(periods_per_year)).clamp_min(_EPS)
    final = equity[..., -1].clamp_min(_EPS)
    cagr = torch.pow(final, 1.0 / years) - 1.0

    active = _lagged(positions).abs() > 0
    if mask is not None:
        active = active & mask
    active = active.to(returns.dtype)
    wins = (returns > 0).to(returns.dtype) * active
    hit = wins.sum(-1) / (active.sum(-1) + _EPS)

    turnover = (positions - _lagged(positions)).abs().sum(-1)
    return Metrics(
        sharpe=sharpe,
        sortino=sortino,
        max_drawdown=mdd,
        total_return=equity[..., -1] - 1.0,
        cagr=cagr,
        volatility=std * ann,
        hit_rate=hit,
        n_trades=0.5 * turnover,
        turnover=turnover,
    )
