"""Keltner-channel mean-reversion (stateful): EMA midline and ATR bands
(the reference's ``models/keltner.py``).

The close's deviation from its EMA midline, in average true ranges (ATR,
the rolling mean of the true range), feeds the shared band machine: enter
long ``k`` ATRs below the midline, short above, hold until the price
re-crosses the midline. Both the EMA span and the ATR window equal
``window``; a zero ATR (constant prices) gives deviation 0.
"""

from __future__ import annotations

import math

import torch

from ..ops import rolling, signals
from .base import Strategy, register


def true_range(high, low, close):
    """Per-bar true range ``max(high - low, |high - prev_close|,
    |low - prev_close|)``; the first bar uses its own close as the previous
    one. Shapes ``(..., T)`` -> same."""
    prev_close = torch.cat([close[..., :1], close[..., :-1]], dim=-1)
    return torch.maximum(high - low,
                         torch.maximum((high - prev_close).abs(),
                                       (low - prev_close).abs()))


def keltner_z(high, low, close, window, *, eps: float = 1e-12):
    """``(close - EMA_w(close)) / ATR_w``, 0 where the ATR is not above
    ``eps`` (warmup bars, whose ATR is NaN, included); ``window`` is a
    scalar or a tensor that broadcasts with a time axis of 1."""
    mid = rolling.ema(close, span=window)
    atr = rolling.rolling_mean(true_range(high, low, close), window,
                               fill=math.nan)
    dev = close - mid
    return torch.where(atr > eps, dev / (atr + eps),
                       torch.zeros((), dtype=dev.dtype, device=dev.device))


def _positions(ohlcv, params):
    w = params["window"]
    close = ohlcv.close
    z = keltner_z(ohlcv.high, ohlcv.low, close, w)
    valid = rolling.valid_mask(close.shape[-1], w, close.device)
    z = torch.where(valid, z, torch.zeros_like(z))
    return signals.band_hysteresis(z, valid, params["k"], 0.0)


KELTNER = register(Strategy(
    name="keltner",
    param_fields=("window", "k"),
    positions_fn=_positions,
    stateful=True,
))
