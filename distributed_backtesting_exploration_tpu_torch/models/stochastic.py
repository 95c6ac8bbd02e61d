"""Stochastic-oscillator mean-reversion (stateful): %K with the shared
band-hysteresis machine (the reference's ``models/stochastic.py``).

``%K = 100 * (close - LL_w) / (HH_w - LL_w)`` locates the close inside the
trailing ``window``-bar high/low channel. Centered (``%K - 50``), the trade
is the band machine shared with Bollinger: enter long below ``50 - band``,
short above ``50 + band``, hold until %K re-crosses 50. A flat channel
yields %K = 50. As in the reference, windows beyond ``MAX_WINDOW`` give NaN
channels (its traced-window view bound).
"""

from __future__ import annotations

import math

import torch

from ..ops import rolling, signals
from .base import Strategy, register

MAX_WINDOW = 256


def stochastic_k(high, low, close, window, *, max_window: int = MAX_WINDOW,
                 eps: float = 1e-12):
    """%K in ``[0, 100]``; ``window`` may be a tensor of windows that
    broadcasts against the ``(..., T)`` series."""
    hh = rolling.rolling_max(high, window, max_window=max_window,
                             fill=math.inf)
    ll = rolling.rolling_min(low, window, max_window=max_window,
                             fill=-math.inf)
    rng = hh - ll
    return torch.where(rng > eps, 100.0 * (close - ll) / (rng + eps),
                       torch.full_like(rng, 50.0))


def _positions(ohlcv, params):
    w = params["window"]
    close = ohlcv.close
    k_pct = stochastic_k(ohlcv.high, ohlcv.low, close, w)
    valid = rolling.valid_mask(close.shape[-1], w, close.device)
    centered = torch.where(valid, k_pct - 50.0, torch.zeros_like(k_pct))
    return signals.band_hysteresis(centered, valid, params["band"], 0.0)


STOCHASTIC = register(Strategy(
    name="stochastic",
    param_fields=("window", "band"),
    positions_fn=_positions,
    stateful=True,
))
