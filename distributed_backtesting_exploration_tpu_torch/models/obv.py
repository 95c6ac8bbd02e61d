"""On-balance-volume trend (path-free): OBV against its own rolling mean
(the reference's ``models/obv.py``).

``obv[t] = sum_{s<=t} sign(close[s] - close[s-1]) * v[s]`` with the volume
normalized by its first bar (:func:`~..ops.rolling.obv_series`), traded as
``sign(obv - sma_w(obv))``: long while volume flow runs above its
``window``-bar average, short below, flat for ``t < window - 1``. Pad bars
repeat the last close, so the OBV step is exactly zero there.
"""

from __future__ import annotations

import torch

from ..ops import rolling
from .base import Strategy, register

#: The one OBV definition the generic model and the fused prep share.
obv_series = rolling.obv_series


def _positions(ohlcv, params):
    close = ohlcv.close
    w = params["window"]
    obv = obv_series(close, ohlcv.volume)
    sma = rolling.rolling_mean(obv, w)
    valid = rolling.valid_mask(close.shape[-1], w, close.device)
    return torch.where(valid, torch.sign(obv - sma),
                       torch.zeros((), dtype=close.dtype, device=close.device))


OBV_TREND = register(Strategy(
    name="obv_trend",
    param_fields=("window",),
    positions_fn=_positions,
    stateful=False,
))
