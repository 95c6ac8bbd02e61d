"""VWAP-deviation mean-reversion (stateful): the volume-weighted band
family (the reference's ``models/vwap.py``).

The rolling VWAP over the trailing ``window`` bars is
``sum(close * volume) / sum(volume)``. The close's deviation from it is
z-scored over the same window and fed to the shared band machine: enter
``k`` deviations from the anchor, exit when the price re-crosses it.
"""

from __future__ import annotations

import torch

from ..ops import rolling, signals
from .base import Strategy, register


def rolling_vwap(close, volume, window, *, eps: float = 1e-12):
    """Trailing-``window`` volume-weighted average price, ``(..., T)``;
    ``window`` broadcasts as in :func:`~..ops.rolling.rolling_sum`. Where
    the window's volume is not above ``eps`` (and in the warmup), the plain
    close: a deviation of 0."""
    pv = rolling.rolling_sum(close * volume, window)
    v = rolling.rolling_sum(volume, window)
    return torch.where(v > eps, pv / (v + eps), close)


def _positions(ohlcv, params):
    close, volume = ohlcv.close, ohlcv.volume
    w = params["window"]
    dev = close - rolling_vwap(close, volume, w)
    z = rolling.rolling_zscore(dev, w, fill=0.0)
    # The VWAP needs `w` bars, its deviation's z-score another `w`.
    w2 = 2 * torch.as_tensor(w, dtype=close.dtype, device=close.device) - 1
    valid = rolling.valid_mask(close.shape[-1], w2, close.device)
    z = torch.where(valid, z, torch.zeros((), dtype=z.dtype, device=z.device))
    return signals.band_hysteresis(z, valid, params["k"], 0.0)


VWAP_REVERSION = register(Strategy(
    name="vwap_reversion",
    param_fields=("window", "k"),
    positions_fn=_positions,
    stateful=True,
))
