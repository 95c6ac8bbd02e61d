"""Bollinger-band mean-reversion (stateful) and band-touch (path-free).

The reference's ``models/bollinger.py``. ``bollinger`` is the hysteresis
machine: enter long when the z-score drops below ``-k``, short above
``+k``, hold until the price re-crosses the rolling mean.
``bollinger_touch`` is the path-free variant: exposure is which band the
close is currently outside of.
"""

from __future__ import annotations

import torch

from ..ops import rolling, signals
from .base import Strategy, register


def _z_and_valid(ohlcv, params):
    close = ohlcv.close
    z = rolling.rolling_zscore(close, params["window"], fill=0.0)
    valid = rolling.valid_mask(close.shape[-1], params["window"],
                               close.device)
    return z, valid


def _touch_positions(ohlcv, params):
    z, valid = _z_and_valid(ohlcv, params)
    k = params["k"]
    one = torch.ones((), dtype=z.dtype, device=z.device)
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    pos = torch.where(z < -k, one, torch.where(z > k, -one, zero))
    return torch.where(valid, pos, zero)


def _mr_positions(ohlcv, params):
    # Exit at the rolling mean: the shared band machine with z_exit = 0.
    z, valid = _z_and_valid(ohlcv, params)
    return signals.band_hysteresis(z, valid, params["k"], 0.0)


BOLLINGER = register(Strategy(
    name="bollinger",
    param_fields=("window", "k"),
    positions_fn=_mr_positions,
    stateful=True,
))

BOLLINGER_TOUCH = register(Strategy(
    name="bollinger_touch",
    param_fields=("window", "k"),
    positions_fn=_touch_positions,
    stateful=False,
))
