"""Donchian-channel breakout (stateful), the reference's
``models/donchian.py``.

Go long when the close breaks above the trailing ``window``-bar high, short
when it breaks below the trailing low, and hold until the opposite channel
is touched. The channel at bar ``t`` uses bars ``t-window .. t-1`` (the
breakout bar itself is excluded). ``donchian`` builds the channel from the
closes, ``donchian_hl`` from the highs and lows. As in the reference,
windows beyond ``MAX_WINDOW`` give NaN channels (never a breakout).
"""

from __future__ import annotations

import math

import torch

from ..ops import rolling
from .base import Strategy, register

MAX_WINDOW = 256


def _latch(close, hi, lo, w):
    """Shared breakout latch: +1 at or above the prior channel high, -1 at
    or below the prior low (up wins), hold otherwise; warmup flat."""
    # Channel known at the close of t-1, applied to bar t.
    hi_prev = torch.cat([torch.full_like(hi[..., :1], math.inf),
                         hi[..., :-1]], dim=-1)
    lo_prev = torch.cat([torch.full_like(lo[..., :1], -math.inf),
                         lo[..., :-1]], dim=-1)
    up = close >= hi_prev
    down = close <= lo_prev
    T = up.shape[-1]
    valid = torch.broadcast_to(
        rolling.valid_mask(T, w + 1, up.device), up.shape)
    one = torch.ones((), dtype=hi.dtype, device=hi.device)
    zero = torch.zeros((), dtype=hi.dtype, device=hi.device)
    pos = torch.zeros(up.shape[:-1], dtype=hi.dtype, device=hi.device)
    out = torch.empty(up.shape, dtype=hi.dtype, device=hi.device)
    for t in range(T):
        nxt = torch.where(up[..., t], one,
                          torch.where(down[..., t], -one, pos))
        pos = torch.where(valid[..., t], nxt, zero)
        out[..., t] = pos
    return out


def _channel(hi_src, lo_src, w):
    hi = rolling.rolling_max(hi_src, w, max_window=MAX_WINDOW, fill=math.inf)
    lo = rolling.rolling_min(lo_src, w, max_window=MAX_WINDOW,
                             fill=-math.inf)
    return hi, lo


def _positions(ohlcv, params):
    w = params["window"]
    return _latch(ohlcv.close, *_channel(ohlcv.close, ohlcv.close, w), w)


def _positions_hl(ohlcv, params):
    """Classic channels from the HIGH/LOW columns."""
    w = params["window"]
    return _latch(ohlcv.close, *_channel(ohlcv.high, ohlcv.low, w), w)


DONCHIAN = register(Strategy(
    name="donchian",
    param_fields=("window",),
    positions_fn=_positions,
    stateful=True,
))

DONCHIAN_HL = register(Strategy(
    name="donchian_hl",
    param_fields=("window",),
    positions_fn=_positions_hl,
    stateful=True,
))
