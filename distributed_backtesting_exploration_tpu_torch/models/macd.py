"""MACD signal-line crossover (path-free; the reference's ``models/macd.py``).

``macd = ema(close, fast) - ema(close, slow)``; the trade is the sign of
``macd - ema(macd, signal)``. As in the reference, every EMA is the
shift-doubling ladder (:func:`~..ops.rolling.ema_ladder`) and the close is
demeaned by its first bar before the EMAs: a constant shift cancels in the
difference, and the f32 error then scales with price deviations rather
than the price level.

Warmup: positions are flat for ``t < slow + signal - 2``.
"""

from __future__ import annotations

import torch

from ..ops import rolling
from .base import Strategy, register


def macd_lines(close, fast, slow, signal):
    """``(macd, signal_line)`` for spans ``fast``/``slow``/``signal``
    (scalars or tensors that broadcast against the ``(..., T)`` series with
    a time axis of 1)."""
    x = close - close[..., :1]
    macd = (rolling.ema_ladder(x, span=fast)
            - rolling.ema_ladder(x, span=slow))
    return macd, rolling.ema_ladder(macd, span=signal)


def _positions(ohlcv, params):
    close = ohlcv.close
    macd, sig = macd_lines(close, params["fast"], params["slow"],
                           params["signal"])
    warm = (torch.as_tensor(params["slow"], dtype=close.dtype)
            + torch.as_tensor(params["signal"], dtype=close.dtype) - 1.0)
    valid = rolling.valid_mask(close.shape[-1], warm, close.device)
    return torch.where(valid, torch.sign(macd - sig),
                       torch.zeros((), dtype=close.dtype, device=close.device))


MACD = register(Strategy(
    name="macd",
    param_fields=("fast", "slow", "signal"),
    positions_fn=_positions,
    stateful=False,
))
