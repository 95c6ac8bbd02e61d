"""RSI mean-reversion (stateful): Wilder's relative strength index with the
shared band-hysteresis machine (the reference's ``models/rsi.py``).

RSI maps an EMA-smoothed ratio of up-moves to down-moves into
``[0, 100]``. Centered (``rsi - 50``), the trade is the band machine shared
with Bollinger: enter long below ``50 - band``, short above ``50 + band``,
hold until RSI re-crosses 50. Smoothing is :func:`~..ops.rolling.ema` with
Wilder's decay ``1/period`` and the seed ``y0 = x0``.
"""

from __future__ import annotations

import torch

from ..ops import rolling, signals
from .base import Strategy, register


def rsi_index(close, period):
    """Wilder's RSI in ``[0, 100]``; ``period`` is a scalar or a tensor that
    broadcasts against the ``(..., T)`` series with a time axis of 1.

    Both divisions are IEEE divisions, as in the reference (``100.0 /
    tensor`` in torch would round twice: a reciprocal, then a multiply).
    """
    diff = torch.diff(close, dim=-1, prepend=close[..., :1])
    gains = diff.clamp_min(0.0)
    losses = (-diff).clamp_min(0.0)
    one = torch.ones((), dtype=close.dtype, device=close.device)
    alpha = torch.div(one, torch.as_tensor(period, dtype=close.dtype,
                                           device=close.device))
    avg_gain = rolling.ema(gains, alpha=alpha)
    avg_loss = rolling.ema(losses, alpha=alpha)
    return 100.0 - torch.div(100.0 * one,
                             1.0 + avg_gain / (avg_loss + 1e-12))


def _positions(ohlcv, params):
    close = ohlcv.close
    period = torch.as_tensor(params["period"], dtype=close.dtype,
                             device=close.device)
    rsi = rsi_index(close, period)
    valid = rolling.valid_mask(close.shape[-1], period + 1.0, close.device)
    # Centered index, exit at 50: the shared machine with z_exit = 0.
    return signals.band_hysteresis(rsi - 50.0, valid, params["band"], 0.0)


RSI = register(Strategy(
    name="rsi",
    param_fields=("period", "band"),
    positions_fn=_positions,
    stateful=True,
))
