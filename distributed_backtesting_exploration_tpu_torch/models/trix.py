"""TRIX: triple-EMA rate of change with a signal-line crossover (path-free;
the reference's ``models/trix.py``).

``trix = roc(ema(ema(ema(close, span), span), span))``, the one-bar rate
of change of a triple-smoothed close, traded as ``sign(trix - ema(trix,
signal))``. Every EMA is the shift-doubling ladder
(:func:`~..ops.rolling.ema_ladder`), as in the reference.

Warmup: positions are flat for ``t < 3*span + signal - 3``.
"""

from __future__ import annotations

import torch

from ..ops import rolling
from .base import Strategy, register


def trix_lines(close, span, signal):
    """``(trix, signal_line)`` for spans ``span``/``signal`` (scalars or
    tensors that broadcast against the ``(..., T)`` series with a time axis
    of 1). ``trix[0] = 0``: the rate of change has no history at bar 0."""
    e3 = rolling.ema_ladder(
        rolling.ema_ladder(
            rolling.ema_ladder(close, span=span), span=span), span=span)
    prev = torch.cat([e3[..., :1], e3[..., :-1]], dim=-1)
    trix = e3 / prev - 1.0
    return trix, rolling.ema_ladder(trix, span=signal)


def _positions(ohlcv, params):
    close = ohlcv.close
    trix, sig = trix_lines(close, params["span"], params["signal"])
    warm = (3.0 * torch.as_tensor(params["span"], dtype=close.dtype)
            + torch.as_tensor(params["signal"], dtype=close.dtype) - 2.0)
    valid = rolling.valid_mask(close.shape[-1], warm, close.device)
    return torch.where(valid, torch.sign(trix - sig),
                       torch.zeros((), dtype=close.dtype, device=close.device))


TRIX = register(Strategy(
    name="trix",
    param_fields=("span", "signal"),
    positions_fn=_positions,
    stateful=False,
))
