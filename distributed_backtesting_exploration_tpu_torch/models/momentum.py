"""Time-series momentum (path-free): sign of the trailing ``lookback``
return (the reference's ``models/momentum.py``)."""

from __future__ import annotations

import torch

from ..ops import rolling
from .base import Strategy, register


def _positions(ohlcv, params):
    close = ohlcv.close
    lb = torch.as_tensor(params["lookback"], dtype=close.dtype,
                         device=close.device)
    T = close.shape[-1]
    # The reference's clipped read: close[clip(t - lookback, 0, T-1)],
    # truncated to an integer index.
    idx = torch.arange(T, dtype=close.dtype, device=close.device) - lb
    gather_idx = idx.clamp(0, T - 1).to(torch.int64)
    shape = torch.broadcast_shapes(close.shape, gather_idx.shape)
    past = torch.gather(close.expand(shape), -1, gather_idx.expand(shape))
    valid = rolling.valid_mask(T, lb + 1, close.device)
    return torch.where(valid, torch.sign(close - past),
                       torch.zeros((), dtype=close.dtype, device=close.device))


MOMENTUM = register(Strategy(
    name="momentum",
    param_fields=("lookback",),
    positions_fn=_positions,
    stateful=False,
))
