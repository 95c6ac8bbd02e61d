"""SMA-crossover strategy (path-free).

Long when the fast SMA is above the slow SMA, short when below, flat during
warmup — the reference's ``models/sma_crossover.py``.
"""

from __future__ import annotations

import torch

from ..ops import rolling
from .base import Strategy, register


def _positions(ohlcv, params):
    close = ohlcv.close
    T = close.shape[-1]
    fast = rolling.rolling_mean(close, params["fast"], fill=0.0)
    slow = rolling.rolling_mean(close, params["slow"], fill=0.0)
    valid = (rolling.valid_mask(T, params["slow"], close.device)
             & rolling.valid_mask(T, params["fast"], close.device))
    return torch.where(valid, torch.sign(fast - slow),
                       torch.zeros((), dtype=close.dtype, device=close.device))


SMA_CROSSOVER = register(Strategy(
    name="sma_crossover",
    param_fields=("fast", "slow"),
    positions_fn=_positions,
    stateful=False,
))
