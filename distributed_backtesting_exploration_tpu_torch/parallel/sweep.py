"""The generic sweep engine: every (ticker, param) combo as one batch of
tensor ops (mirrors the reference's ``parallel/sweep.py``).

This is the golden path the fused SMA kernel is held against, and the route
for jobs the fused sweep does not take (e.g. non-integral windows). Axis
order: tickers outer, params inner. Where the reference vmaps over tickers
and params, the port lays them out as ``(N, P, T)`` tensors, in chunks of
the param axis that bound the live memory.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .. import device as device_mod
from ..models.base import Strategy
from ..ops import metrics as metrics_mod
from ..ops import pnl as pnl_mod
from ..utils.data import OHLCV

# Elements of one live (N, P_chunk, T) intermediate: 2**24 f32 = 64 MiB,
# and the sweep holds about ten of them at once.
_CHUNK_ELEMS = 1 << 24


def grid_size(grid: Mapping[str, object]) -> int:
    (leaf,) = set(int(v.shape[0]) for v in grid.values())
    return leaf


def product_grid(**axes) -> dict:
    """Cartesian product of named 1-D parameter axes -> dict of flat (P,)
    tensors, row-major in the argument order (the reference's flat order:
    ``product_grid(fast=[5,10], slow=[50,100])`` yields fast-major combos).
    """
    names = list(axes)
    arrs = [torch.as_tensor(np.asarray(axes[n])) for n in names]
    mesh = torch.meshgrid(*arrs, indexing="ij")
    return {n: m.reshape(-1) for n, m in zip(names, mesh)}


def run_sweep(
    ohlcv,
    strategy: Strategy,
    grid: Mapping[str, object],
    *,
    cost: float = 0.0,
    bar_mask=None,
    periods_per_year: int = 252,
    device: str | torch.device = device_mod.DEFAULT_DEVICE,
) -> metrics_mod.Metrics:
    """Evaluate ``strategy`` on every (ticker, param) combo.

    Args:
        ohlcv: OHLCV with fields shaped ``(n_tickers, T)`` (numpy arrays or
            tensors).
        strategy: a registered :class:`~..models.base.Strategy`.
        grid: dict of ``(P,)`` parameter arrays (see :func:`product_grid`).
        cost: proportional transaction cost per unit turnover.
        bar_mask: optional ``(n_tickers, T)`` validity mask for ragged
            histories, a prefix of True then a suffix of False, as
            :func:`~..utils.data.pad_and_stack` makes it. Padded bars hold
            the last valid position and are left out of the metric moments.
        device: where to run; ``"cuda"`` unless the caller asks for the CPU.

    Returns:
        :class:`~..ops.metrics.Metrics` with every field ``(n_tickers, P)``.
    """
    dev = device_mod.resolve(device)
    fields = OHLCV(*(device_mod.as_tensor(f, torch.float32, dev)[:, None, :]
                     for f in ohlcv))
    N, _, T = fields.close.shape
    mask = None
    last_idx = None
    if bar_mask is not None:
        mask = device_mod.as_tensor(bar_mask, torch.bool, dev)[:, None, :]
        last_idx = (mask.to(torch.int64).sum(-1) - 1).clamp_min(0)
    params = {k: device_mod.as_tensor(v, torch.float32, dev)
              for k, v in grid.items()}
    P = grid_size(params)
    chunk = max(1, _CHUNK_ELEMS // max(N * T, 1))
    parts = []
    for lo in range(0, P, chunk):
        sub = {k: v[lo:lo + chunk, None] for k, v in params.items()}
        pos = strategy.positions(fields, sub)             # (N, Pc, T)
        if mask is not None:
            # Padding is a suffix: HOLD the last valid position through the
            # padded bars (repeat-last closes earn zero return there), as
            # the reference does, instead of charging a phantom exit.
            pos_last = torch.gather(
                pos, -1, last_idx.expand(N, pos.shape[1])[..., None])
            pos = torch.where(mask, pos, pos_last)
        res = pnl_mod.backtest_prefix(fields.close, pos, cost=cost)
        parts.append(metrics_mod.summary_metrics(
            res.returns, res.equity, res.positions,
            periods_per_year=periods_per_year, mask=mask))
    return metrics_mod.Metrics(*(torch.cat(f, dim=-1) for f in zip(*parts)))
