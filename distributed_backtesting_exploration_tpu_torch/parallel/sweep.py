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
    fields, mask = _panel(ohlcv, bar_mask, dev)
    N, _, T = fields.close.shape

    def one_chunk(sub):
        pos = _held(strategy.positions(fields, sub), mask)   # (N, Pc, T)
        res = pnl_mod.backtest_prefix(fields.close, pos, cost=cost)
        return metrics_mod.summary_metrics(
            res.returns, res.equity, res.positions,
            periods_per_year=periods_per_year, mask=mask)

    return map_param_chunks(grid, N * T, dev, one_chunk)


def chunked_sweep(ohlcv, strategy: Strategy, grid: Mapping[str, object], *,
                  param_chunk: int, cost: float = 0.0, bar_mask=None,
                  periods_per_year: int = 252,
                  device: str | torch.device = device_mod.DEFAULT_DEVICE
                  ) -> metrics_mod.Metrics:
    """:func:`run_sweep` over the grid in chunks of ``param_chunk`` combos
    (the last may be shorter), the ``(n_tickers, P)`` metrics concatenated
    in grid order: the reference's ``chunked_sweep``, a bound on the live
    set of one call."""
    P = grid_size(grid)
    parts = [run_sweep(ohlcv, strategy,
                       {k: v[lo:lo + param_chunk] for k, v in grid.items()},
                       cost=cost, bar_mask=bar_mask,
                       periods_per_year=periods_per_year, device=device)
             for lo in range(0, P, param_chunk)]
    return metrics_mod.Metrics(*(torch.cat(f, dim=-1) for f in zip(*parts)))


def reprice(ohlcv, strategy: Strategy, params: Mapping[str, object], *,
            cost: float = 0.0, bar_mask=None,
            device: str | torch.device = device_mod.DEFAULT_DEVICE
            ) -> torch.Tensor:
    """Net-return series of each ticker under its own parameter set (the
    reference's best-returns repricing): ``params`` maps each of the
    strategy's parameters to an ``(n_tickers,)`` array; returns the
    ``(n_tickers, T)`` returns, with :func:`run_sweep`'s handling of
    ``bar_mask``."""
    dev = device_mod.resolve(device)
    fields, mask = _panel(ohlcv, bar_mask, dev)
    cols = {k: device_mod.as_tensor(v, torch.float32, dev)[:, None, None]
            for k, v in params.items()}
    pos = _held(strategy.positions(fields, cols), mask)      # (N, 1, T)
    return pnl_mod.backtest_prefix(fields.close, pos, cost=cost).returns[:, 0]


def _panel(ohlcv, bar_mask, dev: torch.device):
    """The fields as ``(N, 1, T)`` f32 tensors on ``dev``, and the mask as
    ``(N, 1, T)`` (or None)."""
    fields = OHLCV(*(device_mod.as_tensor(f, torch.float32, dev)[:, None, :]
                     for f in ohlcv))
    if bar_mask is None:
        return fields, None
    return fields, device_mod.as_tensor(bar_mask, torch.bool, dev)[:, None, :]


def _held(pos: torch.Tensor, mask) -> torch.Tensor:
    """``pos`` with the last valid position HELD through the padded bars
    (padding is a suffix; repeat-last closes earn zero return there), as
    the reference does, instead of charging a phantom exit."""
    if mask is None:
        return pos
    last_idx = (mask.to(torch.int64).sum(-1) - 1).clamp_min(0)   # (N, 1)
    pos_last = torch.gather(
        pos, -1, last_idx.expand(pos.shape[0], pos.shape[1])[..., None])
    return torch.where(mask, pos, pos_last)


def map_param_chunks(grid: Mapping[str, object], row_elems: int,
                     dev: torch.device, one_chunk) -> metrics_mod.Metrics:
    """Evaluate a sweep over chunks of the param axis (the reference's
    ``map_param_chunks``, shared by the single-asset and pairs sweeps).

    ``one_chunk(sub)`` gets each grid value as a ``(P_chunk, 1)`` f32 column
    on ``dev`` and returns :class:`~..ops.metrics.Metrics` of
    ``(..., P_chunk)`` fields; a chunk is sized so that one
    ``(..., P_chunk, T)`` intermediate of ``row_elems`` elements per param
    stays near ``_CHUNK_ELEMS``. Returns the ``(..., P)`` fields in flat
    grid order.
    """
    parts = [one_chunk(sub) for _, sub in param_chunks(grid, row_elems, dev)]
    return metrics_mod.Metrics(*(torch.cat(f, dim=-1) for f in zip(*parts)))


def param_chunks(grid: Mapping[str, object], row_elems: int,
                 dev: torch.device, chunk_elems: int = _CHUNK_ELEMS):
    """The chunks of :func:`map_param_chunks`: yields ``(lo, sub)``, where
    ``sub`` maps each grid name to its ``(P_chunk, 1)`` f32 column on
    ``dev`` and ``lo`` is the chunk's first flat grid index. A chunk holds
    ``chunk_elems // row_elems`` params (at least one)."""
    params = {k: device_mod.as_tensor(v, torch.float32, dev)
              for k, v in grid.items()}
    chunk = max(1, chunk_elems // max(row_elems, 1))
    for lo in range(0, grid_size(params), chunk):
        yield lo, {k: v[lo:lo + chunk, None] for k, v in params.items()}


def best_params(metric_values: torch.Tensor, grid: Mapping[str, object], *,
                axis: int = -1, metric: str | None = None,
                return_index: bool = False):
    """Select the best point of a ``(..., P)`` metric over the param axis
    (the reference's ``best_params``, the one selection routine of the
    best-returns path).

    Returns ``(best_value, {name: best_param})`` with the leading shape of
    ``metric_values`` minus the param axis, and the flat-grid indices as a
    third element when ``return_index`` is true. ``metric`` (a
    :class:`~..ops.metrics.Metrics` field name) sets the direction: the
    lower-is-better metrics select the minimum. NaN cells rank last (an
    all-NaN row still returns a NaN best), and among equal scores the
    first index wins (``torch.argmax``, as ``jnp.argmax``; +0 and -0 are
    equal here).
    """
    sign = metrics_mod.metric_sign(metric) if metric is not None else 1.0
    score = torch.where(torch.isnan(metric_values),
                        torch.full_like(metric_values, -torch.inf),
                        sign * metric_values)
    idx = torch.argmax(score, dim=axis)
    best = torch.take_along_dim(
        metric_values, idx.unsqueeze(axis), dim=axis).squeeze(axis)
    chosen = {n: device_mod.as_tensor(v, torch.float32,
                                      metric_values.device)[idx]
              for n, v in grid.items()}
    if return_index:
        return best, chosen, idx
    return best, chosen
