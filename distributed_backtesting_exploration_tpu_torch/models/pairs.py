"""Rolling-OLS pairs trade (``BASELINE.json`` configs[3]; the reference's
``models/pairs.py``).

A pair is a (y, x) pair of close series. Per bar, a rolling OLS of y on x
gives the hedge ratio ``beta``; the spread ``y - (alpha + beta x)`` is
z-scored over the same lookback; the band machine enters a unit spread
position when ``|z|`` exceeds ``z_entry`` and exits when z re-crosses
``z_exit``. The spread return of bar t is
``(r_y[t] - beta[t-1] r_x[t]) / max(1 + |beta[t-1]|, 1)`` (gross exposure
normalized), and cost is charged per unit of gross turnover.

Pairs do not fit the single-asset :class:`~.base.Strategy` seam (two
inputs), so this module owns its sweep, :func:`run_pairs_sweep`. Where the
reference vmaps over (pair x param), the port lays the legs out as
``(N, 1, T)`` and the params as ``(P_chunk, 1)`` columns, so every tensor
below is ``(N, P_chunk, T)``, in param chunks as
:func:`~..parallel.sweep.run_sweep` takes them.
"""

from __future__ import annotations

from typing import Mapping

import torch

from .. import device as device_mod
from ..ops import metrics as metrics_mod
from ..ops import pnl as pnl_mod
from ..ops import rolling, signals
from ..parallel import sweep as sweep_mod

Tensor = torch.Tensor


def _lagged(x: Tensor) -> Tensor:
    """``x[t-1]`` with 0 at ``t = 0``."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def pair_signals(y: Tensor, x: Tensor, lookback):
    """Rolling hedge ratio, spread z-score and validity of each pair:
    ``(beta, z, valid)``, broadcast of the legs and the lookbacks."""
    alpha, beta = rolling.rolling_ols(y, x, lookback, fill=0.0)
    spread = y - (alpha + beta * x)
    z = rolling.rolling_zscore(spread, lookback, fill=0.0)
    # The spread needs `lookback` bars of OLS warmup, its z-score another
    # `lookback`: mask both.
    lb = torch.as_tensor(lookback, dtype=y.dtype, device=y.device)
    valid = rolling.valid_mask(y.shape[-1], 2 * lb - 1, y.device)
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    return beta, torch.where(valid, z, zero), valid


def pairs_positions(y: Tensor, x: Tensor, params) -> tuple[Tensor, Tensor]:
    """The band machine over the spread z-score: ``(pos, beta)``. +1 is long
    the spread (long y, short beta x), -1 short, 0 flat."""
    beta, z, valid = pair_signals(y, x, params["lookback"])
    pos = signals.band_hysteresis(z, valid, params["z_entry"],
                                  params.get("z_exit", 0.0))
    return pos, beta


def pair_net_returns(y: Tensor, x: Tensor, params, *, cost: float = 0.0):
    """Positions, per-bar net spread returns and the hedged return
    ``hr``: ``(pos, net, hr)`` with ``net = prev_pos * hr - cost *
    |delta pos|``. The PnL every pairs path is held against."""
    pos, beta = pairs_positions(y, x, params)
    ry = pnl_mod.simple_returns(y)
    rx = pnl_mod.simple_returns(x)
    prev_pos = _lagged(pos)
    prev_beta = _lagged(beta)
    gross = 1.0 + prev_beta.abs()
    hr = (ry - prev_beta * rx) / gross.clamp_min(1.0)
    turnover = (pos - prev_pos).abs()
    net = prev_pos * hr - torch.tensor(cost, dtype=y.dtype,
                                       device=y.device) * turnover
    return pos, net, hr


def pair_backtest(y: Tensor, x: Tensor, params, *, cost: float = 0.0,
                  periods_per_year: int = 252) -> metrics_mod.Metrics:
    """The 9 metrics of every pair under every param set of ``params``."""
    pos, net, _ = pair_net_returns(y, x, params, cost=cost)
    equity = 1.0 + torch.cumsum(net, dim=-1)
    return metrics_mod.summary_metrics(net, equity, pos,
                                       periods_per_year=periods_per_year)


def run_pairs_sweep(y_close, x_close, grid: Mapping[str, object], *,
                    cost: float = 0.0, periods_per_year: int = 252,
                    device: str | torch.device = device_mod.DEFAULT_DEVICE,
                    ) -> metrics_mod.Metrics:
    """Every (pair, param) combo; fields come back ``(n_pairs, P)``.

    ``y_close``/``x_close`` are ``(n_pairs, T)`` (numpy arrays or tensors),
    ``grid`` maps each param name to its ``(P,)`` values
    (:func:`~..parallel.sweep.product_grid`): ``lookback``, ``z_entry`` and
    optionally ``z_exit`` (0 if absent). There is no bar mask, as in the
    reference: a ragged batch is swept one pair at a time.
    """
    dev = device_mod.resolve(device)
    y = device_mod.as_tensor(y_close, torch.float32, dev)[:, None, :]
    x = device_mod.as_tensor(x_close, torch.float32, dev)[:, None, :]
    if x.shape != y.shape or y.ndim != 3:
        raise ValueError(f"y_close and x_close must be (n_pairs, T) of one "
                         f"shape; got {tuple(y.shape)} and {tuple(x.shape)}")
    return sweep_mod.map_param_chunks(
        grid, y.shape[0] * y.shape[-1], dev,
        lambda sub: pair_backtest(y, x, sub, cost=cost,
                                  periods_per_year=periods_per_year))


def chunked_pairs_sweep(y_close, x_close, grid: Mapping[str, object], *,
                        param_chunk: int, cost: float = 0.0,
                        periods_per_year: int = 252,
                        device: str | torch.device = device_mod.DEFAULT_DEVICE,
                        ) -> metrics_mod.Metrics:
    """:func:`run_pairs_sweep` over the grid ``param_chunk`` combos at a
    time, the ``(n_pairs, P)`` fields concatenated in grid order: the
    reference's memory-bounded pairs sweep, with a chunk the caller
    chooses. ``P`` must be divisible by ``param_chunk``."""
    P = sweep_mod.grid_size(grid)
    if P % param_chunk:
        raise ValueError(f"grid size {P} not divisible by chunk {param_chunk}")
    dev = device_mod.resolve(device)
    y = device_mod.as_tensor(y_close, torch.float32, dev)
    x = device_mod.as_tensor(x_close, torch.float32, dev)
    parts = [run_pairs_sweep(y, x,
                             {k: v[lo:lo + param_chunk]
                              for k, v in grid.items()},
                             cost=cost, periods_per_year=periods_per_year,
                             device=dev)
             for lo in range(0, P, param_chunk)]
    return metrics_mod.Metrics(*(torch.cat(f, dim=-1) for f in zip(*parts)))
