"""Multi-device sweeps: the mesh, shard-even padding and ticker-sharded
execution (the reference's ``parallel/sharding.py``).

The reference shards a sweep's ticker axis over a 1-D ``jax.sharding.Mesh``
of a worker's chips under ``shard_map``, one SPMD program for all of them.
The port keeps that mesh small and explicit, in one process, the way JAX's
single-controller mesh runs inside a worker:

- a :class:`Mesh` is a tuple of ``torch.device``s and an axis name; shard
  ``i``'s work runs on ``mesh.devices[i]``, each shard's launches queued on
  its own device, so shards on distinct cards run at once;
- the collectives are explicit tensor moves between the shards' devices, in
  shard order: an all-gather of per-block values is a stack (or
  concatenation) on shard 0's device (:func:`gather`); the left halo is the
  left shard's last ``k`` values moved to shard ``i``, zeros on shard 0, as
  ``ppermute`` gives (:func:`from_left`); a ``psum`` is a sum in shard order
  moved back to each shard (:func:`psum`). A received value is always a new
  tensor (``Tensor.to`` of a tensor already on the target device returns
  the tensor itself, and a mesh may list a device more than once), so
  nothing a shard does to what it received reaches the sender's block;
- a mesh may list a device more than once: ``["cpu"] * 4`` in the tests,
  ``["cuda:0"] * 4`` on a one-card machine. :func:`make_mesh` with no
  arguments takes every local CUDA device and raises where there is none;
  it never falls back to the CPU.

A ticker-sharded sweep needs no collective in its hot loop: each shard runs
the generic sweep on its rows and the metrics are gathered once.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from .. import device as device_mod
from ..models.base import Strategy
from ..ops import metrics as metrics_mod
from ..utils.data import OHLCV
from . import sweep as sweep_mod
from .walkforward import argmax_nan_first

TICKER_AXIS = "tickers"

Tensor = torch.Tensor


class Mesh(NamedTuple):
    """A 1-D mesh: shard ``i`` runs on ``devices[i]``."""

    devices: tuple
    axis_name: str = TICKER_AXIS

    @property
    def size(self) -> int:
        """The number of shards."""
        return len(self.devices)

    @property
    def distinct(self) -> int:
        """The number of distinct devices, the shards that can run at
        once."""
        return len(set(self.devices))


def make_mesh(devices: Sequence | None = None, *,
              axis_name: str = TICKER_AXIS) -> Mesh:
    """A 1-D mesh over ``devices`` (default: every local CUDA device).

    Without ``devices`` and without CUDA it raises ``RuntimeError``: the
    CPU is used only where the caller lists it. Any list is taken, repeats
    included (``["cpu"] * 4``, ``["cuda:0"] * 4``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() needs CUDA devices and torch.cuda.is_available() "
                "is False; pass devices (e.g. ['cpu'] * 4) to mesh the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(device_mod.resolve(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs, axis_name)


def pad_tickers(n_tickers: int, n_shards: int) -> int:
    """Smallest multiple of ``n_shards`` >= ``n_tickers``."""
    return -(-n_tickers // n_shards) * n_shards


def pad_rows(a, n_pad: int):
    """Pad a row-stacked array (numpy or tensor) to ``n_pad`` rows by
    repeating the last row: the pad rows are real, well-formed inputs whose
    outputs callers drop, so no kernel needs a validity mask."""
    n = a.shape[0]
    if n_pad == n:
        return a
    if isinstance(a, Tensor):
        return torch.cat([a, a[-1:].expand(n_pad - n, *a.shape[1:])])
    a = np.asarray(a)
    return np.concatenate([a, np.repeat(a[-1:], n_pad - n, axis=0)], axis=0)


def copy_to(x: Tensor, dev: torch.device) -> Tensor:
    """``x`` on ``dev`` as a tensor of its own (a copy even where ``x`` is
    already there)."""
    y = x.to(dev)
    return y.clone() if y is x else y


def shard_rows(mesh: Mesh, a) -> list:
    """Rows of ``a`` (numpy or tensor) padded to a mesh multiple with
    :func:`pad_rows` and split into ``mesh.size`` equal blocks, block ``i``
    on ``mesh.devices[i]``."""
    n_pad = pad_tickers(a.shape[0], mesh.size)
    t = pad_rows(a if isinstance(a, Tensor)
                 else torch.from_numpy(np.ascontiguousarray(a)), n_pad)
    per = n_pad // mesh.size
    return [t[i * per:(i + 1) * per].to(d).contiguous()
            for i, d in enumerate(mesh.devices)]


def shard_last(mesh: Mesh, x: Tensor) -> list:
    """The last axis of ``x`` split into ``mesh.size`` equal blocks, block
    ``i`` on ``mesh.devices[i]`` (the length must divide)."""
    T = x.shape[-1]
    if T % mesh.size:
        raise ValueError(f"T={T} not divisible by the {mesh.size}-way "
                         f"{mesh.axis_name!r} axis")
    return [b.to(d).contiguous()
            for b, d in zip(torch.chunk(x, mesh.size, dim=-1), mesh.devices)]


def gather(mesh: Mesh, blocks: Sequence[Tensor], dim: int = 0) -> Tensor:
    """The all-gather: per-shard blocks concatenated along ``dim`` in shard
    order on shard 0's device."""
    return torch.cat([b.to(mesh.devices[0]) for b in blocks], dim=dim)


def from_left(mesh: Mesh, blocks: Sequence[Tensor], k: int) -> list:
    """The left halo, ``ppermute``'s: shard ``i`` receives the last ``k``
    values along the last axis of shard ``i - 1``'s block, shard 0 zeros.
    Each received halo is a tensor of its own."""
    out = [torch.zeros_like(blocks[0][..., -k:])]
    for i in range(1, mesh.size):
        out.append(copy_to(blocks[i - 1][..., -k:], mesh.devices[i]))
    return out


def total(mesh: Mesh, vals: Sequence[Tensor]) -> Tensor:
    """The per-shard values summed in shard order, on shard 0's device."""
    acc = vals[0].to(mesh.devices[0])
    for v in vals[1:]:
        acc = acc + v.to(mesh.devices[0])
    return acc


def psum(mesh: Mesh, vals: Sequence[Tensor]) -> list:
    """The ``psum``: :func:`total`, moved back to each shard."""
    acc = total(mesh, vals)
    return [copy_to(acc, d) for d in mesh.devices]


def device_put_sweep(mesh: Mesh, ohlcv, grid: Mapping[str, object],
                     bar_mask=None):
    """Place a sweep's inputs: the ticker rows padded (repeat-last) to a
    mesh multiple and split over the shards, the grid on every shard.
    Returns ``(ohlcv blocks, grid blocks, mask blocks or None, n_real)``,
    one entry a shard; callers keep the first ``n_real`` rows of the
    gathered result."""
    n = int(ohlcv.close.shape[0])
    fields = [shard_rows(mesh, device_mod.as_tensor(f, torch.float32,
                                                    torch.device("cpu"))
                         if not isinstance(f, Tensor) else f.float())
              for f in ohlcv]
    panels = [OHLCV(*blk) for blk in zip(*fields)]
    grids = [{k: device_mod.as_tensor(v, torch.float32, d)
              for k, v in grid.items()} for d in mesh.devices]
    masks = None
    if bar_mask is not None:
        m = (bar_mask if isinstance(bar_mask, Tensor)
             else torch.from_numpy(np.asarray(bar_mask, bool)))
        masks = shard_rows(mesh, m)
    return panels, grids, masks, n


def _local_sweep(panel, strategy, grid, *, cost, mask, periods_per_year,
                 param_chunk, device):
    if not param_chunk:
        return sweep_mod.run_sweep(panel, strategy, grid, cost=cost,
                                   bar_mask=mask,
                                   periods_per_year=periods_per_year,
                                   device=device)
    P = sweep_mod.grid_size(grid)
    parts = [sweep_mod.run_sweep(
        panel, strategy, {k: v[lo:lo + param_chunk] for k, v in grid.items()},
        cost=cost, bar_mask=mask, periods_per_year=periods_per_year,
        device=device) for lo in range(0, P, param_chunk)]
    return metrics_mod.Metrics(*(torch.cat(f, dim=-1) for f in zip(*parts)))


def sharded_sweep(mesh: Mesh, ohlcv, strategy: Strategy,
                  grid: Mapping[str, object], *, cost: float = 0.0,
                  bar_mask=None, periods_per_year: int = 252,
                  param_chunk: int | None = None) -> metrics_mod.Metrics:
    """The multi-device sweep: each shard runs the generic sweep
    (:func:`~.sweep.run_sweep`, or in grid chunks of ``param_chunk``
    combos) on its rows, on its device; the ``(n_tickers, P)`` metrics are
    gathered on shard 0's device in shard order, pad rows dropped."""
    panels, grids, masks, n = device_put_sweep(mesh, ohlcv, grid, bar_mask)
    parts = [_local_sweep(p, strategy, g, cost=cost,
                          mask=None if masks is None else masks[i],
                          periods_per_year=periods_per_year,
                          param_chunk=param_chunk, device=mesh.devices[i])
             for i, (p, g) in enumerate(zip(panels, grids))]
    return metrics_mod.Metrics(*(gather(mesh, f)[:n] for f in zip(*parts)))


def best_over_grid(mesh: Mesh, ohlcv, strategy: Strategy,
                   grid: Mapping[str, object], *, metric: str = "sharpe",
                   cost: float = 0.0, bar_mask=None,
                   periods_per_year: int = 252):
    """Sweep and global argmax over the whole (ticker x param) grid.

    Returns ``(best_value, best_ticker_index, {param: value})``, scalars on
    shard 0's device. Each shard reduces its block to one (value, flat
    index) pair; the pairs are gathered in shard order and the argmax taken
    over them. The rule is ``jnp.argmax``'s
    (:func:`~.walkforward.argmax_nan_first`): the first NaN wins, and among
    equal values the first index; the repeat-last pad rows come after the
    real ones, so they never win."""
    sign = metrics_mod.metric_sign(metric)
    panels, grids, masks, _ = device_put_sweep(mesh, ohlcv, grid, bar_mask)
    vals, idxs = [], []
    n_per = panels[0].close.shape[0]
    for i, (p, g) in enumerate(zip(panels, grids)):
        m = sweep_mod.run_sweep(p, strategy, g, cost=cost,
                                bar_mask=None if masks is None else masks[i],
                                periods_per_year=periods_per_year,
                                device=mesh.devices[i])
        flat = (sign * getattr(m, metric)).reshape(-1)
        li = argmax_nan_first(flat, dim=0)
        vals.append(flat[li])
        idxs.append(li)
    all_v = torch.stack([v.to(mesh.devices[0]) for v in vals])
    all_i = torch.stack([i.to(mesh.devices[0]) for i in idxs])
    shard = argmax_nan_first(all_v, dim=0)
    P = sweep_mod.grid_size(grids[0])
    flat_idx = all_i[shard]
    ticker = (shard * n_per + flat_idx // P).to(torch.int32)
    param = (flat_idx % P).to(torch.int64)
    chosen = {k: v[param] for k, v in grids[0].items()}
    return sign * all_v[shard], ticker, chosen
