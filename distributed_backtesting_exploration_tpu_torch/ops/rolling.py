"""Rolling-window indicators as O(T) cumulative-sum ops (PyTorch).

The part of the reference's ``ops/rolling.py`` the SMA sweep needs. Time is
the last axis. A rolling sum over window ``w`` is ``cs[t] - cs[t-w]`` on the
inclusive prefix sum, where the shifted read is a clipped gather so that
``w`` may be a tensor of windows that broadcasts against the series (the
port's stand-in for the reference's ``vmap`` over traced windows).
Warmup bars ``t < w - 1`` are filled with ``fill``.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def _as_window(window, like: Tensor) -> Tensor:
    return torch.as_tensor(window, dtype=like.dtype, device=like.device)


def _shifted(cs: Tensor, w, *, fill: float = 0.0) -> Tensor:
    """``cs[..., t - w]`` along the last axis, ``fill`` where ``t < w``.

    ``w`` is a scalar or a tensor that broadcasts against ``cs`` with the
    time axis dropped (e.g. ``(P, 1)`` windows against ``(N, 1, T)``
    series). As in the reference, the gather index is ``t - w`` clipped to
    ``[0, T-1]`` and then truncated to an integer, so a non-integral window
    reads the same bar the reference reads.
    """
    T = cs.shape[-1]
    w = _as_window(w, cs)
    idx = torch.arange(T, device=cs.device, dtype=cs.dtype) - w
    gather_idx = idx.clamp(0, T - 1).to(torch.int64)
    shape = torch.broadcast_shapes(cs.shape, gather_idx.shape)
    taken = torch.gather(cs.expand(shape), -1, gather_idx.expand(shape))
    return torch.where(idx >= 0, taken, torch.full_like(taken, fill))


def valid_mask(T: int, window, device=None) -> Tensor:
    """Boolean mask, True where a ``window``-bar indicator is defined.

    Shaped ``(T,)`` for a scalar window, ``window.shape + (T,)`` for a
    tensor of windows; broadcasts against any ``(..., T)`` indicator.
    """
    w = torch.as_tensor(window, dtype=torch.float32, device=device)
    return torch.arange(T, device=w.device) >= w - 1


def rolling_sum(x: Tensor, window, *, fill: float = math.nan) -> Tensor:
    """Rolling sum over the trailing ``window`` bars (inclusive), same length.

    ``out[..., t] = sum(x[..., t-window+1 : t+1])``; warmup -> ``fill``.
    """
    cs = torch.cumsum(x, dim=-1)
    out = cs - _shifted(cs, window)
    valid = valid_mask(x.shape[-1], _as_window(window, x))
    return torch.where(valid, out, torch.full_like(out, fill))


def rolling_mean(x: Tensor, window, *, fill: float = math.nan) -> Tensor:
    """Rolling mean (SMA) over the trailing ``window`` bars."""
    return rolling_sum(x, window, fill=fill) / _as_window(window, x)
