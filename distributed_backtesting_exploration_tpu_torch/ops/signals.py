"""Shared signal state machines (reference ``ops/signals.py``).

The band entry/exit hysteresis machine (enter when a z-score breaches an
entry band, hold until it re-crosses an exit band) is the stateful core of
Bollinger mean-reversion and the stochastic oscillator. The port keeps the
reference's sequential golden model only: the reference's associative form
computes the identical state sequence.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _per_series(x, like: Tensor) -> Tensor:
    """A band that broadcasts against ``like`` (``(..., T)``) as its
    per-series value, shaped ``like.shape[:-1]``."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.broadcast_to(x, like.shape)[..., 0]


def band_hysteresis(z: Tensor, valid: Tensor, z_entry, z_exit=0.0) -> Tensor:
    """Positions from a z-score band machine; shapes ``(..., T)`` -> same.

    Enter long (+1) when ``z < -z_entry``, short (-1) when ``z > z_entry``;
    exit to flat when z re-crosses ``-z_exit`` (long) / ``z_exit`` (short).
    The position never flips sign without passing through flat. Bars with
    ``valid`` False force flat. ``z_entry``/``z_exit`` are scalars or
    tensors that broadcast against ``z`` with a time axis of 1 (e.g.
    ``(P, 1)`` bands against ``(N, P, T)`` z-scores).
    """
    valid = torch.broadcast_to(valid, z.shape)
    ze = _per_series(z_entry, z)
    zx = _per_series(z_exit, z)
    one = torch.ones((), dtype=z.dtype, device=z.device)
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    pos = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
    out = torch.empty_like(z)
    for t in range(z.shape[-1]):
        zt = z[..., t]
        entered = torch.where(zt < -ze, one, torch.where(zt > ze, -one, zero))
        exit_long = (pos > 0) & (zt >= -zx)
        exit_short = (pos < 0) & (zt <= zx)
        held = torch.where(exit_long | exit_short, zero, pos)
        pos = torch.where(valid[..., t],
                          torch.where(pos == 0, entered, held), zero)
        out[..., t] = pos
    return out
