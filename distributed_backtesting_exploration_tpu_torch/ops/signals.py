"""Shared signal state machines (reference ``ops/signals.py``).

The band entry/exit hysteresis machine (enter when a z-score breaches an
entry band, hold until it re-crosses an exit band) is the stateful core of
Bollinger mean-reversion and the stochastic oscillator. The sequential
golden model is :func:`band_hysteresis`; the associative form
(:func:`band_transition_maps`, :func:`prefix_compose_maps`,
:func:`band_hysteresis_assoc`) computes the identical state sequence by
composing per-bar maps on the states {-1, 0, +1}, which is how the
time-sharded backtests fold the band and latch machines across blocks
(:mod:`..parallel.timeshard`). Composition only selects among exact
{-1, 0, +1} values, so every association order gives the same bits.
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


def _band(x, like: Tensor) -> Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def band_transition_maps(z: Tensor, valid: Tensor, z_entry, z_exit=0.0):
    """Per-bar transition maps of the band machine, as three float tensors
    ``(frm_m, frm_0, frm_p)``: the next state when the previous state is
    -1, 0 or +1. ``z_entry``/``z_exit`` broadcast against ``z``."""
    valid = torch.broadcast_to(valid, z.shape)
    ze, zx = _band(z_entry, z), _band(z_exit, z)
    one = torch.ones((), dtype=z.dtype, device=z.device)
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    entered = torch.where(z < -ze, one, torch.where(z > ze, -one, zero))
    frm_m = torch.where(z <= zx, zero, -one)      # short exits at z <= z_exit
    frm_p = torch.where(z >= -zx, zero, one)      # long exits at z >= -z_exit
    return (torch.where(valid, frm_m, zero), torch.where(valid, entered, zero),
            torch.where(valid, frm_p, zero))


def _compose_maps(earlier, later):
    """``later`` after ``earlier`` on 3-state maps: each component of
    ``earlier`` routed through ``later``'s table by two selects."""
    lm, l0, lp = later

    def apply(v):
        return torch.where(v < 0, lm, torch.where(v > 0, lp, l0))

    em, e0, ep = earlier
    return apply(em), apply(e0), apply(ep)


def _shift_last(x: Tensor, s: int, fill: float) -> Tensor:
    """``y[..., t] = x[..., t-s]`` with ``fill`` for ``t < s``."""
    pad = torch.full(x.shape[:-1] + (min(s, x.shape[-1]),), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :x.shape[-1] - pad.shape[-1]]], dim=-1)


def prefix_compose_maps(maps):
    """Inclusive prefix composition of per-bar 3-state maps along the last
    axis: a Hillis-Steele shift-doubling ladder of ~log2(T) rounds, the
    identity map shifted in past the edge (the reference's
    ``prefix_compose_maps``)."""
    pm, p0, pp = maps
    T = pm.shape[-1]
    span = 1
    while span < T:
        earlier = (_shift_last(pm, span, -1.0), _shift_last(p0, span, 0.0),
                   _shift_last(pp, span, 1.0))
        pm, p0, pp = _compose_maps(earlier, (pm, p0, pp))
        span *= 2
    return pm, p0, pp


def band_hysteresis_assoc(z: Tensor, valid: Tensor, z_entry,
                          z_exit=0.0) -> Tensor:
    """:func:`band_hysteresis` in O(log T) depth by prefix composition; the
    identical position sequence (the start state is flat, so the path is
    the prefix maps' 0-component)."""
    _, p0, _ = prefix_compose_maps(band_transition_maps(z, valid, z_entry,
                                                        z_exit))
    return p0
