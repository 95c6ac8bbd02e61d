"""Time-axis (sequence) parallelism: blockwise scans with a carry handed
from block to block (the reference's ``parallel/timeshard.py``).

The long-context axis of a backtest is bar time. Indicators are prefix-sum
algebra and the PnL and band machines are first-order recurrences, so a
long history shards by its bars: each shard of a :class:`~.sharding.Mesh`
runs the local recurrence on its block, then fixes the block up with the
carry from the shards to its left. The reference writes this as
``shard_map`` programs with ``all_gather``/``ppermute``/``psum``; the port
runs the same blockwise computations as torch ops on each shard's device,
and its collectives are the explicit moves of :mod:`.sharding`
(``from_left``, ``psum``, ``gather``, an exclusive fold in shard order).

- :func:`sharded_cumsum`: each block's prefix sums in f64, the f64 totals
  of the blocks to the left added, rounded once to the input's dtype. A sum
  of f32 prices is exact in f64 in any order, so the blockwise prefix sums
  have the bits of the single-device :func:`~..ops.rolling.prefix_sum`
  (and of a one-shard mesh): no knife edge between the sharded and the
  single-device windowed sums, where the reference's f32 blockwise cumsum
  rounds apart from its f32 single-device one (its own test bounds that at
  rtol=0.25 for an 8k-bar history, ``tests/test_timeshard_wire.py``).
  Rolling sums, means, variances and the OLS moments are differences of
  these prefix sums, so every windowed indicator here has the bits of the
  port's generic models.
- :func:`sharded_linear_scan`: ``y[t] = a[t] y[t-1] + b[t]``, each block's
  prefix maps by a shift-doubling ladder in f64, one ``(A, B)`` summary a
  block folded in shard order, the incoming carry applied, rounded once.
  The f64 results of two splits differ by f64 roundings only, far below an
  f32 rounding, so the EMAs agree with a one-shard mesh's bit for bit
  unless a value falls within a few f64 units of an f32 rounding boundary.
- :func:`sharded_band_positions` and the Donchian latch: the band machine's
  per-bar update is a map on the states {-1, 0, +1}
  (:func:`~..ops.signals.band_transition_maps`); a block composes into one
  3-vector summary, the summaries fold in shard order, and each bar's
  prefix map routes the incoming state. Selects only, so exact.
- Rolling extrema (Donchian channels, stochastic %K) come from a bounded
  halo of the left block's last ``window`` bars and a local sliding
  reduction: exact, no carry.

The metrics' sums are f32 sums per block added in shard order, so they
agree with the single-device metrics to f32 tolerance, not bit for bit;
positions agree exactly wherever their signals do.

Every ``sharded_*_backtest`` takes a ``(..., T)`` panel whose bar count
divides by the mesh, and ``t_real``: a history right-padded with
repeat-last bars passes its real length, and the pad bars are then dead in
every metric (zero return, turnover and activity; every denominator is
``t_real``). A window must fit one block (the halo comes from the left
neighbour only); the EMA families have O(1) state and no such bound.
Results are :class:`~..ops.metrics.Metrics` of ``(...)`` fields on shard
0's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import signals
from ..ops.metrics import Metrics, metrics_from_reductions
from .sharding import Mesh, copy_to, from_left, gather, shard_last, total

TIME_AXIS = "time"

Tensor = torch.Tensor
_EPS = 1e-12


def _tensor(x) -> Tensor:
    """``x`` as an f32 tensor (where it is not a tensor already)."""
    if isinstance(x, Tensor):
        return x if x.dtype == torch.float32 else x.float()
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _gidx(mesh: Mesh, Tb: int) -> list:
    """Each block's global bar indices."""
    return [torch.arange(Tb, device=d) + i * Tb
            for i, d in enumerate(mesh.devices)]


def _exclusive_block_reduce(mesh: Mesh, vals, op, identity: float) -> list:
    """``op`` of the per-block ``vals`` of every shard strictly left of
    each one, folded in shard order (``identity`` on shard 0)."""
    out, acc = [], None
    for i, d in enumerate(mesh.devices):
        out.append(torch.full_like(vals[i], identity) if acc is None
                   else copy_to(acc, d))
        v = vals[i].to(mesh.devices[0])
        acc = v.clone() if acc is None else op(acc, v)
    return out


def _exclusive_block_offset(mesh: Mesh, totals) -> list:
    """The sum of the per-block ``totals`` of the shards left of each."""
    return _exclusive_block_reduce(mesh, totals, torch.add, 0.0)


def _per(x: Tensor, w) -> Tensor:
    """``x / w`` as a true division by a tensor on ``x``'s device: torch on
    CUDA divides by a Python number as a multiply by its reciprocal, which
    rounds otherwise than the generic models' division by a window
    tensor."""
    return x / torch.full((), float(w), dtype=x.dtype, device=x.device)


def _broadcast(mesh: Mesh, x: Tensor) -> list:
    return [copy_to(x, d) for d in mesh.devices]


def _cumsum_blocks(mesh: Mesh, blks) -> list:
    """Blockwise inclusive prefix sums: each block's in f64, the f64 totals
    of the blocks to its left added, rounded once to the blocks' dtype."""
    cs = [torch.cumsum(b.double(), dim=-1) for b in blks]
    off = _exclusive_block_offset(mesh, [c[..., -1] for c in cs])
    return [(c + o[..., None]).to(b.dtype)
            for c, o, b in zip(cs, off, blks)]


def sharded_cumsum(mesh: Mesh, x) -> Tensor:
    """Inclusive prefix sums along the last axis of ``x``, its bars split
    over the mesh; the result gathered on shard 0's device. Bit-equal to
    :func:`~..ops.rolling.prefix_sum` where the f64 sums are exact (sums
    of f32 prices always are)."""
    x = _tensor(x)
    return gather(mesh, _cumsum_blocks(mesh, shard_last(mesh, x)), dim=-1)


def _ladder(a: Tensor, b: Tensor):
    """Inclusive prefix maps of ``y = a y_prev + b`` along the last axis:
    ``(prod a, y with y_in = 0)`` by shift-doubling (identity ``(1, 0)``
    shifted in)."""
    T = a.shape[-1]
    A, B = a, b
    step = 1
    while step < T:
        Ae = torch.cat([torch.ones_like(A[..., :step]), A[..., :-step]], -1)
        Be = torch.cat([torch.zeros_like(B[..., :step]), B[..., :-step]], -1)
        A, B = Ae * A, A * Be + B
        step *= 2
    return A, B


def _linear_scan_blocks(mesh: Mesh, a_blks, b_blks, dtype) -> list:
    """Blockwise ``y[t] = a[t] y[t-1] + b[t]`` (``y[-1] = 0``) in f64: each
    block's prefix maps, the blocks' ``(A, B)`` summaries folded left in
    shard order into each block's incoming carry, ``y = B_local +
    A_prefix * carry``, rounded once to ``dtype``."""
    pref = [_ladder(a.double(), b.double()) for a, b in zip(a_blks, b_blks)]
    out, carry = [], None
    for i, (A, B) in enumerate(pref):
        d = mesh.devices[i]
        c = torch.zeros_like(B[..., -1]) if carry is None else copy_to(carry,
                                                                       d)
        out.append((B + A * c[..., None]).to(dtype))
        carry = (A[..., -1] * c + B[..., -1]).to(mesh.devices[0])
    return out


def sharded_linear_scan(mesh: Mesh, a, b) -> Tensor:
    """Distributed ``y[t] = a[t] y[t-1] + b[t]`` (``y[-1] = 0``) along the
    last axis, gathered on shard 0's device (f64 inside, rounded once)."""
    a, b = _tensor(a), _tensor(b)
    return gather(mesh, _linear_scan_blocks(
        mesh, shard_last(mesh, a), shard_last(mesh, b), a.dtype), dim=-1)


def _ema_blocks(mesh: Mesh, x_blks, gidx, alpha: float) -> list:
    """Blockwise EMA with :func:`~..ops.rolling.ema`'s seed, ``y[0] =
    x[0]`` at the global first bar (``a = 0, b = x`` there)."""
    keep = float(np.float32(1.0 - alpha))
    a_blks, b_blks = [], []
    for x, g in zip(x_blks, gidx):
        xd = x.double()
        t0 = g == 0
        a_blks.append(torch.where(t0, 0.0, torch.full_like(xd, keep)))
        b_blks.append(torch.where(t0, xd, alpha * xd))
    return _linear_scan_blocks(mesh, a_blks, b_blks, x_blks[0].dtype)


def _alpha(span=None, alpha=None) -> float:
    """The decay as an f32 value (``2 / (span + 1)`` rounded to f32)."""
    if (span is None) == (alpha is None):
        raise ValueError("pass exactly one of span= or alpha=")
    if alpha is None:
        alpha = 2.0 / (float(span) + 1.0)
    return float(np.float32(alpha))


def sharded_ema(mesh: Mesh, x, *, span=None, alpha=None) -> Tensor:
    """EMA of a ``(..., T)`` series, its bars split over the mesh: ``y[t] =
    (1 - a) y[t-1] + a x[t]``, ``y[0] = x[0]``; gathered on shard 0's
    device. No window, so no halo bound: any block length works."""
    a = _alpha(span, alpha)
    x = _tensor(x)
    blks = shard_last(mesh, x)
    return gather(mesh, _ema_blocks(mesh, blks, _gidx(mesh, blks[0].shape[-1]),
                                    a), dim=-1)


def chunked_scan(step, init_carry, inputs, *, chunk: int):
    """A sequential scan over the leading axis of ``inputs`` (a tensor or a
    tuple of tensors) in pieces of ``chunk`` steps: ``step(carry, x_t) ->
    (carry, y_t)``; returns ``(carry, ys)`` with the ``y_t`` stacked (a
    tensor or a tuple). The same results as one scan; the escape hatch of
    a state machine that does not compose."""
    single = isinstance(inputs, Tensor)
    xs = (inputs,) if single else tuple(inputs)
    T = xs[0].shape[0]
    if T % chunk:
        raise ValueError(f"T={T} not divisible by chunk={chunk}")
    carry, ys = init_carry, []
    for lo in range(0, T, chunk):
        for t in range(lo, lo + chunk):
            carry, y = step(carry, xs[0][t] if single
                            else tuple(x[t] for x in xs))
            ys.append(y)
    if isinstance(ys[0], tuple):
        return carry, tuple(torch.stack(list(c)) for c in zip(*ys))
    return carry, torch.stack(ys)


def _lag1(mesh: Mesh, blks) -> list:
    """Each block's values one bar back, the left block's last bar at its
    first (zeros on shard 0)."""
    halo = from_left(mesh, blks, 1)
    return [torch.cat([h, b[..., :-1]], dim=-1) for h, b in zip(halo, blks)]


def _returns_from_prev(close: Tensor, prev: Tensor, g: Tensor) -> Tensor:
    one = torch.ones((), dtype=close.dtype, device=close.device)
    zero = torch.zeros((), dtype=close.dtype, device=close.device)
    return torch.where(g == 0, zero, close / torch.where(g == 0, one, prev)
                       - 1.0)


def _block_returns(mesh: Mesh, close_blks, gidx) -> list:
    """Per-bar simple returns by a one-bar halo (``r[0] = 0``)."""
    return [_returns_from_prev(c, p, g)
            for c, p, g in zip(close_blks, _lag1(mesh, close_blks), gidx)]


def _pnl_metrics_local(mesh: Mesh, pos, r, gidx, T: int, *, cost: float,
                       periods_per_year: int, eps: float = _EPS,
                       prev_pos=None) -> Metrics:
    """The shared tail: lagged exposure by a one-bar halo, net returns per
    block, then the moments, the running-peak drawdown (an exclusive max
    of the left blocks' peaks) and the final equity as sums in shard
    order. Bars with ``gidx >= T`` are dead: zero net return, turnover and
    activity; every denominator is ``T``."""
    if prev_pos is None:
        prev_pos = _lag1(mesh, pos)
    nets, lives = [], []
    for p, pp, rr, g in zip(pos, prev_pos, r, gidx):
        live = g < T
        net = pp * rr - float(np.float32(cost)) * (p - pp).abs()
        nets.append(torch.where(live, net, torch.zeros_like(net)))
        lives.append(live)
    s1 = total(mesh, [n.sum(-1) for n in nets])
    s2 = total(mesh, [(n * n).sum(-1) for n in nets])
    down = [n.clamp_max(0.0) for n in nets]
    down_sq = total(mesh, [(d * d).sum(-1) for d in down])
    eq = [1.0 + torch.cumsum(n, dim=-1) for n in nets]
    off = _exclusive_block_offset(mesh, [n.sum(-1) for n in nets])
    eq = [e + o[..., None] for e, o in zip(eq, off)]
    left_peak = _exclusive_block_reduce(mesh, [e.amax(-1) for e in eq],
                                        torch.maximum, -np.inf)
    mdd = None
    for e, lp in zip(eq, left_peak):
        peak = torch.maximum(torch.cummax(e, dim=-1).values, lp[..., None])
        dd = ((peak - e) / peak.clamp_min(eps)).amax(-1).to(mesh.devices[0])
        mdd = dd if mdd is None else torch.maximum(mdd, dd)
    eq_final = total(mesh, [torch.where(g == T - 1, e, torch.zeros_like(e))
                             .sum(-1) for e, g in zip(eq, gidx)])
    active = [(pp.abs() > 0) & lv for pp, lv in zip(prev_pos, lives)]
    wins = total(mesh, [((n > 0) & a).to(n.dtype).sum(-1)
                         for n, a in zip(nets, active)])
    act = total(mesh, [a.to(n.dtype).sum(-1) for a, n in zip(active, nets)])
    turnover = total(mesh, [torch.where(lv, (p - pp).abs(),
                                         torch.zeros_like(p)).sum(-1)
                             for p, pp, lv in zip(pos, prev_pos, lives)])
    return metrics_from_reductions(
        s1=s1, s2=s2, downside_sq_sum=down_sq, mdd=mdd, eq_final=eq_final,
        wins_sum=wins, active_sum=act, turnover=turnover, n=float(T),
        periods_per_year=periods_per_year, eps=eps)


def _cumsum_ext(mesh: Mesh, blks, halo_w: int):
    """Global prefix sums of a blocked series and each block's prefix sums
    behind a ``halo_w``-bar left halo (the lagged reads of a windowed
    sum). Returns ``(cs, cs_ext)``."""
    cs = _cumsum_blocks(mesh, blks)
    halo = from_left(mesh, cs, halo_w)
    return cs, [torch.cat([h, c], dim=-1) for h, c in zip(halo, cs)]


def _windowed_sum_blk(cs: Tensor, cs_ext: Tensor, g: Tensor, w: int,
                      halo_w: int) -> Tensor:
    """Trailing ``w``-bar sum ``cs[t] - cs[t - w]`` with a zero lagged read
    in the global warmup ``t < w`` (:func:`~..ops.rolling.rolling_sum`'s
    difference)."""
    Tb = cs.shape[-1]
    lagged = cs_ext[..., halo_w - w:halo_w - w + Tb]
    return cs - torch.where(g >= w, lagged, torch.zeros_like(lagged))


def _live_mean(mesh: Mesh, blks, gidx, T: int) -> list:
    """Each row's mean over its live bars (``gidx < T``), the block sums in
    f64 added in shard order, divided by ``T`` and rounded once: on every
    shard."""
    tot = total(mesh, [torch.where(g < T, b.double(),
                                    torch.zeros((), dtype=torch.float64,
                                                device=b.device)).sum(-1)
                        for b, g in zip(blks, gidx)])
    return _broadcast(mesh, (tot / T).to(blks[0].dtype)[..., None])


def _windowed_zscore_local(mesh: Mesh, blks, gidx, window: int, halo_w: int,
                           T: int, *, eps: float = _EPS) -> list:
    """Blockwise rolling z-score (:func:`~..ops.rolling.rolling_zscore`'s
    formula, ddof=0), its second moments centered by the series' mean over
    its live bars; the three windowed sums ride one stacked prefix sum."""
    mean = _live_mean(mesh, blks, gidx, T)
    stacked = [torch.stack([b - m, (b - m) * (b - m), b])
               for b, m in zip(blks, mean)]
    cs, cs_ext = _cumsum_ext(mesh, stacked, halo_w)
    out = []
    for b, c, ce, g in zip(blks, cs, cs_ext, gidx):
        s = _windowed_sum_blk(c, ce, g, window, halo_w)
        var = _per(s[1] - _per(s[0] * s[0], window), window).clamp_min(0.0)
        out.append((b - _per(s[2], window)) / (torch.sqrt(var) + eps))
    return out


def _transition_positions_local(mesh: Mesh, maps_blks) -> list:
    """Position path of a {-1, 0, +1} transition-map machine over the
    blocks, exact: each block's prefix maps, its 3-vector summary, the
    state entering each block folded left from flat in shard order, and
    each bar's prefix map applied to it."""
    prefix = [signals.prefix_compose_maps(m) for m in maps_blks]
    out, state = [], None
    for i, (pm, p0, pp) in enumerate(prefix):
        d = mesh.devices[i]
        s = torch.zeros_like(p0[..., -1]) if state is None else copy_to(state,
                                                                        d)
        s1 = s[..., None]
        out.append(torch.where(s1 < 0, pm, torch.where(s1 > 0, pp, p0)))
        nxt = torch.where(s < 0, pm[..., -1],
                          torch.where(s > 0, pp[..., -1], p0[..., -1]))
        state = nxt.to(mesh.devices[0])
    return out


def _band_positions_local(mesh: Mesh, z_blks, valid_blks, z_entry,
                          z_exit) -> list:
    """Band-machine positions over the blocks (the band transition maps
    through :func:`_transition_positions_local`)."""
    return _transition_positions_local(mesh, [
        signals.band_transition_maps(z, v, z_entry, z_exit)
        for z, v in zip(z_blks, valid_blks)])


def _latch_maps(up: Tensor, down: Tensor, valid: Tensor):
    """Per-bar transition maps of the Donchian breakout latch: a break
    above the prior channel high goes long from any state, below the prior
    low short (``up`` wins where both hold), else hold; invalid bars force
    flat."""
    one = torch.ones(up.shape, dtype=torch.float32, device=up.device)
    zero = torch.zeros_like(one)
    v = torch.broadcast_to(valid, up.shape)

    def nxt_from(prev):
        return torch.where(up, one, torch.where(down, -one, prev))

    return (torch.where(v, nxt_from(-one), zero),
            torch.where(v, nxt_from(zero), zero),
            torch.where(v, nxt_from(one), zero))


def _reduce_window_last(x: Tensor, w: int, mode: str) -> Tensor:
    """Sliding extrema along the last axis, ``out[..., j] = mode(x[...,
    j:j+w])`` (length ``x.shape[-1] - w + 1``)."""
    win = x.unfold(-1, w, 1)
    return win.amax(-1) if mode == "max" else win.amin(-1)


def sharded_band_positions(mesh: Mesh, z, valid, z_entry, z_exit=0.0
                           ) -> Tensor:
    """Band-machine position path with the bars split over the mesh,
    gathered on shard 0's device: bit-equal to
    :func:`~..ops.signals.band_hysteresis` (and its associative form) on
    the whole series."""
    z = _tensor(z)
    valid = torch.as_tensor(valid).to(torch.bool)
    valid = torch.broadcast_to(valid.to(z.device), z.shape)
    return gather(mesh, _band_positions_local(
        mesh, shard_last(mesh, z), shard_last(mesh, valid), z_entry, z_exit),
        dim=-1)


def _resolve_t_real(T_pad: int, t_real) -> int:
    """The semantic history length of a right-padded panel (``T_pad``
    where ``t_real`` is None)."""
    if t_real is None:
        return T_pad
    t = int(t_real)
    if not 0 < t <= T_pad:
        raise ValueError(
            f"t_real={t} must be in (0, {T_pad}] (the padded length)")
    return t


def _check_divides(T: int, n: int) -> None:
    if T % n:
        raise ValueError(f"T={T} not divisible by the {n}-way "
                         f"{TIME_AXIS!r} axis")


def _check_time_axis(T: int, n: int, window: int, what: str) -> None:
    """The rejections of a windowed family: a window below 1 (it would
    return silent garbage, not fail), bars that do not divide by the mesh,
    a window that does not fit one block (its halo comes from one
    neighbour)."""
    if window < 1:
        raise ValueError(f"{what} must be >= 1, got {window}")
    _check_divides(T, n)
    if window > T // n:
        raise ValueError(
            f"{what}={window} exceeds the {T // n}-bar block; the halo "
            "exchange needs the window to fit one neighbor block")


def _setup(mesh: Mesh, *fields):
    """The fields' blocks (f32, split over the mesh), each block's global
    bar indices, and the padded length."""
    blks = [shard_last(mesh, _tensor(f)) for f in fields]
    return blks, _gidx(mesh, blks[0][0].shape[-1]), fields[0].shape[-1]


def _zero_where_not(valid: Tensor, x: Tensor) -> Tensor:
    return torch.where(valid, x, torch.zeros_like(x))


def sharded_sma_backtest(mesh: Mesh, close, fast: int, slow: int, *,
                         cost: float = 0.0, periods_per_year: int = 252,
                         t_real: int | None = None) -> Metrics:
    """SMA crossover with the bars split over the mesh: returns by a
    one-bar halo, the SMAs from the blockwise prefix sums and a
    ``slow``-bar halo, then the shared PnL tail. ``slow`` must fit one
    block."""
    if not 0 < fast < slow:
        raise ValueError(f"need 0 < fast < slow, got {fast}, {slow}")
    T_pad = close.shape[-1]
    _check_time_axis(T_pad, mesh.size, slow, "slow")
    T = _resolve_t_real(T_pad, t_real)
    (c,), g, _ = _setup(mesh, close)
    r = _block_returns(mesh, c, g)
    cs, cs_ext = _cumsum_ext(mesh, c, slow)
    pos = []
    for a, ae, gi in zip(cs, cs_ext, g):
        f = _per(_windowed_sum_blk(a, ae, gi, fast, slow), fast)
        s = _per(_windowed_sum_blk(a, ae, gi, slow, slow), slow)
        pos.append(_zero_where_not(gi >= slow - 1, torch.sign(f - s)))
    return _pnl_metrics_local(mesh, pos, r, g, T, cost=cost,
                              periods_per_year=periods_per_year)


def _zscore_band(mesh, c, g, window, T, k, z_exit, machine: str):
    z = _windowed_zscore_local(mesh, c, g, window, window, T)
    valid = [gi >= window - 1 for gi in g]
    z = [_zero_where_not(v, zi) for v, zi in zip(valid, z)]
    if machine == "touch":
        k_f = float(np.float32(k))
        one = torch.ones((), device=z[0].device)
        return [_zero_where_not(v, torch.where(zi < -k_f, one, torch.where(
            zi > k_f, -one, torch.zeros_like(one))))
            for v, zi in zip(valid, z)]
    return _band_positions_local(mesh, z, valid, float(np.float32(k)),
                                 float(np.float32(z_exit)))


def sharded_bollinger_backtest(mesh: Mesh, close, window: int, k: float, *,
                               z_exit: float = 0.0, cost: float = 0.0,
                               periods_per_year: int = 252,
                               t_real: int | None = None) -> Metrics:
    """Bollinger mean reversion with the bars split over the mesh: the
    blockwise rolling z-score (``window``-bar halo) into the band machine
    folded across blocks, then the PnL tail."""
    T_pad = close.shape[-1]
    _check_time_axis(T_pad, mesh.size, window, "window")
    T = _resolve_t_real(T_pad, t_real)
    (c,), g, _ = _setup(mesh, close)
    r = _block_returns(mesh, c, g)
    pos = _zscore_band(mesh, c, g, window, T, k, z_exit, "hysteresis")
    return _pnl_metrics_local(mesh, pos, r, g, T, cost=cost,
                              periods_per_year=periods_per_year)


def sharded_bollinger_touch_backtest(mesh: Mesh, close, window: int,
                                     k: float, *, cost: float = 0.0,
                                     periods_per_year: int = 252,
                                     t_real: int | None = None) -> Metrics:
    """Bollinger band touch (memoryless: +1 below the lower band, -1 above
    the upper) with the bars split over the mesh; no state crosses a
    block."""
    T_pad = close.shape[-1]
    _check_time_axis(T_pad, mesh.size, window, "window")
    T = _resolve_t_real(T_pad, t_real)
    (c,), g, _ = _setup(mesh, close)
    r = _block_returns(mesh, c, g)
    pos = _zscore_band(mesh, c, g, window, T, k, 0.0, "touch")
    return _pnl_metrics_local(mesh, pos, r, g, T, cost=cost,
                              periods_per_year=periods_per_year)


def sharded_rsi_backtest(mesh: Mesh, close, period: int, band: float, *,
                         cost: float = 0.0, periods_per_year: int = 252,
                         t_real: int | None = None) -> Metrics:
    """RSI mean reversion with the bars split over the mesh: Wilder's
    gain and loss averages as blockwise linear scans (no halo, O(1)
    state), the centered RSI into the band machine (long below ``50 -
    band``, short above ``50 + band``, exit at 50)."""
    T_pad = close.shape[-1]
    _check_divides(T_pad, mesh.size)
    if period < 1:
        raise ValueError(f"period must be >= 1, got {period}")
    T = _resolve_t_real(T_pad, t_real)
    alpha = float(np.float32(1.0 / period))
    (c,), g, _ = _setup(mesh, close)
    prev = _lag1(mesh, c)
    r = [_returns_from_prev(ci, p, gi) for ci, p, gi in zip(c, prev, g)]
    diff = [_zero_where_not(gi != 0, ci - p) for ci, p, gi in zip(c, prev, g)]
    ag = _ema_blocks(mesh, [d.clamp_min(0.0) for d in diff], g, alpha)
    al = _ema_blocks(mesh, [(-d).clamp_min(0.0) for d in diff], g, alpha)
    z = [100.0 - 100.0 / (1.0 + a / (b + _EPS)) - 50.0
         for a, b in zip(ag, al)]
    valid = [gi >= period for gi in g]
    pos = _band_positions_local(mesh, z, valid, float(np.float32(band)), 0.0)
    return _pnl_metrics_local(mesh, pos, r, g, T, cost=cost,
                              periods_per_year=periods_per_year)


def sharded_pairs_backtest(mesh: Mesh, y_close, x_close, lookback: int,
                           z_entry: float, *, z_exit: float = 0.0,
                           cost: float = 0.0, periods_per_year: int = 252,
                           t_real: int | None = None) -> Metrics:
    """Rolling-OLS pairs with both legs' bars split over the mesh: the
    centered OLS moments from one stacked blockwise prefix sum
    (``lookback``-bar halo) give the hedge ratio, the spread's rolling
    z-score the band machine's input, and the PnL tail prices the hedged
    return ``(r_y - beta[t-1] r_x) / max(1 + |beta[t-1]|, 1)``. Formulas
    of :mod:`~..models.pairs` (legs centered by their live means, warmup
    spread ``y``, valid from ``2 * lookback - 1`` bars)."""
    T_pad = y_close.shape[-1]
    _check_time_axis(T_pad, mesh.size, lookback, "lookback")
    T = _resolve_t_real(T_pad, t_real)
    (yb, xb), g, _ = _setup(mesh, y_close, x_close)
    r2 = _block_returns(mesh, [torch.stack([y, x]) for y, x in zip(yb, xb)],
                        g)
    my = _live_mean(mesh, yb, g, T)
    mx = _live_mean(mesh, xb, g, T)
    stacked = [torch.stack([x - mxi, y - myi, (x - mxi) * (x - mxi),
                            (x - mxi) * (y - myi)])
               for y, x, myi, mxi in zip(yb, xb, my, mx)]
    cs, cs_ext = _cumsum_ext(mesh, stacked, lookback)
    spread, beta = [], []
    for c, ce, gi, y, x, myi, mxi in zip(cs, cs_ext, g, yb, xb, my, mx):
        s = _windowed_sum_blk(c, ce, gi, lookback, lookback)
        sx, sy, sxx, sxy = s[0], s[1], s[2], s[3]
        cov = sxy - _per(sx * sy, lookback)
        var = (sxx - _per(sx * sx, lookback)).clamp_min(0.0)
        b = cov / (var + _EPS)
        alpha = (_per(sy, lookback) + myi) - b * (_per(sx, lookback) + mxi)
        ok = gi >= lookback - 1
        b = _zero_where_not(ok, b)
        beta.append(b)
        spread.append(torch.where(ok, y - (alpha + b * x), y))
    z = _windowed_zscore_local(mesh, spread, g, lookback, lookback, T)
    valid = [gi >= 2 * lookback - 2 for gi in g]
    z = [_zero_where_not(v, zi) for v, zi in zip(valid, z)]
    pos = _band_positions_local(mesh, z, valid, float(np.float32(z_entry)),
                                float(np.float32(z_exit)))
    prev = _lag1(mesh, [torch.stack([p, b]) for p, b in zip(pos, beta)])
    hr = [(rr[0] - pv[1] * rr[1]) / (1.0 + pv[1].abs()).clamp_min(1.0)
          for rr, pv in zip(r2, prev)]
    return _pnl_metrics_local(mesh, pos, hr, g, T, cost=cost,
                              periods_per_year=periods_per_year,
                              prev_pos=[pv[0] for pv in prev])


def _donchian_metrics_local(mesh: Mesh, c, hi, lo, g, window: int, T: int,
                            *, cost: float, periods_per_year: int) -> Metrics:
    """The shared body of both Donchian variants: one stacked
    ``window``-bar halo serves the returns' lagged close and both prior
    channel extrema (bars ``t - window .. t - 1``); the breakout latch
    folds across blocks as the band machine does."""
    w = window
    stacked = [torch.stack([a, b, d]) for a, b, d in zip(c, hi, lo)]
    halo = from_left(mesh, stacked, w)
    pos, r = [], []
    for s, h, ci, gi in zip(stacked, halo, c, g):
        ext = torch.cat([h, s], dim=-1)
        Tb = ci.shape[-1]
        r.append(_returns_from_prev(ci, ext[0, ..., w - 1:w - 1 + Tb], gi))
        hi_prev = _reduce_window_last(ext[1], w, "max")[..., :Tb]
        lo_prev = _reduce_window_last(ext[2], w, "min")[..., :Tb]
        pos.append(_latch_maps(ci >= hi_prev, ci <= lo_prev, gi >= w))
    pos = _transition_positions_local(mesh, pos)
    return _pnl_metrics_local(mesh, pos, r, g, T, cost=cost,
                              periods_per_year=periods_per_year)


def sharded_donchian_backtest(mesh: Mesh, close, window: int, *,
                              cost: float = 0.0, periods_per_year: int = 252,
                              t_real: int | None = None) -> Metrics:
    """Donchian close-channel breakout with the bars split over the mesh:
    the channel extrema from a ``window``-bar halo and a local sliding
    reduction (exact), the latch folded across blocks."""
    T_pad = close.shape[-1]
    _check_time_axis(T_pad, mesh.size, window, "window")
    T = _resolve_t_real(T_pad, t_real)
    (c,), g, _ = _setup(mesh, close)
    return _donchian_metrics_local(mesh, c, c, c, g, window, T, cost=cost,
                                   periods_per_year=periods_per_year)


def sharded_donchian_hl_backtest(mesh: Mesh, close, high, low, window: int,
                                 *, cost: float = 0.0,
                                 periods_per_year: int = 252,
                                 t_real: int | None = None) -> Metrics:
    """The high/low-channel Donchian breakout with the bars split over the
    mesh (the channels from the high and low columns)."""
    T_pad = close.shape[-1]
    _check_time_axis(T_pad, mesh.size, window, "window")
    T = _resolve_t_real(T_pad, t_real)
    (c, hi, lo), g, _ = _setup(mesh, close, high, low)
    return _donchian_metrics_local(mesh, c, hi, lo, g, window, T, cost=cost,
                                   periods_per_year=periods_per_year)


def sharded_stochastic_backtest(mesh: Mesh, close, high, low, window: int,
                                band: float, *, cost: float = 0.0,
                                periods_per_year: int = 252,
                                t_real: int | None = None) -> Metrics:
    """Stochastic %K mean reversion with the bars split over the mesh: the
    trailing ``window``-bar high/low channel (ending at bar t) from a halo
    and a local sliding reduction, %K centered into the band machine (flat
    channel -> 50, valid from ``window - 1`` bars)."""
    eps = _EPS
    T_pad = close.shape[-1]
    _check_time_axis(T_pad, mesh.size, window, "window")
    T = _resolve_t_real(T_pad, t_real)
    halo = max(window - 1, 1)
    (c, hi, lo), g, _ = _setup(mesh, close, high, low)
    stacked = [torch.stack([a, b, d]) for a, b, d in zip(c, hi, lo)]
    halos = from_left(mesh, stacked, halo)
    r, z, valid = [], [], []
    start = halo - window + 1
    for s, h, ci, gi in zip(stacked, halos, c, g):
        ext = torch.cat([h, s], dim=-1)
        Tb = ci.shape[-1]
        r.append(_returns_from_prev(ci, ext[0, ..., halo - 1:halo - 1 + Tb],
                                    gi))
        hh = _reduce_window_last(ext[1], window, "max")[..., start:start + Tb]
        ll = _reduce_window_last(ext[2], window, "min")[..., start:start + Tb]
        rng = hh - ll
        k_pct = torch.where(rng > eps, 100.0 * (ci - ll) / (rng + eps),
                            torch.full_like(rng, 50.0))
        v = gi >= window - 1
        valid.append(v)
        z.append(_zero_where_not(v, k_pct - 50.0))
    pos = _band_positions_local(mesh, z, valid, float(np.float32(band)), 0.0)
    return _pnl_metrics_local(mesh, pos, r, g, T, cost=cost,
                              periods_per_year=periods_per_year)


def sharded_trix_backtest(mesh: Mesh, close, span: int, signal: int, *,
                          cost: float = 0.0, periods_per_year: int = 252,
                          t_real: int | None = None) -> Metrics:
    """TRIX signal line with the bars split over the mesh: the triple EMA
    as three chained blockwise linear scans, its one-bar rate of change by
    a halo, the signal line a fourth EMA; ``sign(trix - signal)`` after
    the ``3 span + signal - 2`` warmup."""
    T_pad = close.shape[-1]
    _check_divides(T_pad, mesh.size)
    if span < 1 or signal < 1:
        raise ValueError(f"spans must be >= 1, got {span}, {signal}")
    T = _resolve_t_real(T_pad, t_real)
    a_span, a_sig = _alpha(span=span), _alpha(span=signal)
    (c,), g, _ = _setup(mesh, close)
    r = _block_returns(mesh, c, g)
    e3 = c
    for _ in range(3):
        e3 = _ema_blocks(mesh, e3, g, a_span)
    trix = [_returns_from_prev(e, p, gi)
            for e, p, gi in zip(e3, _lag1(mesh, e3), g)]
    sig = _ema_blocks(mesh, trix, g, a_sig)
    warm = 3 * span + signal - 2
    pos = [_zero_where_not(gi >= warm - 1, torch.sign(t - s))
           for t, s, gi in zip(trix, sig, g)]
    return _pnl_metrics_local(mesh, pos, r, g, T, cost=cost,
                              periods_per_year=periods_per_year)


def sharded_momentum_backtest(mesh: Mesh, close, lookback: int, *,
                              cost: float = 0.0, periods_per_year: int = 252,
                              t_real: int | None = None) -> Metrics:
    """Time-series momentum, ``sign(close[t] - close[t - lookback])``,
    with the bars split over the mesh: one ``lookback``-bar halo serves
    both lags."""
    T_pad = close.shape[-1]
    _check_time_axis(T_pad, mesh.size, lookback, "lookback")
    T = _resolve_t_real(T_pad, t_real)
    (c,), g, _ = _setup(mesh, close)
    halos = from_left(mesh, c, lookback)
    r, pos = [], []
    for h, ci, gi in zip(halos, c, g):
        ext = torch.cat([h, ci], dim=-1)
        Tb = ci.shape[-1]
        r.append(_returns_from_prev(
            ci, ext[..., lookback - 1:lookback - 1 + Tb], gi))
        pos.append(_zero_where_not(gi >= lookback,
                                   torch.sign(ci - ext[..., :Tb])))
    return _pnl_metrics_local(mesh, pos, r, g, T, cost=cost,
                              periods_per_year=periods_per_year)


def sharded_keltner_backtest(mesh: Mesh, close, high, low, window: int,
                             k: float, *, cost: float = 0.0,
                             periods_per_year: int = 252,
                             t_real: int | None = None) -> Metrics:
    """Keltner-channel mean reversion with the bars split over the mesh:
    the EMA midline a blockwise linear scan, the ATR the windowed mean of
    the true range (blockwise prefix sums, ``window``-bar halo), the
    ATR-normalized deviation into the band machine."""
    T_pad = close.shape[-1]
    _check_time_axis(T_pad, mesh.size, window, "window")
    T = _resolve_t_real(T_pad, t_real)
    alpha = _alpha(span=window)
    (c, hi, lo), g, _ = _setup(mesh, close, high, low)
    prev_raw = _lag1(mesh, c)
    r = [_returns_from_prev(ci, p, gi) for ci, p, gi in zip(c, prev_raw, g)]
    tr = []
    for ci, h, low_, p, gi in zip(c, hi, lo, prev_raw, g):
        pc = torch.where(gi == 0, ci, p)
        tr.append(torch.maximum(h - low_, torch.maximum((h - pc).abs(),
                                                        (low_ - pc).abs())))
    mid = _ema_blocks(mesh, c, g, alpha)
    cs, cs_ext = _cumsum_ext(mesh, tr, window)
    z, valid = [], []
    for ci, m, a, ae, gi in zip(c, mid, cs, cs_ext, g):
        atr = _per(_windowed_sum_blk(a, ae, gi, window, window), window)
        v = gi >= window - 1
        valid.append(v)
        z.append(_zero_where_not(v & (atr > _EPS), (ci - m) / (atr + _EPS)))
    pos = _band_positions_local(mesh, z, valid, float(np.float32(k)), 0.0)
    return _pnl_metrics_local(mesh, pos, r, g, T, cost=cost,
                              periods_per_year=periods_per_year)


def sharded_vwap_backtest(mesh: Mesh, close, volume, window: int, k: float,
                          *, cost: float = 0.0, periods_per_year: int = 252,
                          t_real: int | None = None) -> Metrics:
    """VWAP-deviation mean reversion with the bars split over the mesh:
    the rolling VWAP from one stacked blockwise prefix sum of price x
    volume and volume, the close's deviation from it (0 through the warmup
    and where the window's volume is not above 1e-12) z-scored blockwise,
    into the band machine; valid from ``2 * window - 1`` bars."""
    T_pad = close.shape[-1]
    _check_time_axis(T_pad, mesh.size, window, "window")
    T = _resolve_t_real(T_pad, t_real)
    (c, vol), g, _ = _setup(mesh, close, volume)
    r = _block_returns(mesh, c, g)
    cs, cs_ext = _cumsum_ext(mesh, [torch.stack([ci * v, v])
                                    for ci, v in zip(c, vol)], window)
    dev = []
    for ci, a, ae, gi in zip(c, cs, cs_ext, g):
        s = _windowed_sum_blk(a, ae, gi, window, window)
        pv, v = s[0], s[1]
        vwap = torch.where((gi >= window - 1) & (v > _EPS), pv / (v + _EPS),
                           ci)
        dev.append(ci - vwap)
    z = _windowed_zscore_local(mesh, dev, g, window, window, T)
    valid = [gi >= 2 * window - 2 for gi in g]
    z = [_zero_where_not(v, zi) for v, zi in zip(valid, z)]
    pos = _band_positions_local(mesh, z, valid, float(np.float32(k)), 0.0)
    return _pnl_metrics_local(mesh, pos, r, g, T, cost=cost,
                              periods_per_year=periods_per_year)


def sharded_macd_backtest(mesh: Mesh, close, fast: int, slow: int,
                          signal: int, *, cost: float = 0.0,
                          periods_per_year: int = 252,
                          t_real: int | None = None) -> Metrics:
    """MACD signal line with the bars split over the mesh: the close less
    its global first bar (sent to every shard), the fast and slow EMAs and
    the signal line as blockwise linear scans, ``sign(macd - signal)``
    after the ``slow + signal - 1`` warmup."""
    T_pad = close.shape[-1]
    _check_divides(T_pad, mesh.size)
    if fast < 1 or slow < 1 or signal < 1:
        raise ValueError(f"spans must be >= 1, got {fast}, {slow}, {signal}")
    T = _resolve_t_real(T_pad, t_real)
    (c,), g, _ = _setup(mesh, close)
    r = _block_returns(mesh, c, g)
    c0 = _broadcast(mesh, c[0][..., :1])
    x = [ci - z for ci, z in zip(c, c0)]
    ef = _ema_blocks(mesh, x, g, _alpha(span=fast))
    es = _ema_blocks(mesh, x, g, _alpha(span=slow))
    macd = [a - b for a, b in zip(ef, es)]
    sig = _ema_blocks(mesh, macd, g, _alpha(span=signal))
    warm = slow + signal - 1
    pos = [_zero_where_not(gi >= warm - 1, torch.sign(m - s))
           for m, s, gi in zip(macd, sig, g)]
    return _pnl_metrics_local(mesh, pos, r, g, T, cost=cost,
                              periods_per_year=periods_per_year)


def sharded_obv_backtest(mesh: Mesh, close, volume, window: int, *,
                         cost: float = 0.0, periods_per_year: int = 252,
                         t_real: int | None = None) -> Metrics:
    """OBV trend with the bars split over the mesh: the OBV a blockwise
    prefix sum of the signed, first-bar-normalized volume steps, its
    rolling mean a second blockwise prefix sum with a ``window``-bar halo;
    ``sign(obv - sma)``."""
    T_pad = close.shape[-1]
    _check_time_axis(T_pad, mesh.size, window, "window")
    T = _resolve_t_real(T_pad, t_real)
    (c, vol), g, _ = _setup(mesh, close, volume)
    prev = _lag1(mesh, c)
    r = [_returns_from_prev(ci, p, gi) for ci, p, gi in zip(c, prev, g)]
    v0 = _broadcast(mesh, vol[0][..., :1])
    step = []
    for ci, p, v, z, gi in zip(c, prev, vol, v0, g):
        vn = v / torch.where(z == 0.0, torch.ones_like(z), z)
        step.append(_zero_where_not(gi != 0, torch.sign(ci - p)) * vn)
    obv = _cumsum_blocks(mesh, step)
    cs, cs_ext = _cumsum_ext(mesh, obv, window)
    pos = []
    for o, a, ae, gi in zip(obv, cs, cs_ext, g):
        sma = _per(_windowed_sum_blk(a, ae, gi, window, window), window)
        pos.append(_zero_where_not(gi >= window - 1, torch.sign(o - sma)))
    return _pnl_metrics_local(mesh, pos, r, g, T, cost=cost,
                              periods_per_year=periods_per_year)
