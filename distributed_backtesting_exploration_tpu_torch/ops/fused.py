"""Fused parameter sweeps: K1-K7 of the port (reference ``ops/fused.py``).

Each ``fused_*_sweep`` computes the 9 metrics of every (ticker, combo)
backtest of one strategy's grid and returns them as :class:`Metrics` of
``(N, P)`` fields, like the reference's wrapper of the same name. It
prepares the inputs host-side and with plain torch ops (distinct windows,
cumsums, returns, OBV, the z-, EMA or pairs tables) and hands them to one
kernel entry:

==============================  ========================  ===================
sweep                           entry                     kernel source
==============================  ========================  ===================
``fused_sma_sweep``             :func:`fused_sma`         ``fused_sma.cu``
``fused_bollinger_sweep``,      :func:`band_inline`       ``band_machine.cu``
``fused_bollinger_touch_sweep``
``fused_stochastic_sweep``      :func:`band_stoch`        ``band_machine.cu``
``fused_momentum_sweep``        :func:`momentum`          ``single_window.cu``
``fused_donchian_sweep``,       :func:`donchian`          ``single_window.cu``
``fused_donchian_hl_sweep``
``fused_rsi_sweep``,            :func:`band_table`        ``band_machine.cu``
``fused_keltner_sweep``,
``fused_vwap_sweep``
``fused_macd_sweep``            :func:`macd`              ``ema_cross.cu``
                                :func:`ema_rows_cuda`     ``ema_rows.cu``
``fused_trix_sweep``            :func:`trix`              ``ema_cross.cu``
                                :func:`ema_rows_cuda`     ``ema_rows.cu``
``fused_obv_sweep``             :func:`obv`               ``fused_sma.cu``
``fused_pairs_sweep``           :func:`pairs`             ``band_machine.cu``
                                :func:`pairs_tables_cuda` ``pairs_tables.cu``
==============================  ========================  ===================

Each entry dispatches on its inputs' device: on a CUDA tensor its
``*_cuda`` wrapper launches the hand-written kernel (and raises on anything
it cannot launch: there is no fallback); on a CPU tensor its ``*_plain``
version computes the same function with plain PyTorch ops. The plain
versions step bar by bar in the kernels' order (:class:`_MetricState`), so
on the card a kernel and its plain version agree to the bit; they are the
yardstick the kernels are held against.

:func:`fused_sma`, :func:`band_inline`, :func:`macd`, :func:`trix`,
:func:`obv` and :func:`pairs` run their lanes in tiles, one tile a CTA,
that form the SMA, z, macd line, rate of change, signal or (z, hedged
return) pair of the tile's distinct windows once per bar block in shared
memory; their CUDA wrappers build the tiles' window lists with torch ops
on the card (:func:`window_tiles`). The channel entries (:func:`band_stoch`,
:func:`donchian`) take the raw rows and build the channel extrema on the
card (no ``(N, W, T)`` table),
and the table entries (:func:`band_table`, :func:`band_stoch`,
:func:`donchian`) take their lanes window-major: the sweep sorts them by
window (:func:`window_major`) and passes ``lane``, each slot's lane in the
caller's order, where the entry writes the slot's metrics. On the card,
macd's EMA table, trix's triple-EMA table and pairs' z- and hedged-return
tables are built by kernels of their own (:func:`ema_rows_cuda`,
:func:`pairs_tables_cuda`).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..models import donchian as donchian_model
from ..models import stochastic as stochastic_model
from . import _kernels, rolling
from .metrics import Metrics, metrics_from_reductions
from .pnl import simple_returns

_EPS = 1e-12
_N_METRICS = 9
_KERNEL_THREADS = 128      # lanes per CTA (kThreads in csrc/*.cu)
# Lanes a tile (one CTA) of K1, K2's inline entry, K4, K5, K6 and K7, which
# share the values of a tile's distinct windows (csrc/bar_blocks.cuh): the
# fastest of chip_smoke.py's width sweep (PERF.md, section 6).
_SMA_LANES = 1024
_BAND_INLINE_LANES = 512
_MACD_LANES = 512
_OBV_LANES = 1024
_TRIX_LANES = 1024
_PAIRS_LANES = 1024
_MAX_PARAM_BLOCKS = 65535  # CUDA gridDim.y limit
_MACHINES = {"hysteresis": 0, "touch": 1}
# The reference's stand-in for the generic channel's +-inf warmup fill.
_CHANNEL_FILL = 1e30


def _epilogue_ok(epilogue) -> bool:
    if epilogue in ("ladder", "scan"):
        return True
    if isinstance(epilogue, str) and epilogue.startswith("scan:"):
        try:
            b = int(epilogue[5:])
        except ValueError:
            return False
        return b >= 8 and b % 8 == 0
    return False


def _resolve_epilogue(epilogue: str | None) -> str:
    """The reference's epilogue rule (``_resolve_epilogue``): ``"scan"``,
    ``"scan:<B>"`` with B a positive multiple of 8, or ``"ladder"``; None
    means ``"scan"``. Any other value raises."""
    if epilogue is None:
        return "scan"
    if _epilogue_ok(epilogue):
        return epilogue
    raise ValueError(
        f"epilogue must be 'scan', 'scan:<B>' (B a positive multiple of 8) "
        f"or 'ladder', got {epilogue!r}")


# The reference's T-block schedule of its carry scan (``_scan_block``): one
# sublane tile a block, doubled until the blocks number at most 256. The
# kernels here run one sequential pass a lane and need none; the streaming
# metric advance (:func:`_equity_advance`) blocks its equity scan by it.
_SCAN_BLOCK_DEFAULT = 8
_SCAN_MAX_BLOCKS = 256


def _scan_block(T_pad: int, epilogue: str) -> int:
    """The T-block size of the reference's carry scan: ``B`` of
    ``"scan:<B>"``, else 8 doubled until at most ``_SCAN_MAX_BLOCKS``
    blocks cover ``T_pad`` bars."""
    if epilogue.startswith("scan:"):
        return int(epilogue[5:])
    b = _SCAN_BLOCK_DEFAULT
    while -(-T_pad // b) > _SCAN_MAX_BLOCKS:
        b *= 2
    return b


def _spans(T_pad: int, block: int):
    """(start, stop) spans tiling ``T_pad`` bars by ``block``."""
    return [(s, min(s + block, T_pad)) for s in range(0, T_pad, block)]


def _cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis as the reference's
    Hillis-Steele shift-doubling ladder, op for op: each pass adds the
    series shifted by ``s`` bars (zeros shifted in), ``s`` doubling. Not
    ``torch.cumsum``, whose CUDA scan splits a row by the tensor's row
    count: the ladder's adds are elementwise, so every device and shape
    gives the reference's bits."""
    T = x.shape[-1]
    s = 1
    while s < T:
        pad = torch.zeros(x.shape[:-1] + (s,), dtype=x.dtype, device=x.device)
        x = x + torch.cat([pad, x[..., :-s]], dim=-1)
        s *= 2
    return x


def _cummax_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max over the last axis (the shift ladder of
    :func:`_cumsum_last`, -inf shifted in)."""
    T = x.shape[-1]
    s = 1
    while s < T:
        pad = torch.full(x.shape[:-1] + (s,), -math.inf, dtype=x.dtype,
                         device=x.device)
        x = torch.maximum(x, torch.cat([pad, x[..., :-s]], dim=-1))
        s *= 2
    return x


def _equity_advance(net: torch.Tensor, block: int, cum: torch.Tensor,
                    peak: torch.Tensor, mdd: torch.Tensor):
    """The reference's ``_equity_advance``: advance the (cumulative net,
    running peak, max drawdown) carry of ``equity = 1 + cumsum(net)``
    across a ``(..., D)`` net-return slice in blocks of ``block`` bars.
    Seeded 0 / -inf / 0 it is the scan over a whole panel; from a stored
    carry, the streaming append's recurrent step. Returns new tensors
    ``(cum, peak, mdd)`` and writes into none of its inputs."""
    eps = torch.tensor(_EPS, dtype=net.dtype, device=net.device)
    for s, e in _spans(net.shape[-1], block):
        cs = _cumsum_last(net[..., s:e])
        eq = (1.0 + cum)[..., None] + cs
        pk = torch.maximum(_cummax_last(eq), peak[..., None])
        dd = (pk - eq) / torch.maximum(pk, eps)
        mdd = torch.maximum(mdd, dd.amax(dim=-1))
        cum = cum + cs[..., -1]
        peak = pk[..., -1]
    return cum, peak, mdd


def _check_table(table: str | None) -> None:
    """The reference's table rule: None, ``"inline"`` or ``"hbm"``. Any
    other value raises."""
    if table not in (None, "inline", "hbm"):
        raise ValueError(f"table must be 'inline' or 'hbm', got {table!r}")


def _distinct_windows(vals: np.ndarray, what: str) -> np.ndarray:
    """Validate integral bar counts and return the sorted distinct windows."""
    if not np.allclose(vals, np.round(vals)):
        raise ValueError(
            f"fused sweep {what} are bar counts and must be integral; got "
            f"non-integer values "
            f"(e.g. {vals[~np.isclose(vals, np.round(vals))][0]})")
    return np.unique(np.round(vals)).astype(np.float32)


def _flat(x) -> np.ndarray:
    return np.asarray(x, np.float32).reshape(-1)


def _same_length(**arrays) -> None:
    shapes = {k: v.shape for k, v in arrays.items()}
    if len(set(shapes.values())) > 1:
        raise ValueError(
            f"{' and '.join(shapes)} must be flat per-combo arrays of one "
            f"length; got {' and '.join(str(s) for s in shapes.values())}")


def _grid_setup(fast, slow):
    """Per-lane integer windows and warmup of a flat (fast, slow) grid.

    Mirrors the reference's ``_grid_setup``: windows are validated as
    integral and rounded; the warmup is ``max(fast, slow)`` of the raw
    values, truncated to an integer as the reference's kernel truncates it.
    Returns ``(fast_w, slow_w, warm)``, each an ``(P,)`` int32 array.
    """
    fast, slow = _flat(fast), _flat(slow)
    _same_length(fast=fast, slow=slow)
    windows = _distinct_windows(np.concatenate([fast, slow]), "windows")
    if windows.size and windows[0] < 1:
        raise ValueError(
            f"fused sweep windows must be at least 1 bar; got {windows[0]:g}")
    fast_w = np.round(fast).astype(np.int32)
    slow_w = np.round(slow).astype(np.int32)
    warm = np.maximum(fast, slow).astype(np.int32)
    return fast_w, slow_w, warm


def _window_setup(vals, what: str, warm_offset: float, min_window: int,
                  warm_scale: float = 1.0):
    """Distinct windows and per-lane window, row and warmup of one window
    axis (the reference's ``_boll_grid_setup`` / ``_single_window_grid_setup``
    without the one-hot): warmup ``warm_scale * value + warm_offset`` in
    f32, truncated to an integer. Returns ``(windows, win, widx, warm)``:
    the sorted distinct windows, then ``(P,)`` int32 arrays."""
    windows = _distinct_windows(vals, what)
    if windows.size and windows[0] < min_window:
        raise ValueError(f"fused sweep {what} must be at least {min_window} "
                         f"bar(s); got {windows[0]:g}")
    rounded = np.round(vals).astype(np.float32)
    widx = np.searchsorted(windows, rounded).astype(np.int32)
    warm = (np.float32(warm_scale) * vals
            + np.float32(warm_offset)).astype(np.int32)
    return windows, rounded.astype(np.int32), widx, warm


def window_tiles(lanes: int, *windows: torch.Tensor):
    """The window lists of the tiles of K1, K2's inline entry, K4, K5, K6
    and K7 (``csrc/bar_blocks.cuh``), built with torch ops on the windows'
    device.

    The kernels run ``lanes`` consecutive lanes a tile, one tile a CTA, and
    form the value of each window a tile reads once per bar in shared
    memory. ``windows`` are one or two ``(P,)`` integer tensors of each
    lane's windows (K2, K6: its window; K1: its fast and its slow window;
    K4: its key :func:`macd_keys`; K5: its span's row in the triple-EMA
    table; K7: its lookback's row in the pairs tables).
    Returns ``(wins, counts, *idx)``, all int32: ``wins`` the
    ``(n_tiles, Wc)`` lists, ``Wc = lanes * len(windows)``, row t holding
    tile t's ``counts[t]`` sorted distinct windows, then its smallest window
    again; and per tensor of ``windows`` the ``(P,)`` index of each lane's
    window in its tile's list: ``wins[p // lanes, idx[p]]`` is lane p's
    window. The empty lanes of a ragged last tile repeat its first lane. No
    step waits on the device: a list's width is its bound, its length a
    count.
    """
    cols = [w.reshape(-1).long() for w in windows]
    P = cols[0].shape[0]
    n_tiles = -(-P // lanes)
    pad = n_tiles * lanes - P
    if pad:
        cols = [torch.cat([w, w[(n_tiles - 1) * lanes:][:1].expand(pad)])
                for w in cols]
    vals = torch.cat([w.view(n_tiles, lanes) for w in cols], dim=1)
    srt, order = torch.sort(vals, dim=1, stable=True)
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    rank = torch.cumsum(first, dim=1) - 1        # index in the tile's list
    wins = srt[:, :1].expand_as(srt).clone()
    wins.scatter_(1, rank, srt)                  # equal windows, equal ranks
    idx = torch.empty_like(rank).scatter_(1, order, rank)
    return (wins.int(), (rank[:, -1] + 1).int(),
            *(idx[:, i * lanes:(i + 1) * lanes].reshape(-1)[:P].int()
              for i in range(len(cols))))


def window_major(widx: np.ndarray, *per_lane: np.ndarray):
    """The lanes of one grid in window-major order: a stable sort by each
    lane's window row ``widx``. Returns ``(lane, widx, *per_lane)`` in slot
    order: ``lane[p]`` is slot p's lane in the caller's order, the others
    the per-lane arrays permuted alike (int32 ``lane``). The entries that
    take ``lane`` write slot p's metrics at ``lane[p]``, so the caller sees
    its own order, and each lane's arithmetic is the same in any order."""
    order = np.argsort(widx, kind="stable")
    return (order.astype(np.int32), widx[order],
            *(np.asarray(a)[order] for a in per_lane))


def _signal_decay(signal: np.ndarray) -> np.ndarray:
    """Per-lane signal-line decay ``2 / (signal + 1)`` in f32, host-side as
    the reference's ``_macd_grid_setup`` forms it; signal spans are
    validated as integral only."""
    _distinct_windows(signal, "signal spans")
    return np.float32(2.0) / (signal + np.float32(1.0))


def _macd_grid_setup(fast, slow, signal):
    """The reference's ``_macd_grid_setup`` without the selector: the
    distinct spans of ``fast`` and ``slow``, each lane's fast and slow row
    in their table, its signal decay, and its warmup ``slow + signal - 1``
    in f32, truncated. Returns ``(spans, fidx, sidx, a_sig, warm)``."""
    fast, slow, signal = _flat(fast), _flat(slow), _flat(signal)
    _same_length(fast=fast, slow=slow, signal=signal)
    spans, _, fidx, _ = _window_setup(np.concatenate([fast, slow]), "spans",
                                      0.0, 1)
    P = fast.shape[0]
    warm = (slow + signal - np.float32(1.0)).astype(np.int32)
    return spans, fidx[:P], fidx[P:], _signal_decay(signal), warm


def _trix_grid_setup(span, signal):
    """The reference's ``_trix_grid_setup`` without the one-hot: distinct
    spans, each lane's row, its signal decay and its warmup
    ``3*span + signal - 2`` in f32, truncated. Returns
    ``(spans, widx, a_sig, warm)``."""
    span, signal = _flat(span), _flat(signal)
    _same_length(span=span, signal=signal)
    spans, _, widx, _ = _window_setup(span, "spans", 0.0, 1)
    warm = (np.float32(3.0) * span + signal
            - np.float32(2.0)).astype(np.int32)
    return spans, widx, _signal_decay(signal), warm


def _check_t_real(t_real, N: int, T: int) -> np.ndarray:
    if t_real is None:
        return np.full((N,), T, np.int32)
    tr = np.asarray(t_real).reshape(-1)
    if tr.shape != (N,):
        raise ValueError(f"t_real must hold one length per ticker ({N}); "
                         f"got shape {np.asarray(t_real).shape}")
    if tr.size and (tr.min() < 1 or tr.max() > T):
        raise ValueError(f"t_real values must lie in [1, {T}]; got "
                         f"[{tr.min()}, {tr.max()}]")
    return tr.astype(np.int32)


def row_mean(x: torch.Tensor, t_real: np.ndarray) -> torch.Tensor:
    """The mean of each row's ``t_real`` real bars along the last axis, kept
    (``(N, 1)`` of an ``(N, T)`` stack, ``(N, W, 1)`` of an ``(N, W, T)``
    table), summed in f64, divided by ``t_real`` and rounded once: the
    centering of the Bollinger preps and of the VWAP deviation. Where the
    reference's ``_fused_boll_call`` and ``_fused_vwap_call`` center a
    ragged stack over all its bars, pad bars included, this mean is a
    function of the row's own bars, on any device and whatever the rows and
    bars stacked with it: a sum of f32 values whose exponents span less
    than 2**29 is exact in f64 in any order (prices always; a deviation
    unless one bar's is below 2**-29 of the largest, and then the f64 sums
    differ by one f64 rounding, far below the f32 rounding of the mean).
    On a full row it is :func:`~.rolling.mean_f64`'s, the generic model's
    centering.
    """
    T = x.shape[-1]
    tr = torch.as_tensor(np.asarray(t_real, np.int64), device=x.device)
    tr = tr.reshape(-1, *([1] * (x.ndim - 1)))
    bars = torch.arange(T, device=x.device)
    zero = torch.zeros((), dtype=torch.float64, device=x.device)
    total = torch.where(bars < tr, x.double(), zero).sum(-1, keepdim=True)
    return (total / tr).to(x.dtype)


def _check_launch(name: str, dev: torch.device, P: int,
                  lanes: int = _KERNEL_THREADS, **args) -> None:
    """Refuse what a kernel cannot take: ``args`` maps each argument name to
    ``(tensor, dtype, shape)``; every tensor must be a contiguous tensor of
    that dtype and shape on ``dev`` (a CUDA device), and the ``P`` combos
    must fit the grid of ``lanes`` lanes a CTA."""
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors; got {dev}")
    for arg, (x, dtype, shape) in args.items():
        if x.device != dev:
            raise ValueError(f"{arg} is on {x.device}, the inputs on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{arg} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{arg} must have shape {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    if -(-P // lanes) > _MAX_PARAM_BLOCKS:
        raise ValueError(f"{P} combos exceed the kernel's grid limit of "
                         f"{_MAX_PARAM_BLOCKS * lanes}")


def _launch(name: str, entry, *args) -> None:
    """Call a C entry on the current stream and count the launch."""
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                      for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _kernels.LAUNCHES[name] += 1


class _MetricState:
    """The kernels' per-bar PnL and metric sums over ``(N, P)`` lanes, in
    the order of ``csrc/metrics_tail.cuh``.

    One :meth:`step` per bar carries the running sums as the kernels do. A
    vectorized ``cumsum`` over time would associate the equity sum
    differently, and where a combo's additive equity ends near zero, CAGR
    (``final ** (1 / years)``) magnifies that last-bit difference past any
    f32 tolerance; the same order keeps the kernels and the plain versions
    in step there too.
    """

    def __init__(self, t_real: torch.Tensor, P: int):
        N = t_real.shape[0]
        dev = t_real.device
        self.t_real = t_real
        self.tr = t_real.long()[:, None]                       # (N, 1)
        self.zero = torch.zeros((N, P), dtype=torch.float32, device=dev)
        zero = self.zero
        self.prev, self.s1, self.s2, self.dsq, self.cum = (zero,) * 5
        self.mdd, self.wins, self.active, self.turn = (zero,) * 4
        self.peak = torch.full((N, P), -math.inf, dtype=torch.float32,
                               device=dev)

    def step(self, t: int, pos: torch.Tensor, r_col: torch.Tensor,
             cost: float) -> None:
        """Bar ``t``: ``pos`` is the ``(N, P)`` position decided at its
        close, ``r_col`` the ``(N, 1)`` simple returns of the bar. Bars at
        or past a ticker's real length change nothing: zero net, no
        turnover, the last position held."""
        zero, prev = self.zero, self.prev
        ok = t < self.tr
        dp = torch.where(ok, (pos - prev).abs(), zero)
        net = torch.where(ok, prev * r_col - cost * dp, zero)
        self.s1 = self.s1 + net
        self.s2 = self.s2 + net * net
        down = net.clamp_max(0.0)
        self.dsq = self.dsq + down * down
        self.cum = self.cum + net
        eq = 1.0 + self.cum
        self.peak = torch.maximum(self.peak, eq)
        self.mdd = torch.maximum(self.mdd,
                                 (self.peak - eq) / self.peak.clamp_min(_EPS))
        act = (prev != 0) & ok
        self.active = self.active + act
        self.wins = self.wins + (act & (net > 0))
        self.turn = self.turn + dp
        self.prev = torch.where(ok, pos, prev)

    def planes(self, ppy: int) -> torch.Tensor:
        """The ``(9, N, P)`` metric planes in :class:`Metrics` order."""
        m = metrics_from_reductions(
            s1=self.s1, s2=self.s2, downside_sq_sum=self.dsq, mdd=self.mdd,
            eq_final=1.0 + self.cum, wins_sum=self.wins,
            active_sum=self.active, turnover=self.turn,
            n=self.t_real.to(torch.float32)[:, None], periods_per_year=ppy)
        return torch.stack(list(m), 0)


def _on_device(plain, cuda, x: torch.Tensor):
    """The plain version for a CPU tensor, the kernel wrapper otherwise."""
    return plain if x.device.type == "cpu" else cuda


def _to_lanes(planes: torch.Tensor, lane) -> torch.Tensor:
    """``(9, N, P)`` planes in slot order put in the caller's lane order:
    slot p at lane ``lane[p]`` (``lane`` None: the orders are one)."""
    if lane is None:
        return planes
    out = torch.empty_like(planes)
    out[:, :, lane.long()] = planes
    return out


def _lane_arg(lane, P: int, dev: torch.device) -> torch.Tensor:
    """A kernel's ``lane`` argument: the identity where the caller gives
    none."""
    if lane is None:
        return torch.arange(P, dtype=torch.int32, device=dev)
    return lane


def _channel_levels(lib, hi_src, lo_src, T: int):
    """The ``(N, L + 1, T)`` level tensors of a channel entry in device
    memory where its library (``lib``) says the kernel cannot build them in
    shared memory at row length ``T`` (long rows), else ``(None, None)``:
    the kernel builds them itself."""
    L = lib.dbx_channel_levels(int(T))
    if L < 0:
        return None, None
    return (extrema_levels(hi_src, L, "max").contiguous(),
            extrema_levels(lo_src, L, "min").contiguous())


def _shift_t(x: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """``y[..., t] = x[..., t - s]`` with ``fill`` for ``t < s``."""
    T = x.shape[-1]
    s = min(s, T)
    if s == 0:
        return x
    return torch.cat([torch.full_like(x[..., :s], fill), x[..., :T - s]],
                     dim=-1)


def _lagged_window_sum(c: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """``c[..., t] - c[..., t - w]`` for every window, ``c[..., t - w] = 0``
    for ``t < w`` (the kernels' op order, and the reference's
    ``_cumsum_window_tools``): ``(N, T)`` cumsum rows give ``(N, W, T)``,
    one row per window; ``(N, W, T)`` rows take window ``w`` on row ``w``."""
    if c.ndim == 2:
        c = c[:, None, :].expand(c.shape[0], windows.shape[0], c.shape[1])
    N, W, T = c.shape
    lag_idx = torch.arange(T, device=c.device)[None, :] - windows[:, None]
    lag = torch.gather(c, -1, lag_idx.clamp_min(0).expand(N, -1, -1))
    lag = torch.where(lag_idx >= 0, lag, torch.zeros_like(lag))
    return c - lag


def sma_table(cs: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """The ``(N, W, T)`` distinct-window SMA table of the ``(N, T)`` cumsum
    ``cs`` with the reference's ``_sma_table`` op sequence,
    ``(cs[t] - cs[t-w]) / float(w)``, 0 for ``t < w - 1``."""
    t = torch.arange(cs.shape[1], device=cs.device)
    table = _lagged_window_sum(cs, windows) / windows.to(cs.dtype)[:, None]
    return torch.where(t[None, :] >= windows[:, None] - 1, table,
                       torch.zeros_like(table))


def _sma_rows(cs: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """:func:`sma_table` laid out ``(T, N, W)`` for a bar-by-bar pass."""
    return sma_table(cs, windows).permute(2, 0, 1).contiguous()


# --- K1: SMA crossover ----------------------------------------------------

def fused_sma_plain(cs, r, t_real, fast, slow, warm, *, cost: float,
                    ppy: int) -> torch.Tensor:
    """Plain PyTorch version of K1: the kernel's algorithm as tensor ops.

    ``cs`` and ``r`` are the ``(N, T)`` close cumsum and simple returns;
    ``t_real`` the ``(N,)`` real lengths; ``fast``/``slow``/``warm`` the
    ``(P,)`` integer windows and warmups. Returns the ``(9, N, P)`` metric
    planes in :class:`Metrics` field order.
    """
    N, T = cs.shape
    P = fast.shape[0]
    windows, inv = torch.unique(torch.cat([fast, slow]).long(),
                                return_inverse=True)
    fi, si = inv[:P], inv[P:]
    table = _sma_rows(cs, windows)                              # (T, N, W)

    st = _MetricState(t_real, P)
    t_on = (warm.long() - 1)[None, :]                           # (1, P)
    for step in range(T):
        row = table[step]
        pos = torch.where(step >= t_on, torch.sign(row[:, fi] - row[:, si]),
                          st.zero)
        st.step(step, pos, r[:, step:step + 1], cost)
    return st.planes(ppy)


def fused_sma_cuda(cs, r, t_real, fast, slow, warm, *, cost: float,
                   ppy: int) -> torch.Tensor:
    """Launch K1 (``csrc/fused_sma.cu``) on PyTorch's current stream.

    Same inputs and output as :func:`fused_sma_plain`, all on one CUDA
    device. The lanes run in tiles of ``_SMA_LANES``, whose window lists
    are built on the card from ``fast`` and ``slow`` (:func:`window_tiles`).
    Raises on a wrong device, dtype, shape or layout, and when the launch
    reports an error.
    """
    N, T = cs.shape
    P = fast.shape[0]
    lanes = _SMA_LANES
    f32, i32 = torch.float32, torch.int32
    _check_launch("fused_sma_cuda", cs.device, P, lanes,
                  cs=(cs, f32, (N, T)), r=(r, f32, (N, T)),
                  t_real=(t_real, i32, (N,)), fast=(fast, i32, (P,)),
                  slow=(slow, i32, (P,)), warm=(warm, i32, (P,)))
    out = torch.empty((_N_METRICS, N, P), dtype=f32, device=cs.device)
    if N and P:
        _launch_fused_sma(cs, r, t_real, window_tiles(lanes, fast, slow),
                          warm, out, lanes, cost=cost, ppy=ppy)
    return out


def _launch_fused_sma(cs, r, t_real, tiles, warm, out, lanes: int, *,
                      cost: float, ppy: int) -> None:
    """K1's launch on checked inputs and its tiles (:func:`window_tiles`
    of the fast and slow windows)."""
    wins, counts, fi, si = tiles
    N, T = cs.shape
    _launch("fused_sma", _kernels.fused_sma_lib().dbx_fused_sma, cs, r,
            t_real, wins, counts, fi, si, warm, out, N, T, fi.shape[0],
            lanes, wins.shape[1], float(cost), int(ppy))


def fused_sma(cs, r, t_real, fast, slow, warm, *, cost: float,
              ppy: int) -> torch.Tensor:
    """K1 on the inputs' device: the kernel on CUDA, the plain version on
    the CPU."""
    fn = _on_device(fused_sma_plain, fused_sma_cuda, cs)
    return fn(cs, r, t_real, fast, slow, warm, cost=cost, ppy=ppy)


# --- K6: OBV trend (obv_trend) --------------------------------------------

def obv_plain(obv, cs, r, t_real, window, warm, *, cost: float,
              ppy: int) -> torch.Tensor:
    """Plain PyTorch version of K6 (``dbx_obv``): ``pos = sign(obv[t] -
    sma_w[t])`` from bar ``warm - 1``, the SMA of the OBV from its cumsum
    ``cs`` in K1's op order. ``obv``, ``cs`` and ``r`` are ``(N, T)``;
    ``window``/``warm`` the ``(P,)`` int32 windows and warmups. Returns the
    ``(9, N, P)`` metric planes."""
    N, T = obv.shape
    P = window.shape[0]
    windows, widx = torch.unique(window.long(), return_inverse=True)
    table = _sma_rows(cs, windows)                              # (T, N, W)
    st = _MetricState(t_real, P)
    t_on = (warm.long() - 1)[None, :]
    for step in range(T):
        d = obv[:, step:step + 1] - table[step][:, widx]
        pos = torch.where(step >= t_on, torch.sign(d), st.zero)
        st.step(step, pos, r[:, step:step + 1], cost)
    return st.planes(ppy)


def obv_cuda(obv, cs, r, t_real, window, warm, *, cost: float,
             ppy: int) -> torch.Tensor:
    """Launch K6 (``csrc/fused_sma.cu``, ``dbx_obv``): same inputs and
    output as :func:`obv_plain`, all on one CUDA device. The lanes run in
    tiles of ``_OBV_LANES`` as :func:`fused_sma_cuda`'s do."""
    N, T = obv.shape
    P = window.shape[0]
    lanes = _OBV_LANES
    f32, i32 = torch.float32, torch.int32
    _check_launch("obv_cuda", obv.device, P, lanes,
                  obv=(obv, f32, (N, T)), cs=(cs, f32, (N, T)),
                  r=(r, f32, (N, T)), t_real=(t_real, i32, (N,)),
                  window=(window, i32, (P,)), warm=(warm, i32, (P,)))
    out = torch.empty((_N_METRICS, N, P), dtype=f32, device=obv.device)
    if N and P:
        _launch_obv(obv, cs, r, t_real, window_tiles(lanes, window), warm,
                    out, lanes, cost=cost, ppy=ppy)
    return out


def _launch_obv(obv, cs, r, t_real, tiles, warm, out, lanes: int, *,
                cost: float, ppy: int) -> None:
    """K6's launch on checked inputs and its tiles (:func:`window_tiles`
    of the windows)."""
    wins, counts, wi = tiles
    N, T = obv.shape
    _launch("obv", _kernels.fused_sma_lib().dbx_obv, obv, cs, r, t_real,
            wins, counts, wi, warm, out, N, T, wi.shape[0], lanes,
            wins.shape[1], float(cost), int(ppy))


def obv(obv, cs, r, t_real, window, warm, *, cost: float,
        ppy: int) -> torch.Tensor:
    """K6 on the inputs' device."""
    fn = _on_device(obv_plain, obv_cuda, obv)
    return fn(obv, cs, r, t_real, window, warm, cost=cost, ppy=ppy)


# --- K2: band machine (bollinger, bollinger_touch, stochastic) ------------

def boll_z_table(close, cs, csx, csx2, windows) -> torch.Tensor:
    """The ``(N, W, T)`` Bollinger z-table of each distinct window, in
    ``csrc/band_machine.cu``'s op order (the reference's
    ``_build_boll_z_scratch``): ``m = (cs[t] - cs[t-w]) / w``,
    ``var = max((s2 - s1*s1/w) / w, 0)`` from the centered window sums,
    ``z = (c - m) / (sqrt(var) + 1e-12)``, 0 for ``t < w - 1``."""
    windows = windows.long()
    fw = windows.to(torch.float32)[:, None]
    m = _lagged_window_sum(cs, windows) / fw
    s1 = _lagged_window_sum(csx, windows)
    s2 = _lagged_window_sum(csx2, windows)
    var = ((s2 - s1 * s1 / fw) / fw).clamp_min(0.0)
    z = (close[:, None, :] - m) / (torch.sqrt(var) + _EPS)
    t = torch.arange(close.shape[1], device=close.device)
    return torch.where(t[None, :] >= windows[:, None] - 1, z,
                       torch.zeros_like(z))


def _machine_code(machine: str) -> int:
    if machine not in _MACHINES:
        raise ValueError(f"machine must be one of {sorted(_MACHINES)}, got "
                         f"{machine!r}")
    return _MACHINES[machine]


def _band_next(prev, zs, k, z_exit, machine: str):
    """The band machine's next ``(N, P)`` state from ``prev`` on a valid
    bar with z-scores ``zs``, in ``band_next``'s order
    (``csrc/band_machine.cu``)."""
    one = torch.ones((), dtype=zs.dtype, device=zs.device)
    zero = torch.zeros((), dtype=zs.dtype, device=zs.device)
    nxt = torch.where(zs < -k, one, torch.where(zs > k, -one, zero))
    if machine == "touch":
        return nxt
    held = torch.where(prev > 0, torch.where(zs >= -z_exit, zero, prev),
                       torch.where(zs <= z_exit, zero, prev))
    return torch.where(prev == 0, nxt, held)


def band_machine_plain(z, r, t_real, widx, k, warm, lane=None, *,
                       machine: str, z_exit: float, cost: float,
                       ppy: int) -> torch.Tensor:
    """Plain PyTorch version of K2 over a z-table (``dbx_band_table``).

    ``z`` is the ``(N, W, T)`` z-table, ``widx`` each slot's row in it,
    ``k`` the ``(P,)`` entry bands, ``warm`` the ``(P,)`` integer warmups,
    ``lane`` the ``(P,)`` int32 lane of each slot in the caller's order
    (None: slot p is lane p; see :func:`window_major`). ``machine`` is
    ``"hysteresis"`` (enter beyond +-k, leave a long at ``z >= -z_exit`` and
    a short at ``z <= z_exit``) or ``"touch"`` (memoryless). Returns the
    ``(9, N, P)`` metric planes in lane order.
    """
    _machine_code(machine)
    N, W, T = z.shape
    P = widx.shape[0]
    zt = z.permute(2, 0, 1)                                     # (T, N, W)
    lanes = widx.long()
    kk = k[None, :]
    zx = torch.tensor(z_exit, dtype=torch.float32, device=z.device)
    st = _MetricState(t_real, P)
    t_on = (warm.long() - 1)[None, :]
    for step in range(T):
        zs = zt[step][:, lanes]                                 # (N, P)
        nxt = _band_next(st.prev, zs, kk, zx, machine)
        pos = torch.where(step >= t_on, nxt, st.zero)
        st.step(step, pos, r[:, step:step + 1], cost)
    return _to_lanes(st.planes(ppy), lane)


def band_inline_plain(close, cs, csx, csx2, r, t_real, window, k, warm, *,
                      machine: str, z_exit: float, cost: float,
                      ppy: int) -> torch.Tensor:
    """Plain PyTorch version of K2's inline entry (``dbx_band_inline``):
    the z-table of the lanes' distinct windows (:func:`boll_z_table`), then
    :func:`band_machine_plain`. ``close``, ``cs``, ``csx``, ``csx2`` and
    ``r`` are ``(N, T)``: the close, its cumsum, the cumsums of the centered
    close and of its square, the simple returns; ``window`` the ``(P,)``
    integer windows."""
    windows, widx = torch.unique(window.long(), return_inverse=True)
    z = boll_z_table(close, cs, csx, csx2, windows)
    return band_machine_plain(z, r, t_real, widx, k, warm, machine=machine,
                              z_exit=z_exit, cost=cost, ppy=ppy)


def band_inline_cuda(close, cs, csx, csx2, r, t_real, window, k, warm, *,
                     machine: str, z_exit: float, cost: float,
                     ppy: int) -> torch.Tensor:
    """Launch K2's inline entry (``csrc/band_machine.cu``,
    ``dbx_band_inline``): same inputs and output as
    :func:`band_inline_plain`, all on one CUDA device; the lanes run in
    tiles of ``_BAND_INLINE_LANES`` as :func:`fused_sma_cuda`'s do."""
    N, T = close.shape
    P = window.shape[0]
    lanes = _BAND_INLINE_LANES
    code = _machine_code(machine)
    f32, i32 = torch.float32, torch.int32
    row = (N, T)
    _check_launch("band_inline_cuda", close.device, P, lanes,
                  close=(close, f32, row), cs=(cs, f32, row),
                  csx=(csx, f32, row), csx2=(csx2, f32, row),
                  r=(r, f32, row), t_real=(t_real, i32, (N,)),
                  window=(window, i32, (P,)), k=(k, f32, (P,)),
                  warm=(warm, i32, (P,)))
    out = torch.empty((_N_METRICS, N, P), dtype=f32, device=close.device)
    if N and P:
        _launch_band_inline((close, cs, csx, csx2, r), t_real,
                            window_tiles(lanes, window), k, warm, out, lanes,
                            code=code, z_exit=z_exit, cost=cost, ppy=ppy)
    return out


def _launch_band_inline(rows, t_real, tiles, k, warm, out, lanes: int, *,
                        code: int, z_exit: float, cost: float,
                        ppy: int) -> None:
    """K2 inline's launch on checked inputs (``rows``: close, cs, csx, csx2,
    r), its tiles (:func:`window_tiles` of the windows) and the machine's
    code."""
    wins, counts, wi = tiles
    N, T = rows[0].shape
    _launch("band_inline", _kernels.band_machine_lib().dbx_band_inline,
            *rows, t_real, wins, counts, wi, k, warm, out, N, T, wi.shape[0],
            lanes, wins.shape[1], code, float(z_exit), float(cost), int(ppy))


def band_table_cuda(z, r, t_real, widx, k, warm, lane=None, *,
                    machine: str, z_exit: float, cost: float,
                    ppy: int) -> torch.Tensor:
    """Launch K2's table entry on a z-table (``csrc/band_machine.cu``,
    ``dbx_band_table``): same inputs and output as
    :func:`band_machine_plain`, all on one CUDA device. Each lane reads
    its table row in device memory, a warp's lanes on a few rows when the
    slots run window-major."""
    N, W, T = z.shape
    P = widx.shape[0]
    code = _machine_code(machine)
    f32, i32 = torch.float32, torch.int32
    lane = _lane_arg(lane, P, z.device)
    _check_launch("band_table_cuda", z.device, P,
                  z=(z, f32, (N, W, T)), r=(r, f32, (N, T)),
                  t_real=(t_real, i32, (N,)), widx=(widx, i32, (P,)),
                  k=(k, f32, (P,)), warm=(warm, i32, (P,)),
                  lane=(lane, i32, (P,)))
    out = torch.empty((_N_METRICS, N, P), dtype=f32, device=z.device)
    if N and P:
        _launch("band_table", _kernels.band_machine_lib().dbx_band_table,
                z, r, t_real, widx, k, warm, lane, out, N, T, W, P, code,
                float(z_exit), float(cost), int(ppy))
    return out


def band_stoch_plain(close, high, low, r, t_real, window, k, warm,
                     lane=None, *, machine: str, z_exit: float, cost: float,
                     ppy: int) -> torch.Tensor:
    """Plain PyTorch version of K2's stochastic entry (``dbx_band_stoch``):
    the centered %K rows of the lanes' distinct windows
    (:func:`stochastic_z_table`, channels from the highs and lows), then
    :func:`band_machine_plain`. ``close``, ``high``, ``low`` and ``r`` are
    ``(N, T)``; ``window`` the ``(P,)`` int32 window of each slot; ``k``,
    ``warm`` and ``lane`` as :func:`band_machine_plain`."""
    windows, widx = torch.unique(window.long(), return_inverse=True)
    z = stochastic_z_table(close, high, low, windows.cpu().numpy())
    return band_machine_plain(z, r, t_real, widx, k, warm, lane,
                              machine=machine, z_exit=z_exit, cost=cost,
                              ppy=ppy)


def band_stoch_cuda(close, high, low, r, t_real, window, k, warm, lane=None,
                    *, machine: str, z_exit: float, cost: float,
                    ppy: int) -> torch.Tensor:
    """Launch K2's stochastic entry (``csrc/band_machine.cu``,
    ``dbx_band_stoch``): same inputs and output as :func:`band_stoch_plain`,
    all on one CUDA device. The kernel builds the channel levels of each
    ticker in shared memory; for rows too long for that, the levels are
    built here in device memory (:func:`extrema_levels`) and the kernel
    reads them there."""
    N, T = close.shape
    P = window.shape[0]
    code = _machine_code(machine)
    f32, i32 = torch.float32, torch.int32
    lane = _lane_arg(lane, P, close.device)
    row = (N, T)
    _check_launch("band_stoch_cuda", close.device, P,
                  close=(close, f32, row), high=(high, f32, row),
                  low=(low, f32, row), r=(r, f32, row),
                  t_real=(t_real, i32, (N,)), window=(window, i32, (P,)),
                  k=(k, f32, (P,)), warm=(warm, i32, (P,)),
                  lane=(lane, i32, (P,)))
    out = torch.empty((_N_METRICS, N, P), dtype=f32, device=close.device)
    if N and P:
        lib = _kernels.band_machine_lib()
        lev_hi, lev_lo = _channel_levels(lib, high, low, T)
        _launch("band_stoch", lib.dbx_band_stoch, close, high, low, r,
                lev_hi, lev_lo, t_real, window, k, warm, lane, out, N, T, P,
                code, float(z_exit), float(cost), int(ppy))
    return out


def band_inline(close, cs, csx, csx2, r, t_real, window, k, warm, *,
                machine: str, z_exit: float, cost: float,
                ppy: int) -> torch.Tensor:
    """K2's inline entry on the inputs' device."""
    fn = _on_device(band_inline_plain, band_inline_cuda, close)
    return fn(close, cs, csx, csx2, r, t_real, window, k, warm,
              machine=machine, z_exit=z_exit, cost=cost, ppy=ppy)


def band_table(z, r, t_real, widx, k, warm, lane=None, *, machine: str,
               z_exit: float, cost: float, ppy: int) -> torch.Tensor:
    """K2's table entry on the inputs' device."""
    fn = _on_device(band_machine_plain, band_table_cuda, z)
    return fn(z, r, t_real, widx, k, warm, lane, machine=machine,
              z_exit=z_exit, cost=cost, ppy=ppy)


def band_stoch(close, high, low, r, t_real, window, k, warm, lane=None, *,
               machine: str, z_exit: float, cost: float,
               ppy: int) -> torch.Tensor:
    """K2's stochastic entry on the inputs' device."""
    fn = _on_device(band_stoch_plain, band_stoch_cuda, close)
    return fn(close, high, low, r, t_real, window, k, warm, lane,
              machine=machine, z_exit=z_exit, cost=cost, ppy=ppy)


# --- K3: single window (momentum, donchian, donchian_hl) ------------------

def momentum_plain(close, r, t_real, lookback, warm, *, cost: float,
                   ppy: int) -> torch.Tensor:
    """Plain PyTorch version of K3's momentum entry (``dbx_momentum``):
    ``pos = sign(close[t] - close[max(t - w, 0)])`` after the warmup.
    ``close``/``r`` are ``(N, T)``, ``lookback``/``warm`` ``(P,)`` int32.
    Returns the ``(9, N, P)`` metric planes."""
    N, T = close.shape
    P = lookback.shape[0]
    lb = lookback.long()
    st = _MetricState(t_real, P)
    t_on = (warm.long() - 1)[None, :]
    for step in range(T):
        past = close[:, (step - lb).clamp_min(0)]               # (N, P)
        pos = torch.where(step >= t_on,
                          torch.sign(close[:, step:step + 1] - past), st.zero)
        st.step(step, pos, r[:, step:step + 1], cost)
    return st.planes(ppy)


def donchian_latch_plain(sig, r, t_real, widx, warm, lane=None, *,
                         cost: float, ppy: int) -> torch.Tensor:
    """The breakout latch of K3's donchian entry over an ``(N, W, T)`` int8
    sign table (:func:`donchian_sign_table`), row ``widx`` per slot: +1 on
    an up breakout, -1 on a down one, else hold; flat before the warmup.
    ``lane`` as :func:`band_machine_plain`. Returns the ``(9, N, P)``
    metric planes in lane order."""
    N, W, T = sig.shape
    P = widx.shape[0]
    st_t = sig.permute(2, 0, 1)                                 # (T, N, W)
    lanes = widx.long()
    st = _MetricState(t_real, P)
    one = torch.ones((), dtype=torch.float32, device=sig.device)
    t_on = (warm.long() - 1)[None, :]
    for step in range(T):
        s = st_t[step][:, lanes]                                # (N, P)
        nxt = torch.where(s > 0, one, torch.where(s < 0, -one, st.prev))
        pos = torch.where(step >= t_on, nxt, st.zero)
        st.step(step, pos, r[:, step:step + 1], cost)
    return _to_lanes(st.planes(ppy), lane)


def donchian_plain(close, hi_src, lo_src, r, t_real, window, warm,
                   lane=None, *, cost: float, ppy: int) -> torch.Tensor:
    """Plain PyTorch version of K3's donchian entry (``dbx_donchian``): the
    breakout-sign rows of the lanes' distinct windows
    (:func:`donchian_sign_table`, the channel from ``hi_src`` and
    ``lo_src``), then :func:`donchian_latch_plain`. ``close``, ``hi_src``,
    ``lo_src`` and ``r`` are ``(N, T)``; ``window`` and ``warm`` the
    ``(P,)`` int32 window and warmup of each slot; ``lane`` as
    :func:`band_machine_plain`."""
    windows, widx = torch.unique(window.long(), return_inverse=True)
    sig = donchian_sign_table(close, hi_src, lo_src, windows.cpu().numpy())
    return donchian_latch_plain(sig, r, t_real, widx, warm, lane, cost=cost,
                                ppy=ppy)


def momentum_cuda(close, r, t_real, lookback, warm, *, cost: float,
                  ppy: int) -> torch.Tensor:
    """Launch K3's momentum entry (``csrc/single_window.cu``,
    ``dbx_momentum``): same inputs and output as :func:`momentum_plain`."""
    N, T = close.shape
    P = lookback.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check_launch("momentum_cuda", close.device, P,
                  close=(close, f32, (N, T)), r=(r, f32, (N, T)),
                  t_real=(t_real, i32, (N,)),
                  lookback=(lookback, i32, (P,)), warm=(warm, i32, (P,)))
    out = torch.empty((_N_METRICS, N, P), dtype=f32, device=close.device)
    if N and P:
        _launch("momentum", _kernels.single_window_lib().dbx_momentum,
                close, r, t_real, lookback, warm, out, N, T, P, float(cost),
                int(ppy))
    return out


def donchian_cuda(close, hi_src, lo_src, r, t_real, window, warm,
                  lane=None, *, cost: float, ppy: int) -> torch.Tensor:
    """Launch K3's donchian entry (``csrc/single_window.cu``,
    ``dbx_donchian``): same inputs and output as :func:`donchian_plain`,
    all on one CUDA device. The kernel builds the channel levels of each
    ticker in shared memory; for rows too long for that, the levels are
    built here in device memory (:func:`extrema_levels`) and the kernel
    reads them there."""
    N, T = close.shape
    P = window.shape[0]
    f32, i32 = torch.float32, torch.int32
    lane = _lane_arg(lane, P, close.device)
    row = (N, T)
    _check_launch("donchian_cuda", close.device, P,
                  close=(close, f32, row), hi_src=(hi_src, f32, row),
                  lo_src=(lo_src, f32, row), r=(r, f32, row),
                  t_real=(t_real, i32, (N,)), window=(window, i32, (P,)),
                  warm=(warm, i32, (P,)), lane=(lane, i32, (P,)))
    out = torch.empty((_N_METRICS, N, P), dtype=f32, device=close.device)
    if N and P:
        lib = _kernels.single_window_lib()
        lev_hi, lev_lo = _channel_levels(lib, hi_src, lo_src, T)
        _launch("donchian", lib.dbx_donchian, close, hi_src, lo_src, r,
                lev_hi, lev_lo, t_real, window, warm, lane, out, N, T, P,
                float(cost), int(ppy))
    return out


def momentum(close, r, t_real, lookback, warm, *, cost: float,
             ppy: int) -> torch.Tensor:
    """K3's momentum entry on the inputs' device."""
    fn = _on_device(momentum_plain, momentum_cuda, close)
    return fn(close, r, t_real, lookback, warm, cost=cost, ppy=ppy)


def donchian(close, hi_src, lo_src, r, t_real, window, warm, lane=None, *,
             cost: float, ppy: int) -> torch.Tensor:
    """K3's donchian entry on the inputs' device."""
    fn = _on_device(donchian_plain, donchian_cuda, close)
    return fn(close, hi_src, lo_src, r, t_real, window, warm, lane, cost=cost,
              ppy=ppy)


# --- K4 and K5: EMA signal-line crossover (macd, trix) --------------------

def _signal_cross_plain(series, r, t_real, a_sig, warm, *, cost: float,
                        ppy: int) -> torch.Tensor:
    """The shared tail of K4 and K5 in ``csrc/ema_cross.cu``'s order:
    ``series(step)`` gives the lanes' ``(N, P)`` value x at a bar; the
    signal line is ``s = x`` at bar 0, then ``(1-a)*s + a*x`` (two
    multiplies and one add, ``1-a`` formed once); ``pos = sign(x - s)``
    from bar ``warm - 1``."""
    T = r.shape[1]
    P = a_sig.shape[0]
    a = a_sig[None, :]
    keep = 1.0 - a
    st = _MetricState(t_real, P)
    t_on = (warm.long() - 1)[None, :]
    sig = st.zero
    for step in range(T):
        x = series(step)
        sig = x if step == 0 else keep * sig + a * x
        pos = torch.where(step >= t_on, torch.sign(x - sig), st.zero)
        st.step(step, pos, r[:, step:step + 1], cost)
    return st.planes(ppy)


def macd_plain(tbl, r, t_real, fidx, sidx, a_sig, warm, *, cost: float,
               ppy: int) -> torch.Tensor:
    """Plain PyTorch version of K4 (``dbx_macd``): the macd line is each
    lane's fast row minus its slow row of the ``(N, W, T)`` EMA table;
    ``fidx``/``sidx`` are the ``(P,)`` rows, ``a_sig`` the ``(P,)`` signal
    decays, ``warm`` the ``(P,)`` integer warmups. Returns the
    ``(9, N, P)`` metric planes."""
    tt = tbl.permute(2, 0, 1)                                   # (T, N, W)
    fi, si = fidx.long(), sidx.long()
    return _signal_cross_plain(lambda t: tt[t][:, fi] - tt[t][:, si], r,
                               t_real, a_sig, warm, cost=cost, ppy=ppy)


def trix_plain(tbl, r, t_real, widx, a_sig, warm, *, cost: float,
               ppy: int) -> torch.Tensor:
    """Plain PyTorch version of K5 (``dbx_trix``): x is the one-bar rate of
    change of each lane's row ``widx`` of the ``(N, W, T)`` triple-EMA
    table, ``e3[t] / e3[t-1] - 1`` with a previous value of 0 taken as 1,
    and 0 at bar 0. Other arguments as :func:`macd_plain`."""
    tt = tbl.permute(2, 0, 1)                                   # (T, N, W)
    lanes = widx.long()
    one = torch.ones((), dtype=tbl.dtype, device=tbl.device)

    def series(t):
        if t == 0:
            return torch.zeros((tbl.shape[0], lanes.shape[0]),
                               dtype=tbl.dtype, device=tbl.device)
        prev = tt[t - 1][:, lanes]
        return tt[t][:, lanes] / torch.where(prev == 0, one, prev) - 1.0

    return _signal_cross_plain(series, r, t_real, a_sig, warm, cost=cost,
                               ppy=ppy)


def macd_keys(fidx: torch.Tensor, sidx: torch.Tensor, W: int) -> torch.Tensor:
    """Each lane's tile key ``fidx * W + sidx`` (int64) for
    :func:`window_tiles`: one value a distinct (fast, slow) pair of rows of
    a ``W``-row EMA table, sorted as the pairs are."""
    return fidx.long() * W + sidx.long()


def macd_cuda(tbl, r, t_real, fidx, sidx, a_sig, warm, *, cost: float,
              ppy: int) -> torch.Tensor:
    """Launch K4 (``csrc/ema_cross.cu``, ``dbx_macd``): same inputs and
    output as :func:`macd_plain`, all on one CUDA device. The lanes run in
    tiles of ``_MACD_LANES``, whose lists of (fast, slow) keys are built on
    the card (:func:`window_tiles` of :func:`macd_keys`); each tile forms
    the macd line of its pairs once per bar."""
    N, W, T = tbl.shape
    P = fidx.shape[0]
    lanes = _MACD_LANES
    f32, i32 = torch.float32, torch.int32
    _check_launch("macd_cuda", tbl.device, P, lanes,
                  tbl=(tbl, f32, (N, W, T)), r=(r, f32, (N, T)),
                  t_real=(t_real, i32, (N,)), fidx=(fidx, i32, (P,)),
                  sidx=(sidx, i32, (P,)), a_sig=(a_sig, f32, (P,)),
                  warm=(warm, i32, (P,)))
    out = torch.empty((_N_METRICS, N, P), dtype=f32, device=tbl.device)
    if N and P:
        _launch_macd(tbl, r, t_real, window_tiles(lanes, macd_keys(
            fidx, sidx, W)), a_sig, warm, out, lanes, cost=cost, ppy=ppy)
    return out


def _launch_macd(tbl, r, t_real, tiles, a_sig, warm, out, lanes: int, *,
                 cost: float, ppy: int) -> None:
    """K4's launch on checked inputs and its tiles (:func:`window_tiles`
    of the lanes' :func:`macd_keys`)."""
    wins, counts, wi = tiles
    N, W, T = tbl.shape
    _launch("macd", _kernels.ema_cross_lib().dbx_macd, tbl, r, t_real, wins,
            counts, wi, a_sig, warm, out, N, T, W, wi.shape[0], lanes,
            wins.shape[1], float(cost), int(ppy))


def trix_cuda(tbl, r, t_real, widx, a_sig, warm, *, cost: float,
              ppy: int) -> torch.Tensor:
    """Launch K5 (``csrc/ema_cross.cu``, ``dbx_trix``): same inputs and
    output as :func:`trix_plain`, all on one CUDA device. The lanes run in
    tiles of ``_TRIX_LANES``, whose lists of table rows are built on the
    card from ``widx`` (:func:`window_tiles`); each tile forms the rate of
    change of its rows once per bar."""
    N, W, T = tbl.shape
    P = widx.shape[0]
    lanes = _TRIX_LANES
    f32, i32 = torch.float32, torch.int32
    _check_launch("trix_cuda", tbl.device, P, lanes,
                  tbl=(tbl, f32, (N, W, T)), r=(r, f32, (N, T)),
                  t_real=(t_real, i32, (N,)), widx=(widx, i32, (P,)),
                  a_sig=(a_sig, f32, (P,)), warm=(warm, i32, (P,)))
    out = torch.empty((_N_METRICS, N, P), dtype=f32, device=tbl.device)
    if N and P:
        _launch_trix(tbl, r, t_real, window_tiles(lanes, widx), a_sig, warm,
                     out, lanes, cost=cost, ppy=ppy)
    return out


def _launch_trix(tbl, r, t_real, tiles, a_sig, warm, out, lanes: int, *,
                 cost: float, ppy: int) -> None:
    """K5's launch on checked inputs and its tiles (:func:`window_tiles`
    of the lanes' table rows)."""
    wins, counts, wi = tiles
    N, W, T = tbl.shape
    _launch("trix", _kernels.ema_cross_lib().dbx_trix, tbl, r, t_real, wins,
            counts, wi, a_sig, warm, out, N, T, W, wi.shape[0], lanes,
            wins.shape[1], float(cost), int(ppy))


def macd(tbl, r, t_real, fidx, sidx, a_sig, warm, *, cost: float,
         ppy: int) -> torch.Tensor:
    """K4 on the inputs' device."""
    fn = _on_device(macd_plain, macd_cuda, tbl)
    return fn(tbl, r, t_real, fidx, sidx, a_sig, warm, cost=cost, ppy=ppy)


def trix(tbl, r, t_real, widx, a_sig, warm, *, cost: float,
         ppy: int) -> torch.Tensor:
    """K5 on the inputs' device."""
    fn = _on_device(trix_plain, trix_cuda, tbl)
    return fn(tbl, r, t_real, widx, a_sig, warm, cost=cost, ppy=ppy)


# --- K7: pairs ------------------------------------------------------------

def pairs_plain(z, hr, t_real, widx, k, z_exit, warm, *, cost: float,
                ppy: int) -> torch.Tensor:
    """Plain PyTorch version of K7 (``dbx_pairs``): the hysteresis band
    machine over row ``widx`` of the ``(N, W, T)`` spread z-table with the
    lane's own ``k`` and ``z_exit`` (``(P,)`` f32), earning row ``widx`` of
    the hedged-return table ``hr``: ``net = prev * hr - cost * |dpos|``.
    Returns the ``(9, N, P)`` metric planes."""
    N, W, T = z.shape
    P = widx.shape[0]
    zt, ht = z.permute(2, 0, 1), hr.permute(2, 0, 1)            # (T, N, W)
    lanes = widx.long()
    kk, zx = k[None, :], z_exit[None, :]
    st = _MetricState(t_real, P)
    t_on = (warm.long() - 1)[None, :]
    for step in range(T):
        nxt = _band_next(st.prev, zt[step][:, lanes], kk, zx, "hysteresis")
        pos = torch.where(step >= t_on, nxt, st.zero)
        st.step(step, pos, ht[step][:, lanes], cost)
    return st.planes(ppy)


def pairs_cuda(z, hr, t_real, widx, k, z_exit, warm, *, cost: float,
               ppy: int) -> torch.Tensor:
    """Launch K7 (``csrc/band_machine.cu``, ``dbx_pairs``): same inputs and
    output as :func:`pairs_plain`, all on one CUDA device. The lanes run in
    tiles of ``_PAIRS_LANES``, whose lists of table rows are built on the
    card from ``widx`` (:func:`window_tiles`); each tile stages the (z, hr)
    pair of its rows once per bar."""
    N, W, T = z.shape
    P = widx.shape[0]
    lanes = _PAIRS_LANES
    f32, i32 = torch.float32, torch.int32
    _check_launch("pairs_cuda", z.device, P, lanes,
                  z=(z, f32, (N, W, T)), hr=(hr, f32, (N, W, T)),
                  t_real=(t_real, i32, (N,)), widx=(widx, i32, (P,)),
                  k=(k, f32, (P,)), z_exit=(z_exit, f32, (P,)),
                  warm=(warm, i32, (P,)))
    out = torch.empty((_N_METRICS, N, P), dtype=f32, device=z.device)
    if N and P:
        _launch_pairs(z, hr, t_real, window_tiles(lanes, widx), k, z_exit,
                      warm, out, lanes, cost=cost, ppy=ppy)
    return out


def _launch_pairs(z, hr, t_real, tiles, k, z_exit, warm, out, lanes: int, *,
                  cost: float, ppy: int) -> None:
    """K7's launch on checked inputs and its tiles (:func:`window_tiles`
    of the lanes' table rows)."""
    wins, counts, wi = tiles
    N, W, T = z.shape
    _launch("pairs", _kernels.band_machine_lib().dbx_pairs, z, hr, t_real,
            wins, counts, wi, k, z_exit, warm, out, N, T, W, wi.shape[0],
            lanes, wins.shape[1], float(cost), int(ppy))


def pairs(z, hr, t_real, widx, k, z_exit, warm, *, cost: float,
          ppy: int) -> torch.Tensor:
    """K7 on the inputs' device."""
    fn = _on_device(pairs_plain, pairs_cuda, z)
    return fn(z, hr, t_real, widx, k, z_exit, warm, cost=cost, ppy=ppy)


# --- table prep (torch ops before the launch) -----------------------------

def _level_list(src: torch.Tensor, L: int, mode: str) -> list:
    """The sparse table's doubling levels of ``src`` (the reference's
    ``_extrema_table``): ``level[0] = src``, ``level[j][t] =
    op(level[j-1][t], level[j-1][t - 2^(j-1)])`` with the neutral value
    before the shift, so ``level[j][t] = op(src[t - 2^j + 1 .. t])``; one
    op per level."""
    op = torch.maximum if mode == "max" else torch.minimum
    neutral = -math.inf if mode == "max" else math.inf
    levels = [src]
    for j in range(L):
        levels.append(op(levels[j], _shift_t(levels[j], 1 << j, neutral)))
    return levels


def extrema_levels(src: torch.Tensor, L: int, mode: str) -> torch.Tensor:
    """Levels 0..L of ``src`` (``(N, T)``) as one ``(N, L + 1, T)`` tensor,
    the layout the channel kernels read when the levels do not fit in
    shared memory."""
    return torch.stack(_level_list(src, L, mode), dim=1)


def _extrema_rows(src: torch.Tensor, windows: np.ndarray, mode: str):
    """Yield each distinct window's ``(N, T)`` rolling max/min of ``src``
    from ONE sparse table (:func:`_level_list`): every window is the op of
    two overlapping spans. Exact (max/min of raw prices); warmup bars
    ``t < w - 1`` are left as computed (the callers mask them)."""
    op = torch.maximum if mode == "max" else torch.minimum
    neutral = -math.inf if mode == "max" else math.inf
    levels = _level_list(src, max(int(w).bit_length() - 1 for w in windows),
                         mode)
    for w in windows:
        w = int(w)
        j = w.bit_length() - 1                      # largest 2^j <= w
        yield w, op(levels[j], _shift_t(levels[j], w - (1 << j), neutral))


def stochastic_z_table(close, high, low, windows: np.ndarray) -> torch.Tensor:
    """The ``(N, W, T)`` centered %K table of each distinct window (the
    reference's ``_fused_stoch_call`` prep): ``%K - 50`` with the channel
    from the highs and lows, 50 where the channel is flat, 0 before
    ``t = w - 1``. :func:`band_stoch_plain` steps over it; the kernel forms
    the same values per lane and bar and writes no table."""
    N, T = close.shape
    t = torch.arange(T, device=close.device)
    z = torch.empty((N, len(windows), T), dtype=torch.float32,
                    device=close.device)
    rows = zip(_extrema_rows(high, windows, "max"),
               _extrema_rows(low, windows, "min"))
    for i, ((w, hi), (_, lo)) in enumerate(rows):
        rng = hi - lo
        k_pct = torch.where(rng > _EPS, 100.0 * (close - lo) / (rng + _EPS),
                            50.0) - 50.0
        z[:, i] = torch.where(t >= w - 1, k_pct, 0.0)
    return z


def donchian_sign_table(close, hi_src, lo_src,
                        windows: np.ndarray) -> torch.Tensor:
    """The ``(N, W, T)`` int8 breakout-sign table (the reference's
    ``_fused_don_call`` HBM table): +1 where the close is at or above the
    prior bar's channel high, -1 at or below the prior low, up wins; the
    channel is +-1e30 before ``t = w - 1`` and at ``t = 0``.
    :func:`donchian_plain` steps over it; the kernel forms the same signs
    per lane and bar and writes no table."""
    N, T = close.shape
    t = torch.arange(T, device=close.device)
    sig = torch.empty((N, len(windows), T), dtype=torch.int8,
                      device=close.device)
    rows = zip(_extrema_rows(hi_src, windows, "max"),
               _extrema_rows(lo_src, windows, "min"))
    for i, ((w, hi), (_, lo)) in enumerate(rows):
        hi = torch.where(t >= w - 1, hi, _CHANNEL_FILL)
        lo = torch.where(t >= w - 1, lo, -_CHANNEL_FILL)
        up = close >= _shift_t(hi, 1, _CHANNEL_FILL)
        down = close <= _shift_t(lo, 1, -_CHANNEL_FILL)
        sig[:, i] = torch.where(up, 1, torch.where(down, -1, 0)).to(torch.int8)
    return sig


# The EMA tables below are built in one pass over an (N, W, T) tensor: the
# ladder is elementwise, so a (W, 1) column of decays broadcast against the
# (N, 1, T) series gives each row the values a per-window loop would. Each
# repeats its generic model's ops (models/macd.py, trix.py, rsi.py,
# keltner.py) on the distinct windows, so the fused and generic paths see
# the same values.

def _col(dev: torch.device, values: np.ndarray) -> torch.Tensor:
    """``(W,)`` values as a ``(W, 1)`` f32 column on ``dev``."""
    return torch.from_numpy(np.asarray(values, np.float32)).to(dev)[:, None]


def _windows_col(dev: torch.device, windows: np.ndarray):
    """Distinct windows as ``(W,)`` int64 and a ``(W, 1)`` f32 column."""
    w = torch.from_numpy(np.asarray(windows).astype(np.int64)).to(dev)
    return w, _col(dev, windows)


def macd_ema_table(close, spans: np.ndarray) -> torch.Tensor:
    """The ``(N, W, T)`` EMAs of the close demeaned by its first bar, one
    row per distinct span (the reference's ``_fused_macd_call`` prep)."""
    x = (close - close[:, :1])[:, None, :]
    return rolling.ema_ladder(x, span=_col(close.device, spans)).contiguous()


def trix_ema_table(close, spans: np.ndarray) -> torch.Tensor:
    """The ``(N, W, T)`` triple EMAs of the close, one row per distinct span
    (the reference's ``_fused_trix_call`` prep): three chained ladders."""
    span = _col(close.device, spans)
    e = close[:, None, :]
    for _ in range(3):
        e = rolling.ema_ladder(e, span=span)
    return e.contiguous()


def ema_decay(dev: torch.device, spans: np.ndarray) -> torch.Tensor:
    """The ``(W,)`` f32 EMA decays ``2 / (span + 1)`` of the distinct
    spans, formed as :func:`~.rolling.ema_ladder` forms them."""
    return rolling._decay(torch.empty(0, device=dev), _col(dev, spans),
                          None).reshape(-1).contiguous()


def ema_rows_cuda(x, decay, ladders: int) -> torch.Tensor:
    """Launch ``dbx_ema_rows`` (``csrc/ema_rows.cu``): the ``(N, W, T)``
    table of ``ladders`` (1 to 3) chained EMA ladders of the ``(N, T)`` f32
    rows ``x``, one row per ``(W,)`` f32 decay, on the card. With the decays
    of :func:`ema_decay` it equals, bit for bit, :func:`trix_ema_table`
    (3 ladders of the close) and :func:`macd_ema_table` (1 ladder of the
    close demeaned by its first bar), the plain versions. A row of up to
    2048 bars runs in one warp's registers (:func:`ema_rows_registers`);
    longer rows are staged in shared memory, or run on scratch in device
    memory where they are too long to stage."""
    N, T = x.shape
    W = decay.shape[0]
    if not 1 <= ladders <= 3:
        raise ValueError(f"ladders must be 1, 2 or 3, got {ladders}")
    _check_launch("ema_rows_cuda", x.device, 0,
                  x=(x, torch.float32, (N, T)),
                  decay=(decay, torch.float32, (W,)))
    out = torch.empty((N, W, T), dtype=torch.float32, device=x.device)
    if N and W and T:
        n_scratch = _ema_rows_scratch(int(T))
        scratch = (torch.empty((N * W * n_scratch,), dtype=torch.float32,
                               device=x.device) if n_scratch else None)
        _launch("ema_rows", _kernels.ema_rows_lib().dbx_ema_rows, x, decay,
                out, scratch, N, T, W, int(ladders))
    return out


@functools.lru_cache(maxsize=None)
def _ema_rows_scratch(T: int) -> int:
    """Floats of device-memory scratch a row of ``dbx_ema_rows`` needs at
    row length ``T``, 0 where it is held in registers or staged in shared
    memory."""
    return int(_kernels.ema_rows_lib().dbx_ema_rows_scratch(T))


@functools.lru_cache(maxsize=None)
def ema_rows_registers(T: int) -> int:
    """The registers a lane of ``dbx_ema_rows`` holds of a row of ``T``
    bars (bar t on lane t % 32 in register t // 32, one row a warp), 0
    where the row is longer than the largest register plan and runs on the
    staged path."""
    return int(_kernels.ema_rows_lib().dbx_ema_rows_registers(int(T)))


def macd_sweep_table(close, spans: np.ndarray) -> torch.Tensor:
    """K4's EMA table on the close's device: :func:`macd_ema_table` (torch
    ops) on the CPU, :func:`ema_rows_cuda` (one ladder of the close
    demeaned by its first bar) on the card."""
    if close.device.type == "cpu":
        return macd_ema_table(close, spans)
    return ema_rows_cuda((close - close[:, :1]).contiguous(),
                         ema_decay(close.device, spans), 1)


def trix_sweep_table(close, spans: np.ndarray) -> torch.Tensor:
    """K5's triple-EMA table on the close's device: :func:`trix_ema_table`
    (torch ops) on the CPU, :func:`ema_rows_cuda` on the card."""
    if close.device.type == "cpu":
        return trix_ema_table(close, spans)
    return ema_rows_cuda(close, ema_decay(close.device, spans), 3)


def rsi_z_table(close, periods: np.ndarray) -> torch.Tensor:
    """The ``(N, W, T)`` centered RSI, ``rsi - 50``, of each distinct period
    (the reference's ``_fused_rsi_call`` prep): Wilder ladders of the gains
    and losses with decay ``1/period``, then
    ``100 - 100 / (1 + ag / (al + 1e-12)) - 50``."""
    diff = torch.diff(close, dim=-1, prepend=close[:, :1])
    gains = diff.clamp_min(0.0)[:, None, :]
    losses = (-diff).clamp_min(0.0)[:, None, :]
    one = torch.ones((), dtype=close.dtype, device=close.device)
    alpha = torch.div(one, _col(close.device, periods))
    ag = rolling.ema(gains, alpha=alpha)
    al = rolling.ema(losses, alpha=alpha)
    rsi = 100.0 - torch.div(100.0 * one, 1.0 + ag / (al + _EPS))
    return (rsi - 50.0).contiguous()


def keltner_z_table(close, high, low, windows: np.ndarray) -> torch.Tensor:
    """The ``(N, W, T)`` Keltner z-table of each distinct window (the
    reference's ``_fused_keltner_call`` prep): the close's deviation from
    its EMA midline over the ATR, the windowed mean of the true range from
    its ``(N, T)`` cumsum; 0 before ``t = w - 1`` and where the ATR is not
    above 1e-12."""
    prev = torch.cat([close[:, :1], close[:, :-1]], dim=1)
    true_range = torch.maximum(high - low,
                               torch.maximum((high - prev).abs(),
                                             (low - prev).abs()))
    w, fw = _windows_col(close.device, windows)
    atr = _lagged_window_sum(rolling.prefix_sum(true_range, 1), w) / fw
    mid = rolling.ema(close[:, None, :], span=fw)
    dev = close[:, None, :] - mid
    t = torch.arange(close.shape[1], device=close.device)
    have = (t[None, :] >= w[:, None] - 1) & (atr > _EPS)
    return torch.where(have, dev / (atr + _EPS),
                       torch.zeros((), dtype=dev.dtype, device=dev.device))


def vwap_z_table(close, volume, windows: np.ndarray,
                 t_real=None) -> torch.Tensor:
    """The ``(N, W, T)`` z-table of the close's deviation from its rolling
    VWAP, one row per distinct window (the reference's ``_fused_vwap_call``
    prep, op for op but for the centering): the deviation is 0 before ``t =
    w - 1`` and where the window's volume is not above 1e-12; its z-score is
    centered with the deviation's mean over each row's own ``t_real`` bars
    (:func:`row_mean`; all T where ``t_real`` is None), where the reference
    centers over all the bars of the stacked panel, a ragged group's pad
    bars included; z is 0 before ``t = w - 1``. The prefix sums are
    :func:`~.rolling.prefix_sum`'s. So a row's z-table is a function of its
    own bars, whatever the rows and bars stacked with it."""
    N, T = close.shape
    w, fw = _windows_col(close.device, windows)
    t = torch.arange(T, device=close.device)
    warm_ok = t[None, :] >= w[:, None] - 1                      # (W, T)
    zero = torch.zeros((), dtype=close.dtype, device=close.device)
    pv = _lagged_window_sum(rolling.prefix_sum(close * volume, 1), w)
    v = _lagged_window_sum(rolling.prefix_sum(volume, 1), w)
    dev = torch.where(warm_ok & (v > _EPS),
                      close[:, None, :] - pv / (v + _EPS), zero)
    m = _lagged_window_sum(rolling.prefix_sum(dev, 2), w) / fw
    xc = dev - row_mean(dev, _check_t_real(t_real, N, T))
    s1 = _lagged_window_sum(rolling.prefix_sum(xc, 2), w)
    s2 = _lagged_window_sum(rolling.prefix_sum(xc * xc, 2), w)
    var = ((s2 - s1 * s1 / fw) / fw).clamp_min(0.0)
    z = (dev - m) / (torch.sqrt(var) + _EPS)
    return torch.where(warm_ok, z, zero)


def pairs_tables(y_close, x_close, windows: np.ndarray):
    """The ``(N, W, T)`` spread z-table and hedged-return table of each
    pair and distinct lookback (the reference's ``_fused_pairs_call`` prep,
    op for op). Rolling OLS of y on x from the windowed moments of the legs
    centered by their means over all T bars (summed in f64 and rounded once,
    :func:`~.rolling.mean_f64`, as the generic model's
    ``rolling_ols``): ``beta = cov / (var + 1e-12)``,
    ``var = max(sxx - sx*sx/w, 0)``, ``alpha = (sy/w + my) - beta*(sx/w +
    mx)``; during the OLS warmup (``t < w - 1``) beta is 0 and the spread is
    exactly y. The spread's z-score: moments of the spread centered by its
    mean over all T bars, the window mean of the uncentered spread; 0 before
    ``t = 2w - 2``. ``hr = (r_y - beta[t-1] r_x) / max(1 + |beta[t-1]|, 1)``
    with ``beta[-1] = 0``. Returns ``(z, hr)``. The windowed sums are
    differences of ``torch.cumsum`` rows, the spread's mean
    ``torch.mean``'s."""
    y, x = y_close, x_close
    w, fw = _windows_col(y.device, windows)
    return _pairs_z_hr(y, x, rolling.mean_f64(x, 1), rolling.mean_f64(y, 1),
                       w, fw,
                       lambda s: torch.cumsum(s, dim=-1),
                       lambda s: s.mean(dim=-1, keepdim=True))


def _pairs_z_hr(y, x, mx, my, w, fw, prefix, spread_mean):
    """The formulas of :func:`pairs_tables` on the ``(N, T)`` legs: ``mx``
    and ``my`` their ``(N, 1)`` means, ``w`` the ``(W,)`` int64 lookbacks
    and ``fw`` their ``(W, 1)`` f32 column; ``prefix(s)`` the inclusive
    prefix sums of ``s`` along its last axis and ``spread_mean(s)`` the
    ``(N, W, 1)`` mean of the spread over its T bars, the two orders of
    summation the callers choose. A windowed sum is the difference of two
    prefix sums in their dtype, rounded to the series' (f32 for torch's
    cumsum of f32; f64 for :func:`seq_cumsum`, so rounded once)."""
    t = torch.arange(y.shape[1], device=y.device)
    zero = torch.zeros((), dtype=y.dtype, device=y.device)

    def wsum(series):                       # (N, T) or (N, W, T) -> (N, W, T)
        return _lagged_window_sum(prefix(series), w).to(series.dtype)

    xc, yc = x - mx, y - my
    sx, sy = wsum(xc), wsum(yc)
    sxx, sxy = wsum(xc * xc), wsum(xc * yc)
    cov = sxy - sx * sy / fw
    var = (sxx - sx * sx / fw).clamp_min(0.0)
    beta = cov / (var + _EPS)
    alpha = (sy / fw + my[:, :, None]) - beta * (sx / fw + mx[:, :, None])
    ols_ok = t[None, :] >= w[:, None] - 1                       # (W, T)
    beta_tbl = torch.where(ols_ok, beta, zero)
    y3, x3 = y[:, None, :], x[:, None, :]
    spread = torch.where(ols_ok, y3 - (alpha + beta * x3), y3)

    sc = spread - spread_mean(spread)
    s1, s2 = wsum(sc), wsum(sc * sc)
    varz = ((s2 - s1 * s1 / fw) / fw).clamp_min(0.0)
    mz = wsum(spread) / fw
    z = (spread - mz) / (torch.sqrt(varz) + _EPS)
    z = torch.where(t[None, :] >= 2 * w[:, None] - 2, z, zero)

    ry = simple_returns(y)[:, None, :]
    rx = simple_returns(x)[:, None, :]
    beta_prev = torch.cat([torch.zeros_like(beta_tbl[..., :1]),
                           beta_tbl[..., :-1]], dim=-1)
    hr = (ry - beta_prev * rx) / (1.0 + beta_prev.abs()).clamp_min(1.0)
    return z.contiguous(), hr.contiguous()


def seq_cumsum(v: torch.Tensor) -> torch.Tensor:
    """The f64 prefix sums of ``v`` (f32) along its last axis, each row
    summed bar by bar in f64 (the order of ``csrc/pairs_tables.cu``, on any
    device; torch's CPU cumsum of f32 sums so too, and rounds each bar to
    f32)."""
    acc = torch.zeros(v.shape[:-1], dtype=torch.float64, device=v.device)
    out = torch.empty(v.shape, dtype=torch.float64, device=v.device)
    for t in range(v.shape[-1]):
        acc = acc + v[..., t].double()
        out[..., t] = acc
    return out


def lane_tree_mean(s: torch.Tensor) -> torch.Tensor:
    """The ``(..., 1)`` f32 mean of ``s`` (f32) over its last axis in the
    order of ``csrc/pairs_tables.cu``: lane l of 32 sums the elements l,
    l + 32, ... in f64 (0 past the end), the 32 sums fold in a fixed tree
    (l + 16, then l + 8, ...), and the total is divided by the length in
    f64 and rounded to f32."""
    T = s.shape[-1]
    v = torch.nn.functional.pad(s, (0, -T % 32)).double()
    v = v.reshape(*s.shape[:-1], -1, 32)
    acc = torch.zeros(v.shape[:-2] + (32,), dtype=torch.float64,
                      device=s.device)
    for i in range(v.shape[-2]):
        acc = acc + v[..., i, :]
    for half in (16, 8, 4, 2, 1):
        acc = acc[..., :half] + acc[..., half:2 * half]
    return (acc / T).float()


def pairs_tables_plain(y, x, mx, my, windows):
    """Plain PyTorch version of ``dbx_pairs_tables``: the formulas of
    :func:`pairs_tables` in the kernel's order. ``y`` and ``x`` are the
    ``(N, T)`` f32 legs, ``mx`` and ``my`` their ``(N,)`` f32 means,
    ``windows`` the ``(W,)`` int32 distinct lookbacks. Every prefix sum is
    :func:`seq_cumsum`'s, in f64, and every windowed sum the f64 difference
    of two of them rounded once to f32 (where :func:`pairs_tables` takes it
    in f32 from f32 prefix sums, which cancel); the spread's mean is
    :func:`lane_tree_mean`'s. Returns ``(z, hr)``."""
    return _pairs_z_hr(y, x, mx[:, None], my[:, None], windows.long(),
                       windows.to(torch.float32)[:, None], seq_cumsum,
                       lane_tree_mean)


def pairs_tables_cuda(y, x, mx, my, windows, max_window=None):
    """Launch ``dbx_pairs_tables`` (``csrc/pairs_tables.cu``): same inputs
    and output as :func:`pairs_tables_plain`, all on one CUDA device.
    ``max_window`` is the longest lookback (it sizes the kernel's ring of
    tiles; a value below it gives wrong z); ``None`` reads it from
    ``windows``, which waits for the card. No ``(N, W, T)`` tensor but the
    two tables is allocated: the z table holds the legs' f64 prefix rows
    (32 B a (pair, bar)) where it has room and then the spread, else the
    scratch holds them; the scratch holds the spreads' means."""
    N, T = y.shape
    W = windows.shape[0]
    f32 = torch.float32
    _check_launch("pairs_tables_cuda", y.device, 0,
                  y=(y, f32, (N, T)), x=(x, f32, (N, T)),
                  mx=(mx, f32, (N,)), my=(my, f32, (N,)),
                  windows=(windows, torch.int32, (W,)))
    z = torch.empty((N, W, T), dtype=f32, device=y.device)
    hr = torch.empty_like(z)
    if N and W and T:
        if max_window is None:
            max_window = int(windows.max())
        lib = _kernels.pairs_tables_lib()
        scratch = torch.empty((pairs_tables_plan(N, T, W, max_window)[0],),
                              dtype=f32, device=y.device)
        _launch("pairs_tables", lib.dbx_pairs_tables, y, x, mx, my, windows,
                z, hr, scratch, N, T, W, int(max_window))
    return z, hr


@functools.lru_cache(maxsize=None)
def pairs_tables_plan(N: int, T: int, W: int,
                      max_window: int) -> tuple[int, ...]:
    """How ``dbx_pairs_tables`` lays out a call on ``N`` pairs of ``T``
    bars and ``W`` lookbacks, the longest ``max_window`` bars: the floats
    of device-memory scratch it needs, the pairs a warp of the legs' prefix
    chains takes (four chains a pair, one a lane), the (pair, lookback)
    rows a CTA of the spreads' chains takes (one a lane, a warp for each of
    the three sums), the launches a call makes (3, or 4 where the lookbacks
    are too long for the ring), 1 where the spread launch stages a pair's
    four prefix rows in shared memory (0: it reads them from device
    memory), the tiles of 32 bars in the sums launch's ring (0: its lags
    come from device memory), and 1 where the legs' prefix rows live in
    the z table (0: in the scratch)."""
    info = (ctypes.c_int * 7)()
    err = _kernels.pairs_tables_lib().dbx_pairs_tables_plan(
        int(N), int(T), int(W), int(max_window), info)
    if err != 0:
        raise ValueError(f"dbx_pairs_tables takes no N={N}, T={T}, W={W}, "
                         f"max_window={max_window}")
    return tuple(int(v) for v in info)


def pairs_sweep_tables(y, x, windows: np.ndarray):
    """K7's tables on the legs' device: :func:`pairs_tables` (torch ops) on
    the CPU, :func:`pairs_tables_cuda` on the card from the legs' means
    (:func:`~.rolling.mean_f64`, the generic model's centering of the
    legs, the same bits on any device and stack)."""
    if y.device.type == "cpu":
        return pairs_tables(y, x, windows)
    lookbacks = np.asarray(windows).astype(np.int32)
    return pairs_tables_cuda(y, x, rolling.mean_f64(x, 1)[:, 0],
                             rolling.mean_f64(y, 1)[:, 0],
                             *_to(y.device, lookbacks),
                             max_window=int(lookbacks.max(initial=1)))


# --- sweep wrappers -------------------------------------------------------

def _prologue(carry_out: bool, t_real, table, epilogue, device):
    """The reference wrappers' argument rules, checked before any work:
    ``carry_out=True`` takes a uniform full-history panel only
    (:func:`_check_carry_out_args`); ``table`` and ``epilogue`` are
    validated and an invalid value raises. Returns the resolved device."""
    _check_carry_out_args(carry_out, t_real)
    _check_table(table)
    _resolve_epilogue(epilogue)
    return device_mod.resolve(device)


def _check_carry_out_args(carry_out: bool, t_real) -> None:
    """The reference's ``_check_carry_out_args``: a streaming checkpoint
    summarizes one panel state, so ``carry_out=True`` with ``t_real``
    (a ragged group) raises."""
    if carry_out and t_real is not None:
        raise ValueError(
            "carry_out=True supports uniform full-history panels only "
            "(a streaming checkpoint summarizes ONE panel state; ragged "
            "groups checkpoint per panel)")


def _carry_out_tail(metrics: Metrics, carry_out: bool, strategy: str,
                    fields: dict, grid: dict, *, cost, ppy, epilogue):
    """The shared tail of every sweep wrapper (the reference's
    ``_carry_out_tail``): ``metrics`` as the kernel gave them, or with
    ``carry_out=True`` ``(metrics, carry)``, the carry the streaming
    checkpoint of this sweep (:class:`..streaming.recurrent.StreamCarry`)
    built by the generic models' scan form
    (:func:`..streaming.recurrent.build_carry`) on the fields' device, so
    that a later bar slice appends in O(bars)."""
    if not carry_out:
        return metrics
    from ..streaming import recurrent

    carry = recurrent.build_carry(
        strategy, fields, grid, cost=float(cost), periods_per_year=int(ppy),
        epilogue=epilogue, device=next(iter(fields.values())).device)
    return metrics, carry


def _panel(dev: torch.device, close, *others):
    """``close`` and any further ``(N, T)`` fields as f32 tensors on
    ``dev``, all of one shape."""
    fields = [device_mod.as_tensor(f, torch.float32, dev).contiguous()
              for f in (close, *others)]
    if fields[0].ndim != 2:
        raise ValueError(f"close must be (N, T); got {tuple(fields[0].shape)}")
    for f in fields[1:]:
        if f.shape != fields[0].shape:
            raise ValueError(f"every field must be (N, T) = "
                             f"{tuple(fields[0].shape)}; got {tuple(f.shape)}")
    return fields


def _to(dev: torch.device, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def fused_sma_sweep(close, fast, slow, *, t_real=None, cost: float = 0.0,
                    periods_per_year: int = 252,
                    table: str | None = None,
                    epilogue: str | None = None,
                    carry_out: bool = False,
                    device: str | torch.device = device_mod.DEFAULT_DEVICE,
                    ) -> Metrics:
    """Fused SMA-crossover sweep: ``(N, T)`` closes x ``(P,)`` param lanes.

    ``fast``/``slow`` are the *flat* per-combo window arrays (use
    :func:`~..parallel.sweep.product_grid`); windows are bar counts and
    must be integral. ``t_real`` gives each ticker's real length in a
    ragged batch whose closes are padded by repeating the last bar. Returns
    :class:`Metrics` with ``(N, P)`` fields on ``device`` (``"cuda"``
    unless the caller asks for the CPU).

    ``table`` (``"inline"``/``"hbm"``) and ``epilogue`` (``"scan"``,
    ``"scan:<B>"``, ``"ladder"``) are validated by the reference's rules,
    and an invalid value raises; on Hopper one kernel design serves every
    value (no table, one sequential pass per lane), so a valid value
    changes nothing. ``carry_out=True`` returns ``(metrics, carry)``: the
    kernel's metrics untouched and the streaming checkpoint of the sweep
    (:func:`..streaming.recurrent.build_carry` on the same device); it
    takes a uniform panel only, and with ``t_real`` raises ``ValueError``
    before the kernel runs.
    """
    dev = _prologue(carry_out, t_real, table, epilogue, device)
    (close,) = _panel(dev, close)
    N, T = close.shape
    fast_w, slow_w, warm = _grid_setup(fast, slow)
    tr = _check_t_real(t_real, N, T)
    planes = fused_sma(
        rolling.prefix_sum(close, 1).contiguous(),
        simple_returns(close).contiguous(),
        *_to(dev, tr, fast_w, slow_w, warm),
        cost=float(cost), ppy=int(periods_per_year))
    return _carry_out_tail(Metrics(*planes), carry_out, "sma_crossover",
                           {"close": close}, {"fast": fast, "slow": slow},
                           cost=cost, ppy=periods_per_year, epilogue=epilogue)


def _bollinger_family_sweep(close, window, k, *, machine: str, z_exit: float,
                            t_real, cost, periods_per_year, table, epilogue,
                            carry_out, device) -> Metrics:
    dev = _prologue(carry_out, t_real, table, epilogue, device)
    if carry_out and machine == "hysteresis" and float(z_exit) != 0.0:
        raise ValueError(
            "carry_out=True requires z_exit=0 for the bollinger machine "
            "(the streaming family follows models.bollinger, which exits "
            "at the rolling mean)")
    (close,) = _panel(dev, close)
    N, T = close.shape
    window, k = _flat(window), _flat(k)
    _same_length(window=window, k=k)
    _, win, _, warm = _window_setup(window, "windows", 0.0, 1)
    tr = _check_t_real(t_real, N, T)
    xc = close - row_mean(close, tr)
    cs = rolling.prefix_sum(close, 1)
    csx = rolling.prefix_sum(xc, 1)
    csx2 = rolling.prefix_sum(xc * xc, 1)
    planes = band_inline(close, cs, csx, csx2,
                         simple_returns(close).contiguous(),
                         *_to(dev, tr, win, k, warm), machine=machine,
                         z_exit=float(z_exit), cost=float(cost),
                         ppy=int(periods_per_year))
    return _carry_out_tail(
        Metrics(*planes), carry_out,
        "bollinger" if machine == "hysteresis" else "bollinger_touch",
        {"close": close}, {"window": window, "k": k}, cost=cost,
        ppy=periods_per_year, epilogue=epilogue)


def fused_bollinger_sweep(close, window, k, *, t_real=None,
                          z_exit: float = 0.0, cost: float = 0.0,
                          periods_per_year: int = 252,
                          table: str | None = None,
                          epilogue: str | None = None,
                          carry_out: bool = False,
                          device: str | torch.device =
                          device_mod.DEFAULT_DEVICE) -> Metrics:
    """Fused Bollinger mean-reversion sweep: ``(N, T)`` closes x ``(P,)``
    lanes (K2, hysteresis machine).

    ``window``/``k`` are flat per-combo arrays (:func:`product_grid`
    order); windows must be integral bar counts. Matches the generic
    ``run_sweep(..., "bollinger")`` path. The kernel forms each lane's z
    from the cumsum rows, whatever the valid ``table`` value. Other
    arguments as :func:`fused_sma_sweep`.
    """
    return _bollinger_family_sweep(
        close, window, k, machine="hysteresis", z_exit=z_exit, t_real=t_real,
        cost=cost, periods_per_year=periods_per_year, table=table,
        epilogue=epilogue, carry_out=carry_out, device=device)


def fused_bollinger_touch_sweep(close, window, k, *, t_real=None,
                                cost: float = 0.0,
                                periods_per_year: int = 252,
                                table: str | None = None,
                                epilogue: str | None = None,
                                carry_out: bool = False,
                                device: str | torch.device =
                                device_mod.DEFAULT_DEVICE) -> Metrics:
    """Fused band-touch sweep (K2, memoryless machine): long/short while
    outside the +-k band, flat inside. Same layout and arguments as
    :func:`fused_bollinger_sweep`."""
    return _bollinger_family_sweep(
        close, window, k, machine="touch", z_exit=0.0, t_real=t_real,
        cost=cost, periods_per_year=periods_per_year, table=table,
        epilogue=epilogue, carry_out=carry_out, device=device)


def fused_stochastic_sweep(close, high, low, window, band, *, t_real=None,
                           cost: float = 0.0, periods_per_year: int = 252,
                           epilogue: str | None = None,
                           carry_out: bool = False,
                           device: str | torch.device =
                           device_mod.DEFAULT_DEVICE) -> Metrics:
    """Fused stochastic-%K reversion sweep: ``(N, T)`` panels x ``(P,)``
    lanes (K2's stochastic entry, hysteresis machine with z_exit = 0 on the
    centered %K, whose channel the kernel builds from the highs and lows:
    no ``(N, W, T)`` table on the card).

    ``window``/``band`` are flat per-combo arrays; windows must be integral
    bar counts. Matches ``run_sweep(..., "stochastic")``.
    """
    dev = _prologue(carry_out, t_real, None, epilogue, device)
    close, high, low = _panel(dev, close, high, low)
    N, T = close.shape
    window, band = _flat(window), _flat(band)
    _same_length(window=window, band=band)
    grid = {"window": window, "band": band}
    _, win, widx, warm = _window_setup(window, "windows", 0.0, 1)
    lane, _, win, band, warm = window_major(widx, win, band, warm)
    tr = _check_t_real(t_real, N, T)
    planes = band_stoch(close, high, low, simple_returns(close).contiguous(),
                        *_to(dev, tr, win, band, warm, lane),
                        machine="hysteresis", z_exit=0.0, cost=float(cost),
                        ppy=int(periods_per_year))
    return _carry_out_tail(
        Metrics(*planes), carry_out, "stochastic",
        {"close": close, "high": high, "low": low}, grid, cost=cost,
        ppy=periods_per_year, epilogue=epilogue)


def _band_table_sweep(close, window, band, names, warm_offset: float,
                      z_table, *, t_real, cost, periods_per_year,
                      warm_scale: float = 1.0) -> Metrics:
    """K2's table entry, hysteresis machine with z_exit = 0, over the
    z-table ``z_table(windows)`` of the distinct windows, lanes
    window-major. ``window`` and ``band`` are the flat per-combo values,
    ``names`` their argument names for the error messages; each lane's
    warmup is ``warm_scale`` times its window plus ``warm_offset``."""
    N, T = close.shape
    window, band = _flat(window), _flat(band)
    _same_length(**dict(zip(names, (window, band))))
    windows, _, widx, warm = _window_setup(window, f"{names[0]}s",
                                           warm_offset, 1, warm_scale)
    lane, widx, band, warm = window_major(widx, band, warm)
    tr = _check_t_real(t_real, N, T)
    planes = band_table(z_table(windows), simple_returns(close).contiguous(),
                        *_to(close.device, tr, widx, band, warm, lane),
                        machine="hysteresis", z_exit=0.0, cost=float(cost),
                        ppy=int(periods_per_year))
    return Metrics(*planes)


def fused_vwap_sweep(close, volume, window, k, *, t_real=None,
                     cost: float = 0.0, periods_per_year: int = 252,
                     epilogue: str | None = None,
                     carry_out: bool = False,
                     device: str | torch.device =
                     device_mod.DEFAULT_DEVICE) -> Metrics:
    """Fused VWAP-deviation reversion sweep: ``(N, T)`` closes and volumes
    x ``(P,)`` lanes (K2's table entry, hysteresis machine with z_exit = 0
    on :func:`vwap_z_table`).

    ``window``/``k`` are flat per-combo arrays (:func:`product_grid` order);
    windows must be integral bar counts, and each lane's warmup is
    ``2 * window - 1`` (the VWAP needs ``window`` bars, its deviation's
    z-score another ``window``). A window longer than the history leaves
    its lanes flat. Matches ``run_sweep(..., "vwap_reversion")``.
    """
    dev = _prologue(carry_out, t_real, None, epilogue, device)
    close, volume = _panel(dev, close, volume)
    m = _band_table_sweep(
        close, window, k, ("window", "k"), -1.0,
        lambda w: vwap_z_table(close, volume, w, t_real), t_real=t_real,
        cost=cost, periods_per_year=periods_per_year, warm_scale=2.0)
    return _carry_out_tail(m, carry_out, "vwap_reversion",
                           {"close": close, "volume": volume},
                           {"window": window, "k": k}, cost=cost,
                           ppy=periods_per_year, epilogue=epilogue)


def fused_obv_sweep(close, volume, window, *, t_real=None, cost: float = 0.0,
                    periods_per_year: int = 252,
                    table: str | None = None,
                    epilogue: str | None = None,
                    carry_out: bool = False,
                    device: str | torch.device = device_mod.DEFAULT_DEVICE,
                    ) -> Metrics:
    """Fused OBV-trend sweep: ``(N, T)`` closes and volumes x ``(P,)``
    windows (K6).

    ``window`` is a flat per-combo array; windows must be integral bar
    counts. The OBV is :func:`~.rolling.obv_series`, the generic model's
    own, and its windowed mean takes the generic rolling mean's op order,
    so this matches ``run_sweep(..., "obv_trend")``. A valid ``table``
    changes nothing (the kernel forms each lane's SMA from the staged OBV
    cumsum row, K1's design). Other arguments as :func:`fused_sma_sweep`.
    """
    dev = _prologue(carry_out, t_real, table, epilogue, device)
    close, volume = _panel(dev, close, volume)
    N, T = close.shape
    _, win, _, warm = _window_setup(_flat(window), "windows", 0.0, 1)
    tr = _check_t_real(t_real, N, T)
    series = rolling.obv_series(close, volume).contiguous()
    planes = obv(series, rolling.prefix_sum(series, 1).contiguous(),
                 simple_returns(close).contiguous(),
                 *_to(dev, tr, win, warm), cost=float(cost),
                 ppy=int(periods_per_year))
    return _carry_out_tail(Metrics(*planes), carry_out, "obv_trend",
                           {"close": close, "volume": volume},
                           {"window": window}, cost=cost,
                           ppy=periods_per_year, epilogue=epilogue)


def _pairs_grid_setup(lookback, z_entry, z_exit):
    """The reference's ``_pairs_grid_setup`` without the one-hot and the
    padded lanes: the distinct lookbacks, each lane's row, entry band, exit
    band (``z_exit`` a scalar or per-combo) and warmup ``2 * lookback - 1``
    in f32, truncated. Returns ``(windows, widx, k, zx, warm)``."""
    lookback, z_entry = _flat(lookback), _flat(z_entry)
    z_exit = np.broadcast_to(np.asarray(z_exit, np.float32).reshape(-1),
                             lookback.shape).copy()
    _same_length(lookback=lookback, z_entry=z_entry, z_exit=z_exit)
    windows, _, widx, warm = _window_setup(lookback, "lookbacks", -1.0, 1,
                                           2.0)
    return windows, widx, z_entry, z_exit, warm


def fused_pairs_sweep(y_close, x_close, lookback, z_entry, *, t_real=None,
                      z_exit=0.0, cost: float = 0.0,
                      periods_per_year: int = 252,
                      epilogue: str | None = None,
                      carry_out: bool = False,
                      device: str | torch.device =
                      device_mod.DEFAULT_DEVICE) -> Metrics:
    """Fused rolling-OLS pairs sweep: ``(N, T)`` pair legs x ``(P,)`` lanes
    (K7; ``BASELINE.json`` configs[3]).

    ``lookback``/``z_entry`` are flat per-combo arrays (:func:`product_grid`
    order); ``z_exit`` is a scalar or a per-combo array. Lookbacks are bar
    counts and must be integral. ``t_real`` gives each pair's real length in
    a ragged group whose legs repeat their last bar. Matches
    :func:`~..models.pairs.run_pairs_sweep` within the reference's pairs
    budget: the tables take the generic path's formulas and op order
    (:func:`pairs_tables` on the CPU; on the card :func:`pairs_tables_cuda`,
    whose windowed sums are f64 differences rounded once, so a z at the
    band can land a bar apart from the generic path's f32 sums).
    """
    dev = _prologue(carry_out, t_real, None, epilogue, device)
    y_close, x_close = _panel(dev, y_close, x_close)
    N, T = y_close.shape
    windows, widx, k, zx, warm = _pairs_grid_setup(lookback, z_entry, z_exit)
    tr = _check_t_real(t_real, N, T)
    # The lanes' arrays go to the card before the tables' launch: a copy
    # from host memory waits for the card's stream, so after the launch it
    # would hold the host until the tables are built, and the card would
    # then idle while the host launches the tiles' build (window_tiles).
    lanes = _to(dev, tr, widx, k, zx, warm)
    z, hr = pairs_sweep_tables(y_close, x_close, windows)
    planes = pairs(z, hr, *lanes, cost=float(cost),
                   ppy=int(periods_per_year))
    return _carry_out_tail(
        Metrics(*planes), carry_out, "pairs",
        {"close": y_close, "close2": x_close},
        {"lookback": lookback, "z_entry": k, "z_exit": zx}, cost=cost,
        ppy=periods_per_year, epilogue=epilogue)


def fused_momentum_sweep(close, lookback, *, t_real=None, cost: float = 0.0,
                         periods_per_year: int = 252,
                         table: str | None = None,
                         epilogue: str | None = None,
                         carry_out: bool = False,
                         device: str | torch.device =
                         device_mod.DEFAULT_DEVICE) -> Metrics:
    """Fused time-series momentum sweep: ``(N, T)`` closes x ``(P,)`` lanes
    (K3's momentum entry). Lookbacks must be integral; the signal is exact.
    A valid ``table`` changes nothing (the kernel reads the staged close
    row). Other arguments as :func:`fused_sma_sweep`."""
    dev = _prologue(carry_out, t_real, table, epilogue, device)
    (close,) = _panel(dev, close)
    N, T = close.shape
    _, lb, _, warm = _window_setup(_flat(lookback), "lookbacks",
                                   1.0, 0)
    tr = _check_t_real(t_real, N, T)
    planes = momentum(close, simple_returns(close).contiguous(),
                      *_to(dev, tr, lb, warm), cost=float(cost),
                      ppy=int(periods_per_year))
    return _carry_out_tail(Metrics(*planes), carry_out, "momentum",
                           {"close": close}, {"lookback": lookback},
                           cost=cost, ppy=periods_per_year, epilogue=epilogue)


def _donchian_family_sweep(close, hi_src, lo_src, window, *, t_real, cost,
                           periods_per_year) -> Metrics:
    N, T = close.shape
    _, win, widx, warm = _window_setup(_flat(window), "windows", 1.0, 1)
    lane, _, win, warm = window_major(widx, win, warm)
    tr = _check_t_real(t_real, N, T)
    planes = donchian(close, hi_src, lo_src,
                      simple_returns(close).contiguous(),
                      *_to(close.device, tr, win, warm, lane),
                      cost=float(cost), ppy=int(periods_per_year))
    return Metrics(*planes)


def fused_donchian_sweep(close, window, *, t_real=None, cost: float = 0.0,
                         periods_per_year: int = 252,
                         table: str | None = None,
                         epilogue: str | None = None,
                         carry_out: bool = False,
                         device: str | torch.device =
                         device_mod.DEFAULT_DEVICE) -> Metrics:
    """Fused Donchian-breakout sweep on the close channel: ``(N, T)``
    closes x ``(P,)`` lanes (K3's donchian entry, which builds each
    window's channel and breakout sign on the card: no ``(N, W, T)`` table).
    Windows must be integral; channels are exact, so positions are the
    generic path's. A valid ``table`` changes nothing: the port runs one
    design (the reference's ``"inline"`` substrate, ``_don_kernel_inline``)
    whatever the value."""
    dev = _prologue(carry_out, t_real, table, epilogue, device)
    (close,) = _panel(dev, close)
    m = _donchian_family_sweep(
        close, close, close, window, t_real=t_real, cost=cost,
        periods_per_year=periods_per_year)
    return _carry_out_tail(m, carry_out, "donchian", {"close": close},
                           {"window": window}, cost=cost,
                           ppy=periods_per_year, epilogue=epilogue)


def fused_donchian_hl_sweep(close, high, low, window, *, t_real=None,
                            cost: float = 0.0, periods_per_year: int = 252,
                            table: str | None = None,
                            epilogue: str | None = None,
                            carry_out: bool = False,
                            device: str | torch.device =
                            device_mod.DEFAULT_DEVICE) -> Metrics:
    """Fused high/low-channel Donchian sweep: the breakout channel comes
    from the highs and lows; otherwise as :func:`fused_donchian_sweep`."""
    dev = _prologue(carry_out, t_real, table, epilogue, device)
    close, high, low = _panel(dev, close, high, low)
    m = _donchian_family_sweep(
        close, high, low, window, t_real=t_real, cost=cost,
        periods_per_year=periods_per_year)
    return _carry_out_tail(m, carry_out, "donchian_hl",
                           {"close": close, "high": high, "low": low},
                           {"window": window}, cost=cost,
                           ppy=periods_per_year, epilogue=epilogue)


def fused_rsi_sweep(close, period, band, *, t_real=None, cost: float = 0.0,
                    periods_per_year: int = 252,
                    epilogue: str | None = None,
                    carry_out: bool = False,
                    device: str | torch.device =
                    device_mod.DEFAULT_DEVICE) -> Metrics:
    """Fused RSI mean-reversion sweep: ``(N, T)`` closes x ``(P,)`` lanes
    (K2's table entry, hysteresis machine with z_exit = 0 on the centered
    RSI table).

    ``period``/``band`` are flat per-combo arrays (:func:`product_grid`
    order); periods must be integral bar counts. Matches
    ``run_sweep(..., "rsi")``: both paths build the RSI with the same ops.
    Other arguments as :func:`fused_sma_sweep`.
    """
    dev = _prologue(carry_out, t_real, None, epilogue, device)
    (close,) = _panel(dev, close)
    m = _band_table_sweep(
        close, period, band, ("period", "band"), 1.0,
        lambda p: rsi_z_table(close, p), t_real=t_real, cost=cost,
        periods_per_year=periods_per_year)
    return _carry_out_tail(m, carry_out, "rsi", {"close": close},
                           {"period": period, "band": band}, cost=cost,
                           ppy=periods_per_year, epilogue=epilogue)


def fused_keltner_sweep(close, high, low, window, k, *, t_real=None,
                        cost: float = 0.0, periods_per_year: int = 252,
                        epilogue: str | None = None,
                        carry_out: bool = False,
                        device: str | torch.device =
                        device_mod.DEFAULT_DEVICE) -> Metrics:
    """Fused Keltner-channel reversion sweep: ``(N, T)`` panels x ``(P,)``
    lanes (K2's table entry, hysteresis machine with z_exit = 0 on the
    ATR-normalized deviation from the EMA midline).

    ``window``/``k`` are flat per-combo arrays; windows must be integral bar
    counts. Matches ``run_sweep(..., "keltner")``: both paths build the
    deviation with the same ops.
    """
    dev = _prologue(carry_out, t_real, None, epilogue, device)
    close, high, low = _panel(dev, close, high, low)
    m = _band_table_sweep(
        close, window, k, ("window", "k"), 0.0,
        lambda w: keltner_z_table(close, high, low, w), t_real=t_real,
        cost=cost, periods_per_year=periods_per_year)
    return _carry_out_tail(m, carry_out, "keltner",
                           {"close": close, "high": high, "low": low},
                           {"window": window, "k": k}, cost=cost,
                           ppy=periods_per_year, epilogue=epilogue)


def fused_macd_sweep(close, fast, slow, signal, *, t_real=None,
                     cost: float = 0.0, periods_per_year: int = 252,
                     epilogue: str | None = None,
                     carry_out: bool = False,
                     device: str | torch.device =
                     device_mod.DEFAULT_DEVICE) -> Metrics:
    """Fused MACD signal-line crossover sweep: ``(N, T)`` closes x ``(P,)``
    lanes (K4).

    ``fast``/``slow``/``signal`` are flat per-combo span arrays
    (:func:`product_grid` order); spans and signal spans must be integral.
    Matches ``run_sweep(..., "macd")`` to the reference's flip-aware budget:
    the EMA table is the generic path's ladder (:func:`macd_sweep_table`),
    but the kernel carries the signal line sequentially, which rounds in
    another order than the generic ladder. Other arguments as
    :func:`fused_sma_sweep`.
    """
    dev = _prologue(carry_out, t_real, None, epilogue, device)
    (close,) = _panel(dev, close)
    N, T = close.shape
    spans, fidx, sidx, a_sig, warm = _macd_grid_setup(fast, slow, signal)
    tr = _check_t_real(t_real, N, T)
    # The lanes' arrays go to the card before the table's launch, as in
    # fused_pairs_sweep.
    lanes = _to(dev, tr, fidx, sidx, a_sig, warm)
    planes = macd(macd_sweep_table(close, spans),
                  simple_returns(close).contiguous(), *lanes,
                  cost=float(cost), ppy=int(periods_per_year))
    return _carry_out_tail(Metrics(*planes), carry_out, "macd",
                           {"close": close},
                           {"fast": fast, "slow": slow, "signal": signal},
                           cost=cost, ppy=periods_per_year, epilogue=epilogue)


def fused_trix_sweep(close, span, signal, *, t_real=None, cost: float = 0.0,
                     periods_per_year: int = 252,
                     epilogue: str | None = None,
                     carry_out: bool = False,
                     device: str | torch.device =
                     device_mod.DEFAULT_DEVICE) -> Metrics:
    """Fused TRIX signal-line crossover sweep: ``(N, T)`` closes x ``(P,)``
    lanes (K5, on the triple-EMA table of :func:`trix_sweep_table`).
    ``span``/``signal`` are flat per-combo span arrays; both must be
    integral. Matches ``run_sweep(..., "trix")`` to the same flip-aware
    budget as :func:`fused_macd_sweep`, for the same reason."""
    dev = _prologue(carry_out, t_real, None, epilogue, device)
    (close,) = _panel(dev, close)
    N, T = close.shape
    spans, widx, a_sig, warm = _trix_grid_setup(span, signal)
    tr = _check_t_real(t_real, N, T)
    # The lanes' arrays go to the card before the table's launch, as in
    # fused_pairs_sweep.
    lanes = _to(dev, tr, widx, a_sig, warm)
    planes = trix(trix_sweep_table(close, spans),
                  simple_returns(close).contiguous(), *lanes,
                  cost=float(cost), ppy=int(periods_per_year))
    return _carry_out_tail(Metrics(*planes), carry_out, "trix",
                           {"close": close}, {"span": span, "signal": signal},
                           cost=cost, ppy=periods_per_year, epilogue=epilogue)


# --- the family registry, paged mode and scenario batches -----------------


class _Family(NamedTuple):
    """One single-asset family's row: the OHLCV fields its wrapper consumes
    (in its argument order), its grid axes, the call ``(arrays, grid, **kw)
    -> Metrics``, the axes that hold bar counts (integral), and the generic
    path's channel view bound where it has one."""

    fields: tuple
    axes: tuple
    call: Callable
    window_axes: tuple = ("window",)
    max_window: float = math.inf


# The one registry of the families: the backend's routing rows
# (``rpc.compute._FUSED_STRATEGIES``) are built from it, so the fields the
# page pool gathers and the scenario generator feeds are the fields the
# wrappers take.
_PAGED_FAMILIES = {
    "sma_crossover": _Family(
        ("close",), ("fast", "slow"),
        lambda a, g, **kw: fused_sma_sweep(a[0], g["fast"], g["slow"],
                                           **kw),
        window_axes=("fast", "slow")),
    "bollinger": _Family(
        ("close",), ("window", "k"),
        lambda a, g, **kw: fused_bollinger_sweep(a[0], g["window"], g["k"],
                                                 **kw)),
    "bollinger_touch": _Family(
        ("close",), ("window", "k"),
        lambda a, g, **kw: fused_bollinger_touch_sweep(
            a[0], g["window"], g["k"], **kw)),
    "momentum": _Family(
        ("close",), ("lookback",),
        lambda a, g, **kw: fused_momentum_sweep(a[0], g["lookback"], **kw),
        window_axes=("lookback",)),
    "donchian": _Family(
        ("close",), ("window",),
        lambda a, g, **kw: fused_donchian_sweep(a[0], g["window"], **kw),
        max_window=donchian_model.MAX_WINDOW),
    "donchian_hl": _Family(
        ("close", "high", "low"), ("window",),
        lambda a, g, **kw: fused_donchian_hl_sweep(
            a[0], a[1], a[2], g["window"], **kw),
        max_window=donchian_model.MAX_WINDOW),
    "rsi": _Family(
        ("close",), ("period", "band"),
        lambda a, g, **kw: fused_rsi_sweep(a[0], g["period"], g["band"],
                                           **kw),
        window_axes=("period",)),
    "stochastic": _Family(
        ("close", "high", "low"), ("window", "band"),
        lambda a, g, **kw: fused_stochastic_sweep(
            a[0], a[1], a[2], g["window"], g["band"], **kw),
        max_window=stochastic_model.MAX_WINDOW),
    "keltner": _Family(
        ("close", "high", "low"), ("window", "k"),
        lambda a, g, **kw: fused_keltner_sweep(
            a[0], a[1], a[2], g["window"], g["k"], **kw)),
    "macd": _Family(
        ("close",), ("fast", "slow", "signal"),
        lambda a, g, **kw: fused_macd_sweep(
            a[0], g["fast"], g["slow"], g["signal"], **kw),
        window_axes=("fast", "slow", "signal")),
    "trix": _Family(
        ("close",), ("span", "signal"),
        lambda a, g, **kw: fused_trix_sweep(a[0], g["span"], g["signal"],
                                            **kw),
        window_axes=("span", "signal")),
    "vwap_reversion": _Family(
        ("close", "volume"), ("window", "k"),
        lambda a, g, **kw: fused_vwap_sweep(
            a[0], a[1], g["window"], g["k"], **kw)),
    "obv_trend": _Family(
        ("close", "volume"), ("window",),
        lambda a, g, **kw: fused_obv_sweep(a[0], a[1], g["window"], **kw)),
}

_PAGE_BARS_DEFAULT = 512


def paged_enabled() -> bool:
    """Switch of the paged route, read when a backend is made: on with
    ``DBX_PAGED=1``; unset or ``0`` sends every group to the dense stacks.
    Off by default, where the reference's is on: on the H100 a 500-job
    mixed-length batch ran slower paged than on the dense stacks."""
    return os.environ.get("DBX_PAGED", "0") not in ("", "0")


def resolve_page_bars() -> int:
    """The validated page size ``DBX_PAGE_BARS`` (default 512 bars): a
    positive multiple of 8."""
    raw = os.environ.get("DBX_PAGE_BARS")
    if not raw:
        return _PAGE_BARS_DEFAULT
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"DBX_PAGE_BARS={raw!r} is not an integer (expected a "
            "positive multiple of 8)") from None
    if v < 8 or v % 8:
        raise ValueError(
            f"DBX_PAGE_BARS={v} is unusable: pages must be a positive "
            "multiple of 8 bars (the f32 sublane tile)")
    return v


def paged_supported(strategy: str) -> bool:
    """True when ``strategy`` has a paged (and scenario) row."""
    return strategy in _PAGED_FAMILIES


def paged_fields(strategy: str) -> tuple:
    """The OHLCV fields the strategy's paged route gathers."""
    return _PAGED_FAMILIES[strategy].fields


def _paged_gather(pool: torch.Tensor, table: torch.Tensor,
                  t_real: torch.Tensor, T_run: int) -> torch.Tensor:
    """An ``(n, T_run)`` field block from the page pool: one
    ``index_select`` of each row's pages (``table``, ``(n, pages)`` slots),
    then every bar at or past a row's ``t_real`` replaced by its last real
    bar, so the block equals the dense repeat-last stack whatever the
    table's padded entries point at."""
    n = table.shape[0]
    rows = pool.index_select(0, table.reshape(-1)).reshape(n, -1)[:, :T_run]
    tr = t_real.long()[:, None]
    last = rows.gather(1, (tr - 1).clamp_min(0))
    bars = torch.arange(T_run, device=pool.device)[None, :]
    return torch.where(bars < tr, rows, last)


def fused_paged_sweep(strategy: str, pool: torch.Tensor, tables: dict,
                      t_real, grid: dict, *, cost: float = 0.0,
                      periods_per_year: int = 252,
                      epilogue: str | None = None) -> Metrics:
    """A (possibly mixed-length) group's sweep from the device page pool.

    ``pool`` is the ``(slots, page_bars)`` f32 pool, ``tables`` maps each
    field the family consumes to a host ``(n, max_pages)`` int32 slot table
    (a short row padded with any slot in bounds), ``t_real`` the rows' real
    lengths, ``grid`` the flat per-combo axes. The group is binned by page
    count; each bin is gathered at its own longest length
    (:func:`_paged_gather`) and swept by one call of the family's wrapper
    (a uniform bin without ``t_real``), so a row pads at most to its bin's
    longest, within one page of its own length. Rows come back in the
    caller's order; the metrics lie on the pool's device.

    The pool is written in place (``rpc.page_pool``): the caller holds the
    pool's writer lock from its ``prepare`` until this returns.
    """
    fam = _PAGED_FAMILIES.get(strategy)
    if fam is None:
        raise ValueError(
            f"strategy {strategy!r} has no paged execution row "
            f"(known: {sorted(_PAGED_FAMILIES)})")
    fields, call = fam.fields, fam.call
    missing = [f for f in fields if f not in tables]
    if missing:
        raise ValueError(
            f"paged sweep for {strategy!r} needs page tables for fields "
            f"{list(fields)}; missing {missing}")
    t_real = np.asarray(t_real, np.int32).reshape(-1)
    n = t_real.shape[0]
    if n == 0:
        raise ValueError("paged sweep over an empty group")
    dev = pool.device
    pages_of = -(-t_real // int(pool.shape[1]))
    kw = dict(cost=float(cost), periods_per_year=int(periods_per_year),
              epilogue=epilogue, device=dev)
    parts, order = [], []
    for p in np.unique(pages_of):
        idx = np.flatnonzero(pages_of == p)
        t_bin = t_real[idx]
        T_bin = int(t_bin.max())
        tr_dev = device_mod.upload(t_bin, dev)
        arrays = [_paged_gather(
            pool, device_mod.upload(
                np.asarray(tables[f], np.int64)[idx][:, :int(p)], dev),
            tr_dev, T_bin) for f in fields]
        uniform = bool((t_bin == T_bin).all())
        parts.append(call(arrays, grid, t_real=None if uniform else t_bin,
                          **kw))
        order.extend(idx.tolist())
    if len(parts) == 1:
        return parts[0]
    inv = np.empty(n, np.int64)
    inv[np.asarray(order)] = np.arange(n)
    inv = device_mod.upload(inv, dev)
    return Metrics(*(torch.cat(cols, dim=0)[inv] for cols in zip(*parts)))


def scenario_fused_enabled() -> bool:
    """Kill switch of the fused scenario route (``DBX_SCENARIO_FUSED=0``
    keeps scenario batches on the materialized rung; default on), read per
    call."""
    return os.environ.get("DBX_SCENARIO_FUSED", "1") != "0"


def scenario_supported(strategy: str) -> bool:
    """True when ``strategy`` can serve a scenario spec batch: the paged
    registry's families (the generator emits every OHLCV field)."""
    return strategy in _PAGED_FAMILIES


def fused_scenario_sweep(strategy: str, base: dict, seed_lo, seed_hi,
                         vol_scale, shock, grid: dict, *, n_bars: int,
                         block: int, regimes: int, cost: float = 0.0,
                         periods_per_year: int = 252,
                         epilogue: str | None = None,
                         device: str | torch.device =
                         device_mod.DEFAULT_DEVICE) -> Metrics:
    """K scenarios of one base panel through a family's sweep, the panels
    generated on the device and never stored.

    ``base`` maps the five OHLCV names to the real base's ``(T,)`` arrays;
    ``seed_lo``/``seed_hi`` are each scenario's :func:`seed_words
    <..scenarios.synth.seed_words>`, ``vol_scale``/``shock`` its generator
    modulation, all ``(K,)``; ``n_bars``, ``block`` and ``regimes`` are
    shared by the batch. The generator (:func:`..scenarios.synth.
    generate_rows`) yields chunks of rows bounded by a byte budget, and each
    chunk goes through one call of the family's wrapper: a row is one
    ticker, so row k is the sweep of scenario k alone. Returns
    :class:`Metrics` of ``(K, P)`` fields on ``device``.
    """
    from ..scenarios import synth

    fam = _PAGED_FAMILIES.get(strategy)
    if fam is None:
        raise ValueError(
            f"strategy {strategy!r} has no scenario execution row "
            f"(known: {sorted(_PAGED_FAMILIES)})")
    if n_bars < 1 or block < 1 or regimes < 1:
        raise ValueError(
            f"scenario sweep needs n_bars/block/regimes >= 1 "
            f"(got {n_bars}/{block}/{regimes})")
    if np.asarray(seed_lo).shape[0] == 0:
        raise ValueError("scenario sweep over an empty spec batch")
    fields, call = fam.fields, fam.call
    dev = device_mod.resolve(device)
    parts = []
    for _, rows in synth.generate_rows(
            base, seed_lo, seed_hi, vol_scale, shock, n_bars=int(n_bars),
            block=int(block), regimes=int(regimes), device=dev):
        parts.append(call([rows[f] for f in fields], grid, cost=float(cost),
                          periods_per_year=int(periods_per_year),
                          epilogue=epilogue, device=dev))
    if len(parts) == 1:
        return parts[0]
    return Metrics(*(torch.cat(cols, dim=0) for cols in zip(*parts)))
