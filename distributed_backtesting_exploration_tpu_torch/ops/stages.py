"""Roofline stage scaffolds: K8 of the port (reference ``bench.py``
``stage_call`` and ``boll_stage_call``, the ``roofline_stages`` config).

Each scaffold is a shipped kernel cut after one stage, so that timing
consecutive stages splits the kernel's time: the SMA crossover kernel
reading its table (the reference's ``ops/fused.py`` ``_kernel``) and the
bollinger kernel reading its z-table (``_boll_kernel``). The stages:

- ``prep``: no kernel, the table build alone (the sum of the table plus
  the first bar's return, in every lane);
- ``touch``: the sum of the ticker's whole table, in every lane, in an
  order set by the table's shape alone (:func:`_touch_plain`);
- ``matmul``: the sum over the padded bars of each lane's selected value
  (SMA: fast row minus slow row of the table; bollinger: its z row);
- ``signal`` (and ``signal_ladder``): the sum over the padded bars of
  position times return;
- ``no_ladders``: the one-pass reduction rows of the metrics tail, without
  equity, peak and drawdown;
- ``full`` (and ``full_ladder``): the shipped metrics, row 0 the sharpe.

The ``*_ladder`` stages name the reference's other substrate (a log-depth
ladder instead of a scan); the port has one design, a sequential pass per
lane, so they run the same kernel as their plain names.

Each call builds its inputs in the reference's op order
(:func:`sma_stage_inputs`, :func:`boll_stage_inputs`), and each kernel
entry dispatches on the inputs' device: on a CUDA tensor its ``*_cuda``
wrapper launches ``csrc/stages.cu``; on a CPU tensor its ``*_plain``
version computes the same 9 rows with tensor ops in the kernel's order, so
on the card the two agree to the bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from . import _kernels, fused, rolling
from .pnl import simple_returns

SMA_STAGES = ("prep", "touch", "matmul", "signal", "no_ladders", "full",
              "full_ladder")
BOLL_STAGES = ("prep", "touch", "matmul", "signal", "signal_ladder",
               "no_ladders", "full", "full_ladder")
LANES = (128, 256, 512, 1024)
# The scaffolds' cost and periods per year (bench.py passes these to the
# shipped tail and its stand-ins).
COST, PPY = 1e-3, 252
# Stage code of each kernel stage in csrc/stages.cu.
_CODES = {"touch": 0, "matmul": 1, "signal": 2, "signal_ladder": 2,
          "no_ladders": 3, "full": 4, "full_ladder": 4}
# cudaErrorInvalidConfiguration: the entries' answer to a table whose
# blocks do not fit a CTA's shared memory.
_NO_LAYOUT = 9
# touch's fixed order (csrc/stages.cu `touch_sum`): chunks a ticker's table
# is cut into; float4 accumulators of each of a warp's 32 lanes.
TOUCH_CHUNKS, TOUCH_ACCS, _WARP = 64, 4, 32


class StageInputs(NamedTuple):
    """A scaffold's prepared inputs: the ``(N, T_pad)`` returns of the
    padded close, the ``(N, W_pad, T_pad)`` table, each lane's ``(P,)``
    int32 row(s) in it (``row_b``: the SMA's slow row, None for
    bollinger), its entry band (bollinger, else None) and warmup, and the
    real bar count ``tr``."""

    r: torch.Tensor
    table: torch.Tensor
    row_a: torch.Tensor
    row_b: torch.Tensor | None
    k: torch.Tensor | None
    warm: torch.Tensor
    tr: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_last(close: torch.Tensor, T_pad: int) -> torch.Tensor:
    """``(N, T)`` closes padded to ``T_pad`` bars by repeating the last
    close, so the pad bars' returns are exactly 0."""
    pad = T_pad - close.shape[1]
    if not pad:
        return close
    return torch.cat([close, close[:, -1:].expand(-1, pad)], dim=1)


def _pad_w(table: torch.Tensor, W_pad: int) -> torch.Tensor:
    """Zero rows appended to an ``(N, W, T)`` table up to ``W_pad``."""
    N, W, T = table.shape
    if W == W_pad:
        return table.contiguous()
    return torch.cat([table, table.new_zeros((N, W_pad - W, T))], dim=1)


def _check_stage(stage: str, stages: tuple, lanes: int) -> None:
    if stage not in stages:
        raise ValueError(f"stage must be one of {stages}, got {stage!r}")
    if lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES}, got {lanes!r}")


def sma_stage_inputs(close, fast, slow, *,
                     device: str | torch.device = device_mod.DEFAULT_DEVICE
                     ) -> StageInputs:
    """The SMA scaffold's prep (``bench.py`` ``stage_call``): closes padded
    to ``T_pad = round_up(T, 8)``, the distinct-window SMA table of the
    padded close (the reference's ``_sma_table``) with its window axis
    zero-padded to a multiple of 8, the returns of the padded close, and
    each lane's fast and slow rows and warmup ``max(fast, slow)``."""
    dev = device_mod.resolve(device)
    (close,) = fused._panel(dev, close)
    N, T = close.shape
    fast_w, slow_w, warm = fused._grid_setup(fast, slow)
    windows = np.unique(np.concatenate([fast_w, slow_w]))
    close_p = _pad_last(close, _round_up(T, 8))
    table = fused.sma_table(rolling.prefix_sum(close_p, 1),
                            torch.from_numpy(windows.astype(np.int64)).to(dev))
    rows = fused._to(dev, np.searchsorted(windows, fast_w).astype(np.int32),
                     np.searchsorted(windows, slow_w).astype(np.int32), warm)
    return StageInputs(simple_returns(close_p).contiguous(),
                       _pad_w(table, _round_up(windows.size, 8)),
                       rows[0], rows[1], None, rows[2], T)


def boll_stage_inputs(close, window, k, *,
                      device: str | torch.device = device_mod.DEFAULT_DEVICE
                      ) -> StageInputs:
    """The bollinger scaffold's prep (``bench.py`` ``boll_stage_call``):
    closes padded to ``T_pad = round_up(T, 128)``, centered with the mean
    over their first T bars, the z-table of the distinct windows in the
    reference's op order (:func:`fused.boll_z_table`) with its window axis
    zero-padded to a multiple of 8, the returns of the padded close, and
    each lane's row, entry band and warmup (its window)."""
    dev = device_mod.resolve(device)
    (close,) = fused._panel(dev, close)
    N, T = close.shape
    window, k = fused._flat(window), fused._flat(k)
    fused._same_length(window=window, k=k)
    windows, _, widx, warm = fused._window_setup(window, "windows", 0.0, 1)
    close_p = _pad_last(close, _round_up(T, 128))
    xc = close_p - fused.row_mean(close_p, np.full(N, T))
    z = fused.boll_z_table(
        close_p, rolling.prefix_sum(close_p, 1), rolling.prefix_sum(xc, 1),
        rolling.prefix_sum(xc * xc, 1),
        torch.from_numpy(windows.astype(np.int64)).to(dev))
    lanes = fused._to(dev, widx, k, warm)
    return StageInputs(simple_returns(close_p).contiguous(),
                       _pad_w(z, _round_up(windows.size, 8)),
                       lanes[0], None, lanes[1], lanes[2], T)


def prep_value(inp: StageInputs) -> torch.Tensor:
    """The ``prep`` stage's ``(N, P)`` output: the table's sum plus the
    first bar's return (0), as the reference's scaffold returns it."""
    P = inp.row_a.shape[0]
    return (inp.table.sum(dim=(1, 2))[:, None]
            + inp.r[:, :1]).expand(-1, P)


# --- plain versions, in csrc/stages.cu's order ----------------------------

def _halve(x: torch.Tensor) -> torch.Tensor:
    """Fold the last axis (a power of 2) by halves: ``x[:h] + x[h:]`` until
    one is left, the order of a warp's butterfly as its lane 0 sees it."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _touch_plain(table: torch.Tensor, P: int) -> torch.Tensor:
    """The kernel's touch sum (``csrc/stages.cu`` ``touch_sum``), in an
    order set by the table's shape alone: the flattened table, as 16-byte
    words, is cut into TOUCH_CHUNKS chunks of q words (zeros past the end);
    in a chunk, lane i of a warp adds word ``(j * 4 + u) * 32 + i`` to its
    accumulator u on pass j, in order; each lane folds its 4 x 4 sums with
    a fixed tree, the warp's 32 by halves, the chunks' by halves."""
    N = table.shape[0]
    flat = table.reshape(N, -1)
    m4 = flat.shape[1] // 4
    q = -(-m4 // TOUCH_CHUNKS)
    per_pass = TOUCH_ACCS * _WARP
    passes = -(-q // per_pass)
    words = torch.nn.functional.pad(flat, (0, (TOUCH_CHUNKS * q - m4) * 4))
    words = words.view(N, TOUCH_CHUNKS, q, 4)
    words = torch.nn.functional.pad(words, (0, 0, 0, passes * per_pass - q))
    words = words.view(N, TOUCH_CHUNKS, passes, TOUCH_ACCS, _WARP, 4)
    acc = torch.zeros((N, TOUCH_CHUNKS, TOUCH_ACCS, _WARP, 4),
                      dtype=table.dtype, device=table.device)
    for j in range(passes):
        acc = acc + words[:, :, j]
    s = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    lane = (s[:, :, 0] + s[:, :, 1]) + (s[:, :, 2] + s[:, :, 3])
    return _halve(_halve(lane))[:, None].expand(N, P)


class _Reductions:
    """The ``no_ladders`` stage's one-pass sums (``ReductionAcc`` in
    ``csrc/stages.cu``): the metric update of ``_MetricState`` without the
    equity, peak and drawdown; ``down_hit`` adds the downside square sum
    and the hit counts of the SMA scaffold's rows."""

    def __init__(self, shape, dev, down_hit: bool):
        zero = torch.zeros(shape, dtype=torch.float32, device=dev)
        self.down_hit = down_hit
        self.prev = self.s1 = self.s2 = self.dsq = zero
        self.wins = self.active = self.turn = zero

    def step(self, pos, r_col, cost: float) -> None:
        prev = self.prev
        dp = (pos - prev).abs()
        net = prev * r_col - cost * dp
        self.s1 = self.s1 + net
        self.s2 = self.s2 + net * net
        if self.down_hit:
            down = net.clamp_max(0.0)
            self.dsq = self.dsq + down * down
            act = prev != 0
            self.active = self.active + act
            self.wins = self.wins + (act & (net > 0))
        self.turn = self.turn + dp
        self.prev = pos

    def rows(self, tr: int) -> torch.Tensor:
        # A tensor divisor: torch divides by a Python scalar through its
        # reciprocal, which rounds twice.
        nf = torch.full_like(self.s1, float(tr))
        mean = self.s1 / nf
        sd = torch.sqrt((self.s2 / nf - mean * mean).clamp_min(0.0))
        if self.down_hit:
            dstd = torch.sqrt(self.dsq / nf)
            hit = self.wins / (self.active + fused._EPS)
            rows = (self.s1, self.s2, mean, sd, dstd, hit, self.turn, sd,
                    self.s1)
        else:
            rows = (self.s1, self.s2, mean, sd, sd, self.s1, self.turn, sd,
                    self.s1)
        return torch.stack(rows, 0)


def _stage_plain(inp: StageInputs, stage: str, lanes: int) -> torch.Tensor:
    """Both scaffolds' plain version: the ``(9, N, P)`` rows of ``stage``
    (a one-value stage repeats its value in every row)."""
    N, _, T = inp.table.shape
    P = inp.row_a.shape[0]
    if stage == "touch":
        return _touch_plain(inp.table, P)[None].expand(9, N, P)
    tt = inp.table.permute(2, 0, 1)                             # (T, N, W)
    a = inp.row_a.long()
    sma = inp.row_b is not None
    b = inp.row_b.long() if sma else None

    def selected(t):
        return tt[t][:, a] - tt[t][:, b] if sma else tt[t][:, a]

    zero = torch.zeros((N, P), dtype=torch.float32, device=inp.r.device)
    if stage == "matmul":
        v = zero
        for t in range(T):
            v = v + selected(t)
        return v[None].expand(9, N, P)

    t_on = (inp.warm.long() - 1)[None, :]
    if sma:
        def position(state, t):
            return torch.where(t >= t_on, torch.sign(selected(t)), zero)
    else:
        k = inp.k[None, :]
        zx = torch.zeros((), dtype=torch.float32, device=inp.r.device)

        def position(state, t):
            nxt = fused._band_next(state, selected(t), k, zx, "hysteresis")
            return torch.where(t >= t_on, nxt, zero)

    if stage in ("signal", "signal_ladder"):
        v, state = zero, zero
        for t in range(T):
            state = position(state, t)
            v = v + state * inp.r[:, t:t + 1]
        return v[None].expand(9, N, P)
    if stage == "no_ladders":
        acc = _Reductions((N, P), inp.r.device, down_hit=sma)
    else:
        acc = fused._MetricState(
            torch.full((N,), inp.tr, dtype=torch.int32,
                       device=inp.r.device), P)
    for t in range(inp.tr):
        pos = position(acc.prev, t)
        if stage == "no_ladders":
            acc.step(pos, inp.r[:, t:t + 1], COST)
        else:
            acc.step(t, pos, inp.r[:, t:t + 1], COST)
    return acc.rows(inp.tr) if stage == "no_ladders" else acc.planes(PPY)


def sma_stage_plain(inp: StageInputs, *, stage: str,
                    lanes: int = 128) -> torch.Tensor:
    """Plain PyTorch version of ``dbx_sma_stage``: the ``(9, N, P)`` rows
    of ``stage`` on :func:`sma_stage_inputs`."""
    _check_stage(stage, SMA_STAGES[1:], lanes)
    return _stage_plain(inp, stage, lanes)


def boll_stage_plain(inp: StageInputs, *, stage: str,
                     lanes: int = 128) -> torch.Tensor:
    """Plain PyTorch version of ``dbx_boll_stage``: the ``(9, N, P)`` rows
    of ``stage`` on :func:`boll_stage_inputs`."""
    _check_stage(stage, BOLL_STAGES[1:], lanes)
    return _stage_plain(inp, stage, lanes)


# --- kernel wrappers ------------------------------------------------------

def _stage_cuda(kind: str, inp: StageInputs, stage: str,
                lanes: int) -> torch.Tensor:
    N, W, T = inp.table.shape
    P = inp.row_a.shape[0]
    f32, i32 = torch.float32, torch.int32
    # The SMA lanes' second row, or the bollinger lanes' entry bands.
    name, lane_b, dtype = (("row_b", inp.row_b, i32) if kind == "sma"
                           else ("k", inp.k, f32))
    if lane_b is None:
        raise ValueError(f"{kind}_stage_cuda needs {name}")
    fused._check_launch(
        f"{kind}_stage_cuda", inp.table.device, P,
        r=(inp.r, f32, (N, T)), table=(inp.table, f32, (N, W, T)),
        row_a=(inp.row_a, i32, (P,)), **{name: (lane_b, dtype, (P,))},
        warm=(inp.warm, i32, (P,)))
    if not 1 <= inp.tr <= T:
        raise ValueError(f"tr must lie in [1, {T}], got {inp.tr}")
    if T % 4 or inp.table.data_ptr() % 16 or inp.r.data_ptr() % 16:
        raise ValueError("the kernel copies 16-byte words: T must be a "
                         "multiple of 4 and table and r 16-byte aligned")
    out = torch.empty((9, N, P), dtype=f32, device=inp.table.device)
    if N and P:
        # fused._launch, but with the entry's refusal of a table too wide
        # for its blocks raised as the caller's error.
        label = f"{kind}_stage_{stage}_l{lanes}"
        entry = getattr(_kernels.stages_lib(), f"dbx_{kind}_stage")
        with torch.cuda.device(out.device):
            err = entry(inp.r.data_ptr(), inp.table.data_ptr(),
                        inp.row_a.data_ptr(), lane_b.data_ptr(),
                        inp.warm.data_ptr(), out.data_ptr(), N, T, W, P,
                        inp.tr, _CODES[stage], lanes, COST, PPY,
                        torch.cuda.current_stream().cuda_stream)
        if err == _NO_LAYOUT:
            raise ValueError(f"no layout of a ({W}, {T}) table at {lanes} "
                             "lanes fits a CTA's shared memory")
        if err != 0:
            raise RuntimeError(f"{label} kernel launch failed: CUDA error "
                               f"{err}")
        _kernels.LAUNCHES[label] += 1
    return out


def sma_stage_cuda(inp: StageInputs, *, stage: str,
                   lanes: int = 128) -> torch.Tensor:
    """Launch ``dbx_sma_stage`` (``csrc/stages.cu``) on PyTorch's current
    stream: same inputs and output as :func:`sma_stage_plain`, all on one
    CUDA device. Raises on a wrong device, dtype, shape or alignment, on a
    table too wide for the kernel's blocks (thousands of rows), and when
    the launch reports an error."""
    _check_stage(stage, SMA_STAGES[1:], lanes)
    return _stage_cuda("sma", inp, stage, lanes)


def boll_stage_cuda(inp: StageInputs, *, stage: str,
                    lanes: int = 128) -> torch.Tensor:
    """Launch ``dbx_boll_stage`` (``csrc/stages.cu``): same inputs and
    output as :func:`sma_stage_cuda`, on :func:`boll_stage_plain`'s
    inputs."""
    _check_stage(stage, BOLL_STAGES[1:], lanes)
    return _stage_cuda("boll", inp, stage, lanes)


def stage_occupancy(kind: str, inp: StageInputs, *, stage: str,
                    lanes: int = 128) -> dict:
    """The build report of K8's ``kind`` ("sma" or "boll") entry launched
    on ``inp`` as the wrappers launch it (``dbx_stage_occupancy``): its
    registers a thread, resident CTAs an SM, lanes, dynamic shared memory,
    cluster size, bars a block, block buffers and the clusters the card
    holds at once."""
    N, W, T = inp.table.shape
    info = (ctypes.c_int * 8)()
    err = _kernels.stages_lib().dbx_stage_occupancy(
        0 if kind == "sma" else 1, _CODES[stage], T, W, inp.row_a.shape[0],
        lanes, info)
    if err != 0:
        raise RuntimeError(f"dbx_stage_occupancy failed: CUDA error {err}")
    keys = ("registers", "ctas_per_sm", "lanes", "smem_bytes", "cluster",
            "block_bars", "ring", "max_active_clusters")
    return dict(zip(keys, info))


def sma_stage(inp: StageInputs, *, stage: str,
              lanes: int = 128) -> torch.Tensor:
    """K8a on the inputs' device: the kernel on CUDA, the plain version on
    the CPU."""
    fn = fused._on_device(sma_stage_plain, sma_stage_cuda, inp.r)
    return fn(inp, stage=stage, lanes=lanes)


def boll_stage(inp: StageInputs, *, stage: str,
               lanes: int = 128) -> torch.Tensor:
    """K8b on the inputs' device."""
    fn = fused._on_device(boll_stage_plain, boll_stage_cuda, inp.r)
    return fn(inp, stage=stage, lanes=lanes)


def sma_stage_call(close, fast, slow, *, stage: str, lanes: int = 128,
                   device: str | torch.device = device_mod.DEFAULT_DEVICE
                   ) -> torch.Tensor:
    """The SMA scaffold cut after ``stage`` (one of :data:`SMA_STAGES`) at
    ``lanes`` threads a CTA: ``(N, T)`` closes x flat ``(P,)`` fast and slow
    windows -> the ``(N, P)`` row 0 (for ``full``, the sharpe)."""
    _check_stage(stage, SMA_STAGES, lanes)
    inp = sma_stage_inputs(close, fast, slow, device=device)
    if stage == "prep":
        return prep_value(inp)
    return sma_stage(inp, stage=stage, lanes=lanes)[0]


def boll_stage_call(close, window, k, *, stage: str, lanes: int = 128,
                    device: str | torch.device = device_mod.DEFAULT_DEVICE
                    ) -> torch.Tensor:
    """The bollinger scaffold cut after ``stage`` (one of
    :data:`BOLL_STAGES`): ``(N, T)`` closes x flat ``(P,)`` windows and
    entry bands -> the ``(N, P)`` row 0."""
    _check_stage(stage, BOLL_STAGES, lanes)
    inp = boll_stage_inputs(close, window, k, device=device)
    if stage == "prep":
        return prep_value(inp)
    return boll_stage(inp, stage=stage, lanes=lanes)[0]
