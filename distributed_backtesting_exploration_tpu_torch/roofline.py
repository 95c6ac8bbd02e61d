"""The H100's peaks, the operation counts of the port's kernels and the
bench grids: one source for ``chip_smoke.py`` and the port bench
(:mod:`.bench`).

Bounds. A kernel's bound is the least time the card could take for its
work: the larger of its fp32 operations over the fp32 rate and the bytes
it must move (each input read once, each output written once) over the
memory rate. The fp32 peak (H100 SXM, NVIDIA data sheet, dense) counts a
fused multiply-add as two operations; the kernels are built with
-fmad=false and the counts below take each add, multiply, compare and
division as one, each a lane-cycle of its own, so single operations issue
at half the peak.
"""

from __future__ import annotations

import numpy as np

PEAK_FP32_FLOPS = 67e12
PEAK_FP32_OPS = PEAK_FP32_FLOPS / 2
# fp64 outside the tensor cores (same data sheet), counted alike.
PEAK_FP64_FLOPS = 34e12
PEAK_FP64_OPS = PEAK_FP64_FLOPS / 2
PEAK_HBM_BYTES = 3.35e12
# Streaming multiprocessors of the H100 SXM and the threads one holds at
# once (compute capability 9.0): a launch's CTAs run in waves of
# SMS x (resident CTAs an SM).
SMS = 132
THREADS_PER_SM = 2048

# Floating-point operations per (combo, bar) below the ticker's length,
# from csrc/metrics_tail.cuh: the PnL and metric updates (position change
# sub+abs 2, net mul+mul+sub 3, s1 add 1, s2 mul+add 2, downside min 1,
# its square mul+add 2, equity add 1 (1 + s1: the one cumulative sum), peak
# max 1, drawdown sub+floor 2, its quotient or, on the bars where it cannot
# raise mdd, the fused multiply-add that shows so 1, mdd max 1, turnover
# add 1, active/win count 2 = 20).
OPS_PER_BAR = 20
# Per (combo, bar) past the warmup, beside the metric update: K1
# (csrc/fused_sma.cu) the fast - slow difference and its sign; from
# csrc/band_machine.cu the machine (entry compares 2, state compares 2 = 4)
# of the inline, table, stochastic and pairs entries; from
# csrc/single_window.cu donchian the latch's two selects; macd and trix
# x - signal and its sign. K6 reads its window's sign; momentum's sign,
# which its kernel forms per lane, is a function of the lookback and counts
# in OPS_WINDOW.
OPS_SIGNAL = {"fused_sma": 2, "band_inline": 4, "band_table": 4,
              "band_stoch": 4, "momentum": 0, "donchian": 2, "macd": 2,
              "trix": 2, "obv": 0, "pairs": 4}
# Per (ticker, distinct window, bar) from the first bar a lane reads the
# window: work that is a function of the window, not of the lane, so the
# function needs it once per distinct window. K1 the SMA (sub, div = 2);
# K6 the SMA of the OBV, obv - sma and its sign (4); momentum the price
# change and its sign (2); K2's inline z (three window sums, mean div,
# s1*s1, two divs by w, s2 sub, clamp, sqrt, +eps, c-m, div = 13); the
# stochastic entry the %K from the levels (the channel's max and min, rng
# sub, its compare, c - lo, *100, rng + eps, div, -50 = 9); donchian the
# channel's max and min and the two breakout compares (4; the channel of
# bar t - 1 on bar t: the warmup is window + 1); trix the rate of change of
# the span's triple EMA (zero test, division, -1 = 3) and macd the macd
# line, the fast row minus the slow row (1), once per (ticker, distinct
# span or (fast, slow) pair, bar) on every bar from bar 0, where the
# signal line starts (csrc/ema_cross.cu).
OPS_WINDOW = {"fused_sma": 2, "band_inline": 13, "obv": 4, "momentum": 2,
              "band_stoch": 9, "donchian": 4, "trix": 3, "macd": 1}
# The channel entries' level build, per ticker, level above the rows and
# bar: one max and one min (csrc/extrema.cuh).
OPS_LEVEL = 2
# Per (combo, bar) below the ticker's length, beside the 20 of the metric
# update, from csrc/ema_cross.cu: the signal EMA (two muls, add = 3) of
# macd and trix. (Until macd ran on tiles its lanes formed the row
# difference each, 4 a (combo, bar).)
OPS_EACH_BAR = {"macd": 3, "trix": 3}

# The table kernels. csrc/ema_rows.cu, per (ticker, span, bar) and ladder:
# the input times the decay (1), then per pass of the ladder the B update's
# multiply and add (2; A is one product a pass). csrc/pairs_tables.cu, per
# (pair, lookback, bar): the OLS from the legs' four window sums (cov 3,
# var 4, beta 2, alpha 6) and the spread (3 and its select) = 19, the
# hedged return on the bar before's hedge ratio (select, mul, sub, abs,
# add, max, div = 7), the centred spread and its square (2), z from three
# window sums (varz 5, mz 1, sqrt, +eps, sub, div, select = 11) = 39 in
# fp32; per (pair, bar) the centred legs and their products (4) and the two
# legs' returns (4). In fp64: each prefix sum a conversion in and an add
# (2) per element, four rows a pair and three a (pair, lookback); each
# window sum a difference and its rounding to f32 (2), seven a (pair,
# lookback, bar); the spread's mean a conversion and an add (2) per
# element.
OPS_LADDER_INPUT = 1
OPS_LADDER_PASS = 2
OPS_PAIRS_ROW = 39
OPS_PAIRS_LEG = 8
OPS64_PREFIX = 2
OPS64_WINDOW = 2
OPS64_MEAN = 2

# K8 (csrc/stages.cu), per (lane, bar), by scaffold and stage: "all" counts
# on every bar the stage walks (T_pad bars for matmul and signal, the real
# bars for no_ladders and full), "signal" on those bars at or past the
# lane's warmup - 1. matmul: the SMA's row difference and the add (the
# bollinger z is a read and an add); signal: SMA sub and sign, bollinger
# the machine (4), then the product and the add; no_ladders: the metric
# update of OPS_PER_BAR less the equity, peak and drawdown (equity add,
# peak max, drawdown sub+floor and its test, mdd max = 6), and for
# bollinger also less the downside min and square and the hit counts (5),
# with the SMA's sub and sign or the machine past the warmup; full: the
# metric update with the same. touch is the ticker's table sum, one add an
# element (a function of the ticker, whatever the lanes).
STAGE_OPS = {
    "sma": {"matmul": (2, 0), "signal": (0, 4), "no_ladders": (14, 2),
            "full": (OPS_PER_BAR, 2)},
    "boll": {"matmul": (1, 0), "signal": (0, 6), "no_ladders": (9, 4),
             "full": (OPS_PER_BAR, 4)},
}


def bound_ms(ops: float, n_bytes: float,
             ops64: float = 0.0) -> tuple[float, str]:
    """Least time for ``ops`` single fp32 operations (and ``ops64`` fp64
    ones, each at its type's rate) and ``n_bytes`` of memory traffic on the
    H100, in ms, and which of the two bounds it."""
    t_ops = ops / PEAK_FP32_OPS + ops64 / PEAK_FP64_OPS
    t_bytes = n_bytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ladder_passes(T: int) -> int:
    """Passes of the EMA ladder over T bars: steps 1, 2, 4, ... below T,
    ceil(log2 T)."""
    return max(int(T) - 1, 0).bit_length()


def ema_rows_bound(N: int, W: int, T: int,
                   ladders: int) -> tuple[float, str]:
    """Bound of ``dbx_ema_rows`` (csrc/ema_rows.cu) on (N, T) rows and W
    decays: the ladders' operations on every (ticker, span, bar), against
    reading the rows and decays and writing the (N, W, T) table."""
    cells = float(N) * W * T
    ops = ladders * (OPS_LADDER_INPUT + OPS_LADDER_PASS * ladder_passes(T))
    return bound_ms(ops * cells, 4.0 * (N * T + W) + 4.0 * cells)


def pairs_tables_bound(N: int, W: int, T: int) -> tuple[float, str]:
    """Bound of ``dbx_pairs_tables`` (csrc/pairs_tables.cu) on N pairs of
    T bars and W lookbacks: its fp32 and fp64 operations, against reading
    the legs, their means and the lookbacks and writing z and hr."""
    rows, legs = float(N) * W * T, float(N) * T
    return bound_ms(OPS_PAIRS_ROW * rows + OPS_PAIRS_LEG * legs,
                    4.0 * (2 * legs + 2 * N + W) + 8.0 * rows,
                    OPS64_PREFIX * (3 * rows + 4 * legs)
                    + (7 * OPS64_WINDOW + OPS64_MEAN) * rows)


def signal_bars(tr, warm, limit=None) -> float:
    """Bars below ``limit`` (default each ticker's length ``tr``) at or past
    each lane's ``warm - 1``, summed over (ticker, lane); ``tr`` (N,) and
    ``warm`` (P,) integer arrays."""
    tr = np.asarray(tr, np.float64)[:, None]
    end = tr if limit is None else np.full_like(tr, float(limit))
    live = end - (np.asarray(warm, np.float64)[None, :] - 1)
    return float(np.minimum(np.clip(live, 0, None), end).sum())


def window_signal_bars(tr, warm, *windows) -> float:
    """Bars below each ticker's length ``tr`` from the first bar a lane
    reads each distinct window, summed over (ticker, window): a window's
    first bar is the least ``warm - 1`` of the lanes reading it. ``warm``
    and each of ``windows`` (a lane's windows: K1 its fast and slow ones)
    are (P,) integer arrays."""
    warm = np.asarray(warm)
    w = np.concatenate([np.asarray(a).reshape(-1) for a in windows])
    distinct, inv = np.unique(w, return_inverse=True)
    firsts = np.full(distinct.shape, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(firsts, inv, np.tile(warm.astype(np.int64), len(windows)))
    return signal_bars(tr, firsts)


def stage_bound(kind: str, stage: str, *, N: int, T_pad: int, W_pad: int,
                tr: int, warm) -> tuple[float, str]:
    """Bound of one K8 stage (``kind`` "sma" or "boll") on an (N, W_pad,
    T_pad) table, ``tr`` real bars and the lanes' (P,) warmups: the bytes
    it reads (the table; from signal on, the returns row too; the lanes'
    rows, bands and warmups) and writes (9 rows of (N, P) f32)."""
    P = len(warm)
    out = 4.0 * 9 * N * P
    table = 4.0 * N * W_pad * T_pad
    if stage == "touch":
        return bound_ms(N * W_pad * T_pad, table + out)
    lane_bytes = 4.0 * P * 3
    stage = {"signal_ladder": "signal", "full_ladder": "full"}.get(stage,
                                                                   stage)
    every, live = STAGE_OPS[kind][stage]
    limit = T_pad if stage in ("matmul", "signal") else tr
    tr_col = np.full((N,), tr)
    ops = every * N * P * limit + live * signal_bars(tr_col, warm, limit)
    n_bytes = table + out + lane_bytes
    if stage != "matmul":
        n_bytes += 4.0 * N * T_pad
    return bound_ms(ops, n_bytes)


# --- the bench grids -------------------------------------------------------

def bench_axes(n_params: int = 2000) -> dict[str, dict[str, np.ndarray]]:
    """Each fused strategy's grid axes as the reference's ``bench.py``
    builds them for ``DBX_BENCH_PARAMS=n_params``, in its argument order
    (the flat grid is their row-major product, ``product_grid``'s order).
    At the default 2000: sma_crossover 2000 combos, momentum and obv_trend
    2000, pairs 500, every other family 1000."""
    f32 = np.float32
    small = min(n_params, 1000)
    band = {"k": np.linspace(0.5, 3.0, max(small // 20, 1)).astype(f32),
            "window": np.arange(10, 50, 2, dtype=f32)}
    donchian = {"window": np.tile(np.arange(10, 135, dtype=f32),
                                  max(small // 125, 1))}
    return {
        "sma_crossover": {
            "fast": np.arange(5, 25, dtype=f32),
            "slow": np.arange(30, 30 + 2 * max(n_params // 20, 1), 2,
                              dtype=f32)},
        "bollinger": band,
        "bollinger_touch": band,
        "momentum": {"lookback": np.tile(np.arange(5, 130, dtype=f32),
                                         max(n_params // 125, 1))},
        "donchian": donchian,
        "donchian_hl": donchian,
        "vwap_reversion": band,
        "keltner": {"k": np.linspace(1.0, 3.0, max(small // 25, 1))
                    .astype(f32),
                    "window": np.arange(5, 55, 2, dtype=f32)},
        "stochastic": {"band": np.linspace(10, 40, max(small // 125, 1))
                       .astype(f32),
                       "window": np.arange(5, 130, dtype=f32)},
        "rsi": {"band": np.linspace(10, 30, max(small // 25, 1)).astype(f32),
                "period": np.arange(5, 55, 2, dtype=f32)},
        "macd": {"fast": np.arange(5, 15, dtype=f32),
                 "slow": np.arange(20, 60, 4, dtype=f32),
                 "signal": np.arange(5, 15, dtype=f32)},
        "trix": {"span": np.arange(5, 15, dtype=f32),
                 "signal": np.tile(np.arange(3, 13, dtype=f32), 10)},
        "obv_trend": {"window": np.tile(np.arange(5, 130, dtype=f32),
                                        max(n_params // 125, 1))},
        "pairs": {"lookback": np.arange(20, 70, 5, dtype=f32),
                  "z_entry": np.linspace(0.5, 3.0, 50).astype(f32)},
    }


def product(axes: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Flat per-combo arrays of the row-major product of ``axes`` in their
    order."""
    mesh = np.meshgrid(*axes.values(), indexing="ij")
    return {n: m.reshape(-1).astype(np.float32) for n, m in zip(axes, mesh)}


# --- the per-config model of the port bench --------------------------------

# Kernel entry of each fused strategy, and the (T)-long f32 input rows it
# reads per ticker as a function of its distinct windows W: K1 the cumsum
# and returns; K2 inline close, three cumsums and returns; the table
# entries W table rows and returns; the channel entries (stochastic,
# donchian) the close, the channel's two sources and returns; K6 obv, its
# cumsum and returns; K7 two rows a lookback.
ENTRY = {"sma_crossover": "fused_sma", "bollinger": "band_inline",
         "bollinger_touch": "band_inline", "stochastic": "band_stoch",
         "rsi": "band_table", "keltner": "band_table",
         "vwap_reversion": "band_table", "momentum": "momentum",
         "donchian": "donchian", "donchian_hl": "donchian", "macd": "macd",
         "trix": "trix", "obv_trend": "obv", "pairs": "pairs"}
_ROWS = {"fused_sma": lambda w: 2, "band_inline": lambda w: 5,
         "band_table": lambda w: w + 1, "band_stoch": lambda w: 4,
         "momentum": lambda w: 2, "donchian": lambda w: 4,
         "macd": lambda w: w + 1,
         "trix": lambda w: w + 1, "obv": lambda w: 3,
         "pairs": lambda w: 2 * w}


def config_model(strategy: str, n_distinct: int, P: int, T: int,
                 n_series: int | None = None) -> dict[str, float]:
    """Operations and bytes per (cell, bar) of one fused sweep's kernel:
    the metric update, the entry's signal work on every bar (an upper
    bound: warmup bars do less) with the per-window work shared by the
    lanes of each of the ``n_series`` series it runs on (default the
    ``n_distinct`` windows; macd's are its (fast, slow) pairs), its input
    rows (a function of the ``n_distinct`` windows) shared by the ticker's
    P lanes, and the 9 metrics of each cell."""
    entry = ENTRY[strategy]
    n_series = n_distinct if n_series is None else n_series
    ops = (OPS_PER_BAR + OPS_EACH_BAR.get(entry, 0) + OPS_SIGNAL[entry]
           + OPS_WINDOW.get(entry, 0) * n_series / P)
    n_bytes = 4.0 * _ROWS[entry](n_distinct) / P + 4.0 * 9 / T
    return {"ops": float(ops), "bytes": n_bytes}


def utilization(rate: float | None, n_bars: int,
                model: dict[str, float]) -> dict:
    """A config's roofline entry at backtests/s ``rate``: the shares of the
    H100's fp32 and memory peaks its (cell, bar)s take, which of the two
    would bound it, and its operations per (cell, bar). ``rate`` None (a
    run off the card) gives no shares."""
    t_ops = model["ops"] / PEAK_FP32_OPS
    t_bytes = model["bytes"] / PEAK_HBM_BYTES
    cell_bars = None if rate is None else rate * n_bars
    return {"fp32_util": None if rate is None else cell_bars * t_ops,
            "hbm_util": None if rate is None else cell_bars * t_bytes,
            "bound": "fp32" if t_ops >= t_bytes else "hbm",
            "ops_per_cell_bar": model["ops"]}
