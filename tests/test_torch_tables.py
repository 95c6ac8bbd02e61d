"""The table builds of K5 and K7 on the CPU: what ``csrc/ema_rows.cu`` and
``csrc/pairs_tables.cu`` compute, held against the torch preps they
replace on the card and against an independent model.

- torch's CPU cumsum of f32 sums each row bar by bar in f64 and rounds at
  every bar; :func:`seq_cumsum` keeps those f64 sums.
- ``pairs_tables_plain`` (the kernel's plain version) equals a numpy model
  of the kernel bit for bit: f64 prefix sums, each windowed sum their f64
  difference rounded once to f32, the spread's mean in the kernel's lane
  tree (:func:`lane_tree_mean`), every other value the f32 formula of
  ``pairs_tables``. With f32 prefix sums and torch's mean in their place,
  the same formulas are the CPU path's ``pairs_tables`` bit for bit.
- The sweep over the kernel's tables holds the flip-aware budget (at most
  max(1, 1%) cells off by more than rtol=2e-3, atol=2e-4;
  ``chip_smoke.py``'s rule) against the generic path run in f64 (the
  witness), and is no farther from the witness than the CPU path's f32
  sums.
- A numpy model of ``dbx_ema_rows``' loop (the ladder's A as a constant a
  pass, squared each pass) equals ``trix_ema_table`` and, with one ladder,
  ``macd_ema_table`` bit for bit.
- K5's tiles give each lane its span's table row.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from distributed_backtesting_exploration_tpu_torch import roofline
from distributed_backtesting_exploration_tpu_torch.models import pairs
from distributed_backtesting_exploration_tpu_torch.ops import fused, rolling
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import assert_metrics_match, assert_window_tiles, to_np

CPU = torch.device("cpu")


def _seq_f64(v: np.ndarray) -> np.ndarray:
    """A numpy loop of sequential f64 prefix sums."""
    acc = np.zeros(v.shape[:-1], np.float64)
    out = np.empty(v.shape, np.float64)
    for t in range(v.shape[-1]):
        acc = acc + v[..., t].astype(np.float64)
        out[..., t] = acc
    return out


@pytest.mark.parametrize("shape,scale", [((64, 200), 1.0), ((4, 5, 180), 1e3),
                                         ((3, 1, 150), 1e-6)])
def test_torch_cpu_cumsum_is_sequential_f64_rounded_per_bar(shape, scale):
    # How the CPU path's prefix sums relate to the kernel's: torch's CPU
    # cumsum of f32 is the kernel's f64 chain rounded at every bar. If a
    # torch update changes how the CPU sums, this fails first.
    rng = np.random.default_rng(7)
    v = (rng.standard_normal(shape) * scale + scale).astype(np.float32)
    want = _seq_f64(v)
    got = to_np(torch.cumsum(torch.from_numpy(v), dim=-1))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want.astype(np.float32).view(np.uint32))
    prefix = fused.seq_cumsum(torch.from_numpy(v))
    assert prefix.dtype == torch.float64
    np.testing.assert_array_equal(to_np(prefix), want)


def _legs(n, T, seed, lens=None):
    closes = data.synthetic_ohlcv(2 * n, T, seed=seed).close
    for i, m in enumerate(lens if lens is not None else ()):
        closes[[i, n + i], m:] = closes[[i, n + i], m - 1:m]
    return torch.from_numpy(closes[:n]), torch.from_numpy(closes[n:])


# (n_pairs, T, lookbacks, seed, t_real)
PAIR_CASES = {
    "3x200": (3, 200, [10, 20, 30], 0, None),
    "T251": (2, 251, [5, 8, 16, 60], 3, None),
    "ragged": (3, 180, [6, 24], 13, [180, 120, 97]),
    "lookback-beyond-T": (2, 90, [7, 50, 120], 23, None),
}


def _lane_tree_np(s: np.ndarray) -> np.ndarray:
    """dbx_pairs_tables' spread mean in numpy: lane l of a warp sums the
    bars l, l + 32, ... in f64 (0 past T), the lanes fold at 16, 8, 4, 2
    and 1 (as __shfl_down), and the total over T in f64 rounds to f32."""
    T = s.shape[-1]
    lanes = np.zeros(s.shape[:-1] + (32,))
    for t0 in range(0, T, 32):
        for lane in range(32):
            t = t0 + lane
            lanes[..., lane] += s[..., t].astype(np.float64) if t < T else 0.0
    for off in (16, 8, 4, 2, 1):
        lanes[..., :off] = lanes[..., :off] + lanes[..., off:2 * off]
    return (lanes[..., :1] / T).astype(np.float32)


def _kernel_model(y, x, mx, my, lookbacks, sqrt=np.sqrt):
    """A numpy model of ``dbx_pairs_tables``' (z, hr), (N, W, T): for
    each lookback w, windowed sums ``f32(c[t] - c[t-w])`` of the f64
    prefix sums c (``np.cumsum`` of f64 is sequential), the f32 formulas
    of the rolling OLS, the spread and its z-score left to right, and the
    spread's mean in the lane tree; ``sqrt`` the f32 square root."""
    f32 = np.float32
    N, T = y.shape
    t = np.arange(T)
    mx, my = mx[:, None], my[:, None]

    def wsum(v, w):
        c = np.cumsum(v.astype(np.float64), axis=-1)
        lag = np.zeros_like(c)
        lag[..., w:] = c[..., :T - w] if w < T else 0.0
        return (c - lag).astype(f32)

    ry = y / np.concatenate([y[:, :1], y[:, :-1]], axis=1) - f32(1)
    rx = x / np.concatenate([x[:, :1], x[:, :-1]], axis=1) - f32(1)
    z_rows, hr_rows = [], []
    for w in lookbacks:
        fw = f32(w)
        xc, yc = x - mx, y - my
        sx, sy = wsum(xc, w), wsum(yc, w)
        sxx, sxy = wsum(xc * xc, w), wsum(xc * yc, w)
        cov = sxy - sx * sy / fw
        var = np.maximum(sxx - sx * sx / fw, f32(0))
        beta = cov / (var + f32(1e-12))
        alpha = (sy / fw + my) - beta * (sx / fw + mx)
        ok = t >= w - 1
        spread = np.where(ok, y - (alpha + beta * x), y)
        sc = spread - _lane_tree_np(spread)
        s1, s2 = wsum(sc, w), wsum(sc * sc, w)
        varz = np.maximum((s2 - s1 * s1 / fw) / fw, f32(0))
        mz = wsum(spread, w) / fw
        z = (spread - mz) / (sqrt(varz) + f32(1e-12))
        z_rows.append(np.where(t >= 2 * w - 2, z, f32(0)))
        bp = np.concatenate([np.zeros((N, 1), f32),
                             np.where(ok, beta, f32(0))[:, :-1]], axis=1)
        hr_rows.append((ry - bp * rx) / np.maximum(f32(1) + np.abs(bp),
                                                   f32(1)))
    return np.stack(z_rows, axis=1), np.stack(hr_rows, axis=1)


@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_pairs_tables_plain_equals_a_numpy_model_of_the_kernel(case):
    n, T, lookbacks, seed, lens = PAIR_CASES[case]
    y, x = _legs(n, T, seed, lens)
    mx, my = x.mean(1), y.mean(1)
    w = torch.from_numpy(np.asarray(lookbacks, np.int32))
    z, hr = fused.pairs_tables_plain(y, x, mx, my, w)
    # The kernel's square root and torch's on the card are IEEE; torch's f32
    # sqrt on the CPU is not always correctly rounded, so the model takes
    # torch's here.
    z_np, hr_np = _kernel_model(
        to_np(y), to_np(x), to_np(mx), to_np(my), lookbacks,
        sqrt=lambda v: to_np(torch.sqrt(torch.from_numpy(v))))
    assert z.dtype == hr.dtype == torch.float32
    np.testing.assert_array_equal(to_np(hr).view(np.uint32),
                                  hr_np.view(np.uint32))
    np.testing.assert_array_equal(to_np(z).view(np.uint32),
                                  z_np.view(np.uint32))
    # Before each row's z warmup both are exactly 0.
    t = torch.arange(T)
    for i, lb in enumerate(lookbacks):
        assert (z[:, i, t < 2 * lb - 2] == 0).all()


@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_pairs_tables_with_f32_sums_and_torch_mean_are_pairs_tables(case):
    # The kernel's formulas are the CPU path's: with its prefix sums rounded
    # to f32 at every bar (torch's CPU cumsum of f32), the legs' f64 means
    # (both paths' centering) and torch's mean in place of the lane tree,
    # every cell is bit-equal.
    n, T, lookbacks, seed, lens = PAIR_CASES[case]
    y, x = _legs(n, T, seed, lens)
    windows = np.float32(lookbacks)
    w = torch.from_numpy(windows.astype(np.int64))
    got = fused._pairs_z_hr(y, x, rolling.mean_f64(x, 1),
                            rolling.mean_f64(y, 1), w, w.float()[:, None],
                            lambda s: fused.seq_cumsum(s).float(),
                            lambda s: s.mean(dim=-1, keepdim=True))
    for a, b in zip(got, fused.pairs_tables(y, x, windows)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("T", [1, 31, 32, 77, 1260])
def test_lane_tree_mean_is_the_kernels_order(T):
    rng = np.random.default_rng(T)
    s = (rng.standard_normal((3, 2, T)) * 50 + 10).astype(np.float32)
    got = to_np(fused.lane_tree_mean(torch.from_numpy(s)))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _lane_tree_np(s).view(np.uint32))


def _pairs_grid(lookbacks, z_entries):
    g = sweep.product_grid(lookback=np.float32(lookbacks),
                           z_entry=np.float32(z_entries))
    return {k: to_np(v) for k, v in g.items()}


def _kernel_path(y, x, g, cost):
    """K7's plain version over ``pairs_tables_plain``: what the card's
    fused pairs sweep computes, on the CPU."""
    windows, widx, k, zx, warm = fused._pairs_grid_setup(
        g["lookback"], g["z_entry"], 0.0)
    w = torch.from_numpy(windows.astype(np.int32))
    z, hr = fused.pairs_tables_plain(y, x, rolling.mean_f64(x, 1)[:, 0],
                                     rolling.mean_f64(y, 1)[:, 0], w)
    tr = torch.full((y.shape[0],), y.shape[1], dtype=torch.int32)
    return fused.Metrics(*fused.pairs_plain(
        z, hr, tr, *fused._to(CPU, widx, k, zx, warm), cost=cost, ppy=252))


def _f64_witness(y, x, g, cost):
    """The generic pairs sweep with its legs in f64 (``chip_smoke.py``'s
    witness for pairs)."""
    y64, x64 = (leg.double()[:, None, :] for leg in (y, x))
    return sweep.map_param_chunks(
        g, y.shape[0] * y.shape[1], CPU,
        lambda sub: pairs.pair_backtest(y64, x64, sub, cost=cost))


def _n_off(got, ref, rtol=2e-3, atol=2e-4) -> int:
    """Cells off in any metric by more than ``atol + rtol |ref|``."""
    off = np.zeros(to_np(ref.sharpe).shape, dtype=bool)
    for name in ref._fields:
        a, b = to_np(getattr(got, name)), to_np(getattr(ref, name))
        off |= np.abs(a - b) > atol + rtol * np.abs(b)
    return int(off.sum())


def test_pairs_kernel_order_sweep_holds_the_flip_aware_budget():
    # The main path's golden batch shape cut to 8 pairs x 600 bars, the
    # bench's 500-combo grid: the kernel's tables against the generic path
    # in f64.
    y, x = _legs(8, 600, seed=132)
    g = _pairs_grid(np.arange(20, 70, 5), np.linspace(0.5, 3.0, 50))
    witness = _f64_witness(y, x, g, 1e-3)
    assert witness.sharpe.dtype == torch.float64
    assert_metrics_match(_kernel_path(y, x, g, 1e-3), witness, rtol=2e-3,
                         atol=2e-4, drift_counts=True)


def test_pairs_kernel_order_is_no_farther_from_the_f64_witness():
    # Where f32 sums cancel (the golden batch's 1260 bars), the kernel's
    # windowed sums, rounded once from f64, keep its sweep within the
    # budget of the f64 generic path and at least as near it as the CPU
    # path's f32 sums (which here drift past the budget: 44 of 2000 cells).
    y, x = _legs(4, 1260, seed=132)
    g = _pairs_grid(np.arange(20, 70, 5), np.linspace(0.5, 3.0, 50))
    witness = _f64_witness(y, x, g, 1e-3)
    got = _kernel_path(y, x, g, 1e-3)
    assert_metrics_match(got, witness, rtol=2e-3, atol=2e-4,
                         drift_counts=True)
    cpu = fused.fused_pairs_sweep(y, x, g["lookback"], g["z_entry"],
                                  cost=1e-3, device="cpu")
    assert _n_off(got, witness) <= _n_off(cpu, witness)


def test_pairs_sweep_tables_on_the_cpu_are_pairs_tables():
    y, x = _legs(2, 120, seed=5)
    windows = np.float32([6, 30])
    for a, b in zip(fused.pairs_sweep_tables(y, x, windows),
                    fused.pairs_tables(y, x, windows)):
        assert torch.equal(a, b)


def _ladder_model(x: np.ndarray, a: np.ndarray, ladders: int) -> np.ndarray:
    """dbx_ema_rows' loop in numpy f32: B = x at bar 0 and x * a after; per
    pass of step s, B[t] = A * B[t - s] + B[t] with A = q for t >= s and 0
    below (B[t - s] = 0 there), q = 1 - a, squared after each pass."""
    T = x.shape[-1]
    t = np.arange(T)
    a = a[:, None]
    b = np.broadcast_to(x[:, None, :], (x.shape[0], a.shape[0], T))
    for _ in range(ladders):
        b = np.where(t == 0, b, b * a).astype(np.float32)
        q = (np.float32(1.0) - a).astype(np.float32)
        s = 1
        while s < T:
            at = np.where(t >= s, q, np.float32(0.0))
            be = np.zeros_like(b)
            be[..., s:] = b[..., :-s]
            b = (at * be).astype(np.float32) + b
            q = (q * q).astype(np.float32)
            s *= 2
    return b


@pytest.mark.parametrize("T", [1, 2, 3, 64, 65, 200])
def test_ema_rows_loop_equals_trix_ema_table(T):
    close = data.synthetic_ohlcv(3, T, seed=T).close
    spans = np.float32([2, 5, 14, 90])
    decay = to_np(fused.ema_decay(CPU, spans))
    want = to_np(fused.trix_ema_table(torch.from_numpy(close), spans))
    got = _ladder_model(close, decay, 3)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_ema_rows_one_ladder_is_macd_ema_table():
    close = data.synthetic_ohlcv(2, 150, seed=4).close
    spans = np.float32([5, 12, 26, 40])
    decay = to_np(fused.ema_decay(CPU, spans))
    want = to_np(fused.macd_ema_table(torch.from_numpy(close), spans))
    got = _ladder_model(close - close[:, :1], decay, 1)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_ema_decay_is_the_ladders_decay():
    spans = np.float32([3, 9, 26])
    col = torch.from_numpy(spans)[:, None]
    want = rolling._decay(torch.zeros(1), col, None).reshape(-1)
    got = fused.ema_decay(CPU, spans)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, want)
    x = torch.from_numpy(data.synthetic_ohlcv(2, 80, seed=1).close)[:, None]
    assert torch.equal(rolling.ema_ladder(x, alpha=got[:, None]),
                       rolling.ema_ladder(x, span=col))


def test_trix_sweep_table_on_the_cpu_is_trix_ema_table():
    close = torch.from_numpy(data.synthetic_ohlcv(2, 100, seed=2).close)
    spans = np.float32([5, 9])
    assert torch.equal(fused.trix_sweep_table(close, spans),
                       fused.trix_ema_table(close, spans))


def _trix_rows(order: str):
    axes = roofline.bench_axes()["trix"]
    g = (roofline.product(axes) if order == "span-major" else
         roofline.product({"signal": axes["signal"], "span": axes["span"]}))
    _, widx, _, _ = fused._trix_grid_setup(g["span"], g["signal"])
    if order == "shuffled":
        widx = np.random.default_rng(3).permutation(widx)
    return widx


@pytest.mark.parametrize("lanes", [128, 512, 1024])
@pytest.mark.parametrize("order", ["span-major", "signal-major", "shuffled"])
def test_trix_tiles_give_each_lane_its_span(order, lanes):
    # The bench grid (10 spans x 100 lanes each): every tile lists at most
    # the 10 table rows, and each lane's index gives back its row.
    widx = torch.from_numpy(_trix_rows(order))
    tiles = fused.window_tiles(lanes, widx)
    assert_window_tiles(lanes, [widx], tiles)
    wins, counts, wi = tiles
    tile = torch.arange(widx.numel()) // lanes
    assert torch.equal(wins[tile, wi.long()], widx)
    assert int(counts.max()) <= 10
    if order == "span-major":
        assert int(counts.max()) <= -(-lanes // 100) + 1


def test_table_kernels_and_trix_bounds():
    # Trix's rate of change is a function of (ticker, span, bar): counted
    # once per span, the signal EMA per lane.
    assert roofline.OPS_WINDOW["trix"] == 3
    assert roofline.OPS_EACH_BAR["trix"] == 3
    assert roofline.config_model("trix", 10, 1000, 1260)["ops"] == (
        pytest.approx(25.03))
    assert roofline.ladder_passes(1) == 0
    assert roofline.ladder_passes(2) == 1
    assert roofline.ladder_passes(1260) == 11
    assert roofline.ladder_passes(1024) == 10
    # dbx_ema_rows at the bench shape: 3 ladders x (1 + 2 x 11) operations
    # a cell, above the table's bytes.
    ms, by = roofline.ema_rows_bound(500, 10, 1260, 3)
    cells = 500 * 10 * 1260
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 69 * cells / roofline.PEAK_FP32_OPS)
    # dbx_pairs_tables at the bench shape: the two tables' bytes.
    ms, by = roofline.pairs_tables_bound(1000, 10, 1260)
    assert by == "bytes"
    n_bytes = 4.0 * (2 * 1000 * 1260 + 2 * 1000 + 10) + 8.0 * 1000 * 10 * 1260
    assert ms == pytest.approx(1e3 * n_bytes / roofline.PEAK_HBM_BYTES)


# --- the kernels' lane and tile mappings (csrc/pairs_tables.cu, ema_rows.cu)
#
# Numpy models that walk the data the way the kernels do: rows dealt to
# lanes, warps and CTAs, bars in tiles of 32, the legs' and the spreads'
# chains carried across tiles, the spreads' lags gathered from a ring of
# tiles, z written over the spread, each row's EMA ladder striped over a
# warp's registers with its shuffles and in-lane shifts. Each must equal
# the plain version bit for bit: the mapping moves where the work runs, not
# one rounding.

_TILE = 32
_LEG_PAIRS = 8          # pairs a CTA of the legs' launch (4 chains each)
_SUM_ROWS = 32          # (pair, lookback) rows a CTA of the sums' launch
_MAX_RING = 16          # tiles of that launch's ring at most
_REGISTER_SIZES = (1, 2, 4, 8, 16, 24, 32, 40, 48, 56, 64)


def _ring_tiles(max_window: int) -> int:
    """csrc/pairs_tables.cu ``ring_tiles``: a power of two, at least
    ceil(max_window / 32) + 1 (the newest tile and the tiles its lags
    reach back to) and 4; 0 where that exceeds 16."""
    need = -(-max_window // _TILE) + 1
    r = 4
    while r < need:
        r *= 2
    return r if r <= _MAX_RING else 0


def _legs_model(y, x, mx, my):
    """Launch 1: 8 pairs a CTA, lane kind x 8 + p summing row kind x 8 + p
    of the tile's values (xc, yc, xc xc, xc yc) in f64, the chain carried
    from tile to tile; the (4, N, T) f64 prefix rows."""
    f32 = np.float32
    N, T = y.shape
    ctas = -(-N // _LEG_PAIRS)
    pair = np.arange(ctas)[:, None] * _LEG_PAIRS + np.arange(_LEG_PAIRS)
    live_pair = pair < N
    pc = np.minimum(pair, N - 1)
    mxp = np.where(live_pair, mx[pc], f32(0))[..., None]
    myp = np.where(live_pair, my[pc], f32(0))[..., None]
    c = np.zeros((4, N, T))
    acc = np.zeros((ctas, 32))
    for b in range(-(-T // _TILE)):
        bars = b * _TILE + np.arange(_TILE)
        live = live_pair[..., None] & (bars < T)
        bc = np.minimum(bars, T - 1)
        xs = np.where(live, x[pc][:, :, bc], f32(0))
        ys = np.where(live, y[pc][:, :, bc], f32(0))
        xc, yc = xs - mxp, ys - myp
        vals = np.concatenate([xc, yc, xc * xc, xc * yc], axis=1)
        assert vals.dtype == f32 and vals.shape == (ctas, 32, _TILE)
        sums = np.zeros((ctas, 32, _TILE))
        for i in range(min(_TILE, T - b * _TILE)):
            acc = acc + vals[:, :, i].astype(np.float64)
            sums[:, :, i] = acc
        for row in range(32):
            kind, p = divmod(row, _LEG_PAIRS)
            rows = np.flatnonzero(pair[:, p] < N)
            cols = bars[bars < T]
            c[kind, pair[rows, p][:, None], cols] = sums[rows, row][:, :cols.size]
    return c


def _spread_model(y, x, mx, my, lookbacks, c):
    """Launch 2: one warp a (pair, lookback) row, lane on bar, blocks of 32
    bars: the OLS from the f64 prefix rows' window sums (rounded once),
    the spread, the hedged return on the hedge ratio of the bar before
    (lane 0 takes the last block's lane 31), and the spread's mean in the
    lane tree. Returns the (N, W, T) spread, hr and the (N, W) means."""
    f32 = np.float32
    N, T = y.shape
    W = len(lookbacks)
    w = np.asarray(lookbacks, np.int64)[None, :, None]          # (1, W, 1)
    fw = w.astype(f32)
    mxn, myn = mx[:, None, None], my[:, None, None]
    lane = np.arange(32)
    spread = np.zeros((N, W, T), f32)
    hr = np.zeros((N, W, T), f32)
    acc = np.zeros((N, W, 32))
    beta_before = np.zeros((N, W), f32)
    tp_all = np.maximum(np.arange(T) - 1, 0)
    ry_all = y / y[:, tp_all] - f32(1)
    rx_all = x / x[:, tp_all] - f32(1)

    def wsum(kind, tc):
        lead = c[kind][:, None, :][:, :, tc]                        # (N, 1, 32)
        lag_at = tc[None, None, :] - w
        lag = np.where(lag_at >= 0, c[kind][:, None, :][
            np.arange(N)[:, None, None], 0, np.maximum(lag_at, 0)], 0.0)
        return (lead - lag).astype(f32)

    for t0 in range(0, T, 32):
        t = t0 + lane
        tc = np.minimum(t, T - 1)
        sx, sy, sxx, sxy = (wsum(k, tc) for k in range(4))
        cov = sxy - sx * sy / fw
        var = np.maximum(sxx - sx * sx / fw, f32(0))
        beta = cov / (var + f32(1e-12))
        alpha = (sy / fw + myn) - beta * (sx / fw + mxn)
        ok = tc[None, None, :] >= w - 1
        yt = y[:, tc][:, None, :]
        s = np.where(ok, yt - (alpha + beta * x[:, tc][:, None, :]), yt)
        beta_tbl = np.where(ok, beta, f32(0))
        bp = np.concatenate([beta_before[..., None], beta_tbl[..., :-1]], -1)
        beta_before = beta_tbl[..., 31]
        h = (ry_all[:, tc][:, None, :] - bp * rx_all[:, tc][:, None, :]) / \
            np.maximum(f32(1) + np.abs(bp), f32(1))
        live = t < T
        spread[..., t[live]] = s[..., live]
        hr[..., t[live]] = h[..., live]
        acc = acc + np.where(live, s.astype(np.float64), 0.0)
    for off in (16, 8, 4, 2, 1):
        acc[..., :off] = acc[..., :off] + acc[..., off:2 * off]
    return spread, hr, (acc[..., 0] / T).astype(f32)


def _sums_model(spread, means, lookbacks, ring, sqrt):
    """Launch 3: rows r = n W + j dealt 32 to a CTA; per tile, each row's
    lead and lag chains of its three sums (lane on row), then z for the tile
    (lane on bar). Each tile goes into a ring of `ring` slots (slot b &
    (ring - 1)) a tile ahead of its sums and its lags are gathered from the
    ring, z written over the spread; with ring 0 the lags come from the
    spread itself and z goes to its own table (4 slots hold the leads)."""
    f32 = np.float32
    N, W, T = spread.shape
    rows = N * W
    tiles = -(-T // _TILE)
    ctas = -(-rows // _SUM_ROWS)
    flat = spread.reshape(rows, T)            # a view: z goes over it
    z_out = flat if ring else np.zeros((rows, T), f32)
    slots = ring or 4
    r_of = np.arange(ctas)[:, None] * _SUM_ROWS + np.arange(_SUM_ROWS)
    live_row = r_of < rows
    rc = np.minimum(r_of, rows - 1)
    w = np.asarray(lookbacks, np.int64)[rc % W]                  # (C, 32)
    fw = w.astype(f32)
    m = np.where(live_row, means.reshape(-1)[rc], f32(0))
    lane = np.arange(_TILE)
    lead_ring = np.zeros((slots, ctas, _SUM_ROWS, _TILE), f32)
    lag_tiles = np.zeros((2, ctas, _SUM_ROWS, _TILE), f32)
    sum_tiles = np.zeros((2, 3, ctas, _SUM_ROWS, _TILE), f32)
    lead_acc = np.zeros((3, ctas, _SUM_ROWS))
    lag_acc = np.zeros((3, ctas, _SUM_ROWS))

    def store(b):
        t = b * _TILE + lane
        ok = live_row[..., None] & (t < T)
        lead_ring[b & (slots - 1)] = np.where(
            ok, flat[rc[..., None], np.minimum(t, T - 1)], f32(0))
        u = t[None, None, :] - w[..., None]
        ok_lag = ok & (u >= 0)
        uc = np.maximum(u, 0)
        if ring:
            slot = (uc // _TILE) & (ring - 1)
            got = lead_ring[slot, np.arange(ctas)[:, None, None],
                            np.arange(_SUM_ROWS)[None, :, None], uc % _TILE]
        else:
            got = flat[rc[..., None], np.minimum(uc, T - 1)]
        lag_tiles[b & 1] = np.where(ok_lag, got, f32(0))

    def value(k, s):
        if k == 0:
            return s
        sc = s - m
        return sc if k == 1 else sc * sc

    def chains(b):
        lead = lead_ring[b & (slots - 1)]
        lag = lag_tiles[b & 1]
        for i in range(min(_TILE, T - b * _TILE)):
            behind = b * _TILE + i >= w
            for k in range(3):
                v = value(k, lead[..., i])
                u = np.where(behind, value(k, lag[..., i]), f32(0))
                lead_acc[k] += v.astype(np.float64)
                lag_acc[k] += u.astype(np.float64)
                sum_tiles[b & 1, k, ..., i] = (lead_acc[k] - lag_acc[k])

    def z_tile(b):
        t = b * _TILE + lane
        s0, s1, s2 = sum_tiles[b & 1]
        f = fw[..., None]
        mz = s0 / f
        varz = np.maximum((s2 - s1 * s1 / f) / f, f32(0))
        zt = (lead_ring[b & (slots - 1)] - mz) / (sqrt(varz) + f32(1e-12))
        zt = np.where(t >= 2 * w[..., None] - 2, zt, f32(0))
        ok = live_row[..., None] & (t < T)
        ci, ri, li = np.nonzero(ok)
        z_out[r_of[ci, ri], t[li]] = zt[ci, ri, li]

    store(0)
    for b in range(tiles + 1):
        if b < tiles:
            chains(b)
        if b >= 1:
            z_tile(b - 1)
        if b + 1 < tiles:
            store(b + 1)
    return z_out.reshape(N, W, T)


def _pairs_mapping_model(y, x, mx, my, lookbacks, sqrt):
    """The three (or four) launches of ``dbx_pairs_tables`` in numpy, on
    numpy f32 inputs; returns (z, hr)."""
    c = _legs_model(y, x, mx, my)
    spread, hr, means = _spread_model(y, x, mx, my, lookbacks, c)
    ring = _ring_tiles(int(max(lookbacks)))
    z = _sums_model(spread.copy(), means, lookbacks, ring, sqrt)
    return z, hr


def _torch_sqrt(v):
    return to_np(torch.sqrt(torch.from_numpy(np.ascontiguousarray(v))))


def _check_pairs_mapping(n, T, lookbacks, seed, lens=None):
    y, x = _legs(n, T, seed, lens)
    mx, my = rolling.mean_f64(x, 1)[:, 0], rolling.mean_f64(y, 1)[:, 0]
    w = torch.from_numpy(np.asarray(lookbacks, np.int32))
    z, hr = fused.pairs_tables_plain(y, x, mx, my, w)
    z_np, hr_np = _pairs_mapping_model(to_np(y), to_np(x), to_np(mx),
                                       to_np(my), lookbacks, _torch_sqrt)
    np.testing.assert_array_equal(hr_np.view(np.uint32),
                                  to_np(hr).view(np.uint32))
    np.testing.assert_array_equal(z_np.view(np.uint32),
                                  to_np(z).view(np.uint32))


# (n_pairs, T, lookbacks): N off the 8 pairs a legs CTA takes, N x W off
# the 32 rows a sums CTA takes, lookbacks past T, one lookback, and one past
# the ring (the lags from memory).
PAIR_MAPPING_CASES = {
    "T1": (3, 1, [1, 5, 20]),
    "T2": (9, 2, [1, 2, 7]),
    "T31": (5, 31, [3, 30, 45]),
    "T33": (11, 33, [1, 16, 33]),
    "T251": (9, 251, [5, 8, 16, 60, 300]),
    "T1260-bench-lookbacks": (5, 1260, list(range(20, 70, 5))),
    "one-lookback": (33, 120, [7]),
    "lags-from-memory": (3, 700, [7, 50, 600]),
}


@pytest.mark.parametrize("case", sorted(PAIR_MAPPING_CASES))
def test_pairs_tables_launch_mapping_equals_plain(case):
    n, T, lookbacks = PAIR_MAPPING_CASES[case]
    _check_pairs_mapping(n, T, lookbacks, seed=T + n)


def test_pairs_tables_launch_mapping_on_ragged_rows():
    _check_pairs_mapping(10, 300, [6, 24, 97], seed=13,
                         lens=[300, 251, 170, 33, 1, 2, 299, 64, 65, 300])


@settings(max_examples=12, deadline=None)
@given(n=st.integers(1, 12), T=st.integers(1, 140),
       lookbacks=st.lists(st.integers(1, 160), min_size=1, max_size=6,
                          unique=True),
       seed=st.integers(0, 2**16))
def test_pairs_tables_launch_mapping_drawn(n, T, lookbacks, seed):
    _check_pairs_mapping(n, T, lookbacks, seed)


def test_ring_tiles_hold_every_lag():
    # The ring must hold the newest tile and the tiles its lags reach back
    # to (ceil(w / 32)), and at least the four a tile's lifetime spans; past
    # 16 tiles (lookbacks over 480 bars) the lags come from memory.
    assert [_ring_tiles(w) for w in (1, 32, 65, 96, 97, 224, 225, 480)] == [
        4, 4, 4, 4, 8, 8, 16, 16]
    assert _ring_tiles(481) == 0
    for w in range(1, 481):
        r = _ring_tiles(w)
        assert r & (r - 1) == 0 and r >= -(-w // _TILE) + 1


def _ema_registers(T: int) -> int:
    """csrc/ema_rows.cu ``registers``: the least compiled size that holds
    T bars 32 a register, 0 past 64 registers (2048 bars)."""
    need = -(-T // 32)
    return next((r for r in _REGISTER_SIZES if r >= need), 0)


def _ema_register_model(x: np.ndarray, a: np.ndarray,
                        ladders: int) -> np.ndarray:
    """dbx_ema_rows' register design in numpy f32: row (n, w) on one warp,
    bar t on lane t % 32 in register t // 32. Per ladder: B = x at bar 0
    and x a after; steps 1 .. 16 by a shuffle from lane (lane - s) % 32 of
    register r, or r - 1 where the receiving lane is below s (the sender,
    lane < 32 - s, keeps r); steps 32 k by a move from the lane's own
    register r - k; A is q above the step and 0 below, q = 1 - a squared
    each pass."""
    f32 = np.float32
    N, T = x.shape
    R = _ema_registers(T)
    assert R > 0
    lane = np.arange(32)
    bars = np.arange(R)[:, None] * 32 + lane                     # (R, 32)
    xs = np.where(bars < T, x[:, np.minimum(bars, T - 1)], f32(0))
    a_ = a[None, :, None, None]
    b = np.broadcast_to(xs[:, None], (N, a.shape[0], R, 32)).copy()
    for _ in range(ladders):
        b = np.where(bars == 0, b, b * a_)
        q = f32(1) - a_
        s = 1
        while s < 32 and s < T:
            new = b.copy()
            for r in range(R - 1, -1, -1):
                below = b[..., r - 1, :] if r > 0 else np.zeros_like(b[..., 0, :])
                send = np.where(lane < 32 - s, b[..., r, :], below)
                be = send[..., (lane - s) & 31]
                if r > 0:
                    new[..., r, :] = q[..., 0, :] * be + b[..., r, :]
                else:
                    on = lane >= s
                    new[..., 0, :] = (np.where(on, q[..., 0, :], f32(0)) *
                                      np.where(on, be, f32(0)) + b[..., 0, :])
            b, q, s = new, q * q, s * 2
        k = 1
        while k < R and 32 * k < T:
            new = b.copy()
            for r in range(R):
                new[..., r, :] = (q[..., 0, :] * b[..., r - k, :] + b[..., r, :]
                                  if r >= k else f32(0) * f32(0) + b[..., r, :])
            b, q, k = new, q * q, k * 2
    flat = b.reshape(N, a.shape[0], R * 32)
    return np.ascontiguousarray(flat[..., :T])


@pytest.mark.parametrize("T", [1, 2, 31, 33, 251, 1260])
def test_ema_register_mapping_equals_trix_and_macd_tables(T):
    # 3 tickers x 5 spans: 15 rows, off the 4 rows (warps) a CTA takes.
    close = data.synthetic_ohlcv(3, T, seed=T + 7).close
    spans = np.float32([2, 5, 9, 14, 90])
    decay = to_np(fused.ema_decay(CPU, spans))
    c = torch.from_numpy(close)
    got = _ema_register_model(close, decay, 3)
    want = to_np(fused.trix_ema_table(c, spans))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    got = _ema_register_model(close - close[:, :1], decay, 1)
    want = to_np(fused.macd_ema_table(c, spans))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@settings(max_examples=15, deadline=None)
@given(n=st.integers(1, 5), T=st.integers(1, 300),
       spans=st.lists(st.integers(2, 400), min_size=1, max_size=5,
                      unique=True),
       ladders=st.integers(1, 3), seed=st.integers(0, 2**16))
def test_ema_register_mapping_drawn(n, T, spans, ladders, seed):
    close = data.synthetic_ohlcv(n, T, seed=seed).close
    spans = np.float32(spans)
    decay = to_np(fused.ema_decay(CPU, spans))
    e = torch.from_numpy(close)[:, None, :]
    for _ in range(ladders):
        e = rolling.ema_ladder(e, span=torch.from_numpy(spans)[:, None])
    got = _ema_register_model(close, decay, ladders)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  to_np(e).view(np.uint32))


def test_ema_register_plan_covers_every_row_length():
    # Every row up to 2048 bars has a register plan that holds it (at most
    # a quarter of it padding past 8 registers); longer rows run staged.
    for T in range(1, 2049):
        r = _ema_registers(T)
        assert 32 * r >= T and (r <= 8 or 32 * r < 1.25 * T + 256)
    assert _ema_registers(2049) == 0
