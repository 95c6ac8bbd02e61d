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
