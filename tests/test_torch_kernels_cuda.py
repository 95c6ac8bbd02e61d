"""K1-K8 and the table kernels (``csrc/*.cu``) against their plain PyTorch
versions on the card.

Marked ``cuda``: every test skips with a reason where no CUDA card is
present (the kernels have no CPU mode). On a machine with a card, and without
JAX (this file and ``torch_parity`` import none), run:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py

Both versions take the same inputs (cumsums, returns, OBV rows, the raw
rows of the channel entries, z-, EMA or pairs tables), so positions are
identical (n_trades and turnover bit-equal) and the other metrics agree at
rtol=2e-4, atol=2e-5; the window-major entries (K2's table and stochastic
entries, K3's donchian) take their lanes sorted by window, as their sweeps
pass them, and must be bit-equal in every metric, as must the tile entries
(K1, K2's inline entry, K5 and K6, which share each window's value across
the lanes of a CTA) at every CTA width, and K3's momentum entry. On returns
that drive equity to +-inf and NaN, K1, momentum and K5 give NaN where
their plain versions do and every other value bit-equal. The table kernels
(``dbx_ema_rows``, ``dbx_pairs_tables``) equal their plain versions
(``trix_ema_table`` and ``macd_ema_table``, ``pairs_tables_plain``) bit
for bit, on rows in registers or staged in shared memory and on long rows
in device memory.
"""

import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu_torch.models import pairs
from distributed_backtesting_exploration_tpu_torch.ops import (
    _kernels, fused, rolling, stages)
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import ATOL, RTOL, assert_metrics_match, crafted_returns

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA kernels with no "
                    "CPU mode")
    return torch.device("cuda")


def _inputs(dev, close, fast_axis, slow_axis, t_real=None):
    g = sweep.product_grid(fast=np.float32(fast_axis),
                           slow=np.float32(slow_axis))
    fw, sw, warm = fused._grid_setup(g["fast"].numpy(), g["slow"].numpy())
    tr = fused._check_t_real(t_real, *close.shape)
    c = torch.as_tensor(close, device=dev)
    return (torch.cumsum(c, 1).contiguous(),
            fused.simple_returns(c).contiguous(),
            *(torch.from_numpy(a).to(dev) for a in (tr, fw, sw, warm)))


def _assert_kernel_matches_plain(inputs, cost, kernel=None, plain=None,
                                 ref_inputs=None, exact=False, **kw):
    kernel = kernel or fused.fused_sma_cuda
    plain = plain or fused.fused_sma_plain
    got = kernel(*inputs, cost=cost, ppy=252, **kw)
    ref = plain(*(ref_inputs or inputs), cost=cost, ppy=252, **kw)
    torch.cuda.synchronize()
    for k, name in enumerate(fused.Metrics._fields):
        a, b = got[k].cpu().numpy(), ref[k].cpu().numpy()
        assert np.isfinite(a).all(), name
        if exact or name in ("n_trades", "turnover"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("n,T,fast,slow,cost,seed", [
    (3, 200, [3, 5, 8], [13, 21], 1e-3, 0),
    (2, 251, list(range(3, 14)), list(range(20, 44, 2)), 1e-3, 5),
    (1, 137, [5], [20], 0.0, 7),
    (2, 64, [5, 30], [40, 90], 1e-3, 2),          # windows longer than T
    (2, 13000, [5, 50], [100, 200], 1e-3, 4),     # rows too long to stage
])
def test_kernel_matches_plain(cuda, n, T, fast, slow, cost, seed):
    close = data.synthetic_ohlcv(n, T, seed=seed).close
    _assert_kernel_matches_plain(_inputs(cuda, close, fast, slow), cost,
                                 exact=True)


def test_kernel_matches_plain_ragged(cuda):
    close = data.synthetic_ohlcv(3, 300, seed=9).close
    lens = np.asarray([300, 251, 170])
    for i, n in enumerate(lens):
        close[i, n:] = close[i, n - 1]
    _assert_kernel_matches_plain(
        _inputs(cuda, close, [3, 5, 8], [13, 21], lens), 1e-3, exact=True)


def test_launch_counter_counts_kernel_launches_only(cuda):
    close = data.synthetic_ohlcv(2, 100, seed=1).close
    inputs = _inputs(cuda, close, [3, 4], [10, 12])
    _kernels.reset_launch_counts()
    fused.fused_sma_plain(*inputs, cost=0.0, ppy=252)
    assert _kernels.LAUNCHES["fused_sma"] == 0
    fused.fused_sma_cuda(*inputs, cost=0.0, ppy=252)
    fused.fused_sma_sweep(close, [3.0], [10.0], device="cuda")
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["fused_sma"] == 2


def test_wrapper_checks_its_inputs(cuda):
    close = data.synthetic_ohlcv(2, 50, seed=1).close
    cs, r, tr, fw, sw, warm = _inputs(cuda, close, [3], [10])
    with pytest.raises(TypeError, match="float32"):
        fused.fused_sma_cuda(cs.double(), r, tr, fw, sw, warm, cost=0.0,
                             ppy=252)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.cat([cs, cs], 1)[:, ::2]
        fused.fused_sma_cuda(wide, r, tr, fw, sw, warm, cost=0.0, ppy=252)
    with pytest.raises(ValueError, match="shape"):
        fused.fused_sma_cuda(cs, r[:1], tr, fw, sw, warm, cost=0.0, ppy=252)
    with pytest.raises(ValueError, match="is on"):
        fused.fused_sma_cuda(cs, r, tr.cpu(), fw, sw, warm, cost=0.0,
                             ppy=252)


def _panel(dev, n, T, seed, lens=None):
    p = data.synthetic_ohlcv(n, T, seed=seed)
    if lens is not None:
        for f in p:
            for i, m in enumerate(lens):
                f[i, m:] = f[i, m - 1]
    close, high, low = (torch.as_tensor(f, device=dev).contiguous()
                        for f in (p.close, p.high, p.low))
    tr = torch.from_numpy(fused._check_t_real(lens, n, T)).to(dev)
    return close, high, low, tr, fused.simple_returns(close).contiguous()


def _band_inline_inputs(dev, n, T, seed, lens=None, ks=(0.5, 1.0, 2.0),
                        windows=(5, 10, 20, 40)):
    close, _, _, tr, r = _panel(dev, n, T, seed, lens)
    g = sweep.product_grid(k=np.float32(ks), window=np.float32(windows))
    _, win, _, warm = fused._window_setup(g["window"].numpy(), "windows",
                                          0.0, 1)
    xc = close - close.mean(1, keepdim=True)
    rows = (close, torch.cumsum(close, 1), torch.cumsum(xc, 1),
            torch.cumsum(xc * xc, 1), r)
    return (*(x.contiguous() for x in rows), tr,
            *fused._to(dev, win, g["k"].numpy(), warm))


def _lanes(dev, widx, *per_lane):
    """Per-lane arrays in window-major slot order, as the sweeps pass them,
    then ``lane``."""
    lane, _, *sorted_ = fused.window_major(widx, *per_lane)
    return (*fused._to(dev, *sorted_), *fused._to(dev, lane))


def _stoch_grid(bands=(15, 30), windows=(1, 5, 14, 30, 300)):
    g = sweep.product_grid(band=np.float32(bands), window=np.float32(windows))
    return fused._window_setup(g["window"].numpy(), "windows", 0.0, 1), g


def _band_table_inputs(dev, n, T, seed, lens=None):
    # The table entry on the stochastic %K table.
    close, high, low, tr, r = _panel(dev, n, T, seed, lens)
    (windows, _, widx, warm), g = _stoch_grid()
    z = fused.stochastic_z_table(close, high, low, windows)
    return (z, r, tr, *_lanes(dev, widx, widx, g["band"].numpy(), warm))


def _band_stoch_inputs(dev, n, T, seed, lens=None, **grid):
    close, high, low, tr, r = _panel(dev, n, T, seed, lens)
    (_, win, widx, warm), g = _stoch_grid(**grid)
    return (close, high, low, r, tr,
            *_lanes(dev, widx, win, g["band"].numpy(), warm))


def _momentum_inputs(dev, n, T, seed, lens=None, lookbacks=(1, 5, 21, 300)):
    close, _, _, tr, r = _panel(dev, n, T, seed, lens)
    _, lb, _, warm = fused._window_setup(np.float32(lookbacks),
                                         "lookbacks", 1.0, 0)
    return (close, r, tr, *fused._to(dev, lb, warm))


def _donchian_inputs(dev, n, T, seed, lens=None,
                     windows=(10, 3, 55, 10, 1, 300)):
    close, high, low, tr, r = _panel(dev, n, T, seed, lens)
    _, win, widx, warm = fused._window_setup(np.float32(windows), "windows",
                                             1.0, 1)
    return (close, high, low, r, tr, *_lanes(dev, widx, win, warm))


def _rsi_table_inputs(dev, n, T, seed, lens=None):
    close, _, _, tr, r = _panel(dev, n, T, seed, lens)
    g = sweep.product_grid(band=np.float32([10, 25]),
                           period=np.float32([5, 14, 30]))
    periods, _, widx, warm = fused._window_setup(g["period"].numpy(),
                                                 "periods", 1.0, 1)
    z = fused.rsi_z_table(close, periods)
    return (z, r, tr, *_lanes(dev, widx, widx, g["band"].numpy(), warm))


def _keltner_table_inputs(dev, n, T, seed, lens=None):
    close, high, low, tr, r = _panel(dev, n, T, seed, lens)
    g = sweep.product_grid(k=np.float32([1.0, 2.0]),
                           window=np.float32([5, 20, 60]))
    windows, _, widx, warm = fused._window_setup(g["window"].numpy(),
                                                 "windows", 0.0, 1)
    z = fused.keltner_z_table(close, high, low, windows)
    return (z, r, tr, *_lanes(dev, widx, widx, g["k"].numpy(), warm))


def _macd_inputs(dev, n, T, seed, lens=None, fast=(5, 12),
                 slow=(20, 26, 300), signals=(3, 9)):
    close, _, _, tr, r = _panel(dev, n, T, seed, lens)
    g = sweep.product_grid(fast=np.float32(fast), signal=np.float32(signals),
                           slow=np.float32(slow))
    spans, fidx, sidx, a_sig, warm = fused._macd_grid_setup(
        g["fast"].numpy(), g["slow"].numpy(), g["signal"].numpy())
    return (fused.macd_ema_table(close, spans), r, tr,
            *fused._to(dev, fidx, sidx, a_sig, warm))


def _trix_inputs(dev, n, T, seed, lens=None, spans=(3, 8, 100),
                 signals=(2, 9)):
    close, _, _, tr, r = _panel(dev, n, T, seed, lens)
    g = sweep.product_grid(span=np.float32(spans), signal=np.float32(signals))
    spans, widx, a_sig, warm = fused._trix_grid_setup(g["span"].numpy(),
                                                      g["signal"].numpy())
    return (fused.trix_ema_table(close, spans), r, tr,
            *fused._to(dev, widx, a_sig, warm))


def _close_volume(dev, n, T, seed, lens=None):
    p = data.synthetic_ohlcv(n, T, seed=seed)
    close, volume = p.close, p.volume
    for f in (close, volume):
        for i, m in enumerate(lens if lens is not None else ()):
            f[i, m:] = f[i, m - 1]
    close, volume = (torch.as_tensor(f, device=dev).contiguous()
                     for f in (close, volume))
    tr = torch.from_numpy(fused._check_t_real(lens, n, T)).to(dev)
    return close, volume, tr, fused.simple_returns(close).contiguous()


def _obv_inputs(dev, n, T, seed, lens=None, windows=(3, 8, 20, 8, 300)):
    close, volume, tr, r = _close_volume(dev, n, T, seed, lens)
    _, win, _, warm = fused._window_setup(np.float32(windows), "windows",
                                          0.0, 1)
    series = rolling.obv_series(close, volume).contiguous()
    return (series, torch.cumsum(series, 1).contiguous(), r, tr,
            *fused._to(dev, win, warm))


def _vwap_table_inputs(dev, n, T, seed, lens=None):
    close, volume, tr, r = _close_volume(dev, n, T, seed, lens)
    g = sweep.product_grid(k=np.float32([1.0, 2.0]),
                           window=np.float32([6, 20, 60]))
    windows, _, widx, warm = fused._window_setup(g["window"].numpy(),
                                                 "windows", -1.0, 1, 2.0)
    z = fused.vwap_z_table(close, volume, windows)
    return (z, r, tr, *_lanes(dev, widx, widx, g["k"].numpy(), warm))


def _pairs_inputs(dev, n, T, seed, lens=None, lookbacks=(5, 20, 300)):
    closes = data.synthetic_ohlcv(2 * n, T, seed=seed).close
    for i, m in enumerate(lens if lens is not None else ()):
        closes[[i, n + i], m:] = closes[[i, n + i], m - 1:m]
    y, x = (torch.as_tensor(c, device=dev).contiguous()
            for c in (closes[:n], closes[n:]))
    g = sweep.product_grid(lookback=np.float32(lookbacks),
                           z_entry=np.float32([0.5, 1.5]),
                           z_exit=np.float32([0.0, 0.5]))
    windows, widx, k, zx, warm = fused._pairs_grid_setup(
        g["lookback"].numpy(), g["z_entry"].numpy(), g["z_exit"].numpy())
    z, hr = fused.pairs_tables(y, x, windows)
    tr = torch.from_numpy(fused._check_t_real(lens, n, T)).to(dev)
    return (z, hr, tr, *fused._to(dev, widx, k, zx, warm))


_NEW_ENTRIES = {
    "band_inline_hysteresis": (_band_inline_inputs, fused.band_inline_cuda,
                               fused.band_inline_plain,
                               {"machine": "hysteresis", "z_exit": 0.0}),
    "band_inline_touch": (_band_inline_inputs, fused.band_inline_cuda,
                          fused.band_inline_plain,
                          {"machine": "touch", "z_exit": 0.0}),
    "band_table_hysteresis": (_band_table_inputs, fused.band_table_cuda,
                              fused.band_machine_plain,
                              {"machine": "hysteresis", "z_exit": 0.0}),
    "band_table_touch": (_band_table_inputs, fused.band_table_cuda,
                         fused.band_machine_plain,
                         {"machine": "touch", "z_exit": 0.0}),
    "band_stoch_hysteresis": (_band_stoch_inputs, fused.band_stoch_cuda,
                              fused.band_stoch_plain,
                              {"machine": "hysteresis", "z_exit": 0.0}),
    "band_stoch_touch": (_band_stoch_inputs, fused.band_stoch_cuda,
                         fused.band_stoch_plain,
                         {"machine": "touch", "z_exit": 0.0}),
    "momentum": (_momentum_inputs, fused.momentum_cuda,
                 fused.momentum_plain, {}),
    "donchian": (_donchian_inputs, fused.donchian_cuda,
                 fused.donchian_plain, {}),
    "band_table_rsi": (_rsi_table_inputs, fused.band_table_cuda,
                       fused.band_machine_plain,
                       {"machine": "hysteresis", "z_exit": 0.0}),
    "band_table_keltner": (_keltner_table_inputs, fused.band_table_cuda,
                           fused.band_machine_plain,
                           {"machine": "hysteresis", "z_exit": 0.0}),
    "macd": (_macd_inputs, fused.macd_cuda, fused.macd_plain, {}),
    "trix": (_trix_inputs, fused.trix_cuda, fused.trix_plain, {}),
    "obv": (_obv_inputs, fused.obv_cuda, fused.obv_plain, {}),
    "band_table_vwap": (_vwap_table_inputs, fused.band_table_cuda,
                        fused.band_machine_plain,
                        {"machine": "hysteresis", "z_exit": 0.0}),
    "pairs": (_pairs_inputs, fused.pairs_cuda, fused.pairs_plain, {}),
}


# The window-major entries, momentum and the tile entries: held bit-equal
# (every entry).
_EXACT = {e for e in _NEW_ENTRIES
          if e.startswith(("band_table", "band_stoch", "donchian",
                           "band_inline", "momentum", "obv", "trix", "macd",
                           "pairs"))}


@pytest.mark.parametrize("entry", sorted(_NEW_ENTRIES))
@pytest.mark.parametrize("n,T,cost,seed", [
    (3, 200, 1e-3, 0),
    (2, 251, 0.0, 5),
    (1, 13000, 1e-3, 4),       # above 48 KB of staged rows, or unstaged
])
def test_new_kernels_match_plain(cuda, entry, n, T, cost, seed):
    # At T = 13000 the channel levels live in device memory.
    build, kernel, plain, kw = _NEW_ENTRIES[entry]
    _assert_kernel_matches_plain(build(cuda, n, T, seed), cost, kernel,
                                 plain, exact=entry in _EXACT, **kw)


@pytest.mark.parametrize("entry", sorted(_NEW_ENTRIES))
def test_new_kernels_match_plain_ragged(cuda, entry):
    build, kernel, plain, kw = _NEW_ENTRIES[entry]
    _assert_kernel_matches_plain(
        build(cuda, 3, 300, 9, np.asarray([300, 251, 170])), 1e-3, kernel,
        plain, exact=entry in _EXACT, **kw)


def _caller_order(inputs, n_lane):
    """Window-major inputs with the slots put back in the caller's lane
    order and ``lane`` the identity."""
    *head, lane = inputs
    inv = torch.empty_like(lane)
    ident = torch.arange(lane.numel(), dtype=lane.dtype, device=lane.device)
    inv[lane.long()] = ident
    return (*head[:-n_lane], *(x[inv.long()] for x in head[-n_lane:]),
            ident)


_STRADDLE = {   # 6 x 300 = 1800 lanes: the lane blocks straddle windows
    "band_stoch": (lambda dev: _band_stoch_inputs(
        dev, 2, 400, 7, bands=np.linspace(10, 40, 6),
        windows=np.arange(1, 301)), fused.band_stoch_cuda,
        fused.band_stoch_plain, 3, {"machine": "hysteresis", "z_exit": 0.0}),
    "band_table": (lambda dev: _band_table_straddle(dev),
                   fused.band_table_cuda, fused.band_machine_plain, 3,
                   {"machine": "touch", "z_exit": 0.0}),
    "donchian": (lambda dev: _donchian_inputs(
        dev, 2, 400, 7, windows=np.tile(np.arange(1, 301), 6)),
        fused.donchian_cuda, fused.donchian_plain, 2, {}),
}


def _band_table_straddle(dev):
    close, high, low, tr, r = _panel(dev, 2, 400, 7)
    (windows, _, widx, warm), g = _stoch_grid(np.linspace(10, 40, 6),
                                              np.arange(1, 301))
    z = fused.stochastic_z_table(close, high, low, windows)
    return (z, r, tr, *_lanes(dev, widx, widx, g["band"].numpy(), warm))


@pytest.mark.parametrize("entry", sorted(_STRADDLE))
def test_window_major_entries_match_plain_on_straddling_grid(cuda, entry):
    # The window-major launch and the caller's-order launch both equal the
    # plain version in the caller's order, bit for bit.
    build, kernel, plain, n_lane, kw = _STRADDLE[entry]
    inputs = build(cuda)
    caller = _caller_order(inputs, n_lane)
    _assert_kernel_matches_plain(inputs, 1e-3, kernel, plain,
                                 ref_inputs=caller, exact=True, **kw)
    _assert_kernel_matches_plain(caller, 1e-3, kernel, plain, exact=True,
                                 **kw)


# The tile entries (K1, K2's inline entry, K4-K7; csrc/bar_blocks.cuh):
# inputs on a case's panel, and their kernel, plain version and machine.
_SHORT_LENS = np.asarray([1, 5, 63, 65, 127, 129, 300])


def _sma_tile_inputs(dev, n, T, seed, lens=None, fast=range(5, 25),
                     slow=range(30, 70, 2)):
    p = data.synthetic_ohlcv(n, T, seed=seed).close
    for i, m in enumerate(lens if lens is not None else ()):
        p[i, m:] = p[i, m - 1]
    return _inputs(dev, p, list(fast), list(slow), lens)


_TILE_ENTRIES = {
    "fused_sma": (_sma_tile_inputs, fused.fused_sma_cuda,
                  fused.fused_sma_plain, {}),
    "band_inline_hysteresis": (_band_inline_inputs, fused.band_inline_cuda,
                               fused.band_inline_plain,
                               {"machine": "hysteresis", "z_exit": 0.3}),
    "band_inline_touch": (_band_inline_inputs, fused.band_inline_cuda,
                          fused.band_inline_plain,
                          {"machine": "touch", "z_exit": 0.0}),
    "obv": (_obv_inputs, fused.obv_cuda, fused.obv_plain, {}),
    "trix": (_trix_inputs, fused.trix_cuda, fused.trix_plain, {}),
    "macd": (_macd_inputs, fused.macd_cuda, fused.macd_plain, {}),
    "pairs": (_pairs_inputs, fused.pairs_cuda, fused.pairs_plain, {}),
}
# The tile entries' cases, which K3 momentum's per-lane read runs too.
_CASE_ENTRIES = {**_TILE_ENTRIES,
                 "momentum": (_momentum_inputs, fused.momentum_cuda,
                              fused.momentum_plain, {})}
# Each tile entry's grid of many distinct windows: lists too long for a
# block of 128 bars.
_WIDE = np.tile(np.arange(2, 401), 2)
_MANY_WINDOWS = {
    _sma_tile_inputs: {"fast": range(2, 130), "slow": range(130, 401)},
    _band_inline_inputs: {"ks": np.linspace(0.5, 3.0, 8),
                          "windows": np.arange(5, 301)},
    _obv_inputs: {"windows": _WIDE},
    _momentum_inputs: {"lookbacks": _WIDE},
    # 399 spans x 2 signals: tiles straddle spans at every width.
    _trix_inputs: {"spans": np.arange(2, 401)},
    # 1600 (fast, slow) pairs x 2 signals: about 512 keys a 1024-lane tile.
    _macd_inputs: {"fast": range(2, 42), "slow": range(42, 401, 9)},
    _pairs_inputs: {"lookbacks": np.arange(2, 401)},
}
_TILE_CASES = {
    # The old kernels' unstaged branch, now the same code.
    "long_rows": lambda build, dev: build(dev, 4, 13000, 4),
    "many_windows": lambda build, dev: build(dev, 2, 420, 6,
                                             **_MANY_WINDOWS[build]),
    # Histories that end mid-block, shorter than most windows.
    "short_histories": lambda build, dev: build(
        dev, _SHORT_LENS.size, 300, 8, lens=_SHORT_LENS),
}


@pytest.mark.parametrize("case", sorted(_TILE_CASES))
@pytest.mark.parametrize("entry", sorted(_CASE_ENTRIES))
def test_tile_entries_match_plain(cuda, entry, case):
    build, kernel, plain, kw = _CASE_ENTRIES[entry]
    _assert_kernel_matches_plain(_TILE_CASES[case](build, cuda), 1e-3,
                                 kernel, plain, exact=True, **kw)


@pytest.mark.parametrize("lanes", [32, 128, 256, 512, 1024])
@pytest.mark.parametrize("entry", sorted(_TILE_ENTRIES))
def test_tile_entries_match_plain_at_every_width(cuda, monkeypatch, entry,
                                                 lanes):
    # 400 (K1), 96 (K2), 5 (K6), 6 (K5), 12 (K4) and 12 (K7) lanes: a
    # ragged last tile at most widths.
    for name in ("_SMA_LANES", "_BAND_INLINE_LANES", "_OBV_LANES",
                 "_TRIX_LANES", "_MACD_LANES", "_PAIRS_LANES"):
        monkeypatch.setattr(fused, name, lanes)
    build, kernel, plain, kw = _TILE_ENTRIES[entry]
    inputs = build(cuda, 3, 300, 9, lens=np.asarray([300, 251, 170]))
    got = kernel(*inputs, cost=1e-3, ppy=252, **kw)
    ref = plain(*inputs, cost=1e-3, ppy=252, **kw)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("lanes", [0, 48, 2048])
def test_tile_entries_refuse_a_width_they_cannot_launch(cuda, lanes):
    cs, r, tr, fast, slow, warm = _sma_tile_inputs(cuda, 2, 60, 1)
    out = torch.empty((9, 2, fast.shape[0]), device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        fused._launch_fused_sma(cs, r, tr, fused.window_tiles(max(lanes, 1),
                                                              fast, slow),
                                warm, out, lanes, cost=0.0, ppy=252)


@pytest.mark.parametrize("cost", [0.0, 1e-3])
@pytest.mark.parametrize("entry", ["fused_sma", "momentum", "trix", "macd",
                                   "pairs"])
def test_crafted_returns_match_plain(cuda, entry, cost):
    # NaN where the plain version has NaN, every other value bit-equal:
    # the metric update propagates NaN as torch's max and clamp do. K7
    # earns its hedged returns: each pair's crafted row on every lookback.
    build, kernel, plain, kw = _CASE_ENTRIES[entry]
    inputs = list(build(cuda, 8, 300, 3))
    r = torch.as_tensor(crafted_returns(300), device=cuda)
    if inputs[1].ndim == 3:
        r = r[:, None, :].expand(inputs[1].shape).contiguous()
    inputs[1] = r
    got = kernel(*inputs, cost=cost, ppy=252, **kw).cpu().numpy()
    ref = plain(*inputs, cost=cost, ppy=252, **kw).cpu().numpy()
    assert np.isnan(ref).any() and np.isinf(ref).any()
    assert (ref[3] < -1).any()                       # equity below 0
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_array_equal(got[ok].view(np.uint32),
                                  ref[ok].view(np.uint32))


def test_new_launch_counters_count_kernel_launches_only(cuda):
    p = data.synthetic_ohlcv(2, 120, seed=1)
    _kernels.reset_launch_counts()
    for entry, (build, kernel, plain, kw) in _NEW_ENTRIES.items():
        plain(*build(cuda, 2, 120, 1), cost=0.0, ppy=252, **kw)
    assert sum(_kernels.LAUNCHES.values()) == 0
    fused.fused_bollinger_sweep(p.close, [10.0], [1.0], device="cuda")
    fused.fused_bollinger_touch_sweep(p.close, [10.0], [1.0], table="hbm",
                                      device="cuda")
    fused.fused_stochastic_sweep(p.close, p.high, p.low, [10.0], [20.0],
                                 device="cuda")
    fused.fused_momentum_sweep(p.close, [5.0], device="cuda")
    fused.fused_donchian_sweep(p.close, [10.0], device="cuda")
    fused.fused_donchian_hl_sweep(p.close, p.high, p.low, [10.0],
                                  device="cuda")
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHES) == {"band_inline": 2, "band_stoch": 1,
                                       "momentum": 1, "donchian": 2}


def test_new_wrappers_check_their_inputs(cuda):
    z, r, tr, widx, k, warm, lane = _band_table_inputs(cuda, 2, 60, 1)
    kw = {"machine": "hysteresis", "z_exit": 0.0, "cost": 0.0, "ppy": 252}
    with pytest.raises(TypeError, match="float32"):
        fused.band_table_cuda(z.double(), r, tr, widx, k, warm, lane, **kw)
    with pytest.raises(ValueError, match="machine"):
        fused.band_table_cuda(z, r, tr, widx, k, warm, lane,
                              **{**kw, "machine": "x"})
    with pytest.raises(ValueError, match="shape"):
        fused.band_table_cuda(z, r, tr, widx, k, warm, lane[:1], **kw)
    c, h, lo, r, tr, win, k, warm, lane = _band_stoch_inputs(cuda, 2, 60, 1)
    with pytest.raises(TypeError, match="int32"):
        fused.band_stoch_cuda(c, h, lo, r, tr, win, k, warm, lane.long(),
                              **kw)
    with pytest.raises(ValueError, match="is on"):
        fused.band_stoch_cuda(c, h.cpu(), lo, r, tr, win, k, warm, lane,
                              **kw)
    c, h, lo, r, tr, win, warm, lane = _donchian_inputs(cuda, 2, 60, 1)
    with pytest.raises(TypeError, match="float32"):
        fused.donchian_cuda(c, h.double(), lo, r, tr, win, warm, lane,
                            cost=0.0, ppy=252)
    with pytest.raises(ValueError, match="contiguous"):
        fused.donchian_cuda(c, h, torch.cat([lo, lo], 1)[:, ::2], r, tr,
                            win, warm, lane, cost=0.0, ppy=252)
    close, r, tr, lb, warm = _momentum_inputs(cuda, 2, 60, 1)
    with pytest.raises(ValueError, match="shape"):
        fused.momentum_cuda(close, r, tr, lb, warm[:1], cost=0.0, ppy=252)


def test_ema_launch_counters_count_kernel_launches_only(cuda):
    p = data.synthetic_ohlcv(2, 120, seed=2)
    _kernels.reset_launch_counts()
    for entry in ("macd", "trix"):
        build, _, plain, _ = _NEW_ENTRIES[entry]
        plain(*build(cuda, 2, 120, 2), cost=0.0, ppy=252)
    assert sum(_kernels.LAUNCHES.values()) == 0
    fused.fused_macd_sweep(p.close, [5.0], [20.0], [9.0], device="cuda")
    fused.fused_trix_sweep(p.close, [8.0], [9.0], device="cuda")
    fused.fused_rsi_sweep(p.close, [14.0], [20.0], device="cuda")
    fused.fused_keltner_sweep(p.close, p.high, p.low, [20.0], [1.5],
                              device="cuda")
    torch.cuda.synchronize()
    # macd's and trix's tables are built on the card.
    assert dict(_kernels.LAUNCHES) == {"macd": 1, "trix": 1, "ema_rows": 2,
                                       "band_table": 2}


def test_ema_wrappers_check_their_inputs(cuda):
    tbl, r, tr, fidx, sidx, a_sig, warm = _macd_inputs(cuda, 2, 60, 1)
    with pytest.raises(TypeError, match="float32"):
        fused.macd_cuda(tbl, r, tr, fidx, sidx, a_sig.double(), warm,
                        cost=0.0, ppy=252)
    with pytest.raises(ValueError, match="shape"):
        fused.macd_cuda(tbl, r, tr, fidx, sidx[:1], a_sig, warm, cost=0.0,
                        ppy=252)
    tbl, r, tr, widx, a_sig, warm = _trix_inputs(cuda, 2, 60, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fused.trix_cuda(tbl.transpose(1, 2).contiguous().transpose(1, 2),
                        r, tr, widx, a_sig, warm, cost=0.0, ppy=252)
    with pytest.raises(ValueError, match="is on"):
        fused.trix_cuda(tbl, r, tr, widx.cpu(), a_sig, warm, cost=0.0,
                        ppy=252)


def test_volume_and_pairs_launch_counters_count_kernel_launches_only(cuda):
    p = data.synthetic_ohlcv(4, 120, seed=3)
    _kernels.reset_launch_counts()
    for entry in ("obv", "band_table_vwap", "pairs"):
        build, _, plain, kw = _NEW_ENTRIES[entry]
        plain(*build(cuda, 2, 120, 3), cost=0.0, ppy=252, **kw)
    assert sum(_kernels.LAUNCHES.values()) == 0
    fused.fused_obv_sweep(p.close, p.volume, [10.0], device="cuda")
    fused.fused_vwap_sweep(p.close, p.volume, [10.0], [1.0], device="cuda")
    fused.fused_pairs_sweep(p.close[:2], p.close[2:], [10.0], [1.0],
                            device="cuda")
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHES) == {"obv": 1, "band_table": 1,
                                       "pairs": 1, "pairs_tables": 1}


def test_volume_and_pairs_wrappers_check_their_inputs(cuda):
    obv, cs, r, tr, win, warm = _obv_inputs(cuda, 2, 60, 1)
    with pytest.raises(TypeError, match="float32"):
        fused.obv_cuda(obv.double(), cs, r, tr, win, warm, cost=0.0, ppy=252)
    z, hr, tr, widx, k, zx, warm = _pairs_inputs(cuda, 2, 60, 1)
    with pytest.raises(ValueError, match="shape"):
        fused.pairs_cuda(z, hr[:, :1].contiguous(), tr, widx, k, zx, warm,
                         cost=0.0, ppy=252)
    with pytest.raises(ValueError, match="is on"):
        fused.pairs_cuda(z, hr, tr, widx, k, zx.cpu(), warm, cost=0.0,
                         ppy=252)


# --- the table kernels (csrc/ema_rows.cu, csrc/pairs_tables.cu) ------------

def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("n,T,seed,lens,spans", [
    (3, 200, 0, None, None),
    (2, 251, 5, None, None),
    (3, 300, 9, [300, 251, 170], None),  # ragged: padded by the last bar
    (2, 13000, 4, None, None),         # rows on scratch in device memory
    (2, 1, 3, None, None),
    (2, 2, 3, None, None),
    (1, 1260, 6, None, None),          # one row a warp: 5 rows, 2 CTAs
    (31, 1260, 7, None, [9]),          # one span: 31 rows
    (33, 33, 8, None, None),           # two registers a lane
    (2, 2048, 9, None, None),          # the largest register plan
    (2, 2049, 9, None, None),          # one bar past it: staged
])
def test_ema_rows_match_trix_ema_table(cuda, n, T, seed, lens, spans):
    close, _, _, _, _ = _panel(cuda, n, T, seed, lens)
    spans = np.float32(spans or [2, 3, 8, 14, 100])
    got = fused.ema_rows_cuda(close, fused.ema_decay(cuda, spans), 3)
    ref = fused.trix_ema_table(close, spans)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("T", [200, 13000])
def test_ema_rows_one_ladder_match_macd_ema_table(cuda, T):
    close, _, _, _, _ = _panel(cuda, 2, T, 6)
    spans = np.float32([5, 12, 26, 300])
    got = fused.ema_rows_cuda((close - close[:, :1]).contiguous(),
                              fused.ema_decay(cuda, spans), 1)
    assert torch.equal(_bits(got), _bits(fused.macd_ema_table(close, spans)))


@pytest.mark.parametrize("T", [200, 13000])
def test_macd_sweep_table_on_the_card_is_macd_ema_table(cuda, T):
    close, _, _, _, _ = _panel(cuda, 3, T, 8, None)
    spans = np.float32([5, 12, 20, 26, 300])
    _kernels.reset_launch_counts()
    got = fused.macd_sweep_table(close, spans)
    assert dict(_kernels.LAUNCHES) == {"ema_rows": 1}
    assert torch.equal(_bits(got), _bits(fused.macd_ema_table(close, spans)))


def _pairs_table_args(dev, n, T, seed, lens=None,
                      lookbacks=(1, 5, 20, 300)):
    closes = data.synthetic_ohlcv(2 * n, T, seed=seed).close
    for i, m in enumerate(lens if lens is not None else ()):
        closes[[i, n + i], m:] = closes[[i, n + i], m - 1:m]
    y, x = (torch.as_tensor(c, device=dev).contiguous()
            for c in (closes[:n], closes[n:]))
    windows = torch.tensor(lookbacks, dtype=torch.int32, device=dev)
    return y, x, x.mean(dim=1), y.mean(dim=1), windows


@pytest.mark.parametrize("n,T,seed,lens,lookbacks", [
    (3, 200, 0, None, None),
    (2, 251, 5, None, None),
    (3, 300, 9, [300, 251, 170], None),
    (2, 3500, 4, None, None),          # prefix rows read from memory
    (1, 5000, 4, None, None),
    (1, 13000, 4, None, None),
    (2, 1, 3, None, None),
    (2, 2, 3, None, None),
    (1, 1260, 6, None, tuple(range(20, 70, 5))),   # the bench lookbacks
    (31, 1260, 7, None, tuple(range(20, 70, 5))),  # 310 rows: 10 CTAs
    (33, 251, 8, None, (7,)),          # one lookback: 33 rows
    (3, 1300, 9, None, (7, 50, 600)),  # past the ring: lags from memory
    (1, 13000, 10, None, (20, 481)),   # both, on long rows
    (3, 251, 11, None, tuple(range(5, 50, 5))),    # W T odd: rows in scratch
    (2, 252, 12, None, tuple(range(5, 50, 5))),    # prefix rows in z
])
def test_pairs_tables_match_plain(cuda, n, T, seed, lens, lookbacks):
    args = _pairs_table_args(cuda, n, T, seed, lens,
                             **({"lookbacks": lookbacks} if lookbacks else {}))
    got = fused.pairs_tables_cuda(*args)
    ref = fused.pairs_tables_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        assert torch.equal(_bits(a), _bits(b))


def test_table_kernels_count_their_launches_and_check_inputs(cuda):
    close, _, _, _, _ = _panel(cuda, 2, 80, 1)
    decay = fused.ema_decay(cuda, np.float32([5, 9]))
    args = _pairs_table_args(cuda, 2, 80, 1)
    _kernels.reset_launch_counts()
    fused.trix_ema_table(close, np.float32([5, 9]))
    fused.pairs_tables_plain(*args)
    assert sum(_kernels.LAUNCHES.values()) == 0
    fused.ema_rows_cuda(close, decay, 3)
    fused.pairs_tables_cuda(*args)
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHES) == {"ema_rows": 1, "pairs_tables": 1}
    with pytest.raises(ValueError, match="ladders"):
        fused.ema_rows_cuda(close, decay, 4)
    with pytest.raises(TypeError, match="float32"):
        fused.ema_rows_cuda(close.double(), decay, 3)
    with pytest.raises(ValueError, match="is on"):
        fused.ema_rows_cuda(close, decay.cpu(), 3)
    # Scratch: a mean a (pair, lookback), after the legs' four f64 prefix
    # rows a pair (8 floats a (pair, bar)) unless those live in the z
    # table (W >= 8, W T even, staged, the ring); 8 pairs a legs CTA, 32
    # rows a sums CTA; 3 launches, the prefix rows staged up to T = 3072, a
    # ring of ceil(w / 32) + 1 tiles or more (a power of two, at least 4) up
    # to 16 tiles; past it the lags come from memory and hr takes a 4th.
    assert fused.pairs_tables_plan(1000, 1260, 10, 65) == (
        10000, 8, 32, 3, 1, 4, 1)
    assert fused.pairs_tables_plan(2, 252, 9, 65) == (18, 8, 32, 3, 1, 4, 1)
    assert fused.pairs_tables_plan(2, 251, 9, 65) == (
        4034, 8, 32, 3, 1, 4, 0)
    assert fused.pairs_tables_plan(2, 200, 4, 97) == (
        3208, 8, 32, 3, 1, 8, 0)
    assert fused.pairs_tables_plan(2, 200, 4, 300) == (
        3208, 8, 32, 3, 1, 16, 0)
    assert fused.pairs_tables_plan(1, 3072, 8, 96) == (8, 8, 32, 3, 1, 4, 1)
    assert fused.pairs_tables_plan(1, 3073, 8, 480) == (
        24592, 8, 32, 3, 0, 16, 0)
    assert fused.pairs_tables_plan(3, 1300, 8, 481) == (
        31224, 8, 32, 4, 1, 0, 0)
    with pytest.raises(ValueError, match="max_window"):
        fused.pairs_tables_plan(1, 10, 1, 0)
    # One row a warp in registers up to 2048 bars, 32 bars a register.
    assert [fused.ema_rows_registers(T) for T in (1, 32, 33, 251, 1260, 2048,
                                                  2049)] == [1, 1, 2, 8, 40,
                                                             64, 0]
    y, x, mx, my, windows = args
    with pytest.raises(TypeError, match="int32"):
        fused.pairs_tables_cuda(y, x, mx, my, windows.long())
    with pytest.raises(ValueError, match="shape"):
        fused.pairs_tables_cuda(y, x[:1], mx, my, windows)


def test_fused_pairs_sweep_builds_no_other_table_on_the_card(cuda):
    # z and hr are the only (N, W, T) tensors the card's pairs sweep holds.
    closes = data.synthetic_ohlcv(64, 1260, seed=2).close
    lookbacks = np.arange(20, 70, 5, dtype=np.float32)
    g = sweep.product_grid(lookback=lookbacks,
                           z_entry=np.linspace(0.5, 3.0, 10, dtype=np.float32))
    y, x = (torch.as_tensor(c, device=cuda) for c in (closes[:32],
                                                       closes[32:]))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    m = fused.fused_pairs_sweep(y, x, g["lookback"].numpy(),
                                g["z_entry"].numpy(), device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del m
    table = 4 * 32 * lookbacks.size * 1260
    assert peak < 3 * table


def test_fused_pairs_sweep_on_the_card_holds_the_budget_against_f64(cuda):
    # The card's tables (windowed sums rounded once from f64) against the
    # generic pairs sweep with its legs in f64: the flip-aware budget.
    closes = data.synthetic_ohlcv(16, 1260, seed=132).close
    g = sweep.product_grid(lookback=np.arange(20, 70, 5, dtype=np.float32),
                           z_entry=np.linspace(0.5, 3.0, 50,
                                               dtype=np.float32))
    y, x = (torch.as_tensor(c, device=cuda) for c in (closes[:8],
                                                       closes[8:]))
    got = fused.fused_pairs_sweep(y, x, g["lookback"].numpy(),
                                  g["z_entry"].numpy(), cost=1e-3,
                                  device="cuda")
    y64, x64 = (leg.double()[:, None, :] for leg in (y, x))
    witness = sweep.map_param_chunks(
        g, 8 * 1260, cuda,
        lambda sub: pairs.pair_backtest(y64, x64, sub, cost=1e-3))
    assert_metrics_match(got, witness, rtol=2e-3, atol=2e-4,
                         drift_counts=True)


# --- K8: the roofline stage scaffolds (csrc/stages.cu) ----------------------

def _stage_inputs(dev, kind, n, T, seed, n_b=75, n_a=None):
    """A scaffold's inputs on ``n`` x ``T`` closes: SMA ``n_a`` (4) fast x
    ``n_b`` slow windows, bollinger ``n_a`` (15) bands x ``n_b`` // 4
    windows (300 lanes at the defaults, a count no lane block divides)."""
    close = data.synthetic_ohlcv(n, T, seed=seed).close
    if kind == "sma":
        fast = np.float32([3, 5, 8, 13, 17][:n_a or 4])
        g = sweep.product_grid(fast=fast,
                               slow=np.arange(20, 20 + 2 * n_b, 2,
                                              dtype=np.float32))
        return stages.sma_stage_inputs(close, g["fast"].numpy(),
                                       g["slow"].numpy(), device=dev)
    g = sweep.product_grid(
        k=np.linspace(0.5, 3.0, n_a or 15).astype(np.float32),
        window=np.arange(5, 5 + n_b // 4 * 2, 2, dtype=np.float32))
    return stages.boll_stage_inputs(close, g["window"].numpy(),
                                    g["k"].numpy(), device=dev)


def _stage_versions(kind):
    if kind == "sma":
        return stages.sma_stage_cuda, stages.sma_stage_plain
    return stages.boll_stage_cuda, stages.boll_stage_plain


def _assert_stage_matches_plain(inp, kind, stage, lanes, ref=None):
    # Same inputs, same order of every operation: each row bit-equal. No
    # lane count (nor the cluster size it leads to) changes a bit.
    kernel, plain = _stage_versions(kind)
    got = kernel(inp, stage=stage, lanes=lanes)
    if ref is None:
        ref = plain(inp, stage=stage, lanes=lanes)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    for i in range(9):
        np.testing.assert_array_equal(got[i].cpu().numpy(),
                                      ref[i].cpu().numpy(),
                                      err_msg=f"{kind} {stage} row {i} at "
                                      f"{lanes} lanes")


_STAGE_CASES = ([("sma", s) for s in stages.SMA_STAGES[1:]]
                + [("boll", s) for s in stages.BOLL_STAGES[1:]])


@pytest.mark.parametrize("lanes", stages.LANES)
@pytest.mark.parametrize("kind,stage", _STAGE_CASES)
def test_stage_kernels_match_plain(cuda, kind, stage, lanes):
    _assert_stage_matches_plain(_stage_inputs(cuda, kind, 3, 251, 0), kind,
                                stage, lanes)


@pytest.mark.parametrize("T", [13000, 30000])   # each row far past a block
@pytest.mark.parametrize("kind,stage", _STAGE_CASES)
def test_stage_kernels_match_plain_on_long_rows(cuda, kind, stage, T):
    inp = _stage_inputs(cuda, kind, 1, T, 2, n_b=8)
    ref = _stage_versions(kind)[1](inp, stage=stage)
    for lanes in stages.LANES:
        _assert_stage_matches_plain(inp, kind, stage, lanes, ref)


# Shapes the bench does not reach: (N, T, seed, {kind: (n_b, n_a)}).
# "wide": about 400 distinct windows, so that a 128-lane CTA's blocks hold
# 4 bars; "short": T shorter than one block and no multiple of 4;
# "one_ticker": N = 1; "p75": 75 lanes, a count no lane block divides.
_STAGE_SHAPES = {"wide": (2, 251, 3, {"sma": (396, 4), "boll": (1600, 15)}),
                 "short": (3, 37, 4, {"sma": (24, 4), "boll": (24, 4)}),
                 "one_ticker": (1, 300, 5, {"sma": (40, 4),
                                            "boll": (40, 4)}),
                 "p75": (2, 251, 6, {"sma": (25, 3), "boll": (100, 3)})}


@pytest.mark.parametrize("shape", sorted(_STAGE_SHAPES))
@pytest.mark.parametrize("kind,stage", _STAGE_CASES)
def test_stage_kernels_match_plain_on_edge_shapes(cuda, kind, stage, shape):
    n, T, seed, lanes_of = _STAGE_SHAPES[shape]
    n_b, n_a = lanes_of[kind]
    inp = _stage_inputs(cuda, kind, n, T, seed, n_b=n_b, n_a=n_a)
    if shape == "wide":
        assert inp.table.shape[1] >= 400
        info = stages.stage_occupancy(kind, inp, stage=stage)
        assert stage == "touch" or info["block_bars"] == 4, info
    if shape == "p75":
        assert inp.row_a.shape[0] == 75
    ref = _stage_versions(kind)[1](inp, stage=stage)
    for lanes in stages.LANES:
        _assert_stage_matches_plain(inp, kind, stage, lanes, ref)


@pytest.mark.parametrize("n_b", [75, 500])
@pytest.mark.parametrize("kind", ["sma", "boll"])
def test_stage_touch_is_one_sum_at_every_width(cuda, kind, n_b):
    # touch's order depends on the table's shape alone: every lane count,
    # and so every cluster size (1 to 16 CTAs over these two grids), gives
    # the plain version's bits.
    inp = _stage_inputs(cuda, kind, 3, 251, 7, n_b=n_b)
    ref = _stage_versions(kind)[1](inp, stage="touch")
    clusters = set()
    for lanes in stages.LANES:
        clusters.add(stages.stage_occupancy(kind, inp, stage="touch",
                                            lanes=lanes)["cluster"])
        _assert_stage_matches_plain(inp, kind, "touch", lanes, ref)
    assert clusters == ({1, 2, 4} if n_b == 75 else {2, 4, 8, 16}), clusters


def test_stage_launch_counters_count_kernel_launches_only(cuda):
    close = data.synthetic_ohlcv(2, 100, seed=1).close
    inp = stages.sma_stage_inputs(close, [3.0, 4.0], [10.0, 12.0],
                                  device=cuda)
    _kernels.reset_launch_counts()
    stages.sma_stage_plain(inp, stage="full")
    stages.boll_stage_plain(
        stages.boll_stage_inputs(close, [5.0], [1.0], device=cuda),
        stage="touch")
    assert sum(_kernels.LAUNCHES.values()) == 0
    stages.sma_stage_call(close, [3.0], [10.0], stage="full", lanes=256,
                          device="cuda")
    stages.sma_stage_call(close, [3.0], [10.0], stage="prep",
                          device="cuda")
    stages.sma_stage(inp, stage="full_ladder")
    stages.boll_stage_call(close, [5.0], [1.0], stage="signal_ladder",
                           device="cuda")
    torch.cuda.synchronize()
    assert dict(_kernels.LAUNCHES) == {"sma_stage_full_l256": 1,
                                       "sma_stage_full_ladder_l128": 1,
                                       "boll_stage_signal_ladder_l128": 1}


def test_stage_wrappers_check_their_inputs(cuda):
    inp = _stage_inputs(cuda, "sma", 2, 60, 1, n_b=4)
    with pytest.raises(TypeError, match="float32"):
        stages.sma_stage_cuda(inp._replace(table=inp.table.double()),
                              stage="full")
    with pytest.raises(ValueError, match="shape"):
        stages.sma_stage_cuda(inp._replace(row_b=inp.row_b[:1]),
                              stage="full")
    with pytest.raises(ValueError, match="is on"):
        stages.sma_stage_cuda(inp._replace(warm=inp.warm.cpu()),
                              stage="full")
    with pytest.raises(ValueError, match="tr"):
        stages.sma_stage_cuda(inp._replace(tr=10_000), stage="full")
    binp = _stage_inputs(cuda, "boll", 2, 60, 1, n_b=8)
    with pytest.raises(ValueError, match="needs k"):
        stages.boll_stage_cuda(binp._replace(k=None), stage="full")
    wide = torch.zeros((1, 8000, 8), device=cuda)
    with pytest.raises(ValueError, match="no layout"):
        stages.sma_stage_cuda(inp._replace(table=wide, r=inp.r[:1, :8],
                                           tr=8), stage="full")


# --- the mesh route and the time-sharded primitives on the card ------------

def _mesh_jobs(strategy: str, n: int, T: int, seed: int):
    from distributed_backtesting_exploration_tpu_torch import roofline
    from distributed_backtesting_exploration_tpu_torch.rpc import (
        backtesting_pb2 as pb, wire)

    axes = {k: v[::7] for k, v in roofline.bench_axes(100)[strategy].items()}
    grid = wire.grid_to_proto(axes)
    if strategy == "pairs":
        legs = data.synthetic_ohlcv(2 * n, T, seed=seed)
        return [pb.JobSpec(
            id=f"{strategy}-{i}", strategy=strategy, grid=grid, cost=1e-3,
            ohlcv=data.to_wire_bytes(data.OHLCV(*(f[i] for f in legs))),
            ohlcv2=data.to_wire_bytes(data.OHLCV(*(f[n + i] for f in legs))))
            for i in range(n)]
    panel = data.synthetic_ohlcv(n, T, seed=seed)
    return [pb.JobSpec(id=f"{strategy}-{i}", strategy=strategy, grid=grid,
                       cost=1e-3, ohlcv=data.to_wire_bytes(
                           data.OHLCV(*(f[i] for f in panel))))
            for i in range(n)]


@pytest.mark.parametrize("strategy", [
    "sma_crossover", "bollinger", "stochastic", "rsi", "momentum",
    "donchian_hl", "macd", "trix", "obv_trend", "vwap_reversion", "pairs"])
def test_mesh_route_launches_each_entry_once_a_shard(cuda, strategy):
    # A mesh of the one card four times: each shard's rows launch the
    # family's entry once, and the blocks are those of the meshless
    # backend bit for bit (every prep is a function of a row's own bars).
    from distributed_backtesting_exploration_tpu_torch import roofline
    from distributed_backtesting_exploration_tpu_torch.parallel import (
        sharding)
    from distributed_backtesting_exploration_tpu_torch.rpc import compute

    jobs = _mesh_jobs(strategy, 10, 300, seed=17)
    mesh = compute.TorchSweepBackend(mesh=sharding.make_mesh(["cuda:0"] * 4))
    one = compute.TorchSweepBackend(device="cuda")
    want = {c.job_id: c.metrics for c in one.process(jobs)}
    _kernels.reset_launch_counts()
    got = {c.job_id: c.metrics for c in mesh.process(jobs)}
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[roofline.ENTRY[strategy]] == 4
    assert got == want


def test_time_sharded_primitives_are_bit_equal_on_the_card(cuda):
    from distributed_backtesting_exploration_tpu_torch.ops import signals
    from distributed_backtesting_exploration_tpu_torch.parallel import (
        sharding, timeshard)

    four = sharding.make_mesh(["cuda:0"] * 4)
    one = sharding.make_mesh(["cuda:0"])
    x = torch.as_tensor(data.synthetic_ohlcv(4, 8192, seed=2).close,
                        device=cuda)
    assert torch.equal(timeshard.sharded_cumsum(four, x),
                       rolling.prefix_sum(x))
    assert torch.equal(timeshard.sharded_ema(four, x, span=20),
                       timeshard.sharded_ema(one, x, span=20))
    z = (x - x.mean(dim=1, keepdim=True)) / x.std(dim=1, keepdim=True)
    valid = torch.arange(8192, device=cuda) >= 19
    assert torch.equal(
        timeshard.sharded_band_positions(four, z, valid, 1.0, 0.0),
        signals.band_hysteresis_assoc(z, valid, 1.0, 0.0))


def test_pairs_block_is_the_same_alone_and_stacked(cuda):
    # One pair's K7 block alone, in a 64-pair stack and in a ragged stack
    # (the pair at its full length): bit-equal, the tables' leg means being
    # f64 means rounded once.
    closes = data.synthetic_ohlcv(128, 400, seed=5).close
    y, x = closes[:64], closes[64:]
    g = sweep.product_grid(lookback=np.float32([20, 35]),
                           z_entry=np.float32([1.0, 2.0]))
    lb, ze = g["lookback"].numpy(), g["z_entry"].numpy()

    def block(yy, xx, tr=None):
        m = fused.fused_pairs_sweep(yy, xx, lb, ze, t_real=tr, cost=1e-3,
                                    device="cuda")
        return torch.stack(list(m)).cpu()

    lens = np.random.default_rng(3).integers(60, 401, 64).astype(np.int32)
    lens[7] = 400
    ry, rx = y.copy(), x.copy()
    for leg in (ry, rx):
        for i, n in enumerate(lens):
            leg[i, n:] = leg[i, n - 1]
    alone = block(y[7:8], x[7:8])[:, 0]
    assert torch.equal(block(y, x)[:, 7], alone)
    assert torch.equal(block(ry, rx, lens)[:, 7], alone)


# --- tuned CTA widths (tune/) ----------------------------------------------

def _tile_sweeps():
    """Each tile entry's public sweep on 3 x 300 bars and a grid of more
    lanes than its widest tile, as (strategy, call(**kw) -> Metrics)."""
    p = data.synthetic_ohlcv(6, 300, seed=12)
    c, v = p.close[:3], p.volume[:3]
    axes = {
        "sma_crossover": dict(fast=np.arange(3, 33), slow=np.arange(40, 80)),
        "bollinger": dict(window=np.arange(5, 65),
                          k=np.linspace(0.5, 3.0, 20)),
        "macd": dict(fast=np.arange(3, 13), slow=np.arange(20, 40, 2),
                     signal=np.arange(3, 13)),
        "trix": dict(span=np.arange(3, 53), signal=np.arange(2, 22)),
        "obv_trend": dict(window=np.tile(np.arange(3, 103), 12)),
        "pairs": dict(lookback=np.arange(10, 60, 2),
                      z_entry=np.linspace(0.5, 3.0, 44)),
    }
    g = {s: {k: vv.numpy() for k, vv in sweep.product_grid(
        **{a: np.float32(x) for a, x in ax.items()}).items()}
        for s, ax in axes.items()}
    return {
        "sma_crossover": lambda **kw: fused.fused_sma_sweep(
            c, g["sma_crossover"]["fast"], g["sma_crossover"]["slow"], **kw),
        "bollinger": lambda **kw: fused.fused_bollinger_sweep(
            c, g["bollinger"]["window"], g["bollinger"]["k"], **kw),
        "macd": lambda **kw: fused.fused_macd_sweep(
            c, g["macd"]["fast"], g["macd"]["slow"], g["macd"]["signal"],
            **kw),
        "trix": lambda **kw: fused.fused_trix_sweep(
            c, g["trix"]["span"], g["trix"]["signal"], **kw),
        "obv_trend": lambda **kw: fused.fused_obv_sweep(
            c, v, g["obv_trend"]["window"], **kw),
        "pairs": lambda **kw: fused.fused_pairs_sweep(
            p.close[:3], p.close[3:], g["pairs"]["lookback"],
            g["pairs"]["z_entry"], **kw),
    }


@pytest.mark.parametrize("cap", [128, 256, 512])
@pytest.mark.parametrize("strategy", sorted(_tile_sweeps()))
def test_tuned_width_gives_the_shipped_widths_bits(cuda, monkeypatch,
                                                   strategy, cap):
    # The sweep resolves the width once, inside the tuned schedule, and
    # launches at min(shipped, cap); every block is the shipped width's.
    monkeypatch.delenv("DBX_LANES_CAP", raising=False)
    run = _tile_sweeps()[strategy]
    widths = []
    tiles = fused.window_tiles

    def spy(lanes, *windows):
        widths.append(lanes)
        return tiles(lanes, *windows)

    monkeypatch.setattr(fused, "window_tiles", spy)
    want = torch.stack(list(run(cost=1e-3, device=cuda)))
    with fused.tuned_schedule({"lanes_cap": str(cap)}):
        got = torch.stack(list(run(cost=1e-3, device=cuda)))
    shipped = fused.shipped_lanes(strategy)
    assert widths == [shipped, min(shipped, cap)]
    assert torch.equal(got, want)


def test_autotune_measure_times_the_groups_sweep_on_the_card(cuda):
    from distributed_backtesting_exploration_tpu_torch.rpc import compute

    backend = compute.TorchSweepBackend(device=cuda)
    close = torch.as_tensor(data.synthetic_ohlcv(8, 300, seed=4).close,
                            device=cuda)
    g = {k: v.numpy() for k, v in sweep.product_grid(
        fast=np.float32(np.arange(3, 23)),
        slow=np.float32(np.arange(30, 90))).items()}
    measure = backend._autotune_measure(lambda: lambda: fused.fused_sma_sweep(
        close, g["fast"], g["slow"], cost=1e-3, device=cuda))
    for cap in ("0", "256", "512"):
        assert measure({"lanes_cap": cap}) > 0.0


def _dispatch_loop(dev, recs, results_dir, **queue_kw):
    """The port's dispatcher over loopback gRPC and the port's worker on
    ``dev``; the results directory's blocks by job id."""
    import os
    import threading
    import time

    from distributed_backtesting_exploration_tpu_torch import obs
    from distributed_backtesting_exploration_tpu_torch.rpc import (
        compute, dispatcher)
    from distributed_backtesting_exploration_tpu_torch.rpc.worker import (
        Worker)

    q = dispatcher.JobQueue(**queue_kw)
    disp = dispatcher.Dispatcher(q, dispatcher.PeerRegistry(),
                                 results_dir=str(results_dir),
                                 registry=obs.Registry())
    srv = dispatcher.DispatcherServer(disp, bind="localhost:0").start()
    w = Worker(f"localhost:{srv.port}", compute.TorchSweepBackend(device=dev),
               poll_interval_s=0.005, jobs_per_chip=8)
    t = threading.Thread(target=w.run, daemon=True)
    t.start()
    try:
        for r in recs:
            q.enqueue(r)
        deadline = time.monotonic() + 300.0
        while not q.drained:
            assert time.monotonic() < deadline, q.stats()
            time.sleep(0.01)
    finally:
        w.stop()
        t.join(timeout=60)
        srv.stop()
        disp.close()
    return {r.id: open(os.path.join(str(results_dir), f"{r.id}.dbxm"),
                       "rb").read() for r in recs}


def test_dispatch_loop_blocks_equal_the_direct_backend(cuda, tmp_path):
    import dataclasses

    from distributed_backtesting_exploration_tpu_torch.rpc import (
        backtesting_pb2 as pb, compute, dispatcher, wire)

    grid = dispatcher.parse_grid("fast=5:25,slow=30:130:5")
    recs = [dataclasses.replace(r, id=f"loop-{i}") for i, r in enumerate(
        dispatcher.synthetic_jobs(32, 1260, "sma_crossover", grid,
                                  cost=1e-3, seed=7))]
    before = _kernels.LAUNCHES["fused_sma"]
    got = _dispatch_loop(cuda, recs, tmp_path, device="cuda")
    assert _kernels.LAUNCHES["fused_sma"] > before
    specs = [pb.JobSpec(id=r.id, strategy=r.strategy, ohlcv=r.ohlcv,
                        grid=wire.grid_to_proto(r.grid), cost=r.cost,
                        periods_per_year=252) for r in recs]
    want = {c.job_id: c.metrics for c in
            compute.TorchSweepBackend(device=cuda).process(specs)}
    assert got == want


def test_dispatcher_scenario_panels_on_the_card(cuda):
    from distributed_backtesting_exploration_tpu_torch import scenarios
    from distributed_backtesting_exploration_tpu_torch.rpc import dispatcher

    grid = dispatcher.parse_grid("fast=5:9,slow=30:40:5")
    (base,) = dispatcher.synthetic_jobs(1, 1260, "sma_crossover", grid,
                                        seed=8)
    q = dispatcher.JobQueue(device="cuda")
    q.enqueue(base)
    for rec in dispatcher.scenario_jobs(
            base.panel_digest, 4, "sma_crossover", grid,
            params={"n_bars": 1260, "seed": 2}):
        blob, digest = q._scenario_payload(rec.scenario)
        params = scenarios.ScenarioParams.from_dict(rec.scenario)
        assert blob == scenarios.scenario_panel_bytes(base.ohlcv, params,
                                                      device="cuda")
        assert q.panel_store.get(digest) == blob
