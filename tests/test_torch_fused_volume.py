"""The port's volume families against the reference: obv_trend (K6) and
vwap_reversion (K2's table entry on the VWAP z-table).

``fused_obv_sweep`` and ``fused_vwap_sweep`` of the port (plain PyTorch
versions on the CPU) against the reference's wrappers (Pallas, interpret
mode on the CPU) and the reference's generic ``jit_sweep``, on the cases of
the reference's ``tests/test_fused.py`` (aligned, T=251, ragged lengths
[180, 131, 256], a vwap window beyond the history); each fused sweep
against the port's own generic sweep; and the two kernel entries at a
ragged shape.

Tolerance: ``torch_parity``'s flip rule (at most max(1, 1%) flipped cells,
the rest at rtol=2e-4, atol=2e-5). ``torch.cumsum`` and ``jnp.cumsum``
associate differently, and OBV and the VWAP sums are cumsums of cumsums or
of ``close * volume`` (about 1e7 a bar), so a signal at a knife edge can
flip a cell. Within the port, both paths build the same cumsums with the
same ops, so the fused sweeps take the generic sweep's positions exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.models.base import (
    get_strategy as ref_strategy)
from distributed_backtesting_exploration_tpu.ops import fused as ref_fused
from distributed_backtesting_exploration_tpu.parallel import sweep as ref_sweep
from distributed_backtesting_exploration_tpu.utils import data as ref_data
from distributed_backtesting_exploration_tpu_torch.models import get_strategy
from distributed_backtesting_exploration_tpu_torch.ops import fused, rolling
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import assert_metrics_match, assert_window_tiles, to_np


def _grid(**axes):
    g = sweep.product_grid(**{k: np.float32(v) for k, v in axes.items()})
    return {k: to_np(v) for k, v in g.items()}


def _ragged(lengths, seed):
    series = [ref_data.OHLCV(*(f[0] for f in ref_data.synthetic_ohlcv(
        1, T, seed=seed + i))) for i, T in enumerate(lengths)]
    batch, lens, mask = ref_data.pad_and_stack(series)
    return data.OHLCV(*batch), lens, mask


def _port(strategy, panel, g, **kw):
    if strategy == "obv_trend":
        return fused.fused_obv_sweep(panel.close, panel.volume, g["window"],
                                     device="cpu", **kw)
    return fused.fused_vwap_sweep(panel.close, panel.volume, g["window"],
                                  g["k"], device="cpu", **kw)


def _ref(strategy, panel, g, **kw):
    close, volume = jnp.asarray(panel.close), jnp.asarray(panel.volume)
    if strategy == "obv_trend":
        return ref_fused.fused_obv_sweep(close, volume, g["window"], **kw)
    return ref_fused.fused_vwap_sweep(close, volume, g["window"], g["k"],
                                      **kw)


def _ref_generic(strategy, panel, g, mask=None, **kw):
    return ref_sweep.jit_sweep(
        ref_data.OHLCV(*(jnp.asarray(f) for f in panel)),
        ref_strategy(strategy), {k: jnp.asarray(v) for k, v in g.items()},
        bar_mask=None if mask is None else jnp.asarray(mask), **kw)


# (strategy, grid axes, n, T, seed, ragged lengths): the reference's cases.
CASES = {
    "obv-aligned": ("obv_trend", {"window": [8, 15, 30]}, 3, 200, 17, None),
    "obv-T251": ("obv_trend", {"window": [10, 21]}, 3, 251, 19, None),
    "obv-ragged": ("obv_trend", {"window": [8, 20]}, 0, 0, 70,
                   [180, 131, 256]),
    "vwap-aligned": ("vwap_reversion",
                     {"window": [10, 20, 30], "k": [0.5, 1.0, 2.0]}, 3, 200,
                     13, None),
    "vwap-T251": ("vwap_reversion", {"window": [8, 16], "k": [1.0, 1.5]}, 3,
                  251, 15, None),
    "vwap-ragged": ("vwap_reversion", {"window": [10, 20], "k": [1.0, 2.0]},
                    0, 0, 60, [180, 131, 256]),
    "vwap-window-beyond-history": ("vwap_reversion",
                                   {"window": [10, 150], "k": [1.0]}, 3, 100,
                                   23, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_volume_matches_reference(case):
    strategy, axes, n, T, seed, lengths = CASES[case]
    g = _grid(**axes)
    if lengths is None:
        panel, lens, mask = data.synthetic_ohlcv(n, T, seed=seed), None, None
    else:
        panel, lens, mask = _ragged(lengths, seed)
    got = _port(strategy, panel, g, t_real=lens, cost=1e-3)
    assert_metrics_match(got, _ref(strategy, panel, g, t_real=lens,
                                   cost=1e-3))
    assert_metrics_match(got, _ref_generic(strategy, panel, g, mask,
                                           cost=1e-3))
    if case == "vwap-window-beyond-history":
        # A window longer than the history never passes its warmup.
        flat = g["window"] > T
        assert (to_np(got.turnover)[:, flat] == 0).all()


@pytest.mark.parametrize("strategy", ["obv_trend", "vwap_reversion"])
def test_fused_volume_rejects_non_integral_windows(strategy):
    panel = data.OHLCV(*(np.ones((1, 64), np.float32),) * 5)
    with pytest.raises(ValueError, match="integral"):
        _port(strategy, panel, {"window": np.float32([10.5]),
                                "k": np.float32([1.0])})


@pytest.mark.parametrize("strategy,axes", [
    ("obv_trend", {"window": [5, 12, 40]}),
    ("vwap_reversion", {"window": [6, 14, 30], "k": [0.5, 1.5]}),
])
def test_fused_volume_plain_matches_generic_sweep(strategy, axes):
    panel = data.synthetic_ohlcv(3, 160, seed=81)
    g = _grid(**axes)
    got = _port(strategy, panel, g, cost=1e-3)
    want = sweep.run_sweep(panel, get_strategy(strategy), g, cost=1e-3,
                           device="cpu")
    # The same cumsums and divisions on both paths: identical positions.
    assert assert_metrics_match(got, want) == 0
    np.testing.assert_array_equal(to_np(got.turnover), to_np(want.turnover))


def test_volume_entries_stop_at_t_real():
    # obv_plain and the table entry on the vwap z-table at a ragged shape:
    # each ticker's row equals the same entry run on that ticker alone, cut
    # to its real length, bit for bit.
    panel, lens, _ = _ragged([120, 77, 150], seed=91)
    close, volume = (torch.from_numpy(f) for f in (panel.close,
                                                   panel.volume))
    r = fused.simple_returns(close)
    tr = torch.from_numpy(lens.astype(np.int32))
    _, win, _, warm = fused._window_setup(np.float32([5, 9, 30]), "windows",
                                          0.0, 1)
    win, warm = torch.from_numpy(win), torch.from_numpy(warm)
    series = rolling.obv_series(close, volume)
    cs = torch.cumsum(series, dim=1)
    obv_all = fused.obv(series, cs, r, tr, win, warm, cost=1e-3, ppy=252)
    g = _grid(window=[6, 12], k=[1.0, 2.0])
    windows, _, widx, vwarm = fused._window_setup(g["window"], "windows",
                                                  -1.0, 1, 2.0)
    z = fused.vwap_z_table(close, volume, windows)
    band = dict(machine="hysteresis", z_exit=0.0, cost=1e-3, ppy=252)
    widx, k, vwarm = (torch.from_numpy(a) for a in (widx, g["k"], vwarm))
    vwap_all = fused.band_table(z, r, tr, widx, k, vwarm, **band)
    for i, n in enumerate(lens):
        one = torch.tensor([n], dtype=torch.int32)
        rows = slice(i, i + 1)
        obv_one = fused.obv(series[rows, :n], cs[rows, :n], r[rows, :n], one,
                            win, warm, cost=1e-3, ppy=252)
        vwap_one = fused.band_table(z[rows, :, :n].contiguous(),
                                    r[rows, :n], one, widx, k, vwarm, **band)
        torch.testing.assert_close(obv_all[:, i], obv_one[:, 0], rtol=0,
                                   atol=0)
        torch.testing.assert_close(vwap_all[:, i], vwap_one[:, 0], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("lanes,tiles", [
    (1024, 16),     # the bench grid: two tiles of 125 distinct windows
    (1024, 9),      # 1125 lanes: a ragged last tile of 101
    (128, 16),      # 16 tiles, the last one ragged
    (32, 1),        # four tiles of 32 windows, the last one of 29
])
def test_window_tiles_give_each_obv_lane_its_window(lanes, tiles):
    # K6's tile lists on its tiled bench grid: every lane's index
    # gives back its window, and a list holds at most one a lane.
    _, w, _, _ = fused._window_setup(
        np.tile(np.arange(5, 130, dtype=np.float32), tiles), "windows",
        0.0, 1)
    w = torch.from_numpy(w)
    assert_window_tiles(lanes, (w,), fused.window_tiles(lanes, w))


def test_vwap_z_table_is_a_function_of_a_rows_own_bars():
    # Each row of a ragged stack (repeat-last pad bars) has, over its own
    # bars, the bits of the row's z-table built alone: the deviation is
    # centered over the row's t_real bars, not over the stack's.
    panel = data.synthetic_ohlcv(4, 200, seed=21)
    lens = np.int32([200, 120, 77, 163])
    close, volume = (torch.from_numpy(np.ascontiguousarray(f))
                     for f in (panel.close, panel.volume))
    for i, n in enumerate(lens):
        close[i, n:] = close[i, n - 1]
        volume[i, n:] = volume[i, n - 1]
    windows = np.float32([5, 12, 30])
    z = fused.vwap_z_table(close, volume, windows, lens)
    for i, n in enumerate(lens):
        alone = fused.vwap_z_table(close[i:i + 1, :n], volume[i:i + 1, :n],
                                   windows)
        torch.testing.assert_close(z[i:i + 1, :, :n], alone, rtol=0, atol=0)
    # The full-length default is the t_real of every row at T.
    torch.testing.assert_close(
        fused.vwap_z_table(close, volume, windows),
        fused.vwap_z_table(close, volume, windows, np.full(4, 200)),
        rtol=0, atol=0)
