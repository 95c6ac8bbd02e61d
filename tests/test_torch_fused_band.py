"""The port's band-machine families (K2) against the reference.

``fused_bollinger_sweep``, ``fused_bollinger_touch_sweep`` and
``fused_stochastic_sweep`` of the port (plain PyTorch versions on the CPU)
against the reference's wrappers (Pallas, interpret mode on the CPU), on
the shapes of the reference's ``tests/test_fused.py``; the port's generic
models and ``ops/rolling.py``/``ops/signals.py`` additions against the
reference's.

Tolerances and the flip budget: see ``torch_parity``. The Bollinger
z-score sits on a knife edge at the band (the two packages' cumsums and
means associate differently), so those cells may flip; stochastic %K comes
from exact channel extrema and the same float ops, so it must not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.models.base import (
    get_strategy as ref_strategy)
from distributed_backtesting_exploration_tpu.ops import fused as ref_fused
from distributed_backtesting_exploration_tpu.ops import rolling as ref_rolling
from distributed_backtesting_exploration_tpu.ops import signals as ref_signals
from distributed_backtesting_exploration_tpu.parallel import sweep as ref_sweep
from distributed_backtesting_exploration_tpu.utils import data as ref_data
from distributed_backtesting_exploration_tpu_torch.models import get_strategy
from distributed_backtesting_exploration_tpu_torch.ops import (
    fused, rolling, signals)
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import (assert_metrics_match, assert_window_tiles,
                          to_np)


def _grid(**axes):
    g = sweep.product_grid(**{k: np.float32(v) for k, v in axes.items()})
    return {k: to_np(v) for k, v in g.items()}


def _jpanel(panel):
    return ref_data.OHLCV(*(jnp.asarray(f) for f in panel))


def _ragged(lengths, seed):
    series = [ref_data.OHLCV(*(f[0] for f in ref_data.synthetic_ohlcv(
        1, T, seed=seed + i))) for i, T in enumerate(lengths)]
    batch, lens, mask = ref_data.pad_and_stack(series)
    return data.OHLCV(*batch), lens, mask


def _boll(panel, g, port_fn, ref_fn, *, t_real=None, cost=1e-3, **kw):
    got = port_fn(panel.close, g["window"], g["k"], t_real=t_real,
                  cost=cost, device="cpu", **kw)
    want = ref_fn(jnp.asarray(panel.close), g["window"], g["k"],
                  t_real=t_real, cost=cost, **kw)
    return got, want


@pytest.mark.parametrize("n,T,windows,ks,cost,seed,z_exit", [
    (3, 200, [10, 20, 30], [0.5, 1.0, 2.0], 1e-3, 0, 0.0),     # small
    (2, 251, [8, 16], [1.0, 1.5], 1e-3, 3, 0.0),                # unaligned T
    (2, 320, list(range(5, 16)), [0.5, 1.0, 1.5, 2.0, 2.5, 3.0], 1e-3, 5,
     0.0),                                                      # wide grid
    (1, 137, [12], [1.5], 1e-3, 7, 0.0),                        # one param
    (2, 200, [10, 25], [1.0, 2.0], 0.0, 9, 0.0),                # zero cost
    (2, 200, [10, 20], [1.0, 2.0], 1e-3, 11, 0.3),              # z_exit
])
def test_fused_bollinger_matches_reference(n, T, windows, ks, cost, seed,
                                           z_exit):
    panel = data.synthetic_ohlcv(n, T, seed=seed)
    g = _grid(k=ks, window=windows)
    assert_metrics_match(*_boll(panel, g, fused.fused_bollinger_sweep,
                                ref_fused.fused_bollinger_sweep, cost=cost,
                                z_exit=z_exit))


def test_fused_bollinger_ragged_matches_reference():
    panel, lens, _ = _ragged([180, 131, 256], seed=11)
    g = _grid(k=[1.0, 2.0], window=[10, 20])
    assert_metrics_match(*_boll(panel, g, fused.fused_bollinger_sweep,
                                ref_fused.fused_bollinger_sweep,
                                t_real=lens))


@pytest.mark.parametrize("n,T,windows,ks,seed", [
    (3, 200, [10, 20, 30], [0.5, 1.0, 2.0], 33),
    (3, 251, [8, 16], [1.0, 1.5], 35),         # the reference's knife edge
])
def test_fused_bollinger_touch_matches_reference(n, T, windows, ks, seed):
    panel = data.synthetic_ohlcv(n, T, seed=seed)
    g = _grid(k=ks, window=windows)
    assert_metrics_match(*_boll(panel, g, fused.fused_bollinger_touch_sweep,
                                ref_fused.fused_bollinger_touch_sweep))


def test_fused_bollinger_touch_ragged_matches_reference():
    panel, lens, _ = _ragged([180, 131, 256], seed=37)
    g = _grid(k=[1.0, 2.0], window=[10, 20])
    assert_metrics_match(*_boll(panel, g, fused.fused_bollinger_touch_sweep,
                                ref_fused.fused_bollinger_touch_sweep,
                                t_real=lens))


@pytest.mark.parametrize("sweep_fn,ref_fn", [
    (fused.fused_bollinger_sweep, ref_fused.fused_bollinger_sweep),
    (fused.fused_bollinger_touch_sweep, ref_fused.fused_bollinger_touch_sweep),
], ids=["hysteresis", "touch"])
def test_fused_bollinger_hbm_table_matches_inline(sweep_fn, ref_fn):
    # A valid table value changes nothing in the port (one kernel design
    # serves both), and the reference's HBM substrate agrees with it under
    # the flip rule.
    panel = data.synthetic_ohlcv(2, 160, seed=13)
    g = _grid(k=[0.5, 1.5], window=[8, 21])
    inline = sweep_fn(panel.close, g["window"], g["k"], cost=1e-3,
                      device="cpu")
    hbm, want = _boll(panel, g, sweep_fn, ref_fn, table="hbm")
    for a, b in zip(inline, hbm):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    assert_metrics_match(hbm, want)


def _stoch(panel, g, *, t_real=None, cost=1e-3):
    got = fused.fused_stochastic_sweep(
        panel.close, panel.high, panel.low, g["window"], g["band"],
        t_real=t_real, cost=cost, device="cpu")
    jp = _jpanel(panel)
    want = ref_fused.fused_stochastic_sweep(
        jp.close, jp.high, jp.low, g["window"], g["band"], t_real=t_real,
        cost=cost)
    return got, want


@pytest.mark.parametrize("n,T,windows,bands,seed", [
    (3, 200, [10, 14, 21], [20.0, 30.0], 41),
    (3, 251, [8, 16], [25.0], 43),
])
def test_fused_stochastic_matches_reference(n, T, windows, bands, seed):
    panel = data.synthetic_ohlcv(n, T, seed=seed)
    g = _grid(band=bands, window=windows)
    assert assert_metrics_match(*_stoch(panel, g)) == 0


def test_fused_stochastic_ragged_matches_reference():
    panel, lens, _ = _ragged([150, 200, 97], seed=45)
    g = _grid(band=[20.0, 30.0], window=[10.0, 14.0])
    assert assert_metrics_match(*_stoch(panel, g, t_real=lens)) == 0


@pytest.mark.parametrize("call", [
    lambda x, w, **kw: fused.fused_bollinger_sweep(x, w, [1.0], **kw),
    lambda x, w, **kw: fused.fused_bollinger_touch_sweep(x, w, [1.0], **kw),
    lambda x, w, **kw: fused.fused_stochastic_sweep(x, x, x, w, [20.0],
                                                    **kw),
], ids=["bollinger", "bollinger_touch", "stochastic"])
def test_fused_band_rejects_non_integer_windows(call):
    with pytest.raises(ValueError, match="integral"):
        call(np.ones((1, 64), np.float32), np.float32([10.5]), device="cpu")


@pytest.mark.parametrize("kw,exc", [
    ({"carry_out": True}, None),
    ({"epilogue": "scan:7"}, ValueError),
    ({"table": "vmem"}, ValueError),
])
def test_fused_bollinger_argument_rules(kw, exc):
    def call():
        return fused.fused_bollinger_sweep(np.ones((1, 64), np.float32),
                                           [10.0], [1.0], device="cpu", **kw)
    if exc is None:
        # carry_out=True: the metrics beside the streaming checkpoint.
        m, carry = call()
        assert carry.strategy == "bollinger" and carry.n_bars == 64
        assert m.sharpe.shape == carry.metric["s1"].shape == (1, 1)
    else:
        with pytest.raises(exc):
            call()


def test_fused_band_rejects_mismatched_grid():
    with pytest.raises(ValueError, match="one length"):
        fused.fused_bollinger_sweep(np.ones((1, 64), np.float32),
                                    [10.0, 20.0], [1.0], device="cpu")


@pytest.mark.parametrize("strategy,axes", [
    ("bollinger", {"k": [0.5, 1.5], "window": [10, 20]}),
    ("bollinger_touch", {"k": [1.0, 2.0], "window": [8, 17]}),
    ("stochastic", {"band": [20.0, 30.0], "window": [10, 14]}),
    ("bollinger", {"k": [1.0], "window": [9.5, 15.0]}),   # non-integral
])
def test_generic_band_models_match_reference(strategy, axes):
    panel = data.synthetic_ohlcv(2, 180, seed=21)
    g = _grid(**axes)
    got = sweep.run_sweep(panel, get_strategy(strategy), g, cost=1e-3,
                          device="cpu")
    want = ref_sweep.jit_sweep(
        _jpanel(panel), ref_strategy(strategy),
        {k: jnp.asarray(v) for k, v in g.items()}, cost=1e-3)
    assert_metrics_match(got, want)


def test_generic_stochastic_ragged_matches_reference():
    panel, lens, mask = _ragged([150, 97], seed=23)
    g = _grid(band=[25.0], window=[10, 21])
    got = sweep.run_sweep(panel, get_strategy("stochastic"), g, cost=1e-3,
                          bar_mask=mask, device="cpu")
    want = ref_sweep.jit_sweep(
        _jpanel(panel), ref_strategy("stochastic"),
        {k: jnp.asarray(v) for k, v in g.items()}, cost=1e-3,
        bar_mask=jnp.asarray(mask))
    assert assert_metrics_match(got, want) == 0


@pytest.mark.parametrize("strategy,fn,axes", [
    ("bollinger", fused.fused_bollinger_sweep, {"k": [0.5, 2.0],
                                                "window": [10, 30]}),
    ("bollinger_touch", fused.fused_bollinger_touch_sweep,
     {"k": [1.0, 1.5], "window": [12, 20]}),
])
def test_fused_band_plain_matches_generic_sweep(strategy, fn, axes):
    panel = data.synthetic_ohlcv(3, 150, seed=27)
    g = _grid(**axes)
    got = fn(panel.close, g["window"], g["k"], cost=1e-3, device="cpu")
    want = sweep.run_sweep(panel, get_strategy(strategy), g, cost=1e-3,
                           device="cpu")
    assert_metrics_match(got, want)


def test_fused_stochastic_plain_matches_generic_sweep():
    panel = data.synthetic_ohlcv(3, 150, seed=29)
    g = _grid(band=[15.0, 30.0], window=[9, 20])
    got = fused.fused_stochastic_sweep(panel.close, panel.high, panel.low,
                                       g["window"], g["band"], cost=1e-3,
                                       device="cpu")
    want = sweep.run_sweep(panel, get_strategy("stochastic"), g, cost=1e-3,
                           device="cpu")
    # Exact channels and the same %K ops: no cell may flip.
    assert assert_metrics_match(got, want) == 0


def test_band_inline_plain_equals_table_form():
    panel = data.synthetic_ohlcv(2, 90, seed=31)
    c = torch.from_numpy(panel.close)
    xc = c - c.mean(1, keepdim=True)
    cs, csx, csx2 = (torch.cumsum(x, 1) for x in (c, xc, xc * xc))
    r = fused.simple_returns(c)
    tr = torch.full((2,), 90, dtype=torch.int32)
    win = torch.tensor([20, 5, 20, 9], dtype=torch.int32)
    k = torch.tensor([1.0, 0.5, 2.0, 1.5])
    kw = dict(machine="hysteresis", z_exit=0.0, cost=1e-3, ppy=252)
    a = fused.band_inline_plain(c, cs, csx, csx2, r, tr, win, k, win, **kw)
    windows = torch.tensor([5, 9, 20])
    z = fused.boll_z_table(c, cs, csx, csx2, windows)
    widx = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
    b = fused.band_machine_plain(z, r, tr, widx, k, win, **kw)
    assert a.shape == (9, 2, 4)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="machine"):
        fused.band_machine_plain(z, r, tr, widx, k, win, machine="latch",
                                 z_exit=0.0, cost=0.0, ppy=252)


def test_band_hysteresis_matches_reference():
    rng = np.random.default_rng(3)
    z = rng.standard_normal((3, 4, 120)).astype(np.float32) * 1.5
    valid = np.arange(120) >= 10
    k = np.float32([0.5, 1.0, 1.5, 2.0])
    got = signals.band_hysteresis(torch.from_numpy(z), torch.from_numpy(valid),
                                  torch.from_numpy(k)[:, None], 0.25)
    want = ref_signals.band_hysteresis(jnp.asarray(z), jnp.asarray(valid),
                                       jnp.asarray(k), 0.25)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert set(np.unique(to_np(got))) <= {-1.0, 0.0, 1.0}


@pytest.mark.parametrize("fn,ref_fn", [
    (rolling.rolling_var, ref_rolling.rolling_var),
    (rolling.rolling_std, ref_rolling.rolling_std),
    (rolling.rolling_zscore, ref_rolling.rolling_zscore),
], ids=["var", "std", "zscore"])
def test_rolling_moments_match_reference(fn, ref_fn):
    # Windowed moments are cumsum differences: the two packages' cumsums
    # associate differently, so they agree to the reference's own budget
    # for these ops (tests/test_rolling.py: rtol=5e-3, atol=1e-4).
    x = data.synthetic_ohlcv(2, 100, seed=5).close
    for w in (7, 30):
        got = to_np(fn(torch.from_numpy(x), w, fill=0.0))
        want = np.asarray(ref_fn(jnp.asarray(x), w, fill=0.0))
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-4)


@pytest.mark.parametrize("mode", ["max", "min"])
def test_rolling_extrema_match_reference(mode):
    p = data.synthetic_ohlcv(2, 90, seed=6)
    x = p.high if mode == "max" else p.low
    port_fn = rolling.rolling_max if mode == "max" else rolling.rolling_min
    static_fn = ref_rolling.rolling_max if mode == "max" else \
        ref_rolling.rolling_min
    windows = np.float32([1, 4, 13, 40])[:, None]
    got = to_np(port_fn(torch.from_numpy(x)[:, None, :],
                        torch.from_numpy(windows), fill=0.0))
    for i, w in enumerate(windows[:, 0]):
        want = np.asarray(static_fn(jnp.asarray(x), int(w), fill=0.0))
        np.testing.assert_array_equal(got[:, i], want)
    # The traced form's view bound: a window beyond it poisons the output.
    bounded = to_np(port_fn(torch.from_numpy(x), 20.0, max_window=16))
    ref_bounded = np.asarray(ref_rolling.rolling_extrema_traced(
        jnp.asarray(x), 20.0, max_window=16, mode=mode))
    np.testing.assert_array_equal(np.isnan(bounded), np.isnan(ref_bounded))
    assert np.isnan(bounded[:, 19:]).all()


def _stoch_rows(panel, lens=None):
    c, h, lo = (torch.from_numpy(f) for f in (panel.close, panel.high,
                                              panel.low))
    n, T = c.shape
    tr = torch.from_numpy(fused._check_t_real(lens, n, T))
    return c, h, lo, fused.simple_returns(c), tr


def _table_form(c, h, lo, r, tr, g, kw):
    """The stochastic entry's old table form: the (N, W, T) %K table and the
    table entry's plain version over it, lanes in the caller's order."""
    windows, _, widx, warm = fused._window_setup(g["window"], "windows", 0.0,
                                                 1)
    z = fused.stochastic_z_table(c, h, lo, windows)
    return fused.band_machine_plain(
        z, r, tr, *(torch.from_numpy(a) for a in (widx, g["band"], warm)),
        **kw)


@pytest.mark.parametrize("case", ["ragged", "beyond_history", "window_1",
                                  "straddling"])
@pytest.mark.parametrize("machine", ["hysteresis", "touch"])
def test_band_stoch_plain_equals_table_form(case, machine):
    # The stochastic entry's plain version (raw rows, window-major lanes)
    # equals the %K table form in the caller's order, bit for bit.
    lens = None
    if case == "ragged":
        panel, lens, _ = _ragged([150, 200, 97], seed=61)
        g = _grid(band=[20.0, 30.0], window=[3, 10, 14, 64])
    elif case == "beyond_history":
        panel = data.synthetic_ohlcv(2, 120, seed=62)
        g = _grid(band=[25.0], window=[10, 200])
    elif case == "window_1":
        panel = data.synthetic_ohlcv(2, 90, seed=63)
        g = _grid(band=[10.0, 40.0], window=[1, 2, 7])
    else:   # 3 x 60 lanes: 128-lane blocks straddle windows
        panel = data.synthetic_ohlcv(2, 100, seed=64)
        g = _grid(band=[15.0, 25.0, 35.0], window=list(range(1, 61)))
    c, h, lo, r, tr = _stoch_rows(panel, lens)
    kw = dict(machine=machine, z_exit=0.0, cost=1e-3, ppy=252)
    want = _table_form(c, h, lo, r, tr, g, kw)
    _, win, widx, warm = fused._window_setup(g["window"], "windows", 0.0, 1)
    lane, _, win, band, warm = fused.window_major(widx, win, g["band"], warm)
    got = fused.band_stoch(c, h, lo, r, tr, *(torch.from_numpy(a) for a in
                                              (win, band, warm, lane)), **kw)
    assert got.shape == (9, c.shape[0], g["band"].size)
    assert torch.equal(got, want)


@pytest.mark.parametrize("lanes,ks,windows", [
    (1024, np.linspace(0.5, 3.0, 50), range(10, 50, 2)),  # the bench grid
    (128, np.linspace(0.5, 3.0, 50), range(10, 50, 2)),   # ragged last tile
    (32, [1.0], [5, 9, 20]),                    # one tile, 3 of 32 lanes
    (256, np.linspace(0.5, 3.0, 8), range(5, 301)),       # many windows
])
def test_window_tiles_give_each_lane_its_window(lanes, ks, windows):
    # K2 inline's tile lists: every lane's index gives back its window,
    # and a list holds at most one window a lane.
    g = _grid(k=ks, window=list(windows))
    _, win, _, _ = fused._window_setup(g["window"], "windows", 0.0, 1)
    win = torch.from_numpy(win)
    assert_window_tiles(lanes, (win,), fused.window_tiles(lanes, win))


def test_window_tiles_select_the_plain_versions_z_rows():
    # The z of a tile's list, selected by each lane's index, is the lane's
    # own z row bit for bit, as the kernel's bar blocks hand it over.
    panel = data.synthetic_ohlcv(2, 90, seed=32)
    c = torch.from_numpy(panel.close)
    xc = c - c.mean(1, keepdim=True)
    cs, csx, csx2 = (torch.cumsum(x, 1) for x in (c, xc, xc * xc))
    win = torch.tensor([20, 5, 20, 9, 95, 5, 33], dtype=torch.int32).repeat(10)
    lanes = 32
    wins, counts, wi = fused.window_tiles(lanes, win)
    for t in range(wins.shape[0]):
        sel = slice(t * lanes, (t + 1) * lanes)
        table = fused.boll_z_table(c, cs, csx, csx2, wins[t, :counts[t]])
        want = fused.boll_z_table(c, cs, csx, csx2, win[sel])
        assert torch.equal(table[:, wi[sel].long()], want)


@pytest.mark.parametrize("source", ["stochastic", "rsi"])
def test_window_major_lanes_give_the_callers_planes(source):
    # The table entry over a grid whose 128-lane blocks straddle windows:
    # lanes in window-major order with `lane` give the caller's-order
    # planes bit for bit.
    panel = data.synthetic_ohlcv(2, 80, seed=65)
    c, h, lo, r, tr = _stoch_rows(panel)
    g = _grid(band=[12.0, 20.0, 28.0], window=list(range(2, 62)))
    windows, _, widx, warm = fused._window_setup(g["window"], "windows", 0.0,
                                                 1)
    z = (fused.stochastic_z_table(c, h, lo, windows) if source ==
         "stochastic" else fused.rsi_z_table(c, windows))
    kw = dict(machine="hysteresis", z_exit=0.0, cost=1e-3, ppy=252)
    want = fused.band_table(z, r, tr, *(torch.from_numpy(a) for a in
                                        (widx, g["band"], warm)), **kw)
    lane, widx_s, band_s, warm_s = fused.window_major(widx, g["band"], warm)
    assert (np.diff(widx_s) >= 0).all()
    assert sorted(lane.tolist()) == list(range(widx.size))
    got = fused.band_table(z, r, tr, *(torch.from_numpy(a) for a in
                                       (widx_s, band_s, warm_s, lane)), **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["max", "min"])
def test_extrema_levels_give_the_channel_rows(mode):
    # The device-memory levels of the long-row variant: level j is the
    # rolling extreme over 2^j bars, so every channel row follows from two
    # of its spans as `_extrema_rows` takes them.
    x = torch.from_numpy(data.synthetic_ohlcv(2, 70, seed=66).high)
    L = 6                                   # floor(log2 70)
    lev = fused.extrema_levels(x, L, mode)
    assert lev.shape == (2, L + 1, 70)
    op = torch.maximum if mode == "max" else torch.minimum
    for j in range(L + 1):
        want = rolling.rolling_max(x, 1 << j, fill=0.0) if mode == "max" \
            else rolling.rolling_min(x, 1 << j, fill=0.0)
        t0 = (1 << j) - 1
        assert torch.equal(lev[:, j, t0:], want[:, t0:])
    for w, row in fused._extrema_rows(x, np.asarray([1, 5, 64, 70]), mode):
        j = w.bit_length() - 1
        span = op(lev[:, j], fused._shift_t(lev[:, j], w - (1 << j),
                                            -np.inf if mode == "max"
                                            else np.inf))
        assert torch.equal(row, span)
