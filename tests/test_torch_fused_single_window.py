"""The port's single-window families (K3) against the reference.

``fused_momentum_sweep``, ``fused_donchian_sweep`` and
``fused_donchian_hl_sweep`` of the port (plain PyTorch versions on the
CPU) against the reference's wrappers (Pallas, interpret mode on the CPU),
on the shapes of the reference's ``tests/test_fused.py`` (including the
ragged case, an unaligned T and a window beyond the history), and the
port's generic models against the reference's.

The signals are exact in both packages (raw past closes, max/min of raw
prices and comparisons), so every case must show 0 flipped cells; the
metrics agree at ``torch_parity``'s rtol=2e-4, atol=2e-5.
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
from distributed_backtesting_exploration_tpu_torch.ops import fused
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import assert_metrics_match, to_np


def _jpanel(panel):
    return ref_data.OHLCV(*(jnp.asarray(f) for f in panel))


def _ragged(lengths, seed):
    series = [ref_data.OHLCV(*(f[0] for f in ref_data.synthetic_ohlcv(
        1, T, seed=seed + i))) for i, T in enumerate(lengths)]
    batch, lens, mask = ref_data.pad_and_stack(series)
    return data.OHLCV(*batch), lens, mask


def _run(strategy, panel, vals, *, t_real=None, cost=1e-3):
    """The port's and the reference's fused sweep of one family."""
    vals = np.float32(vals)
    jp = _jpanel(panel)
    if strategy == "momentum":
        got = fused.fused_momentum_sweep(panel.close, vals, t_real=t_real,
                                         cost=cost, device="cpu")
        want = ref_fused.fused_momentum_sweep(jp.close, vals, t_real=t_real,
                                              cost=cost)
    elif strategy == "donchian":
        got = fused.fused_donchian_sweep(panel.close, vals, t_real=t_real,
                                         cost=cost, device="cpu")
        want = ref_fused.fused_donchian_sweep(jp.close, vals, t_real=t_real,
                                              cost=cost)
    else:
        got = fused.fused_donchian_hl_sweep(
            panel.close, panel.high, panel.low, vals, t_real=t_real,
            cost=cost, device="cpu")
        want = ref_fused.fused_donchian_hl_sweep(
            jp.close, jp.high, jp.low, vals, t_real=t_real, cost=cost)
    return got, want


@pytest.mark.parametrize("strategy,n,T,vals,seed,cost", [
    ("momentum", 3, 200, [5, 10, 21, 63], 0, 1e-3),
    ("momentum", 3, 251, [8, 13], 3, 1e-3),               # unaligned T
    ("momentum", 2, 120, [5, 150], 4, 0.0),               # beyond history
    ("donchian", 3, 200, [10, 20, 55], 5, 1e-3),
    ("donchian", 3, 251, [15, 30], 7, 1e-3),
    ("donchian", 2, 100, [10, 200], 31, 1e-3),            # beyond history
    ("donchian_hl", 3, 200, [10, 20, 55], 5, 1e-3),
    ("donchian_hl", 3, 251, [15, 30], 7, 1e-3),
    ("donchian_hl", 2, 100, [10, 200], 31, 1e-3),
])
def test_fused_single_window_matches_reference(strategy, n, T, vals, seed,
                                               cost):
    panel = data.synthetic_ohlcv(n, T, seed=seed)
    got, want = _run(strategy, panel, vals, cost=cost)
    assert assert_metrics_match(got, want) == 0


@pytest.mark.parametrize("strategy,lengths,seed", [
    ("momentum", [150, 200, 97], 20),
    ("donchian", [150, 200, 97], 20),
    ("donchian_hl", [150, 200, 97], 50),
])
def test_fused_single_window_ragged_matches_reference(strategy, lengths,
                                                      seed):
    panel, lens, _ = _ragged(lengths, seed)
    got, want = _run(strategy, panel, [10.0, 20.0], t_real=lens)
    assert assert_metrics_match(got, want) == 0


@pytest.mark.parametrize("strategy", ["momentum", "donchian_hl"])
def test_fused_single_window_ignores_pad_content(strategy):
    # Each ticker stops at its real length: what lies past it changes
    # nothing.
    panel, lens, _ = _ragged([120, 90], seed=17)
    a, _ = _run(strategy, panel, [5.0, 11.0], t_real=lens)
    dirty = data.OHLCV(*(f.copy() for f in panel))
    for f in dirty:
        f[1, 90:] = 1e6
    if strategy == "momentum":
        b = fused.fused_momentum_sweep(dirty.close, [5.0, 11.0], t_real=lens,
                                       cost=1e-3, device="cpu")
    else:
        b = fused.fused_donchian_hl_sweep(
            dirty.close, dirty.high, dirty.low, [5.0, 11.0], t_real=lens,
            cost=1e-3, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(to_np(x), to_np(y))


@pytest.mark.parametrize("call", [
    lambda x, w: fused.fused_momentum_sweep(x, w, device="cpu"),
    lambda x, w: fused.fused_donchian_sweep(x, w, device="cpu"),
    lambda x, w: fused.fused_donchian_hl_sweep(x, x, x, w, device="cpu"),
], ids=["momentum", "donchian", "donchian_hl"])
def test_fused_single_window_rejects_non_integer_windows(call):
    with pytest.raises(ValueError, match="integral"):
        call(np.ones((1, 64), np.float32), np.float32([10.5]))


@pytest.mark.parametrize("call,vals", [
    (lambda x, w: fused.fused_momentum_sweep(x, w, device="cpu"), [-3.0]),
    (lambda x, w: fused.fused_donchian_sweep(x, w, device="cpu"), [0.0]),
], ids=["momentum", "donchian"])
def test_fused_single_window_rejects_empty_windows(call, vals):
    with pytest.raises(ValueError, match="at least"):
        call(np.ones((1, 64), np.float32), np.float32(vals))


@pytest.mark.parametrize("kw,exc", [
    ({"carry_out": True}, None),
    ({"epilogue": "bogus"}, ValueError),
    ({"table": "vmem"}, ValueError),
])
def test_fused_donchian_argument_rules(kw, exc):
    def call():
        return fused.fused_donchian_sweep(np.ones((1, 64), np.float32),
                                          [10.0], device="cpu", **kw)
    if exc is None:
        # carry_out=True: the metrics beside the streaming checkpoint.
        m, carry = call()
        assert carry.strategy == "donchian" and carry.n_bars == 64
        assert m.sharpe.shape == carry.metric["s1"].shape == (1, 1)
    else:
        with pytest.raises(exc):
            call()


def test_fused_donchian_rejects_mismatched_fields():
    x = np.ones((2, 64), np.float32)
    with pytest.raises(ValueError, match="every field"):
        fused.fused_donchian_hl_sweep(x, x[:1], x, [10.0], device="cpu")


@pytest.mark.parametrize("strategy,axis,vals", [
    ("momentum", "lookback", [5, 10, 21]),
    ("momentum", "lookback", [7.5, 12.0]),      # non-integral lookbacks
    ("donchian", "window", [10, 20, 300]),      # beyond the view bound
    ("donchian_hl", "window", [8, 21]),
])
def test_generic_single_window_models_match_reference(strategy, axis, vals):
    panel = data.synthetic_ohlcv(2, 160, seed=9)
    g = {axis: np.float32(vals)}
    got = sweep.run_sweep(panel, get_strategy(strategy), g, cost=1e-3,
                          device="cpu")
    want = ref_sweep.jit_sweep(_jpanel(panel), ref_strategy(strategy),
                               {axis: jnp.asarray(g[axis])}, cost=1e-3)
    assert assert_metrics_match(got, want) == 0


@pytest.mark.parametrize("strategy", ["momentum", "donchian", "donchian_hl"])
def test_fused_single_window_plain_matches_generic_sweep(strategy):
    panel, lens, mask = _ragged([140, 97, 181], seed=41)
    vals = np.float32([6, 15, 40])
    got, _ = _run(strategy, panel, vals, t_real=lens)
    axis = "lookback" if strategy == "momentum" else "window"
    want = sweep.run_sweep(panel, get_strategy(strategy), {axis: vals},
                           cost=1e-3, bar_mask=mask, device="cpu")
    assert assert_metrics_match(got, want) == 0


def _donchian_table_form(c, hi, lo, r, tr, vals):
    """The donchian entry's old table form: the (N, W, T) int8 breakout-sign
    table and the latch over it, lanes in the caller's order."""
    windows, _, widx, warm = fused._window_setup(np.float32(vals), "windows",
                                                 1.0, 1)
    sig = fused.donchian_sign_table(c, hi, lo, windows)
    return fused.donchian_latch_plain(
        sig, r, tr, *(torch.from_numpy(a) for a in (widx, warm)), cost=1e-3,
        ppy=252)


@pytest.mark.parametrize("case", ["ragged", "beyond_history", "window_1",
                                  "straddling"])
@pytest.mark.parametrize("channel", ["close", "high_low"])
def test_donchian_plain_equals_table_form(case, channel):
    # The donchian entry's plain version (raw rows, window-major lanes)
    # equals the sign-table form in the caller's order, bit for bit; the
    # high/low channel with distinct highs and lows.
    lens = None
    if case == "ragged":
        panel, lens, _ = _ragged([150, 200, 97], seed=71)
        vals = [10, 3, 55, 10]
    elif case == "beyond_history":
        panel = data.synthetic_ohlcv(2, 100, seed=72)
        vals = [10, 200]
    elif case == "window_1":
        panel = data.synthetic_ohlcv(2, 90, seed=73)
        vals = [1, 2, 1, 9]
    else:   # 4 x 50 lanes: 128-lane blocks straddle windows
        panel = data.synthetic_ohlcv(2, 120, seed=74)
        vals = np.tile(np.arange(1, 51), 4)
    c, h, lo = (torch.from_numpy(f) for f in (panel.close, panel.high,
                                              panel.low))
    assert not torch.equal(h, lo)
    hi_src, lo_src = (c, c) if channel == "close" else (h, lo)
    r = fused.simple_returns(c)
    tr = torch.from_numpy(fused._check_t_real(lens, *c.shape))
    want = _donchian_table_form(c, hi_src, lo_src, r, tr, vals)
    _, win, widx, warm = fused._window_setup(np.float32(vals), "windows",
                                             1.0, 1)
    lane, _, win, warm = fused.window_major(widx, win, warm)
    got = fused.donchian(c, hi_src, lo_src, r, tr,
                         *(torch.from_numpy(a) for a in (win, warm, lane)),
                         cost=1e-3, ppy=252)
    assert got.shape == (9, c.shape[0], len(vals))
    assert torch.equal(got, want)
