"""The port's ``fused_sma_sweep`` (plain PyTorch version on the CPU) against
the reference's ``fused_sma_sweep`` (Pallas, interpret mode on the CPU),
on the shapes of ``tests/test_fused.py``; and against the port's own
generic sweep.

Tolerances and the flip budget: see ``torch_parity``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.ops import fused as ref_fused
from distributed_backtesting_exploration_tpu.utils import data as ref_data
from distributed_backtesting_exploration_tpu_torch.models import get_strategy
from distributed_backtesting_exploration_tpu_torch.ops import fused
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import (assert_metrics_match, assert_window_tiles,
                          to_np)


def _flat(fast_axis, slow_axis):
    g = sweep.product_grid(fast=np.float32(fast_axis),
                           slow=np.float32(slow_axis))
    return to_np(g["fast"]), to_np(g["slow"])


def _both(close, fast, slow, *, t_real=None, cost=1e-3, **kw):
    got = fused.fused_sma_sweep(close, fast, slow, t_real=t_real, cost=cost,
                                device="cpu", **kw)
    want = ref_fused.fused_sma_sweep(jnp.asarray(close), fast, slow,
                                     t_real=t_real, cost=cost, **kw)
    return got, want


@pytest.mark.parametrize("n,T,fast,slow,cost,seed", [
    (3, 200, [3, 5, 8], [13, 21], 1e-3, 0),                   # small
    (2, 251, [4, 6], [17, 29], 1e-3, 3),                      # unaligned T
    (2, 320, list(range(3, 14)), list(range(20, 44, 2)), 1e-3, 5),  # 2 blocks
    (1, 137, [5], [20], 1e-3, 7),                             # single param
    (2, 200, [3, 7], [15, 31], 0.0, 9),                       # zero cost
    (2, 64, [5, 30], [40, 90], 1e-3, 2),                      # w > T
])
def test_fused_matches_reference(n, T, fast, slow, cost, seed):
    close = data.synthetic_ohlcv(n, T, seed=seed).close
    assert_metrics_match(*_both(close, *_flat(fast, slow), cost=cost))


def _ragged_close(lengths, seed):
    series = [ref_data.OHLCV(*(f[0] for f in ref_data.synthetic_ohlcv(
        1, T, seed=seed + i))) for i, T in enumerate(lengths)]
    batch, lens, _ = ref_data.pad_and_stack(series, lane_multiple=8)
    return batch.close, lens


def test_fused_ragged_matches_reference():
    close, lens = _ragged_close([300, 251, 170], seed=13)
    assert_metrics_match(*_both(close, *_flat([3, 5, 8], [13, 21]),
                                t_real=lens))


def test_fused_ragged_ignores_pad_content():
    # The port stops each ticker at its real length: what lies past it
    # (here garbage instead of the repeated last close) changes nothing.
    close, lens = _ragged_close([120, 90], seed=17)
    fast, slow = _flat([3, 5], [11, 17])
    a = fused.fused_sma_sweep(close, fast, slow, t_real=lens, cost=1e-3,
                              device="cpu")
    dirty = close.copy()
    dirty[1, 90:] = 1e6
    b = fused.fused_sma_sweep(dirty, fast, slow, t_real=lens, cost=1e-3,
                              device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(to_np(x), to_np(y))


@pytest.mark.parametrize("epilogue", ["ladder", "scan:16"])
def test_fused_epilogues_match_reference(epilogue):
    close = data.synthetic_ohlcv(2, 96, seed=21).close
    assert_metrics_match(*_both(close, *_flat([3, 6], [12, 20]),
                                epilogue=epilogue))


@pytest.mark.parametrize("kw", [{"epilogue": "scan:7"},
                                {"epilogue": "bogus"},
                                {"epilogue": "scan:x"},
                                {"table": "vmem"}])
def test_fused_rejects_invalid_substrate(kw):
    close = np.ones((1, 64), np.float32)
    with pytest.raises(ValueError):
        ref_fused.fused_sma_sweep(jnp.asarray(close), np.float32([3]),
                                  np.float32([10]), **kw)
    with pytest.raises(ValueError):
        fused.fused_sma_sweep(close, np.float32([3]), np.float32([10]),
                              device="cpu", **kw)


@pytest.mark.parametrize("table", [None, "inline", "hbm"])
def test_fused_valid_substrate_changes_nothing(table):
    close = data.synthetic_ohlcv(1, 80, seed=4).close
    fast, slow = _flat([3, 4], [10, 15])
    base = fused.fused_sma_sweep(close, fast, slow, device="cpu")
    other = fused.fused_sma_sweep(close, fast, slow, table=table,
                                  epilogue="ladder", device="cpu")
    for x, y in zip(base, other):
        np.testing.assert_array_equal(to_np(x), to_np(y))


def test_fused_rejects_non_integer_windows():
    with pytest.raises(ValueError, match="integral"):
        fused.fused_sma_sweep(np.ones((1, 64), np.float32), np.float32([3.5]),
                              np.float32([10.0]), device="cpu")


@pytest.mark.parametrize("t_real", [[0], [65], [10, 10]])
def test_fused_rejects_bad_lengths(t_real):
    with pytest.raises(ValueError, match="t_real"):
        fused.fused_sma_sweep(np.ones((1, 64), np.float32), [3.0], [10.0],
                              t_real=t_real, device="cpu")


def test_fused_carry_out_returns_the_streaming_checkpoint():
    close = data.synthetic_ohlcv(2, 64, seed=4).close
    plain = fused.fused_sma_sweep(close, [3.0], [10.0], device="cpu")
    m, carry = fused.fused_sma_sweep(close, [3.0], [10.0], carry_out=True,
                                     device="cpu")
    for got, want in zip(m, plain):
        assert torch.equal(got, want)
    assert (carry.strategy, carry.n_bars) == ("sma_crossover", 64)
    assert carry.metric["s1"].shape == (2, 1)
    with pytest.raises(ValueError, match="uniform full-history"):
        fused.fused_sma_sweep(close, [3.0], [10.0], t_real=[64, 60],
                              carry_out=True, device="cpu")


@pytest.mark.parametrize("ragged", [False, True])
def test_fused_plain_matches_generic_sweep(ragged):
    if ragged:
        close, lens = _ragged_close([150, 97, 200], seed=31)
        mask = np.arange(close.shape[1])[None, :] < lens[:, None]
    else:
        close, lens, mask = data.synthetic_ohlcv(3, 180, seed=31).close, \
            None, None
    fast, slow = _flat([3, 5, 8], [13, 21, 34])
    got = fused.fused_sma_sweep(close, fast, slow, t_real=lens, cost=1e-3,
                                device="cpu")
    panel = data.OHLCV(*([close] * 5))
    want = sweep.run_sweep(panel, get_strategy("sma_crossover"),
                           {"fast": fast, "slow": slow}, cost=1e-3,
                           bar_mask=mask, device="cpu")
    # Same cumsum, same positions: only the order of the metric sums
    # differs, so no cell may flip.
    assert assert_metrics_match(got, want) == 0


def test_fused_plain_version_on_shared_inputs_matches_sweep_wrapper():
    close = data.synthetic_ohlcv(2, 70, seed=40).close
    fast, slow = _flat([3, 5], [9, 12])
    c = torch.from_numpy(close)
    fw, sw, warm = fused._grid_setup(fast, slow)
    planes = fused.fused_sma_plain(
        torch.cumsum(c, 1), fused.simple_returns(c),
        torch.full((2,), 70, dtype=torch.int32), torch.from_numpy(fw),
        torch.from_numpy(sw), torch.from_numpy(warm), cost=1e-3, ppy=252)
    assert planes.shape == (9, 2, 4)
    m = fused.fused_sma_sweep(close, fast, slow, cost=1e-3, device="cpu")
    for k, f in enumerate(m):
        np.testing.assert_array_equal(to_np(planes[k]), to_np(f))


@pytest.mark.parametrize("lanes,fast_axis,slow_axis", [
    (1024, range(5, 25), range(30, 230, 2)),    # the bench grid: 2 tiles
    (128, range(5, 25), range(30, 230, 2)),     # ragged last tile
    (32, [3, 5, 8], [13, 21]),                  # one tile, 6 of 32 lanes
    (64, range(2, 21), range(10, 31)),          # fast and slow overlap
    (256, range(2, 130), range(130, 401)),      # many distinct windows
])
def test_window_tiles_give_each_lane_its_windows(lanes, fast_axis,
                                                 slow_axis):
    # K1's tile lists: every lane's fast and slow index give back its
    # windows, and a list holds at most two windows a lane.
    fw, sw, _ = fused._grid_setup(*_flat(list(fast_axis), list(slow_axis)))
    fw, sw = torch.from_numpy(fw), torch.from_numpy(sw)
    assert_window_tiles(lanes, (fw, sw), fused.window_tiles(lanes, fw, sw))


def test_window_tiles_select_the_plain_versions_sma_rows():
    # The SMAs of a tile's list, selected by each lane's indices, are the
    # lane's own fast and slow SMA rows bit for bit, as the kernel's bar
    # blocks hand them to its lanes.
    close = torch.from_numpy(data.synthetic_ohlcv(2, 90, seed=41).close)
    cs = torch.cumsum(close, 1)
    fw, sw, _ = fused._grid_setup(*_flat([2, 3, 5, 40, 95], [4, 9, 30, 60]))
    fw, sw = torch.from_numpy(fw), torch.from_numpy(sw)
    lanes = 32
    wins, counts, fi, si = fused.window_tiles(lanes, fw, sw)
    for t in range(wins.shape[0]):
        sel = slice(t * lanes, (t + 1) * lanes)
        table = fused.sma_table(cs, wins[t, :counts[t]].long())
        for w, i in ((fw, fi), (sw, si)):
            want = fused.sma_table(cs, w[sel].long())
            assert torch.equal(table[:, i[sel].long()], want)


def test_window_tiles_of_no_lanes():
    wins, counts, fi, si = fused.window_tiles(
        128, torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32))
    assert wins.shape == (0, 256) and counts.shape == (0,)
    assert fi.shape == si.shape == (0,)
