"""K4's and K7's tiles (``csrc/bar_blocks.cuh``) on the CPU.

``macd_cuda`` and ``pairs_cuda`` run their lanes in tiles whose lists the
wrappers build with :func:`window_tiles`: K4 of each lane's key
``fidx * W + sidx`` (its fast and slow rows of the EMA table), K7 of each
lane's lookback row. Per bar block a CTA stages the value of every listed
key or row once (the macd line ``f_row[t] - s_row[t]``, or the (z, hedged
return) pair), and each lane reads its own through its index. Here:

- the lists give every lane back its key or row, on the bench grids and on
  a ragged P, at each width the kernels are swept over;
- the plain versions evaluated through the tile lists, as the kernels read
  them, equal :func:`macd_plain` and :func:`pairs_plain` bit for bit;
- on the CPU, macd's sweep keeps its torch table (``macd_sweep_table``);
- K4's bound counts the macd line once per distinct (fast, slow) pair.
"""

import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu_torch import roofline
from distributed_backtesting_exploration_tpu_torch.ops import fused
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import assert_window_tiles

AXES = roofline.bench_axes()


def _macd_lanes(axes, P=None):
    """Each lane's (fast, slow) rows of the grid of ``axes`` (the wire's
    sorted axis order), the first ``P`` lanes where given."""
    g = roofline.product({k: axes[k] for k in sorted(axes)})
    spans, fidx, sidx, a_sig, warm = fused._macd_grid_setup(
        g["fast"], g["slow"], g["signal"])
    return spans, *(torch.from_numpy(a[:P]) for a in (fidx, sidx, a_sig,
                                                      warm))


def _pairs_lanes(axes, P=None):
    g = roofline.product({k: axes[k] for k in sorted(axes)})
    windows, widx, k, zx, warm = fused._pairs_grid_setup(
        g["lookback"], g["z_entry"], 0.0)
    return windows, *(torch.from_numpy(a[:P]) for a in (widx, k, zx, warm))


@pytest.mark.parametrize("lanes", [128, 256, 512, 1024])
@pytest.mark.parametrize("P", [None, 777])          # the bench grid; ragged
def test_macd_tile_keys_decode(lanes, P):
    spans, fidx, sidx, *_ = _macd_lanes(AXES["macd"], P)
    W = spans.size
    keys = fused.macd_keys(fidx, sidx, W)
    assert keys.dtype == torch.int64
    tiles = fused.window_tiles(lanes, keys)
    assert_window_tiles(lanes, [keys], tiles)
    wins, counts, wi = tiles
    tile = torch.arange(fidx.numel()) // lanes
    got = wins[tile, wi.long()].long()
    assert torch.equal(got // W, fidx.long())
    assert torch.equal(got % W, sidx.long())
    # The bench grid's 100 (fast, slow) pairs: 10 lanes (signals) each.
    assert int(counts.max()) <= 100


@pytest.mark.parametrize("lanes", [128, 256, 512, 1024])
@pytest.mark.parametrize("P", [None, 333])
def test_pairs_tile_rows_decode(lanes, P):
    windows, widx, *_ = _pairs_lanes(AXES["pairs"], P)
    tiles = fused.window_tiles(lanes, widx)
    assert_window_tiles(lanes, [widx], tiles)
    wins, counts, wi = tiles
    tile = torch.arange(widx.numel()) // lanes
    assert torch.equal(wins[tile, wi.long()], widx)
    # Lookback-major: a tile of L lanes spans at most L / 50 + 1 lookbacks.
    assert int(counts.max()) <= min(windows.size, -(-lanes // 50) + 1)


def _macd_through_tiles(tbl, r, tr, fidx, sidx, a_sig, warm, lanes, cost):
    """K4's plain version as its kernel reads: each tile's listed keys'
    macd lines formed once, each lane reading its own by its index."""
    N, W, T = tbl.shape
    wins, _, wi = fused.window_tiles(lanes, fused.macd_keys(fidx, sidx, W))
    keys = wins.long()
    staged = tbl[:, keys // W, :] - tbl[:, keys % W, :]   # (N, tiles, Wc, T)
    tile = torch.arange(fidx.numel()) // lanes
    return fused._signal_cross_plain(
        lambda t: staged[:, tile, wi.long(), t], r, tr, a_sig, warm,
        cost=cost, ppy=252)


def _pairs_through_tiles(z, hr, tr, widx, k, zx, warm, lanes, cost):
    """K7's plain version as its kernel reads: each tile's listed rows'
    (z, hr) staged once, each lane reading its pair by its index."""
    wins, _, wi = fused.window_tiles(lanes, widx)
    zs, hs = z[:, wins.long(), :], hr[:, wins.long(), :]
    tile, j = torch.arange(widx.numel()) // lanes, wi.long()
    st = fused._MetricState(tr, widx.numel())
    t_on = (warm.long() - 1)[None, :]
    for t in range(z.shape[-1]):
        nxt = fused._band_next(st.prev, zs[:, tile, j, t], k[None, :],
                               zx[None, :], "hysteresis")
        st.step(t, torch.where(t >= t_on, nxt, st.zero), hs[:, tile, j, t],
                cost)
    return st.planes(252)


def _ragged(n, T, seed, lens):
    close = data.synthetic_ohlcv(n, T, seed=seed).close
    for i, m in enumerate(lens):
        close[i, m:] = close[i, m - 1]
    return torch.from_numpy(close), torch.from_numpy(np.int32(lens))


@pytest.mark.parametrize("lanes", [32, 128, 1024])
def test_macd_plain_through_tiles_is_macd_plain(lanes):
    close, tr = _ragged(3, 160, 4, [160, 97, 131])
    axes = {"fast": np.float32([3, 5, 12]), "signal": np.float32([2, 9]),
            "slow": np.float32([8, 20, 26, 40])}
    spans, fidx, sidx, a_sig, warm = _macd_lanes(axes, 21)   # ragged P
    tbl = fused.macd_sweep_table(close, spans)
    r = fused.simple_returns(close).contiguous()
    args = (tbl, r, tr, fidx, sidx, a_sig, warm)
    want = fused.macd_plain(*args, cost=1e-3, ppy=252)
    got = _macd_through_tiles(*args, lanes, 1e-3)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("lanes", [32, 128, 512])
def test_pairs_plain_through_tiles_is_pairs_plain(lanes):
    closes, _ = _ragged(6, 160, 5, [160] * 6)
    y, x = closes[:3], closes[3:]
    tr = torch.from_numpy(np.int32([160, 111, 140]))
    axes = {"lookback": np.float32([4, 9, 15, 30]),
            "z_entry": np.float32([0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 1.2])}
    windows, widx, k, zx, warm = _pairs_lanes(axes, 25)      # ragged P
    z, hr = fused.pairs_tables(y, x, windows)
    args = (z, hr, tr, widx, k, zx, warm)
    want = fused.pairs_plain(*args, cost=1e-3, ppy=252)
    got = _pairs_through_tiles(*args, lanes, 1e-3)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_macd_sweep_table_on_the_cpu_is_macd_ema_table():
    close = torch.from_numpy(data.synthetic_ohlcv(2, 100, seed=2).close)
    spans = np.float32([5, 9, 26])
    assert torch.equal(fused.macd_sweep_table(close, spans),
                       fused.macd_ema_table(close, spans))


def test_macd_bound_counts_its_line_once_per_pair():
    # The macd line is a function of (ticker, (fast, slow) pair, bar):
    # counted once per distinct pair, the signal EMA per lane.
    assert roofline.OPS_WINDOW["macd"] == 1
    assert roofline.OPS_EACH_BAR["macd"] == 3
    # The bench grid: 20 spans, 100 pairs over 1000 lanes.
    model = roofline.config_model("macd", 20, 1000, 1260, 100)
    assert model["ops"] == pytest.approx(25.1)
    # With the line formed on every lane, as before the tiles: 26.
    assert (roofline.OPS_PER_BAR + roofline.OPS_EACH_BAR["macd"]
            + roofline.OPS_WINDOW["macd"] + roofline.OPS_SIGNAL["macd"]) == 26
