"""Shared comparison of the PyTorch port against the JAX reference.

The two packages compute the close cumsum in different association orders
(``torch.cumsum`` vs ``jnp.cumsum``); both are valid f32, but an SMA near a
crossover can flip the sign of ``fast - slow`` and with it a cell's whole
position path. So the port is held to the reference's own flip rule
(``tests/test_fused.py`` pairs budget): a cell counts as flipped if any
metric is off by more than ``0.01 + 0.01 * |ref|``; at most ``max(1, 1%)``
of cells may flip; every other cell must match at rtol=2e-4, atol=2e-5
(the fused-vs-generic budget of ``tests/test_fused.py``).
"""

import numpy as np

RTOL, ATOL = 2e-4, 2e-5

# Rows of a ranked metric, 8 combos each, with ties, NaN, +-inf, +-0 and
# subnormals, for the selection tests (top-k and best_params). The first is
# the row where torch's sorts and lax.top_k disagree: lax.top_k ranks +0
# ahead of -0, and among equal keys the lower index first.
CRAFTED = np.float32([
    [-0., 0., 1., 1., -np.inf, 0., -0., -np.inf],
    [np.nan, 2., np.nan, -np.inf, np.inf, 2., -0., 0.],
    [np.nan] * 8,
    [3.] * 8,
    [-1., -0., -2., 0., -1., -0., 0., -2.],
    [np.inf, np.nan, np.inf, -np.inf, 1e-30, -1e-30, 5e-45, -5e-45],
    [0.25, -0.5, 0.75, -1., 1.25, -1.5, 1.75, -2.],
])


def to_np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_metrics_match(got, ref, *, rtol=RTOL, atol=ATOL,
                         drift_counts: bool = False) -> int:
    """Hold ``got`` (port Metrics) against ``ref`` (reference Metrics) under
    the flip rule; return the number of flipped cells. With
    ``drift_counts``, a cell off by more than ``rtol``/``atol`` in any
    metric counts against the same budget as a flipped one (the rule
    ``chip_smoke.py`` applies to macd, trix, vwap_reversion and pairs)."""
    assert tuple(got._fields) == tuple(ref._fields)
    return assert_planes_match(
        [getattr(got, name) for name in ref._fields],
        [getattr(ref, name) for name in ref._fields], ref._fields,
        rtol=rtol, atol=atol, drift_counts=drift_counts)


def assert_planes_match(got, ref, names, *, rtol=RTOL, atol=ATOL,
                        drift_counts: bool = False) -> int:
    """:func:`assert_metrics_match` over parallel lists of same-shaped
    planes, ``names`` labelling each; a cell flips if any plane is off."""
    flipped = np.zeros(to_np(ref[0]).shape, dtype=bool)
    for name, x, y in zip(names, got, ref):
        a, b = to_np(x), to_np(y)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if drift_counts:
            flipped |= np.abs(a - b) > atol + rtol * np.abs(b)
        else:
            flipped |= np.abs(a - b) > 0.01 + 0.01 * np.abs(b)
    n_flips = int(flipped.sum())
    assert n_flips <= max(1, int(0.01 * flipped.size)), (
        f"{n_flips}/{flipped.size} position-path flips")
    for name, x, y in zip(names, got, ref):
        a = to_np(x)[~flipped]
        b = to_np(y)[~flipped]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)
    return n_flips


def assert_window_tiles(lanes, windows, tiles):
    """The invariants of ``tiles = fused.window_tiles(lanes, *windows)``,
    ``(wins, counts, *idx)``: each lane's index gives back its window in its
    tile's list; a list is its tile's sorted distinct windows, ``counts``
    of them, padded with windows of the tile; no list is wider than
    ``lanes * len(windows)``."""
    wins, counts, *idx = (to_np(x) for x in tiles)
    windows = [to_np(w) for w in windows]
    P = windows[0].size
    n_tiles = -(-P // lanes)
    assert wins.dtype == np.int32 and counts.dtype == np.int32
    assert wins.shape == (n_tiles, lanes * len(windows))
    assert counts.shape == (n_tiles,)
    tile = np.arange(P) // lanes
    for w, i in zip(windows, idx):
        assert i.dtype == np.int32 and i.shape == (P,)
        assert (i < counts[tile]).all()
        np.testing.assert_array_equal(wins[tile, i], w)
    for t in range(n_tiles):
        lanes_t = slice(t * lanes, min((t + 1) * lanes, P))
        read = np.unique(np.concatenate([w[lanes_t] for w in windows]))
        assert counts[t] == read.size
        np.testing.assert_array_equal(wins[t, :read.size], read)
        assert np.isin(wins[t, read.size:], read).all()


def crafted_returns(n_bars: int) -> np.ndarray:
    """Eight rows of simple returns that drive a lane's equity through 0,
    below 0, to +-inf and to NaN (``chip_smoke.py``'s crafted case): steps
    of 30-250% either way (rows 0, 1), -100% on every bar (row 2: equity
    exactly 0 at cost 0, then below), a +inf and a -inf return (rows 3, 4),
    a NaN (row 5), returns of 3e38 that overflow the sums (row 6) and
    subnormal ones (row 7)."""
    rng = np.random.default_rng(12)
    r = (rng.choice(np.float32([-1, 1]), (8, n_bars))
         * rng.uniform(0.3, 2.5, (8, n_bars))).astype(np.float32)
    r[2] = -1.0
    r[3, n_bars // 2] = np.inf
    r[4, n_bars // 2] = -np.inf
    r[5, n_bars // 2] = np.nan
    r[6, n_bars // 3:] = 3e38
    r[7] *= np.float32(1e-40)
    return r
