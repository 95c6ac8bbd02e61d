"""The port's pairs trade (K7) against the reference.

``fused_pairs_sweep`` of the port (the plain PyTorch version on the CPU)
against the reference's ``fused_pairs_sweep`` (Pallas, interpret mode on
the CPU) and its generic ``run_pairs_sweep``, on the cases of the
reference's ``tests/test_fused.py`` (``_check_pairs``): 3 x 200, T=251,
the wide lookback grid, a single parameter, zero cost and per-lane
``z_exit``; the same cases with the tables in the card's order of
summation (``pairs_tables_plain``, f64 windowed sums rounded once, which
``dbx_pairs_tables`` builds) under K7's plain version; a ragged group; the
port's own generic ``run_pairs_sweep``; and ``rolling_ols`` and
``obv_series`` against the reference's.

Tolerance: the reference's pairs budget (``_check_pairs``): at most
max(1, 1%) flipped cells; the rest at rtol=2e-3, atol=2e-4. Every case
is held to it exactly but one: in the wide-grid case a cell off by more
than that tolerance counts as flipped (the flip-aware rule
``chip_smoke.py`` applies to macd, trix, vwap_reversion and pairs),
because the packages' cumsums associate differently and the rolling OLS
variance ``sxx - sx*sx/w`` cancels at short lookbacks: at lookback 5 over
320 bars the two packages' hedge ratios differ in the third digit, and
with the same positions a few cells' sharpe moves past rtol=2e-3 while
staying inside the flip threshold. Within the port the fused and generic
paths take identical positions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.models import pairs as ref_pairs
from distributed_backtesting_exploration_tpu.ops import fused as ref_fused
from distributed_backtesting_exploration_tpu.ops import rolling as ref_rolling
from distributed_backtesting_exploration_tpu.utils import data as ref_data
from distributed_backtesting_exploration_tpu_torch.models import pairs
from distributed_backtesting_exploration_tpu_torch.ops import fused, rolling
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import assert_metrics_match, to_np

RTOL, ATOL = 2e-3, 2e-4


def _legs(n_pairs, T, seed):
    closes = data.synthetic_ohlcv(2 * n_pairs, T, seed=seed).close
    return closes[:n_pairs], closes[n_pairs:]


def _grid(lookback, z_entry, z_exit=None):
    axes = {"lookback": np.float32(lookback), "z_entry": np.float32(z_entry)}
    if z_exit is not None:
        axes["z_exit"] = np.float32(z_exit)
    return {k: to_np(v) for k, v in sweep.product_grid(**axes).items()}


def _port(y, x, g, **kw):
    return fused.fused_pairs_sweep(y, x, g["lookback"], g["z_entry"],
                                   z_exit=g.get("z_exit", 0.0), device="cpu",
                                   **kw)


def _ref(y, x, g, **kw):
    return ref_fused.fused_pairs_sweep(
        jnp.asarray(y), jnp.asarray(x), g["lookback"], g["z_entry"],
        z_exit=g.get("z_exit", 0.0), **kw)


def _match(got, want, drift_counts: bool = False) -> int:
    return assert_metrics_match(got, want, rtol=RTOL, atol=ATOL,
                                drift_counts=drift_counts)


# (n_pairs, T, lookbacks, z_entries, cost, seed, z_exit): `_check_pairs`.
CASES = {
    "3x200": (3, 200, [10, 20, 30], [0.5, 1.0, 2.0], 1e-3, 0, None),
    "T251": (2, 251, [8, 16], [1.0, 1.5], 1e-3, 3, None),
    "wide-grid": (2, 320, list(range(5, 16)),
                  [0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 0.8, 1.2, 1.8, 2.2, 2.8,
                   0.6], 1e-3, 5, None),
    "single-param": (1, 137, [12], [1.5], 1e-3, 7, None),
    "zero-cost": (2, 200, [10, 25], [1.0, 2.0], 0.0, 9, None),
    "per-lane-z-exit": (2, 200, [10, 20], [1.0, 2.0], 1e-3, 11, [0.0, 0.5]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_pairs_matches_reference(case):
    n, T, lb, ze, cost, seed, zx = CASES[case]
    y, x = _legs(n, T, seed)
    g = _grid(lb, ze, zx)
    got = _port(y, x, g, cost=cost)
    drift = case == "wide-grid"
    _match(got, _ref(y, x, g, cost=cost), drift)
    _match(got, ref_pairs.run_pairs_sweep(
        jnp.asarray(y), jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in g.items()}, cost=cost), drift)


def _port_card_order(y, x, g, cost):
    """K7's plain version over the tables in the card's order
    (``pairs_tables_plain``: f64 prefix sums, each windowed sum rounded once
    from their f64 difference) on the CPU, from the legs, their means and
    the distinct lookbacks as ``pairs_sweep_tables`` passes them to the
    card."""
    windows, widx, k, zx, warm = fused._pairs_grid_setup(
        g["lookback"], g["z_entry"], g.get("z_exit", 0.0))
    yt, xt = torch.from_numpy(y), torch.from_numpy(x)
    z, hr = fused.pairs_tables_plain(
        yt, xt, rolling.mean_f64(xt, 1)[:, 0], rolling.mean_f64(yt, 1)[:, 0],
        torch.from_numpy(windows.astype(np.int32)))
    tr = fused._check_t_real(None, *y.shape)
    planes = fused.pairs_plain(z, hr, *fused._to(torch.device("cpu"), tr,
                                                 widx, k, zx, warm),
                               cost=cost, ppy=252)
    return fused.Metrics(*planes)


@pytest.mark.parametrize("case", list(CASES))
def test_card_table_order_matches_reference(case):
    # The card builds the pairs tables in another order of summation than
    # the CPU path (and the reference): it is held to the same budget.
    n, T, lb, ze, cost, seed, zx = CASES[case]
    y, x = _legs(n, T, seed)
    g = _grid(lb, ze, zx)
    _match(_port_card_order(y, x, g, cost), _ref(y, x, g, cost=cost),
           case == "wide-grid")


def test_fused_pairs_rejects_non_integral_lookbacks():
    with pytest.raises(ValueError, match="integral"):
        fused.fused_pairs_sweep(np.ones((1, 64)), np.ones((1, 64)),
                                np.asarray([10.5]), np.asarray([1.0]),
                                device="cpu")


def test_fused_pairs_ragged_matches_reference():
    # Legs padded by repeating their last bar, as the backend stacks a
    # ragged group: the centering means run over the stacked length.
    y, x = _legs(3, 240, seed=13)
    lens = np.asarray([240, 170, 201], np.int32)
    for leg in (y, x):
        for i, n in enumerate(lens):
            leg[i, n:] = leg[i, n - 1]
    g = _grid([10, 24], [1.0, 2.0], [0.0, 0.5])
    _match(_port(y, x, g, t_real=lens, cost=1e-3),
           _ref(y, x, g, t_real=lens, cost=1e-3))


def test_fused_pairs_plain_matches_generic_sweep():
    y, x = _legs(3, 180, seed=17)
    g = _grid([6, 15, 40], [0.5, 1.5, 2.5], [0.0, 0.25])
    got = _port(y, x, g, cost=1e-3)
    want = pairs.run_pairs_sweep(y, x, g, cost=1e-3, device="cpu")
    # The tables take the generic path's formulas and op order: identical
    # positions, the rest within the sums' order of evaluation.
    assert _match(got, want) == 0
    np.testing.assert_array_equal(to_np(got.turnover), to_np(want.turnover))


def test_rolling_ols_and_obv_series_match_reference():
    p = data.synthetic_ohlcv(3, 150, seed=19)
    y, x = p.close[:2], p.close[1:]
    # Windowed moments from cumsums in two association orders; the OLS
    # variance cancels, so beta and alpha carry a few 1e-4 of relative
    # error (see the module docstring).
    for w in (20, 60):
        a, b = rolling.rolling_ols(torch.from_numpy(y), torch.from_numpy(x),
                                   w, fill=0.0)
        ra, rb = ref_rolling.rolling_ols(jnp.asarray(y), jnp.asarray(x), w,
                                         fill=0.0)
        np.testing.assert_allclose(to_np(b), np.asarray(rb), rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(to_np(a), np.asarray(ra), rtol=1e-3,
                                   atol=1e-2)
    volume = p.volume.copy()
    volume[1, 0] = 0.0                         # the zero first-bar guard
    got = rolling.obv_series(torch.from_numpy(p.close),
                             torch.from_numpy(volume))
    want = ref_rolling.obv_series(jnp.asarray(p.close), jnp.asarray(volume))
    # A running sum in two association orders: a few ulps of its magnitude.
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    assert np.isfinite(to_np(got)).all()


def test_pairs_tables_warmup_and_hedged_return():
    # During the OLS warmup the hedge ratio is 0, so the hedged return is
    # y's own return; z is 0 before t = 2w - 2.
    y, x = (torch.from_numpy(a) for a in _legs(2, 90, seed=23))
    z, hr = fused.pairs_tables(y, x, np.float32([7, 20]))
    ry = fused.simple_returns(y)
    for i, w in enumerate((7, 20)):
        assert (z[:, i, :2 * w - 2] == 0).all()
        assert (z[:, i, 2 * w - 2:] != 0).all()
        torch.testing.assert_close(hr[:, i, :w], ry[:, :w], rtol=0, atol=0)


def test_fused_pairs_budget_holds_under_another_cumsum_order(monkeypatch):
    # torch's CUDA cumsum splits a row over a number of threads set by the
    # tensor's row count, so the fused tables (N, W, T) and the generic
    # path's (N, P, T) tensors sum the same row in different orders on the
    # card. Summing the (N, W, T) cumsums in blocks of 32 bars instead
    # moves cells of the main path's golden batch (16 pairs x 1260 bars x
    # the 500-combo bench grid); they must stay within the flip-aware
    # budget that chip_smoke.py holds the card's golden check to.
    y, x = _legs(16, 1260, seed=132)
    g = _grid(np.arange(20, 70, 5), np.linspace(0.5, 3.0, 50))
    want = _port(y, x, g, cost=1e-3)
    cumsum = torch.cumsum

    def blocked(t, dim):
        if t.ndim != 3:
            return cumsum(t, dim=dim)
        out, carry = [], torch.zeros_like(t[..., :1])
        for lo in range(0, t.shape[-1], 32):
            c = cumsum(t[..., lo:lo + 32], dim=-1) + carry
            out.append(c)
            carry = c[..., -1:]
        return torch.cat(out, dim=-1)

    monkeypatch.setattr(torch, "cumsum", blocked)
    got = _port(y, x, g, cost=1e-3)
    assert _match(got, want, drift_counts=True) > 0
