"""Time sharding in the port (``parallel/timeshard.py``) and the band
machine's associative form (``ops/signals.py``) against the JAX package.

Meshes of ``["cpu"] * 4`` split the bars four ways. The associative band
machine and the sharded band positions are bit-equal to the sequential
machine and to the reference's functions; ``sharded_cumsum`` is bit-equal to
``rolling.prefix_sum`` (f64 inside, rounded once), ``sharded_ema`` to a
one-shard mesh's; the linear scan is held to an f64 loop at rtol=1e-5. Each
of the 14 ``sharded_*_backtest`` (3 tickers x 1024 bars, one combo) is held
to the JAX package's single-device generic sweep at the reference's
tolerances (``tests/test_timeshard.py``: rtol=2e-4, atol=2e-5; for macd,
trix and pairs at most 2 flipped series, the rest at rtol=2e-3,
atol=2e-4), and to the port's generic sweep alike. The reference's own
sharded functions are not run here (their SPMD compiles take minutes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.models import (
    base as ref_base, pairs as ref_pairs)
from distributed_backtesting_exploration_tpu.ops import signals as ref_signals
from distributed_backtesting_exploration_tpu.parallel import sweep as ref_sweep
from distributed_backtesting_exploration_tpu_torch.models import base, pairs
from distributed_backtesting_exploration_tpu_torch.ops import rolling, signals
from distributed_backtesting_exploration_tpu_torch.parallel import (
    sharding, sweep, timeshard)
from distributed_backtesting_exploration_tpu_torch.utils import data

MESH = sharding.make_mesh(["cpu"] * 4, axis_name=timeshard.TIME_AXIS)
ONE = sharding.make_mesh(["cpu"], axis_name=timeshard.TIME_AXIS)
COST = 1e-3

# strategy -> (sharded function, fields, params in its order, seed)
FAMILIES = {
    "sma_crossover": ("sharded_sma_backtest", ("close",),
                      {"fast": 5, "slow": 21}, 23),
    "bollinger": ("sharded_bollinger_backtest", ("close",),
                  {"window": 20, "k": 1.5}, 29),
    "bollinger_touch": ("sharded_bollinger_touch_backtest", ("close",),
                        {"window": 20, "k": 1.5}, 53),
    "rsi": ("sharded_rsi_backtest", ("close",),
            {"period": 14, "band": 15.0}, 31),
    "donchian": ("sharded_donchian_backtest", ("close",), {"window": 20}, 41),
    "donchian_hl": ("sharded_donchian_hl_backtest", ("close", "high", "low"),
                    {"window": 20}, 43),
    "stochastic": ("sharded_stochastic_backtest", ("close", "high", "low"),
                   {"window": 14, "band": 30.0}, 47),
    "trix": ("sharded_trix_backtest", ("close",),
             {"span": 8, "signal": 5}, 41),
    "momentum": ("sharded_momentum_backtest", ("close",), {"lookback": 20},
                 51),
    "keltner": ("sharded_keltner_backtest", ("close", "high", "low"),
                {"window": 20, "k": 1.5}, 57),
    "vwap_reversion": ("sharded_vwap_backtest", ("close", "volume"),
                       {"window": 20, "k": 1.5}, 59),
    "macd": ("sharded_macd_backtest", ("close",),
             {"fast": 12, "slow": 26, "signal": 9}, 61),
    "obv_trend": ("sharded_obv_backtest", ("close", "volume"),
                  {"window": 20}, 43),
}
FLIP_AWARE = ("macd", "trix", "pairs")


def _hold(got, want, flip_aware: bool, drift_counts: bool = False) -> None:
    """The reference's rule: every series at rtol=2e-4, atol=2e-5; for the
    flip-aware families at most 2 series off by more than 0.01 + 1%, the
    rest at rtol=2e-3, atol=2e-4. With ``drift_counts`` a series off the
    2e-3 tolerance counts against the same budget of 2 (``torch_parity``'s
    rule for pairs against the JAX package, whose f32 cumsums round the
    spread's z apart from the port's f64 prefix sums)."""
    names = want._fields
    a = {n: np.asarray(getattr(got, n)) for n in names}
    b = {n: np.asarray(getattr(want, n)).reshape(a[n].shape) for n in names}
    if not flip_aware:
        for n in names:
            np.testing.assert_allclose(a[n], b[n], rtol=2e-4, atol=2e-5,
                                       err_msg=n)
        return
    flipped = np.zeros(a["sharpe"].shape, bool)
    for n in names:
        flipped |= np.abs(a[n] - b[n]) > (
            2e-4 + 2e-3 * np.abs(b[n]) if drift_counts
            else 0.01 + 0.01 * np.abs(b[n]))
    assert int(flipped.sum()) <= 2, f"{int(flipped.sum())} flips"
    for n in names:
        np.testing.assert_allclose(a[n][~flipped], b[n][~flipped], rtol=2e-3,
                                   atol=2e-4, err_msg=n)


def test_band_machine_associative_form_is_bit_equal():
    rng = np.random.default_rng(0)
    z = (rng.standard_normal((3, 5, 300)) * 2).astype(np.float32)
    valid = rng.random((3, 5, 300)) > 0.05
    ze = np.float32([0.5, 1.0, 1.5, 2.0, 0.0])[:, None]
    zx = np.float32([0.0, 0.2, 0.5, -0.1, 0.0])[:, None]
    zt, vt = torch.from_numpy(z), torch.from_numpy(valid)
    seq = signals.band_hysteresis(zt, vt, torch.from_numpy(ze),
                                  torch.from_numpy(zx))
    got = signals.band_hysteresis_assoc(zt, vt, torch.from_numpy(ze),
                                        torch.from_numpy(zx))
    assert torch.equal(got, seq)
    ref = ref_signals.band_hysteresis_assoc(jnp.asarray(z), jnp.asarray(valid),
                                            jnp.asarray(ze), jnp.asarray(zx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    maps = signals.prefix_compose_maps(signals.band_transition_maps(
        zt, vt, torch.from_numpy(ze), torch.from_numpy(zx)))
    ref_maps = ref_signals.prefix_compose_maps(
        ref_signals.band_transition_maps(jnp.asarray(z), jnp.asarray(valid),
                                         jnp.asarray(ze), jnp.asarray(zx)))
    for m, r in zip(maps, ref_maps):
        np.testing.assert_array_equal(m.numpy(), np.asarray(r))


def test_sharded_band_positions_are_bit_equal():
    rng = np.random.default_rng(1)
    z = torch.from_numpy((rng.standard_normal((4, 512)) * 2).astype(
        np.float32))
    valid = torch.arange(512) >= 19
    got = timeshard.sharded_band_positions(MESH, z, valid, 1.0, 0.25)
    assert torch.equal(got, signals.band_hysteresis(z, valid, 1.0, 0.25))


def test_sharded_cumsum_and_ema_match_their_single_device_forms():
    x = torch.from_numpy(data.synthetic_ohlcv(3, 1024, seed=0).close)
    assert torch.equal(timeshard.sharded_cumsum(MESH, x),
                       rolling.prefix_sum(x))
    assert torch.equal(timeshard.sharded_cumsum(ONE, x),
                       rolling.prefix_sum(x))
    for span in (5, 20, 200):
        four = timeshard.sharded_ema(MESH, x, span=span)
        assert torch.equal(four, timeshard.sharded_ema(ONE, x, span=span))
        torch.testing.assert_close(four, rolling.ema(x, span=span),
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="exactly one"):
        timeshard.sharded_ema(MESH, x)


def test_sharded_linear_scan_matches_an_f64_loop():
    rng = np.random.default_rng(2)
    a = rng.uniform(0.1, 0.99, (2, 512)).astype(np.float32)
    b = rng.standard_normal((2, 512)).astype(np.float32)
    want = np.zeros((2, 512))
    y = np.zeros(2)
    for t in range(512):
        y = a[:, t].astype(np.float64) * y + b[:, t]
        want[:, t] = y
    got = timeshard.sharded_linear_scan(MESH, a, b)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_chunked_scan_equals_one_scan():
    xs = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (256, 4)).astype(np.float32))

    def step(carry, x):
        nxt = 0.9 * carry + x.sum()
        return nxt, (nxt, 2 * nxt)

    carry, (ys, ys2) = timeshard.chunked_scan(step, torch.tensor(0.0), xs,
                                              chunk=32)
    c, want = torch.tensor(0.0), []
    for t in range(256):
        c, (y, _) = step(c, xs[t])
        want.append(y)
    assert torch.equal(carry, c) and torch.equal(ys, torch.stack(want))
    assert torch.equal(ys2, 2 * ys)
    with pytest.raises(ValueError, match="chunk"):
        timeshard.chunked_scan(step, 0.0, xs, chunk=100)


def _ref_sweep(strategy, panel, params):
    grid = {k: jnp.asarray(np.float32([v])) for k, v in params.items()}
    return ref_sweep.run_sweep(type(panel)(*(jnp.asarray(f) for f in panel)),
                               ref_base.get_strategy(strategy), grid,
                               cost=COST)


@pytest.mark.parametrize("strategy", sorted(FAMILIES))
def test_sharded_family_matches_the_single_device_sweeps(strategy):
    fn, fields, params, seed = FAMILIES[strategy]
    panel = data.synthetic_ohlcv(3, 1024, seed=seed)
    got = getattr(timeshard, fn)(MESH, *(getattr(panel, f) for f in fields),
                                 *params.values(), cost=COST)
    assert got.sharpe.shape == (3,)
    _hold(got, _ref_sweep(strategy, panel, params), strategy in FLIP_AWARE)
    port = sweep.run_sweep(panel, base.get_strategy(strategy),
                           {k: np.float32([v]) for k, v in params.items()},
                           cost=COST, device="cpu")
    _hold(got, port, strategy in FLIP_AWARE)


def test_sharded_pairs_matches_the_single_device_sweeps():
    # The reference test's pairs (tests/test_timeshard.py): 8 pairs of
    # 1024 bars, lookback 20, z_entry 1.2.
    closes = data.synthetic_ohlcv(16, 1024, seed=37).close
    y, x = closes[:8], closes[8:]
    got = timeshard.sharded_pairs_backtest(MESH, y, x, 20, 1.2, cost=COST)
    grid = {"lookback": np.float32([20]), "z_entry": np.float32([1.2])}
    ref = ref_pairs.run_pairs_sweep(jnp.asarray(y), jnp.asarray(x),
                                    {k: jnp.asarray(v)
                                     for k, v in grid.items()}, cost=COST)
    _hold(got, ref, True, drift_counts=True)
    _hold(got, pairs.run_pairs_sweep(y, x, grid, cost=COST, device="cpu"),
          True)


@pytest.mark.parametrize("strategy", ["bollinger", "momentum", "rsi",
                                      "stochastic"])
def test_right_padding_with_t_real_is_dead(strategy):
    # 1021 real bars padded to 1024 with repeat-last bars: the same metrics
    # as the port's generic sweep of the 1021 bars.
    fn, fields, params, seed = FAMILIES[strategy]
    panel = data.synthetic_ohlcv(2, 1021, seed=seed)
    padded = [np.concatenate([f, np.repeat(f[:, -1:], 3, axis=1)], axis=1)
              for f in panel]
    pad = data.OHLCV(*padded)
    got = getattr(timeshard, fn)(MESH, *(getattr(pad, f) for f in fields),
                                 *params.values(), cost=COST, t_real=1021)
    want = sweep.run_sweep(panel, base.get_strategy(strategy),
                           {k: np.float32([v]) for k, v in params.items()},
                           cost=COST, device="cpu")
    _hold(got, want, False)


def test_rejections():
    close = np.ones((1, 256), np.float32)
    with pytest.raises(ValueError, match="halo"):
        timeshard.sharded_sma_backtest(MESH, close, 5, 100)
    with pytest.raises(ValueError, match="fast < slow"):
        timeshard.sharded_sma_backtest(MESH, close, 9, 9)
    with pytest.raises(ValueError, match="divisible"):
        timeshard.sharded_momentum_backtest(MESH, close[:, :255], 5)
    with pytest.raises(ValueError, match=">= 1"):
        timeshard.sharded_donchian_backtest(MESH, close, 0)
    with pytest.raises(ValueError, match="halo"):
        timeshard.sharded_pairs_backtest(MESH, close, close, 65, 1.0)
    with pytest.raises(ValueError, match="halo"):
        timeshard.sharded_stochastic_backtest(MESH, close, close, close, 80,
                                              20.0)
    with pytest.raises(ValueError, match="period"):
        timeshard.sharded_rsi_backtest(MESH, close, 0, 20.0)
    with pytest.raises(ValueError, match="spans"):
        timeshard.sharded_macd_backtest(MESH, close, 0, 26, 9)
    with pytest.raises(ValueError, match="t_real"):
        timeshard.sharded_obv_backtest(MESH, close, close, 5, t_real=300)
    # The EMA families have no halo bound: a span longer than a block runs.
    m = timeshard.sharded_trix_backtest(
        MESH, data.synthetic_ohlcv(1, 256, seed=1).close, 70, 9)
    assert np.isfinite(m.sharpe.numpy()).all()
