"""The port's EMA families against the reference: macd (K4), trix (K5), and
rsi and keltner (K2's table entry).

``fused_{macd,trix,rsi,keltner}_sweep`` of the port (plain PyTorch versions
on the CPU) against the reference's wrappers (Pallas, interpret mode on the
CPU), on the shapes of the reference's ``tests/test_fused.py`` (ragged
included); the port's generic models against the reference's
``jit_sweep``; ``ops/rolling.py``'s ``ema`` and ``ema_ladder`` against the
reference's; and each fused sweep against the port's own generic sweep.

Tolerances, each with its reason:
- macd, trix and keltner: the reference's flip-aware budget
  (``tests/test_fused.py`` ``_macd_flip_aware_check`` and its keltner
  fused-vs-generic tolerance): at most max(1, 1%) flipped cells, the rest
  at rtol=2e-3, atol=2e-4. The port's kernels carry the signal EMA
  sequentially where the reference runs a ladder, XLA under ``jit`` may
  contract the ladder's ``A*Be + B`` into one multiply-add, and the
  packages' cumsums associate differently: any of these can move a
  crossing at a knife edge.
- rsi: the same flip rule, the rest at rtol=2e-4, atol=2e-5 (the
  reference's rsi fused-vs-generic budget).
- Within the port, rsi and keltner build their tables with the generic
  models' ops, so the fused sweeps take the generic sweep's positions
  exactly (0 flips); macd and trix keep the flip-aware budget.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.models.base import (
    get_strategy as ref_strategy)
from distributed_backtesting_exploration_tpu.ops import fused as ref_fused
from distributed_backtesting_exploration_tpu.ops import rolling as ref_rolling
from distributed_backtesting_exploration_tpu.parallel import sweep as ref_sweep
from distributed_backtesting_exploration_tpu.utils import data as ref_data
from distributed_backtesting_exploration_tpu_torch.models import (
    get_strategy, keltner, macd, rsi, trix)
from distributed_backtesting_exploration_tpu_torch.ops import fused, rolling
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import assert_metrics_match, to_np

# strategy -> (rtol, atol) for the cells that did not flip.
TOL = {"macd": (2e-3, 2e-4), "trix": (2e-3, 2e-4),
       "keltner": (2e-3, 2e-4), "rsi": (2e-4, 2e-5)}
# strategy -> a small grid of each family, as wire axes.
AXES = {
    "macd": {"fast": [8, 12], "slow": [26, 35], "signal": [5, 9]},
    "trix": {"span": [5, 9, 15], "signal": [4, 9]},
    "rsi": {"band": [15, 20, 25], "period": [7, 14, 21]},
    "keltner": {"k": [1.5, 2.5], "window": [10, 14, 21]},
}


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


def _port(strategy, panel, g, **kw):
    """The port's fused sweep of one family on the CPU."""
    p = panel
    if strategy == "macd":
        return fused.fused_macd_sweep(p.close, g["fast"], g["slow"],
                                      g["signal"], device="cpu", **kw)
    if strategy == "trix":
        return fused.fused_trix_sweep(p.close, g["span"], g["signal"],
                                      device="cpu", **kw)
    if strategy == "rsi":
        return fused.fused_rsi_sweep(p.close, g["period"], g["band"],
                                     device="cpu", **kw)
    return fused.fused_keltner_sweep(p.close, p.high, p.low, g["window"],
                                     g["k"], device="cpu", **kw)


def _ref(strategy, panel, g, **kw):
    """The reference's fused sweep of one family (interpret mode)."""
    p = _jpanel(panel)
    if strategy == "macd":
        return ref_fused.fused_macd_sweep(p.close, g["fast"], g["slow"],
                                          g["signal"], **kw)
    if strategy == "trix":
        return ref_fused.fused_trix_sweep(p.close, g["span"], g["signal"],
                                          **kw)
    if strategy == "rsi":
        return ref_fused.fused_rsi_sweep(p.close, g["period"], g["band"],
                                         **kw)
    return ref_fused.fused_keltner_sweep(p.close, p.high, p.low, g["window"],
                                         g["k"], **kw)


def _match(strategy, got, want) -> int:
    rtol, atol = TOL[strategy]
    return assert_metrics_match(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("strategy,n,T,seed,cost", [
    ("macd", 3, 200, 19, 1e-3),         # the reference's test_fused shapes
    ("macd", 2, 251, 21, 0.0),          # unaligned T, zero cost
    ("trix", 3, 200, 23, 1e-3),
    ("trix", 2, 251, 25, 0.0),
    ("rsi", 3, 200, 17, 1e-3),
    ("rsi", 2, 251, 27, 0.0),
    ("keltner", 3, 200, 47, 1e-3),
    ("keltner", 2, 251, 49, 0.0),
])
def test_fused_ema_matches_reference(strategy, n, T, seed, cost):
    panel = data.synthetic_ohlcv(n, T, seed=seed)
    g = _grid(**AXES[strategy])
    _match(strategy, _port(strategy, panel, g, cost=cost),
           _ref(strategy, panel, g, cost=cost))


@pytest.mark.parametrize("strategy", sorted(AXES))
def test_fused_ema_ragged_matches_reference(strategy):
    panel, lens, _ = _ragged([150, 200, 97], seed=40)
    g = _grid(**AXES[strategy])
    _match(strategy, _port(strategy, panel, g, t_real=lens, cost=1e-3),
           _ref(strategy, panel, g, t_real=lens, cost=1e-3))


def test_fused_ema_ignores_padding_past_t_real():
    # Each lane stops at its ticker's real length: garbage in the padded
    # bars changes no metric.
    panel, lens, _ = _ragged([120, 90], seed=51)
    noisy = data.OHLCV(*(f.copy() for f in panel))
    for f in noisy:
        f[1, 90:] = np.float32(1e3)
    for strategy in sorted(AXES):
        g = _grid(**AXES[strategy])
        a = _port(strategy, panel, g, t_real=lens, cost=1e-3)
        b = _port(strategy, noisy, g, t_real=lens, cost=1e-3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(to_np(x), to_np(y))


@pytest.mark.parametrize("strategy", sorted(AXES))
def test_generic_ema_models_match_reference(strategy):
    panel = data.synthetic_ohlcv(2, 180, seed=61)
    g = _grid(**AXES[strategy])
    got = sweep.run_sweep(panel, get_strategy(strategy), g, cost=1e-3,
                          device="cpu")
    want = ref_sweep.jit_sweep(
        _jpanel(panel), ref_strategy(strategy),
        {k: jnp.asarray(v) for k, v in g.items()}, cost=1e-3)
    _match(strategy, got, want)


def test_generic_keltner_ragged_matches_reference():
    panel, lens, mask = _ragged([150, 97], seed=63)
    g = _grid(**AXES["keltner"])
    got = sweep.run_sweep(panel, get_strategy("keltner"), g, cost=1e-3,
                          bar_mask=mask, device="cpu")
    want = ref_sweep.jit_sweep(
        _jpanel(panel), ref_strategy("keltner"),
        {k: jnp.asarray(v) for k, v in g.items()}, cost=1e-3,
        bar_mask=jnp.asarray(mask))
    _match("keltner", got, want)


@pytest.mark.parametrize("strategy", sorted(AXES))
def test_fused_ema_plain_matches_generic_sweep(strategy):
    panel = data.synthetic_ohlcv(3, 150, seed=71)
    g = _grid(**AXES[strategy])
    got = _port(strategy, panel, g, cost=1e-3)
    want = sweep.run_sweep(panel, get_strategy(strategy), g, cost=1e-3,
                           device="cpu")
    n_flips = _match(strategy, got, want)
    if strategy in ("rsi", "keltner"):
        # The same table ops on both paths: identical positions.
        assert n_flips == 0
        np.testing.assert_array_equal(to_np(got.turnover),
                                      to_np(want.turnover))


def test_ema_tables_equal_the_generic_models():
    # The fused preps repeat the generic models' ops on the distinct
    # windows: every row is bit-equal to the model's series.
    p = data.synthetic_ohlcv(2, 140, seed=73)
    close, high, low = (torch.from_numpy(f) for f in (p.close, p.high,
                                                      p.low))
    w = np.float32([5, 12, 30])
    col = torch.from_numpy(w)[:, None]
    c3, h3, l3 = close[:, None], high[:, None], low[:, None]
    tbl = fused.macd_ema_table(close, w)
    m, _ = macd.macd_lines(c3, col, col.flip(0), col)
    assert torch.equal(tbl - tbl.flip(1), m)
    e3 = fused.trix_ema_table(close, w)
    t_line, _ = trix.trix_lines(c3, col, col)
    prev = torch.cat([e3[..., :1], e3[..., :-1]], -1)
    assert torch.equal(e3 / prev - 1.0, t_line)
    assert torch.equal(fused.rsi_z_table(close, w),
                       rsi.rsi_index(c3, col) - 50.0)
    z = keltner.keltner_z(h3, l3, c3, col)
    valid = rolling.valid_mask(close.shape[-1], col)
    assert torch.equal(fused.keltner_z_table(close, high, low, w),
                       torch.where(valid, z, torch.zeros_like(z)))


@pytest.mark.parametrize("spans", [[5.0], [9.0, 26.0, 40.0]])
def test_ema_ladder_matches_reference(spans):
    # Op for op the reference's ladder: bit-equal to it run eagerly. Under
    # jit, XLA on the CPU may contract A*Be + B into one multiply-add, which
    # rounds once instead of twice: within a few f32 ulps of the price
    # level (rtol=1e-6).
    x = data.synthetic_ohlcv(3, 251, seed=1).close
    col = torch.from_numpy(np.float32(spans))[:, None]
    got = to_np(rolling.ema_ladder(torch.from_numpy(x)[:, None, :],
                                   span=col))
    jitted = jax.jit(lambda v, s: ref_rolling.ema_ladder(v, span=s))
    for i, s in enumerate(spans):
        eager = np.asarray(ref_rolling.ema_ladder(jnp.asarray(x),
                                                  span=jnp.float32(s)))
        np.testing.assert_array_equal(got[:, i], eager)
        np.testing.assert_allclose(
            got[:, i], np.asarray(jitted(jnp.asarray(x), jnp.float32(s))),
            rtol=1e-6, atol=0)


@pytest.mark.parametrize("kw", [{"span": 14.0}, {"alpha": 0.1}])
def test_ema_matches_reference(kw):
    # The port's ema is the ladder; the reference's is an associative scan,
    # which associates the same recurrence differently: within a few f32
    # ulps of the price level (rtol=1e-6).
    x = data.synthetic_ohlcv(2, 200, seed=2).close
    got = to_np(rolling.ema(torch.from_numpy(x), **kw))
    want = np.asarray(ref_rolling.ema(
        jnp.asarray(x), **{k: jnp.float32(v) for k, v in kw.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="exactly one"):
        rolling.ema(torch.from_numpy(x), span=3.0, alpha=0.5)


@pytest.mark.parametrize("call", [
    lambda c, **kw: fused.fused_macd_sweep(c, [5.5], [20.0], [9.0], **kw),
    lambda c, **kw: fused.fused_macd_sweep(c, [5.0], [20.0], [9.5], **kw),
    lambda c, **kw: fused.fused_trix_sweep(c, [8.5], [9.0], **kw),
    lambda c, **kw: fused.fused_trix_sweep(c, [8.0], [2.5], **kw),
    lambda c, **kw: fused.fused_rsi_sweep(c, [14.5], [20.0], **kw),
    lambda c, **kw: fused.fused_keltner_sweep(c, c, c, [20.5], [1.0], **kw),
], ids=["macd-span", "macd-signal", "trix-span", "trix-signal",
        "rsi-period", "keltner-window"])
def test_fused_ema_rejects_non_integral_bar_counts(call):
    with pytest.raises(ValueError, match="integral"):
        call(np.ones((1, 64), np.float32), device="cpu")


@pytest.mark.parametrize("call", [
    lambda c, **kw: fused.fused_macd_sweep(c, [5.0, 8.0], [20.0], [9.0],
                                           **kw),
    lambda c, **kw: fused.fused_trix_sweep(c, [8.0], [9.0, 3.0], **kw),
    lambda c, **kw: fused.fused_rsi_sweep(c, [14.0], [20.0, 25.0], **kw),
    lambda c, **kw: fused.fused_keltner_sweep(c, c, c, [20.0, 10.0], [1.0],
                                              **kw),
], ids=["macd", "trix", "rsi", "keltner"])
def test_fused_ema_rejects_mismatched_grid(call):
    with pytest.raises(ValueError, match="one length"):
        call(np.ones((1, 64), np.float32), device="cpu")


@pytest.mark.parametrize("kw,exc", [
    ({"carry_out": True}, None),
    ({"epilogue": "scan:7"}, ValueError),
])
def test_fused_ema_argument_rules(kw, exc):
    c = np.ones((1, 64), np.float32)
    for strategy, call in (
            ("macd", lambda: fused.fused_macd_sweep(
                c, [5.0], [20.0], [9.0], device="cpu", **kw)),
            ("trix", lambda: fused.fused_trix_sweep(
                c, [8.0], [9.0], device="cpu", **kw)),
            ("rsi", lambda: fused.fused_rsi_sweep(
                c, [14.0], [20.0], device="cpu", **kw)),
            ("keltner", lambda: fused.fused_keltner_sweep(
                c, c, c, [20.0], [1.0], device="cpu", **kw))):
        if exc is None:
            # carry_out=True: the metrics beside the streaming checkpoint.
            m, carry = call()
            assert carry.strategy == strategy and carry.n_bars == 64
            assert m.sharpe.shape == carry.metric["s1"].shape == (1, 1)
        else:
            with pytest.raises(exc):
                call()


def _turnover_of_signal_cross(x, a, warm):
    """A numpy loop of the kernels' signal line, s = x at bar 0, then
    (1-a)*s + a*x; the turnover of pos = sign(x - s) from bar warm - 1."""
    s = np.empty_like(x)
    s[0] = x[0]
    for t in range(1, x.size):
        s[t] = np.float32(1.0 - a) * s[t - 1] + a * x[t]
    pos = np.where(np.arange(x.size) >= warm - 1, np.sign(x - s), 0.0)
    return np.abs(np.diff(pos, prepend=0.0)).sum()


def test_macd_and_trix_plain_carry_the_kernel_signal_order():
    rng = np.random.default_rng(5)
    tbl = np.cumsum(rng.standard_normal((1, 2, 60)), -1).astype(np.float32)
    tbl += np.float32(100.0)
    tbl[0, 0, 30] = 0.0                   # trix: a previous value of 0 -> 1
    a = np.float32(2.0) / np.float32(10.0)
    args = (torch.from_numpy(tbl), torch.zeros((1, 60)),
            torch.tensor([60], dtype=torch.int32))
    lane = [torch.tensor([v], dtype=torch.int32) for v in (0, 1, 4)]
    kw = {"cost": 0.0, "ppy": 252}
    out = fused.macd_plain(*args, lane[0], lane[1], torch.tensor([a]),
                           lane[2], **kw)
    x = tbl[0, 0] - tbl[0, 1]
    assert float(out[8, 0, 0]) == _turnover_of_signal_cross(x, a, 4)
    out = fused.trix_plain(*args, lane[0], torch.tensor([a]), lane[2], **kw)
    e3 = tbl[0, 0]
    prev = np.where(e3[:-1] == 0, np.float32(1.0), e3[:-1])
    x = np.concatenate([[np.float32(0.0)], e3[1:] / prev - np.float32(1.0)])
    assert float(out[8, 0, 0]) == _turnover_of_signal_cross(x, a, 4)
