"""The shared metric update of the port's kernels (``csrc/metrics_tail.cuh``)
against the plain versions' ``_MetricState``, on the CPU.

The kernels cannot run here, so ``_step`` mirrors ``MetricsAcc::step`` in
numpy float32, operation for operation: no cumulative sum beside ``s1``
(the equity is ``1 + s1``), the drawdown quotient formed only on the bars
where the exact ``mdd * pk - d`` is negative or NaN, and the hit counts as
adds of selected 0/1. Max and min propagate NaN, as ``torch.maximum`` and
``clamp`` do. The exact sign of ``mdd * pk - d`` is taken in float64, where
the product of two float32 values is exact and the difference keeps the
exact value's sign (and, for an exact zero, the sign the single-rounded
float32 fused multiply-add gives it).

Tolerance: none. The mirror and ``_MetricState`` must agree bit for bit in
every sum, NaN where the other has NaN.
"""

import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu_torch.ops import fused

from torch_parity import crafted_returns

_EPS = np.float32(1e-12)
# Values at the edges of float32: signed zeros, subnormals, the epsilon,
# ordinary, huge and infinite values, NaN.
_EDGES = np.float32([0.0, -0.0, 1e-45, -1e-45, 1.1e-38, 1e-12, 0.5, 1.0,
                     -1.0, 2.0, 3e38, -3e38, np.inf, -np.inf, np.nan])


def _skips(mdd, pk, d):
    """Where the kernels' rule skips the division: the float32 fused
    multiply-add ``mdd * pk - d`` has its sign bit clear and is no NaN."""
    with np.errstate(all="ignore"):
        f = mdd.astype(np.float64) * pk.astype(np.float64) - d
    return ~(np.signbit(f) | np.isnan(f))


def _update_inputs(mdd, peak, eq):
    """``d`` and ``pk`` as the update forms them from the running maximum
    drawdown, the previous peak and this bar's equity."""
    peak = np.maximum(peak, eq)
    with np.errstate(all="ignore"):
        return mdd, np.maximum(peak, _EPS), peak - eq


def _triples(n, seed):
    """Every triple of the edge values, then ``n`` random ones: half of
    ordinary magnitudes, half of random bit patterns (every float32)."""
    mesh = np.meshgrid(_EDGES, _EDGES, _EDGES, indexing="ij")
    rng = np.random.default_rng(seed)
    plain = rng.standard_normal((3, n // 2)).astype(np.float32) * \
        np.float32(10) ** rng.integers(-3, 4, (3, n // 2)).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, (3, n - n // 2),
                        dtype=np.uint64).astype(np.uint32).view(np.float32)
    return [np.concatenate([m.reshape(-1), p, b])
            for m, p, b in zip(mesh, plain, bits)]


@pytest.mark.parametrize("seed", [0, 1])
def test_skip_rule_never_skips_a_quotient_that_raises_mdd(seed):
    mdd, pk, d = _update_inputs(*_triples(400_000, seed))
    skip = _skips(mdd, pk, d)
    assert 0 < skip.sum() < skip.size
    with np.errstate(all="ignore"):
        q = d / pk
    for full in (np.fmax(mdd, q), np.maximum(mdd, q)):
        np.testing.assert_array_equal(full[skip].view(np.uint32),
                                      mdd[skip].view(np.uint32))


def test_skip_rule_takes_the_division_where_the_sign_says_so():
    # A quotient above mdd; NaN in each operand; and an exact difference
    # of -2^-173, which the float32 fused multiply-add rounds to -0: its
    # sign bit takes the division, where a bare `f < 0` would skip it.
    mdd = np.float32([0.1, np.nan, 0.1, 0.1, np.ldexp(1 - 2.0 ** -24, -110)])
    pk = np.float32([1.0, 1.0, np.nan, 1.0, 2.0 ** -39])
    d = np.float32([0.2, 0.0, 0.0, np.nan, 2.0 ** -149])
    assert not _skips(mdd, pk, d).any()
    f = np.float32(np.float64(mdd[4]) * np.float64(pk[4]) - np.float64(d[4]))
    assert f == 0 and np.signbit(f)


def _step(st, pos, r_col, ok, cost):
    """One bar of ``MetricsAcc::step`` on every lane where ``ok`` (the
    kernels do not step past a ticker's length), in numpy float32."""
    f32 = np.float32
    prev = st["prev"]
    dp = np.abs(pos - prev)
    net = prev * r_col - f32(cost) * dp
    s1 = st["s1"] + net
    s2 = st["s2"] + net * net
    down = np.minimum(net, f32(0))
    dsq = st["dsq"] + down * down
    eq = f32(1) + s1
    peak = np.maximum(st["peak"], eq)
    d = peak - eq
    pk = np.maximum(peak, _EPS)
    mdd = st["mdd"]
    take = ~_skips(mdd, pk, d)
    with np.errstate(all="ignore"):
        mdd = np.where(take, np.maximum(mdd, d / pk), mdd)
    act = np.where(prev != 0, f32(1), f32(0))
    new = {"prev": pos, "s1": s1, "s2": s2, "dsq": dsq, "peak": peak,
           "mdd": mdd, "active": st["active"] + act,
           "wins": st["wins"] + np.where(net > 0, act, f32(0)),
           "turn": st["turn"] + dp}
    return {k: np.where(ok, v, st[k]).astype(f32) for k, v in new.items()}


def _crafted(n_bars, seed):
    """Positions in {-1, 0, +1} (each lane holds its last one about two
    bars in three; two lanes never trade) on the eight rows of returns of
    :func:`torch_parity.crafted_returns`."""
    rng = np.random.default_rng(seed)
    n, p = 8, 24
    moves = rng.integers(-1, 2, (n_bars, n, p)).astype(np.float32)
    hold = rng.random((n_bars, n, p)) < 0.65
    pos = moves.copy()
    for t in range(1, n_bars):
        pos[t] = np.where(hold[t], pos[t - 1], moves[t])
    pos[:, :, :2] = 0.0
    return pos, crafted_returns(n_bars)


def _assert_bits(a, b, name):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
    ok = ~np.isnan(b)
    np.testing.assert_array_equal(a[ok].view(np.uint32),
                                  b[ok].view(np.uint32), err_msg=name)


@pytest.mark.parametrize("cost,lens", [
    (0.0, None),
    (1e-3, None),
    (1e-3, [60, 1, 17, 60, 59, 33, 2, 45]),   # ragged histories
])
def test_mirror_of_the_kernels_step_equals_the_plain_state(cost, lens):
    T = 60
    pos, r = _crafted(T, seed=3)
    N, P = pos.shape[1:]
    tr = np.full(N, T) if lens is None else np.asarray(lens)
    f32 = np.float32
    st = {k: np.zeros((N, P), f32) for k in
          ("prev", "s1", "s2", "dsq", "mdd", "active", "wins", "turn")}
    st["peak"] = np.full((N, P), -np.inf, f32)
    plain = fused._MetricState(torch.from_numpy(tr.astype(np.int32)), P)
    zero_equity = False
    with np.errstate(all="ignore"):
        for t in range(T):
            ok = (t < tr)[:, None]
            st = _step(st, pos[t], r[:, t:t + 1], ok, cost)
            plain.step(t, torch.from_numpy(pos[t]),
                       torch.from_numpy(r[:, t:t + 1]), cost)
            zero_equity |= bool((st["s1"] == -1).any())
    # The series reach NaN and infinite equity, equity below 0, and at no
    # cost equity of exactly 0.
    assert np.isnan(st["mdd"]).any() and np.isinf(st["s1"]).any()
    assert (st["s1"] < -1).any() and (zero_equity or cost > 0)
    for k in ("s1", "s2", "dsq", "peak", "mdd", "active", "wins", "turn"):
        _assert_bits(st[k], getattr(plain, k).numpy(), k)
    # The plain version's cumulative net is s1, bit for bit.
    _assert_bits(st["s1"], plain.cum.numpy(), "cum")
