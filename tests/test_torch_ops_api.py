"""The reference's public API that the port took over last, against the
JAX package on inputs made from a numpy seed, on the CPU.

- The eight standalone metrics (``ops/metrics.py``) against the
  reference's, with and without ``mask``, on ``(T,)`` and ``(N, P, T)``
  inputs, and each equal to the same field of the port's
  ``summary_metrics`` (they share its reductions).
- ``log_returns`` and ``backtest_prefix(compound=True)`` against the
  reference's.
- ``backtest_scan``: the reference test's hold-or-decay machine
  (``tests/test_pnl_metrics.py``) against the JAX ``backtest_scan``, and a
  band-hysteresis step, whose positions must be identical to the port's
  ``signals.band_hysteresis``, whatever structure holds its inputs.
- ``chunked_pairs_sweep`` against the JAX package's under
  ``tests/torch_parity.py``'s flip rule, against the port's own
  ``run_pairs_sweep``, and its ``ValueError``.
- ``walkforward.window_starts``, ``recurrent.keltner_true_range``,
  ``compute.ComputeBackend`` and the re-exports.

Tolerance: rtol=1e-5, atol=1e-6 (f32) against the reference, tighter than
the reference's own compound test (rtol=2e-4,
``tests/test_pnl_metrics.py``); the chunked pairs sweep against the
port's ``run_pairs_sweep`` at the reference's rtol=1e-6, atol=1e-7
(``tests/test_pairs_walkforward.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.models import pairs as ref_pairs
from distributed_backtesting_exploration_tpu.ops import metrics as ref_metrics
from distributed_backtesting_exploration_tpu.ops import pnl as ref_pnl
from distributed_backtesting_exploration_tpu.parallel import (
    walkforward as ref_walkforward)
from distributed_backtesting_exploration_tpu.streaming import (
    recurrent as ref_recurrent)
from distributed_backtesting_exploration_tpu_torch import ops, streaming
from distributed_backtesting_exploration_tpu_torch.models import pairs
from distributed_backtesting_exploration_tpu_torch.ops import (
    metrics, pnl, signals)
from distributed_backtesting_exploration_tpu_torch.parallel import (
    sweep, walkforward)
from distributed_backtesting_exploration_tpu_torch.rpc import compute, worker
from distributed_backtesting_exploration_tpu_torch.rpc import executor
from distributed_backtesting_exploration_tpu_torch.streaming import (
    delta, recurrent)
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import assert_metrics_match, to_np

RTOL, ATOL = 1e-5, 1e-6
T, N, P = 250, 3, 4
RNG = np.random.default_rng(24)
CLOSE = (50.0 * np.exp(np.cumsum(RNG.normal(3e-4, 0.02, (N, 1, T)), -1))
         ).astype(np.float32)
POS = RNG.choice(np.float32([-1, 0, 1]), (N, P, T))
POS[..., :20] = 0.0
# Ragged real lengths, the pad a suffix (a padded batch's mask).
MASK = np.arange(T)[None, None, :] < np.array([T, 200, 131])[:, None, None]


def _series(shape: str):
    """(returns, equity, positions, mask) of one backtest, as numpy."""
    close, pos, mask = CLOSE, POS, MASK
    if shape == "T":
        close, pos, mask = CLOSE[1, 0], POS[1, 0], MASK[1, 0]
    res = pnl.backtest_prefix(torch.from_numpy(close), torch.from_numpy(pos),
                              cost=1e-3)
    return to_np(res.returns), to_np(res.equity), pos, mask


# name -> (its inputs, takes mask)
STANDALONE = {
    "sharpe": (("returns",), True), "sortino": (("returns",), True),
    "max_drawdown": (("equity",), False), "total_return": (("equity",), False),
    "cagr": (("equity",), True),
    "hit_rate": (("returns", "positions"), True),
    "turnover_total": (("positions",), False),
    "n_trades": (("positions",), False),
}
METRIC_CASES = [(name, masked, shape) for name, (_, takes) in STANDALONE.items()
                for masked in ((False, True) if takes else (False,))
                for shape in ("T", "NPT")]


def _call(mod, name, arrays, masked, as_array):
    args, _ = STANDALONE[name]
    kw = {"mask": as_array(arrays["mask"])} if masked else {}
    return getattr(mod, name)(*(as_array(arrays[a]) for a in args), **kw)


@pytest.mark.parametrize("name,masked,shape", METRIC_CASES)
def test_standalone_metric_matches_the_reference(name, masked, shape):
    returns, equity, positions, mask = _series(shape)
    arrays = {"returns": returns, "equity": equity, "positions": positions,
              "mask": mask}
    got = _call(metrics, name, arrays, masked, torch.from_numpy)
    want = _call(ref_metrics, name, arrays, masked, jnp.asarray)
    assert tuple(got.shape) == np.shape(want)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # The same value as summary_metrics' field, bit for bit.
    field = "turnover" if name == "turnover_total" else name
    summary = metrics.summary_metrics(
        *(torch.from_numpy(a) for a in (returns, equity, positions)),
        mask=torch.from_numpy(mask) if masked else None)
    assert torch.equal(got, getattr(summary, field))


@pytest.mark.parametrize("shape", [(T,), (N, T)])
def test_log_returns_match_the_reference(shape):
    close = CLOSE.reshape(N, T)[:shape[0]] if len(shape) == 2 else CLOSE[0, 0]
    got = pnl.log_returns(torch.from_numpy(close))
    want = ref_pnl.log_returns(jnp.asarray(close))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert float(got[..., 0].abs().max()) == 0.0


@pytest.mark.parametrize("cost", [0.0, 5e-4])
def test_compound_equity_matches_the_reference(cost):
    got = pnl.backtest_prefix(torch.from_numpy(CLOSE), torch.from_numpy(POS),
                              cost=cost, compound=True)
    want = ref_pnl.backtest_prefix(jnp.asarray(CLOSE), jnp.asarray(POS),
                                   cost=cost, compound=True)
    for name in ("returns", "equity"):
        np.testing.assert_allclose(to_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(
        to_np(got.equity), np.cumprod(1.0 + to_np(got.returns), -1),
        rtol=2e-4)


def test_additive_equity_is_unchanged_by_the_compound_option():
    close, pos = torch.from_numpy(CLOSE), torch.from_numpy(POS)
    plain = pnl.backtest_prefix(close, pos, cost=1e-3)
    additive = pnl.backtest_prefix(close, pos, cost=1e-3, compound=False)
    assert torch.equal(plain.equity, additive.equity)
    assert torch.equal(plain.equity, 1.0 + torch.cumsum(plain.returns, -1))


def _decay_step(where, xp):
    """The reference test's machine: long on a positive signal, else the
    carry halves."""
    def step(carry, x):
        nxt = where(x > 0, xp(1.0), carry * 0.5)
        return nxt, nxt
    return step


@pytest.mark.parametrize("compound", [False, True])
def test_backtest_scan_decay_machine_matches_the_reference(compound):
    sig = np.random.default_rng(7).choice(np.float32([-1, 1]), (N, T))
    close = CLOSE.reshape(N, T)
    got = pnl.backtest_scan(
        _decay_step(torch.where, lambda v: torch.tensor(v)),
        torch.zeros(N), torch.from_numpy(sig), torch.from_numpy(close),
        cost=1e-3, compound=compound)
    want = ref_pnl.backtest_scan(
        _decay_step(jnp.where, jnp.float32), jnp.zeros(N, jnp.float32),
        jnp.asarray(sig), jnp.asarray(close), cost=1e-3, compound=compound)
    for name in ("positions", "returns", "equity"):
        np.testing.assert_allclose(to_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def _band_inputs():
    g = torch.Generator().manual_seed(5)
    z = torch.randn(N, P, T, generator=g) * 1.5
    valid = torch.arange(T) >= 30
    z_entry = torch.tensor([0.5, 1.0, 1.5, 2.0])[:, None]
    return z, valid, z_entry


def band_step(z_entry, z_exit, like):
    """``signals.band_hysteresis``'s bar as a ``backtest_scan`` step over
    ``(z_t, valid_t)``."""
    ze = signals._per_series(z_entry, like)
    zx = signals._per_series(z_exit, like)
    one = torch.ones(())
    zero = torch.zeros(())

    def step(pos, bar):
        zt, valid_t = bar
        entered = torch.where(zt < -ze, one, torch.where(zt > ze, -one, zero))
        exit_long = (pos > 0) & (zt >= -zx)
        exit_short = (pos < 0) & (zt <= zx)
        held = torch.where(exit_long | exit_short, zero, pos)
        pos = torch.where(valid_t, torch.where(pos == 0, entered, held), zero)
        return pos, pos
    return step


@pytest.mark.parametrize("structure", ["tuple", "list", "dict"])
def test_backtest_scan_band_machine_is_band_hysteresis(structure):
    z, valid, z_entry = _band_inputs()
    valid_b = torch.broadcast_to(valid, z.shape)
    inner = band_step(z_entry, 0.25, z)
    if structure == "dict":
        inputs = {"z": z, "valid": valid_b}

        def step(pos, bar):
            return inner(pos, (bar["z"], bar["valid"]))
    else:
        inputs = (z, valid_b) if structure == "tuple" else [z, valid_b]
        step = inner
    close = torch.from_numpy(CLOSE)
    got = pnl.backtest_scan(step, torch.zeros(N, P), inputs, close,
                            cost=1e-3)
    want = signals.band_hysteresis(z, valid, z_entry, 0.25)
    assert torch.equal(got.positions, want)
    priced = pnl.backtest_prefix(close, want, cost=1e-3)
    assert torch.equal(got.returns, priced.returns)
    assert torch.equal(got.equity, priced.equity)


def test_backtest_scan_rejects_inputs_without_tensors():
    with pytest.raises(ValueError, match="no tensor"):
        pnl.backtest_scan(lambda c, x: (c, c), 0.0, (), torch.ones(3))
    with pytest.raises(TypeError, match="tensors"):
        pnl.backtest_scan(lambda c, x: (c, c), 0.0, (torch.ones(3), 1.0),
                          torch.ones(3))


def _pair_legs(n_pairs=3, bars=T, seed=11):
    closes = data.synthetic_ohlcv(2 * n_pairs, bars, seed=seed).close
    return closes[:n_pairs], closes[n_pairs:]


PAIRS_GRID = {k: to_np(v) for k, v in sweep.product_grid(
    lookback=np.float32([20, 30]),
    z_entry=np.float32([1.0, 1.5, 2.0])).items()}


@pytest.mark.parametrize("param_chunk", [1, 3, 6])
def test_chunked_pairs_sweep_matches_the_reference(param_chunk):
    y, x = _pair_legs()
    got = pairs.chunked_pairs_sweep(y, x, PAIRS_GRID, param_chunk=param_chunk,
                                    cost=1e-3, device="cpu")
    want = ref_pairs.chunked_pairs_sweep(
        jnp.asarray(y), jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in PAIRS_GRID.items()},
        param_chunk=param_chunk, cost=1e-3)
    assert_metrics_match(got, want)


@pytest.mark.parametrize("param_chunk", [1, 2, 3, 6])
def test_chunked_pairs_sweep_matches_run_pairs_sweep(param_chunk):
    y, x = _pair_legs(seed=12)
    got = pairs.chunked_pairs_sweep(y, x, PAIRS_GRID, param_chunk=param_chunk,
                                    cost=1e-3, device="cpu")
    want = pairs.run_pairs_sweep(y, x, PAIRS_GRID, cost=1e-3, device="cpu")
    for name in want._fields:
        np.testing.assert_allclose(
            to_np(getattr(got, name)), to_np(getattr(want, name)),
            rtol=1e-6, atol=1e-7, err_msg=name)


def test_chunked_pairs_sweep_needs_a_dividing_chunk():
    y, x = _pair_legs()
    with pytest.raises(ValueError, match="divisible"):
        pairs.chunked_pairs_sweep(y, x, PAIRS_GRID, param_chunk=4,
                                  device="cpu")


@pytest.mark.parametrize("T_,train,test", [(1260, 600, 55), (300, 80, 30),
                                          (100, 99, 1)])
def test_window_starts(T_, train, test):
    got = walkforward.window_starts(T_, train, test, device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(
        to_np(got), walkforward.window_starts_np(T_, train, test))
    np.testing.assert_array_equal(
        to_np(got), np.asarray(ref_walkforward.window_starts(T_, train, test)))


def test_window_starts_too_short():
    with pytest.raises(ValueError, match="too short"):
        walkforward.window_starts(50, 60, 10, device="cpu")


def test_keltner_true_range_matches_the_reference():
    panel = data.synthetic_ohlcv(N, T, seed=3)
    got = recurrent.keltner_true_range(
        *(torch.from_numpy(getattr(panel, f)) for f in ("high", "low",
                                                        "close")))
    want = ref_recurrent.keltner_true_range(
        *(jnp.asarray(getattr(panel, f)) for f in ("high", "low", "close")))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_torch_backend_is_a_compute_backend():
    backend = compute.TorchSweepBackend(device="cpu")
    assert isinstance(backend, compute.ComputeBackend)
    assert backend.chips == 1


def test_reference_exports_are_the_port_functions():
    assert streaming.metric_delta is delta.metric_delta
    assert worker.pipeline_enabled is executor.pipeline_enabled
    assert worker.pipeline_depth is executor.pipeline_depth
    assert ops.backtest_scan is pnl.backtest_scan
    assert ops.band_hysteresis is signals.band_hysteresis
    for name in ("sharpe", "sortino", "max_drawdown", "total_return",
                 "cagr", "hit_rate", "n_trades"):
        assert getattr(ops, name) is getattr(metrics, name)
