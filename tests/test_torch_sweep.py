"""The port's generic sweep (``parallel.sweep.run_sweep``) against the
reference's ``jit_sweep``, SMA crossover, on shared numpy inputs.

Tolerances and the flip budget: see ``torch_parity``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.models.base import (
    get_strategy as ref_strategy)
from distributed_backtesting_exploration_tpu.parallel import sweep as ref_sweep
from distributed_backtesting_exploration_tpu.utils import data as ref_data
from distributed_backtesting_exploration_tpu_torch.models import get_strategy
from distributed_backtesting_exploration_tpu_torch.ops import rolling
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import assert_metrics_match, to_np


def _ref(panel, axes, cost, mask=None):
    jpanel = ref_data.OHLCV(*(jnp.asarray(f) for f in panel))
    grid = ref_sweep.product_grid(**{k: jnp.asarray(v, jnp.float32)
                                     for k, v in axes.items()})
    return ref_sweep.jit_sweep(
        jpanel, ref_strategy("sma_crossover"), dict(grid), cost=cost,
        bar_mask=None if mask is None else jnp.asarray(mask))


@pytest.mark.parametrize("n,T,fast,slow,cost,seed", [
    (3, 200, [3, 5, 8], [13, 21], 1e-3, 0),
    (2, 251, [4, 6], [17, 29], 1e-3, 3),
    (2, 120, [3.5, 6], [13, 20.25], 1e-3, 4),    # non-integral windows
    (2, 60, [5], [40, 80], 0.0, 6),              # window longer than T
])
def test_run_sweep_matches_reference(n, T, fast, slow, cost, seed):
    panel = data.synthetic_ohlcv(n, T, seed=seed)
    axes = {"fast": np.float32(fast), "slow": np.float32(slow)}
    got = sweep.run_sweep(panel, get_strategy("sma_crossover"),
                          sweep.product_grid(**axes), cost=cost,
                          device="cpu")
    assert_metrics_match(got, _ref(panel, axes, cost))


def test_run_sweep_ragged_mask_matches_reference():
    series = [data.OHLCV(*(f[0] for f in data.synthetic_ohlcv(1, T, seed=T)))
              for T in (150, 97, 200)]
    panel, _, mask = data.pad_and_stack(series)
    axes = {"fast": np.float32([3, 5]), "slow": np.float32([13, 21])}
    got = sweep.run_sweep(panel, get_strategy("sma_crossover"),
                          sweep.product_grid(**axes), cost=1e-3,
                          bar_mask=mask, device="cpu")
    assert_metrics_match(got, _ref(panel, axes, 1e-3, mask))


def test_run_sweep_param_chunks_reassemble(monkeypatch):
    panel = data.synthetic_ohlcv(2, 90, seed=8)
    grid = sweep.product_grid(fast=np.float32([3, 4, 5]),
                              slow=np.float32([10, 12, 14, 16]))
    whole = sweep.run_sweep(panel, get_strategy("sma_crossover"), grid,
                            cost=1e-3, device="cpu")
    monkeypatch.setattr(sweep, "_CHUNK_ELEMS", 2 * 90 * 5)   # 5-combo chunks
    chunked = sweep.run_sweep(panel, get_strategy("sma_crossover"), grid,
                              cost=1e-3, device="cpu")
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(to_np(a), to_np(b))


def test_product_grid_flat_order_matches_reference():
    axes = {"fast": np.float32([5, 10, 15]), "slow": np.float32([50, 100])}
    got = sweep.product_grid(**axes)
    want = ref_sweep.product_grid(**axes)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(to_np(got[k]), to_np(want[k]))
    assert sweep.grid_size(got) == 6


def test_rolling_mean_matches_reference():
    from distributed_backtesting_exploration_tpu.ops import (
        rolling as ref_rolling)

    x = data.synthetic_ohlcv(2, 40, seed=1).close
    for w in (1, 3, 7.0, 39, 45):
        got = rolling.rolling_mean(torch.from_numpy(x), w, fill=0.0)
        want = ref_rolling.rolling_mean(jnp.asarray(x), w, fill=0.0)
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5,
                                   atol=1e-4, err_msg=str(w))
