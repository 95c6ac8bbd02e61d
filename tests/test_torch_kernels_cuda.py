"""K1 (``csrc/fused_sma.cu``) against its plain PyTorch version on the card.

Marked ``cuda``: every test skips with a reason where no CUDA card is
present (the kernel has no CPU mode). On a machine with a card, and without
JAX (this file and ``torch_parity`` import none), run:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py

Both versions take the same cumsum and returns, so positions are identical
(n_trades and turnover bit-equal) and the other metrics agree at
rtol=2e-4, atol=2e-5.
"""

import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu_torch.ops import _kernels, fused
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import ATOL, RTOL

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


def _inputs(dev, close, fast_axis, slow_axis, t_real=None):
    g = sweep.product_grid(fast=np.float32(fast_axis),
                           slow=np.float32(slow_axis))
    fw, sw, warm = fused._grid_setup(g["fast"].numpy(), g["slow"].numpy())
    tr = fused._check_t_real(t_real, *close.shape)
    c = torch.as_tensor(close, device=dev)
    return (torch.cumsum(c, 1).contiguous(),
            fused.simple_returns(c).contiguous(),
            *(torch.from_numpy(a).to(dev) for a in (tr, fw, sw, warm)))


def _assert_kernel_matches_plain(inputs, cost):
    got = fused.fused_sma_cuda(*inputs, cost=cost, ppy=252)
    ref = fused.fused_sma_plain(*inputs, cost=cost, ppy=252)
    torch.cuda.synchronize()
    for k, name in enumerate(fused.Metrics._fields):
        a, b = got[k].cpu().numpy(), ref[k].cpu().numpy()
        assert np.isfinite(a).all(), name
        if name in ("n_trades", "turnover"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("n,T,fast,slow,cost,seed", [
    (3, 200, [3, 5, 8], [13, 21], 1e-3, 0),
    (2, 251, list(range(3, 14)), list(range(20, 44, 2)), 1e-3, 5),
    (1, 137, [5], [20], 0.0, 7),
    (2, 64, [5, 30], [40, 90], 1e-3, 2),          # windows longer than T
    (2, 13000, [5, 50], [100, 200], 1e-3, 4),     # rows too long to stage
])
def test_kernel_matches_plain(cuda, n, T, fast, slow, cost, seed):
    close = data.synthetic_ohlcv(n, T, seed=seed).close
    _assert_kernel_matches_plain(_inputs(cuda, close, fast, slow), cost)


def test_kernel_matches_plain_ragged(cuda):
    close = data.synthetic_ohlcv(3, 300, seed=9).close
    lens = np.asarray([300, 251, 170])
    for i, n in enumerate(lens):
        close[i, n:] = close[i, n - 1]
    _assert_kernel_matches_plain(
        _inputs(cuda, close, [3, 5, 8], [13, 21], lens), 1e-3)


def test_launch_counter_counts_kernel_launches_only(cuda):
    close = data.synthetic_ohlcv(2, 100, seed=1).close
    inputs = _inputs(cuda, close, [3, 4], [10, 12])
    _kernels.reset_launch_counts()
    fused.fused_sma_plain(*inputs, cost=0.0, ppy=252)
    assert _kernels.LAUNCHES["fused_sma"] == 0
    fused.fused_sma_cuda(*inputs, cost=0.0, ppy=252)
    fused.fused_sma_sweep(close, [3.0], [10.0], device="cuda")
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["fused_sma"] == 2


def test_wrapper_checks_its_inputs(cuda):
    close = data.synthetic_ohlcv(2, 50, seed=1).close
    cs, r, tr, fw, sw, warm = _inputs(cuda, close, [3], [10])
    with pytest.raises(TypeError, match="float32"):
        fused.fused_sma_cuda(cs.double(), r, tr, fw, sw, warm, cost=0.0,
                             ppy=252)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.cat([cs, cs], 1)[:, ::2]
        fused.fused_sma_cuda(wide, r, tr, fw, sw, warm, cost=0.0, ppy=252)
    with pytest.raises(ValueError, match="shape"):
        fused.fused_sma_cuda(cs, r[:1], tr, fw, sw, warm, cost=0.0, ppy=252)
    with pytest.raises(ValueError, match="is on"):
        fused.fused_sma_cuda(cs, r, tr.cpu(), fw, sw, warm, cost=0.0,
                             ppy=252)
