"""Seeded kernel-hygiene defects for the port's traced-program rule
(``tests/test_torch_kernel_hygiene.py``): each function is a small
"kernel" whose program carries one defect the rule must report with a
chain into this file. Not a test module (no ``test_`` prefix)."""

import torch

from distributed_backtesting_exploration_tpu_torch.ops import fused


def kernel_with_item(x):
    # A prep that reads a value off the device: a host round trip.
    scale = float(x.abs().max().item())
    return (x / scale).sum(-1)


def _entry_plain(x, w):
    return (x * w).sum(-1).to(torch.float32)


def _entry_cuda(x, w):
    n, t = x.shape
    fused._check_launch("fixture_cuda", x.device, 1,
                        x=(x, torch.float32, (n, t)),
                        w=(w, torch.float32, (t,)))
    raise AssertionError("no kernel behind the fixture entry")


def kernel_f64_at_entry(x):
    # An f64 prep handed to the entry without its rounding to f32.
    w = torch.linspace(0.0, 1.0, x.shape[-1], dtype=torch.float64)
    xd = x.double()
    return fused._on_device(_entry_plain, _entry_cuda, x)(xd, w)


def kernel_default_dtype_at_entry(x):
    # Weights made without a dtype: f32 under the default dtype, f64 (and
    # refused by the entry's check) under a float64 default.
    w = torch.linspace(0.0, 1.0, x.shape[-1])
    return fused._on_device(_entry_plain, _entry_cuda, x)(x, w)


def kernel_f64_output(x):
    return x.double().cumsum(-1)


def kernel_weak_output(x):
    # No dtype given: the output follows torch's default dtype.
    return torch.full(x.shape, 2.0) * x.sum()


def kernel_clean(x):
    return (x * 2.0).cumsum(-1)
