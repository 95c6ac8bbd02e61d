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


def to_np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_metrics_match(got, ref, *, rtol=RTOL, atol=ATOL) -> int:
    """Hold ``got`` (port Metrics) against ``ref`` (reference Metrics) under
    the flip rule; return the number of flipped cells."""
    assert tuple(got._fields) == tuple(ref._fields)
    flipped = np.zeros(to_np(ref.turnover).shape, dtype=bool)
    for name in ref._fields:
        a, b = to_np(getattr(got, name)), to_np(getattr(ref, name))
        assert a.shape == b.shape, (name, a.shape, b.shape)
        flipped |= np.abs(a - b) > (0.01 + 0.01 * np.abs(b))
    n_flips = int(flipped.sum())
    assert n_flips <= max(1, int(0.01 * flipped.size)), (
        f"{n_flips}/{flipped.size} position-path flips")
    for name in ref._fields:
        a = to_np(getattr(got, name))[~flipped]
        b = to_np(getattr(ref, name))[~flipped]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)
    return n_flips
