"""Sweep engines and what composes them. :mod:`.sweep` is the generic
(ticker x param) sweep, the golden path of the fused kernels;
:mod:`.walkforward` the out-of-sample refit over sliding windows;
:mod:`.portfolio` the composition of per-ticker backtests into one book;
:mod:`.sharding` the mesh of devices and the ticker-sharded sweep;
:mod:`.timeshard` the backtests with their bars split over a mesh;
:mod:`.multihost` the process group of a slice of hosts."""

from . import portfolio, sweep, walkforward  # noqa: F401
