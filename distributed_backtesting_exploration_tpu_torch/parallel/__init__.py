"""Sweep engines. :mod:`.sweep` is the generic (ticker x param) sweep, the
golden path of the fused kernels."""

from . import sweep  # noqa: F401
