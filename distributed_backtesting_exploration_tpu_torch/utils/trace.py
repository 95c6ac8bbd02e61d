"""DEPRECATED: moved to :mod:`distributed_backtesting_exploration_tpu_torch.obs`.

The reference's ``utils.trace`` shim, for the port: the span API, metrics
registry, JSONL event log and ``/metrics`` surface live under ``obs``.
This module re-exports the old names unchanged and warns; import from
``..obs`` (or ``..obs.trace``) instead.
"""

from __future__ import annotations

import warnings

from ..obs.trace import (  # noqa: F401
    StepTimer, device_profile, span, timed)

warnings.warn(
    "distributed_backtesting_exploration_tpu_torch.utils.trace is "
    "deprecated; use distributed_backtesting_exploration_tpu_torch.obs "
    "(same names: timed, device_profile, StepTimer, plus the span/registry "
    "APIs)", DeprecationWarning, stacklevel=2)
