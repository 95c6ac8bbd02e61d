"""Strategy families. The port so far carries the SMA crossover only; see
``models.base`` for the Strategy API and the registry."""

from .base import Strategy, register, get_strategy, available_strategies  # noqa: F401
from . import sma_crossover  # noqa: F401
