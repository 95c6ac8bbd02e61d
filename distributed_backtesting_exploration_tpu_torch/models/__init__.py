"""Strategy families ported so far; see ``models.base`` for the Strategy
API and the registry."""

from .base import Strategy, register, get_strategy, available_strategies  # noqa: F401
from . import (  # noqa: F401
    bollinger, donchian, keltner, macd, momentum, rsi, sma_crossover,
    stochastic, trix)
