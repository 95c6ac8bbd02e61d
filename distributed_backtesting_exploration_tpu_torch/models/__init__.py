"""Strategy families ported so far; see ``models.base`` for the Strategy
API and the registry. ``pairs`` is not a Strategy (two legs): it owns its
sweep, ``pairs.run_pairs_sweep``."""

from .base import Strategy, register, get_strategy, available_strategies  # noqa: F401
from . import (  # noqa: F401
    bollinger, donchian, keltner, macd, momentum, obv, pairs, rsi,
    sma_crossover, stochastic, trix, vwap)
