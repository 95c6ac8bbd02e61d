"""Compute ops: rolling indicators, the PnL engine, performance metrics and
the fused sweep (K1). Time is always the last axis."""

from .rolling import rolling_sum, rolling_mean, valid_mask  # noqa: F401
from .pnl import simple_returns, backtest_prefix, BacktestResult  # noqa: F401
from .metrics import (  # noqa: F401
    Metrics,
    LOWER_IS_BETTER,
    metric_sign,
    metrics_from_reductions,
    summary_metrics,
)
from .fused import fused_sma_sweep  # noqa: F401
