"""Compute ops: rolling indicators, signal machines, the PnL engine,
performance metrics and the fused sweeps (K1-K7). Time is always the last
axis."""

from .rolling import rolling_sum, rolling_mean, valid_mask  # noqa: F401
from .pnl import simple_returns, backtest_prefix, BacktestResult  # noqa: F401
from .metrics import (  # noqa: F401
    Metrics,
    LOWER_IS_BETTER,
    metric_sign,
    metrics_from_reductions,
    summary_metrics,
)
from .fused import (  # noqa: F401
    fused_bollinger_sweep,
    fused_bollinger_touch_sweep,
    fused_donchian_hl_sweep,
    fused_donchian_sweep,
    fused_keltner_sweep,
    fused_macd_sweep,
    fused_momentum_sweep,
    fused_obv_sweep,
    fused_pairs_sweep,
    fused_rsi_sweep,
    fused_sma_sweep,
    fused_stochastic_sweep,
    fused_trix_sweep,
    fused_vwap_sweep,
)
