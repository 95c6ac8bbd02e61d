"""Compute ops: rolling indicators, signal machines, the PnL engine,
performance metrics and the fused sweeps (K1-K7). Time is always the last
axis."""

from .rolling import (  # noqa: F401
    rolling_sum,
    rolling_mean,
    rolling_std,
    rolling_var,
    rolling_ols,
    rolling_zscore,
    ema,
    rolling_max,
    rolling_min,
    valid_mask,
)
from .pnl import (  # noqa: F401
    simple_returns,
    log_returns,
    backtest_prefix,
    backtest_scan,
    BacktestResult,
)
from .metrics import (  # noqa: F401
    Metrics,
    LOWER_IS_BETTER,
    metric_sign,
    metrics_from_reductions,
    summary_metrics,
    sharpe,
    sortino,
    max_drawdown,
    total_return,
    cagr,
    hit_rate,
    n_trades,
)
from .signals import band_hysteresis  # noqa: F401
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
