"""Utilities: market-data codecs (numpy only)."""

from .data import (  # noqa: F401
    OHLCV,
    synthetic_ohlcv,
    from_csv_bytes,
    to_wire_bytes,
    from_wire_bytes,
    pad_and_stack,
)
