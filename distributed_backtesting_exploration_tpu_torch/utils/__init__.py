"""Utilities: market-data codecs (numpy only)."""

from .data import (  # noqa: F401
    OHLCV,
    synthetic_ohlcv,
    to_csv_bytes,
    from_csv_bytes,
    to_parquet_bytes,
    from_parquet_bytes,
    to_wire_bytes,
    from_wire_bytes,
    splice_wire_bytes,
    pad_and_stack,
)
