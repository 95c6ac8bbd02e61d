"""Market-data representation and codecs (numpy only).

A copy of the parts of the reference's ``utils/data.py`` that the SMA sweep
job needs. The DBX1 binary block and the synthetic panel must stay
byte-identical to the reference: a mixed fleet of JAX and PyTorch workers
decodes the same payloads, and the tests pin both codecs to the
reference's bytes.

Layout: every field is a separate ``(..., T)`` float32 array
(struct-of-arrays). Ragged histories are padded at the end with the last
bar repeated, so padded bars have exactly zero return
(:func:`pad_and_stack`).
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Sequence

import numpy as np

_WIRE_MAGIC = b"DBX1"
_FIELDS = ("open", "high", "low", "close", "volume")


class OHLCV(NamedTuple):
    """Struct-of-arrays OHLCV batch; each field shaped ``(..., T)``."""

    open: np.ndarray
    high: np.ndarray
    low: np.ndarray
    close: np.ndarray
    volume: np.ndarray

    @property
    def n_bars(self) -> int:
        return self.close.shape[-1]


def synthetic_ohlcv(
    n_tickers: int,
    n_bars: int,
    *,
    seed: int = 0,
    s0: float = 100.0,
    mu: float = 0.08,
    sigma: float = 0.25,
    periods_per_year: int = 252,
    dtype=np.float32,
) -> OHLCV:
    """Geometric-Brownian-motion OHLCV panel, shape ``(n_tickers, n_bars)``.

    Deterministic in ``seed`` and equal, array for array, to the
    reference's panel for the same arguments.
    """
    rng = np.random.default_rng(seed)
    dt = 1.0 / periods_per_year
    z = rng.standard_normal((n_tickers, n_bars))
    log_ret = (mu - 0.5 * sigma**2) * dt + sigma * np.sqrt(dt) * z
    close = s0 * np.exp(np.cumsum(log_ret, axis=-1))
    open_ = np.concatenate([np.full((n_tickers, 1), s0), close[:, :-1]], axis=-1)
    wick = np.abs(rng.standard_normal((2, n_tickers, n_bars))) * sigma * np.sqrt(dt)
    high = np.maximum(open_, close) * (1.0 + wick[0])
    low = np.minimum(open_, close) * (1.0 - wick[1])
    volume = np.exp(rng.normal(12.0, 1.0, (n_tickers, n_bars)))
    return OHLCV(*(a.astype(dtype) for a in (open_, high, low, close, volume)))


def from_csv_bytes(data: bytes, *, dtype=np.float32) -> OHLCV:
    """Decode OHLCV CSV bytes (header with open/high/low/close/volume columns).

    Extra columns (e.g. a leading date column) are tolerated by matching the
    header by name. This is the reference's pure-Python parser; the port has
    no native decoder.
    """
    text = data.decode()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError("empty CSV payload")
    header = [h.strip().lower() for h in lines[0].split(",")]
    cols = {name: header.index(name) for name in _FIELDS if name in header}
    missing = [f for f in _FIELDS if f not in cols]
    if missing:
        raise ValueError(f"CSV missing columns: {missing}; header={header}")
    rows = [ln.split(",") for ln in lines[1:]]
    out = {}
    for name, j in cols.items():
        out[name] = np.asarray([float(r[j]) for r in rows], dtype=dtype)
    return OHLCV(**out)


def to_wire_bytes(series: OHLCV) -> bytes:
    """Pack one ticker into the DBX1 block: magic, T, 5 x f32[T]."""
    if series.close.ndim != 1:
        raise ValueError("to_wire_bytes takes a single ticker, fields shaped (T,)")
    T = series.n_bars
    parts = [_WIRE_MAGIC, struct.pack("<I", T)]
    for f in _FIELDS:
        parts.append(np.ascontiguousarray(
            getattr(series, f), dtype="<f4").tobytes())
    return b"".join(parts)


def from_wire_bytes(data: bytes) -> OHLCV:
    """Decode the DBX1 block produced by :func:`to_wire_bytes`."""
    # Length check before unpack: a 4-7 byte block with valid magic must
    # fail with ValueError, not struct.error.
    if len(data) < 8 or data[:4] != _WIRE_MAGIC:
        raise ValueError("bad magic; not a DBX1 OHLCV block")
    (T,) = struct.unpack_from("<I", data, 4)
    need = 8 + 4 * 5 * T
    if len(data) < need:
        raise ValueError(f"truncated OHLCV block: {len(data)} < {need}")
    fields = []
    off = 8
    for _ in _FIELDS:
        fields.append(np.frombuffer(data, dtype="<f4", count=T, offset=off).copy())
        off += 4 * T
    return OHLCV(*fields)


def pad_and_stack(
    series: Sequence[OHLCV], *, lane_multiple: int = 128
) -> tuple[OHLCV, np.ndarray, np.ndarray]:
    """Stack ragged per-ticker series into one padded batch.

    Returns ``(batch, lengths, mask)`` where ``batch`` fields are
    ``(n_tickers, T_pad)`` with ``T_pad`` the max length rounded up to
    ``lane_multiple``; padding repeats each ticker's final bar (so padded
    returns are exactly 0) and ``mask`` is the ``(n_tickers, T_pad)``
    validity mask.
    """
    lengths = np.asarray([s.n_bars for s in series], np.int32)
    t_max = int(lengths.max())
    t_pad = -(-t_max // lane_multiple) * lane_multiple
    n = len(series)
    cols = {f: np.zeros((n, t_pad), np.float32) for f in _FIELDS}
    for i, s in enumerate(series):
        for f in _FIELDS:
            a = np.asarray(getattr(s, f), np.float32)
            cols[f][i, : a.shape[0]] = a
            cols[f][i, a.shape[0]:] = a[-1]
    mask = np.arange(t_pad)[None, :] < lengths[:, None]
    return OHLCV(**cols), lengths, mask
