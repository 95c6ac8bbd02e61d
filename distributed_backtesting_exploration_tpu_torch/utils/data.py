"""Market-data representation and codecs (numpy only).

A copy of the reference's ``utils/data.py`` codecs: the synthetic panel,
CSV, Parquet and the DBX1 binary block with its streaming-append splice.
Every encoder must stay byte-identical to the reference: a mixed fleet of
JAX and PyTorch workers decodes the same payloads and content-addresses
the same panel bytes, and the tests pin each codec to the reference's
bytes. pyarrow is imported inside the Parquet functions only (hosts
without it still import this module).

Layout: every field is a separate ``(..., T)`` float32 array
(struct-of-arrays). Ragged histories are padded at the end with the last
bar repeated, so padded bars have exactly zero return
(:func:`pad_and_stack`).
"""

from __future__ import annotations

import io
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


def to_csv_bytes(series: OHLCV) -> bytes:
    """Encode a single ticker (fields shaped ``(T,)``) as OHLCV CSV bytes."""
    if series.close.ndim != 1:
        raise ValueError("to_csv_bytes takes a single ticker, fields shaped (T,)")
    buf = io.StringIO()
    buf.write("open,high,low,close,volume\n")
    for row in zip(*(np.asarray(getattr(series, f), np.float64) for f in _FIELDS)):
        buf.write(",".join(repr(float(v)) for v in row) + "\n")
    return buf.getvalue().encode()


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


def to_parquet_bytes(series: OHLCV) -> bytes:
    """Encode a single ticker as a Parquet file (pyarrow): the five named
    columns as f64, the reference's columnar twin of :func:`to_csv_bytes`."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    if series.close.ndim != 1:
        raise ValueError(
            "to_parquet_bytes takes a single ticker, fields shaped (T,)")
    table = pa.table({f: np.asarray(getattr(series, f), np.float64)
                      for f in _FIELDS})
    sink = io.BytesIO()
    pq.write_table(table, sink)
    return sink.getvalue()


def from_parquet_bytes(data: bytes, *, dtype=np.float32) -> OHLCV:
    """Decode a Parquet file's OHLCV columns (name-matched,
    case-insensitive; extra columns such as a date index are tolerated).

    A host without pyarrow, an unreadable file and missing columns all
    raise ``ValueError``, the bad-payload error of every decoder here.
    """
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ValueError(
            "pyarrow is required to decode Parquet payloads but is not "
            "installed on this host; install pyarrow or feed CSV/DBX1 "
            f"files instead ({e})") from e

    try:
        table = pq.read_table(io.BytesIO(data))
    except Exception as e:
        raise ValueError(f"not a readable Parquet file: {e}") from e
    by_name = {name.strip().lower(): i
               for i, name in enumerate(table.column_names)}
    missing = [f for f in _FIELDS if f not in by_name]
    if missing:
        raise ValueError(f"Parquet missing columns: {missing}; "
                         f"columns={table.column_names}")
    return OHLCV(*(np.asarray(table.column(by_name[f]).to_numpy(),
                              dtype=dtype) for f in _FIELDS))


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


def splice_wire_bytes(base: bytes, delta: bytes) -> bytes:
    """Extend a DBX1 panel by a DBX1 delta slice: per-field concatenation.

    The streaming-append primitive: deterministic, so a replayed delta
    chain gives byte-identical extended panels, and so the same content
    digests.
    """
    b = from_wire_bytes(base)
    d = from_wire_bytes(delta)
    if d.n_bars < 1:
        raise ValueError("empty delta slice")
    return to_wire_bytes(OHLCV(*(
        np.concatenate([np.asarray(bf), np.asarray(df)])
        for bf, df in zip(b, d))))


def splice_cone_probe():
    """``(fn, args, integral_keys)`` for dbxcert: the array-dataflow cone
    of :func:`splice_wire_bytes`, per-field concatenation and nothing else
    (the reference's, ``torch.cat`` for its ``jnp.concatenate``).

    Replayed chains reproduce the extended panels' digests because the
    splice is pure data movement: the certifier pins every output of this
    cone to the *exact* class with a zero boundary census, so an edit that
    slips arithmetic into the splice fails the digest-determinism gate.
    The byte framing around it is held by the wire round-trip tests."""
    import torch  # lazy: this module stays numpy-only otherwise

    base = synthetic_ohlcv(1, 12, seed=5)
    delta = synthetic_ohlcv(1, 4, seed=6)

    def fn(b, d):
        return {f: torch.cat([b[f], d[f]], dim=-1) for f in _FIELDS}

    args = [{f: np.asarray(getattr(base, f)[0], np.float32)
             for f in _FIELDS},
            {f: np.asarray(getattr(delta, f)[0], np.float32)
             for f in _FIELDS}]
    return fn, args, frozenset()


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
