"""Binary result codec and job-spec helpers (reference ``rpc/wire.py``).

Completions carry the full per-param metric matrix as one compact float32
"DBXM" block; a top-k job (``JobSpec.top_k > 0``) completes with a "DBXS"
block (the k best grid indices and their metric rows), a best-returns job
(``JobSpec.best_returns``) with a "DBXP" block (the best grid index, its
metric row and the net-return series under it). The bytes must equal the
reference's for the same values: the dispatcher decodes blocks from JAX
and PyTorch workers alike.
"""

from __future__ import annotations

import struct
from typing import Mapping

import numpy as np

from ..ops.metrics import Metrics
from . import backtesting_pb2 as pb

_METRICS_MAGIC = b"DBXM"


def metrics_to_bytes(m: Metrics) -> bytes:
    """Pack a ``(P,)``-per-field Metrics tuple (numpy arrays or CPU
    tensors) into one DBXM block."""
    fields = [np.asarray(f, dtype="<f4").reshape(-1) for f in m]
    P = fields[0].shape[0]
    if any(f.shape[0] != P for f in fields):
        raise ValueError("all metric fields must have equal length")
    head = _METRICS_MAGIC + struct.pack("<II", P, len(fields))
    return head + b"".join(f.tobytes() for f in fields)


def metrics_blocks(planes: np.ndarray) -> list[bytes]:
    """One DBXM block per job from a group's ``(9, n, P)`` metric planes:
    the bytes of :func:`metrics_to_bytes` on each job's row, each block
    joined straight from the planes' rows (one copy a block)."""
    planes = np.ascontiguousarray(planes, dtype="<f4")
    n_fields, n, P = planes.shape
    head = _METRICS_MAGIC + struct.pack("<II", P, n_fields)
    return [b"".join([head, *planes[:, i]]) for i in range(n)]


def metrics_from_bytes(data: bytes) -> Metrics:
    """Decode a DBXM block back into a Metrics tuple of ``(P,)`` arrays."""
    if data[:4] != _METRICS_MAGIC:
        raise ValueError("bad magic; not a DBXM metrics block")
    if len(data) < 12:
        raise ValueError(f"truncated metrics block: {len(data)} < 12-byte header")
    P, n_fields = struct.unpack_from("<II", data, 4)
    if n_fields != len(Metrics._fields):
        raise ValueError(
            f"metrics block has {n_fields} fields, expected "
            f"{len(Metrics._fields)}")
    need = 12 + 4 * n_fields * P
    if len(data) < need:
        raise ValueError(f"truncated metrics block: {len(data)} < {need}")
    out = []
    off = 12
    for _ in range(n_fields):
        out.append(np.frombuffer(data, dtype="<f4", count=P, offset=off).copy())
        off += 4 * P
    return Metrics(*out)


_TOPK_MAGIC = b"DBXS"


def topk_to_bytes(indices, m: Metrics, rank_metric: str) -> bytes:
    """Pack a top-k selection: ``(k,)`` grid-row indices, best first by
    ``rank_metric`` in the metric's own direction, and the ``(k,)`` values
    of each metric field. The metric's name travels in the block."""
    idx = np.asarray(indices, dtype="<i4").reshape(-1)
    fields = [np.asarray(f, dtype="<f4").reshape(-1) for f in m]
    k = idx.shape[0]
    if any(f.shape[0] != k for f in fields):
        raise ValueError("all metric fields must have length k")
    name = rank_metric.encode("utf-8")
    if len(name) > 255:
        raise ValueError("rank_metric name too long")
    head = _TOPK_MAGIC + struct.pack("<IIB", k, len(fields), len(name)) + name
    return head + idx.tobytes() + b"".join(f.tobytes() for f in fields)


def topk_from_bytes(data: bytes) -> tuple[np.ndarray, Metrics, str]:
    """Decode a DBXS block -> ``(indices, Metrics of (k,) arrays, metric)``."""
    if data[:4] != _TOPK_MAGIC:
        raise ValueError("bad magic; not a DBXS top-k block")
    if len(data) < 13:
        raise ValueError(f"truncated top-k block: {len(data)} < 13-byte header")
    k, n_fields, name_len = struct.unpack_from("<IIB", data, 4)
    if n_fields != len(Metrics._fields):
        raise ValueError(
            f"top-k block has {n_fields} fields, expected "
            f"{len(Metrics._fields)}")
    off = 13
    if len(data) < off + name_len:
        raise ValueError(
            f"truncated top-k block: {len(data)} < {off + name_len} (name)")
    rank_metric = data[off:off + name_len].decode("utf-8")
    off += name_len
    need = off + 4 * k + 4 * n_fields * k
    if len(data) < need:
        raise ValueError(f"truncated top-k block: {len(data)} < {need}")
    idx = np.frombuffer(data, dtype="<i4", count=k, offset=off).copy()
    off += 4 * k
    out = []
    for _ in range(n_fields):
        out.append(np.frombuffer(data, dtype="<f4", count=k,
                                 offset=off).copy())
        off += 4 * k
    return idx, Metrics(*out), rank_metric


_RETURNS_MAGIC = b"DBXP"


def best_returns_to_bytes(grid_idx: int, m_row: Metrics, returns,
                          rank_metric: str) -> bytes:
    """Pack a best-param result with its net-return series (a "DBXP"
    block): the winning grid-row index, its 9 metric values and the
    per-bar net strategy returns under that parameter set."""
    vals = np.asarray([float(np.asarray(f).reshape(-1)[0]) for f in m_row],
                      dtype="<f4")
    ret = np.asarray(returns, dtype="<f4").reshape(-1)
    name = rank_metric.encode("utf-8")
    if len(name) > 255:
        raise ValueError("rank_metric name too long")
    head = _RETURNS_MAGIC + struct.pack(
        "<IIIB", int(grid_idx), ret.shape[0], vals.shape[0],
        len(name)) + name
    return head + vals.tobytes() + ret.tobytes()


def best_returns_from_bytes(
        data: bytes) -> tuple[int, Metrics, np.ndarray, str]:
    """Decode a DBXP block -> ``(grid_idx, Metrics of scalars, returns,
    rank_metric)``."""
    if data[:4] != _RETURNS_MAGIC:
        raise ValueError("bad magic; not a DBXP best-returns block")
    if len(data) < 17:
        raise ValueError(
            f"truncated best-returns block: {len(data)} < 17-byte header")
    grid_idx, T, n_fields, name_len = struct.unpack_from("<IIIB", data, 4)
    if n_fields != len(Metrics._fields):
        raise ValueError(
            f"best-returns block has {n_fields} fields, expected "
            f"{len(Metrics._fields)}")
    off = 17
    if len(data) < off + name_len:
        raise ValueError(
            f"truncated best-returns block: {len(data)} < "
            f"{off + name_len} (name)")
    rank_metric = data[off:off + name_len].decode("utf-8")
    off += name_len
    need = off + 4 * n_fields + 4 * T
    if len(data) < need:
        raise ValueError(
            f"truncated best-returns block: {len(data)} < {need}")
    vals = np.frombuffer(data, dtype="<f4", count=n_fields, offset=off)
    off += 4 * n_fields
    ret = np.frombuffer(data, dtype="<f4", count=T, offset=off).copy()
    return (int(grid_idx), Metrics(*(np.float32(v) for v in vals)), ret,
            rank_metric)


def result_kind(data: bytes) -> str:
    """Classify a completion payload: ``"metrics"`` (DBXM), ``"topk"``
    (DBXS), ``"returns"`` (DBXP), or ``"empty"``."""
    if not data:
        return "empty"
    if data[:4] == _METRICS_MAGIC:
        return "metrics"
    if data[:4] == _TOPK_MAGIC:
        return "topk"
    if data[:4] == _RETURNS_MAGIC:
        return "returns"
    raise ValueError("unknown result block magic")


def grid_to_proto(grid: Mapping[str, object]) -> dict:
    """Param axes dict -> proto map field value dict."""
    return {k: pb.GridAxis(values=[float(v) for v in np.asarray(vs).reshape(-1)])
            for k, vs in grid.items()}


def grid_from_proto(proto_grid) -> dict[str, np.ndarray]:
    """Proto map field -> dict of float32 axis arrays, sorted by axis name.

    Proto3 map iteration order is unspecified, so the wire contract pins a
    canonical axis order, lexicographic by axis name: a DBXM block is laid
    out row-major over the cartesian product in that order.
    """
    return {k: np.asarray(proto_grid[k].values, np.float32)
            for k in sorted(proto_grid)}


def grid_n_combos(proto_grid) -> int:
    """Cartesian-product size of a job's parameter grid (1 if empty)."""
    n = 1
    for ax in proto_grid.values():
        n *= max(len(ax.values), 1)
    return n
