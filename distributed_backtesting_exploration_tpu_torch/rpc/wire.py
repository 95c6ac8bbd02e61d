"""Binary result codec and job-spec helpers (reference ``rpc/wire.py``).

Completions carry the full per-param metric matrix as one compact float32
"DBXM" block. The bytes must equal the reference's for the same metrics:
the dispatcher decodes blocks from JAX and PyTorch workers alike.
"""

from __future__ import annotations

import struct

import numpy as np

from ..ops.metrics import Metrics

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
