"""Checkpoint and restore of sweep results (the reference's
``utils/checkpoint.py``, without orbax).

The dispatcher's journal makes the queue crash-durable; this module makes
a long computation resumable: the result store of a large sweep campaign,
one block at a time. A block is one ``.npz`` file holding the nine metric
arrays and a JSON ``meta`` string. It is written to a temporary name in
the same directory, flushed to disk, and renamed over its final name
(``os.replace``), and the directory is flushed after the rename, so a
crash mid-save leaves at most a stray temporary file and never a partial
block, and a block that :meth:`SweepCheckpointer.add` returned from
survives a power loss. The format is not the reference's orbax
directory: the two cannot read each other's checkpoints.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Mapping

import numpy as np

from ..ops.metrics import Metrics

_META = "_meta"
_SUFFIX = ".npz"


def _host(field) -> np.ndarray:
    """A metric field (numpy array or tensor on any device) on the host."""
    if hasattr(field, "detach"):
        return field.detach().cpu().numpy()
    return np.asarray(field)


def save_metrics(path: str, metrics: Metrics, *,
                 meta: Mapping[str, Any] | None = None) -> None:
    """Atomically write a :class:`Metrics` and JSON-serializable ``meta``
    to the file ``path``."""
    path = os.path.abspath(path)
    payload = {name: _host(f) for name, f in zip(Metrics._fields, metrics)}
    payload[_META] = np.asarray(json.dumps(dict(meta or {})))
    fd, tmp = tempfile.mkstemp(prefix=f".{os.path.basename(path)}.",
                               suffix=".tmp", dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    _fsync_dir(os.path.dirname(path))


def _fsync_dir(path: str) -> None:
    """Flush a directory's entries (a rename into it) to disk."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def load_metrics(path: str) -> tuple[Metrics, dict]:
    """Read a checkpoint written by :func:`save_metrics`; returns
    ``(metrics, meta)``."""
    with np.load(os.path.abspath(path), allow_pickle=False) as z:
        meta = json.loads(str(z[_META]))
        return Metrics(*(z[name] for name in Metrics._fields)), meta


class SweepCheckpointer:
    """Incremental result store for a chunked sweep campaign.

    Iterate the (ticker-block x param-block) work list and call :meth:`add`
    after each block; on restart, :meth:`done` names the block ids to skip.
    Each block is one file ``block-<id>.npz`` under ``root``, written
    atomically by :func:`save_metrics`, so a crash mid-save never shows as
    a finished block and never corrupts an earlier one.
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _block_path(self, block_id: str) -> str:
        return os.path.join(self.root, f"block-{block_id}{_SUFFIX}")

    def done(self) -> set[str]:
        return {name[len("block-"):-len(_SUFFIX)]
                for name in os.listdir(self.root)
                if name.startswith("block-") and name.endswith(_SUFFIX)}

    def add(self, block_id: str, metrics: Metrics,
            meta: Mapping[str, Any] | None = None) -> None:
        save_metrics(self._block_path(block_id), metrics, meta=meta)

    def get(self, block_id: str) -> tuple[Metrics, dict]:
        return load_metrics(self._block_path(block_id))
