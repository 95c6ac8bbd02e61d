"""The port's checkpoints (``utils/checkpoint.py``): one ``.npz`` file a
block, written to a temporary name and renamed over its final one. The
API is the reference's (``save_metrics``, ``load_metrics``,
``SweepCheckpointer``); the reference's orbax format is not read."""

import os
import stat

import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu_torch.ops.metrics import Metrics
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.models import get_strategy
from distributed_backtesting_exploration_tpu_torch.utils import (
    checkpoint, data)


def _metrics(seed=0, shape=(3, 5)):
    rng = np.random.default_rng(seed)
    fields = [rng.normal(size=shape).astype(np.float32)
              for _ in Metrics._fields]
    fields[0][0, 0] = np.nan                 # NaN, +-inf and -0 survive too
    fields[1][0, 1] = np.inf
    fields[2][0, 2] = -0.0
    return Metrics(*fields)


def _bits_equal(got, want):
    for name, a, b in zip(Metrics._fields, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_round_trip_is_bit_equal_and_keeps_meta(tmp_path):
    m = _metrics()
    meta = {"strategy": "sma_crossover", "tickers": [0, 3], "cost": 1e-3}
    path = str(tmp_path / "m.npz")
    checkpoint.save_metrics(path, m, meta=meta)
    got, got_meta = checkpoint.load_metrics(path)
    _bits_equal(got, m)
    assert got_meta == meta
    checkpoint.save_metrics(path, m)           # overwrite, no meta
    assert checkpoint.load_metrics(path)[1] == {}
    assert os.listdir(tmp_path) == ["m.npz"]


def test_round_trip_of_a_sweep_on_tensors(tmp_path):
    ohlcv = data.synthetic_ohlcv(2, 64, seed=1)
    grid = sweep.product_grid(fast=np.float32([3, 5]),
                              slow=np.float32([10, 20]))
    m = sweep.run_sweep(ohlcv, get_strategy("sma_crossover"), grid,
                        device="cpu")
    path = str(tmp_path / "sweep.npz")
    checkpoint.save_metrics(path, m, meta={"P": 4})
    got, meta = checkpoint.load_metrics(path)
    _bits_equal(got, Metrics(*(f.numpy() for f in m)))
    assert meta == {"P": 4}


def test_sweep_checkpointer_resumes_through_done(tmp_path):
    root = str(tmp_path / "ckpt")
    ck = checkpoint.SweepCheckpointer(root)
    assert ck.done() == set()
    blocks = {f"{i}-{j}": _metrics(seed=10 * i + j) for i in range(2)
              for j in range(2)}
    for bid in list(blocks)[:3]:
        ck.add(bid, blocks[bid], meta={"block": bid})
    # A restart sees the finished blocks and computes only the rest.
    resumed = checkpoint.SweepCheckpointer(root)
    assert resumed.done() == set(list(blocks)[:3])
    for bid in sorted(set(blocks) - resumed.done()):
        resumed.add(bid, blocks[bid], meta={"block": bid})
    assert resumed.done() == set(blocks)
    for bid, m in blocks.items():
        got, meta = resumed.get(bid)
        _bits_equal(got, m)
        assert meta == {"block": bid}


def test_crash_mid_save_never_shows_as_a_finished_block(tmp_path,
                                                        monkeypatch):
    ck = checkpoint.SweepCheckpointer(str(tmp_path))
    first = _metrics(seed=1)
    ck.add("a", first)

    def crash(src, dst):
        raise OSError("crash before the rename")

    monkeypatch.setattr(checkpoint.os, "replace", crash)
    with pytest.raises(OSError, match="crash"):
        ck.add("b", _metrics(seed=2))
    with pytest.raises(OSError, match="crash"):
        ck.add("a", _metrics(seed=3))          # over an existing block
    monkeypatch.undo()
    assert ck.done() == {"a"}
    _bits_equal(ck.get("a")[0], first)
    # A temporary file left by a process killed mid-write is not a block.
    with open(tmp_path / ".block-c.npz.x1y2.tmp", "wb") as fh:
        fh.write(b"PK\x03\x04 torn")
    assert ck.done() == {"a"}
    ck.add("b", _metrics(seed=2))
    assert ck.done() == {"a", "b"}


def test_large_block_round_trip(tmp_path):
    # The bench's full width: (500, 2000) fields.
    m = Metrics(*(torch.randn(500, 2000, generator=torch.Generator()
                              .manual_seed(i)) for i in range(9)))
    ck = checkpoint.SweepCheckpointer(str(tmp_path))
    ck.add("full", m, meta={"tickers": 500, "combos": 2000})
    got, meta = ck.get("full")
    _bits_equal(got, Metrics(*(f.numpy() for f in m)))
    assert meta == {"tickers": 500, "combos": 2000}


def test_save_flushes_the_directory_after_the_rename(tmp_path, monkeypatch):
    """The rename itself reaches the disk: the block's directory is
    fsynced after ``os.replace``, so a block ``add`` returned from is not
    lost with the directory entry on a power loss."""
    events = []
    real_fsync, real_replace = os.fsync, os.replace

    def fsync(fd):
        kind = "dir" if stat.S_ISDIR(os.fstat(fd).st_mode) else "file"
        events.append(("fsync", kind))
        real_fsync(fd)

    def replace(src, dst):
        events.append(("replace", os.path.basename(dst)))
        real_replace(src, dst)

    monkeypatch.setattr(os, "fsync", fsync)
    monkeypatch.setattr(os, "replace", replace)
    checkpoint.SweepCheckpointer(str(tmp_path)).add("b", _metrics())
    assert events == [("fsync", "file"), ("replace", "block-b.npz"),
                      ("fsync", "dir")]
