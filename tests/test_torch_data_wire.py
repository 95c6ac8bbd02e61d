"""The port's data and wire codecs are byte-identical to the reference's.

A mixed fleet of JAX and PyTorch workers shares one dispatcher: both must
decode the same DBX1, CSV and Parquet payloads, content-address them with
the same digest, and produce the same DBXM, DBXS and DBXP blocks, and the
protobuf copy must not drift from the reference's.
"""

import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.ops import metrics as ref_metrics
from distributed_backtesting_exploration_tpu.rpc import (
    backtesting_pb2 as ref_pb, panel_store as ref_store, wire as ref_wire)
from distributed_backtesting_exploration_tpu.utils import data as ref_data
from distributed_backtesting_exploration_tpu_torch.ops import metrics
from distributed_backtesting_exploration_tpu_torch.rpc import (
    backtesting_pb2 as pb, panel_store, wire)
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import to_np


@pytest.mark.parametrize("n,T,seed", [(3, 64, 0), (2, 251, 5), (1, 1, 9)])
def test_synthetic_ohlcv_equal(n, T, seed):
    a = data.synthetic_ohlcv(n, T, seed=seed)
    b = ref_data.synthetic_ohlcv(n, T, seed=seed)
    for fa, fb in zip(a, b):
        assert fa.dtype == fb.dtype == np.float32
        np.testing.assert_array_equal(fa, fb)


def test_dbx1_bytes_identical_both_ways():
    panel = data.synthetic_ohlcv(2, 77, seed=3)
    for i in range(2):
        one = data.OHLCV(*(f[i] for f in panel))
        raw = data.to_wire_bytes(one)
        assert raw == ref_data.to_wire_bytes(ref_data.OHLCV(*one))
        for fa, fb in zip(data.from_wire_bytes(raw),
                          ref_data.from_wire_bytes(raw)):
            np.testing.assert_array_equal(fa, fb)
    with pytest.raises(ValueError, match="bad magic"):
        data.from_wire_bytes(b"DBX1abc")
    with pytest.raises(ValueError, match="truncated"):
        data.from_wire_bytes(raw[:-4])


def test_csv_and_pad_and_stack_match_reference():
    one = ref_data.synthetic_ohlcv(1, 20, seed=2)
    one = ref_data.OHLCV(*(f[0] for f in one))
    raw = ref_data.to_csv_bytes(one)
    for fa, fb in zip(data.from_csv_bytes(raw), ref_data.from_csv_bytes(raw)):
        np.testing.assert_array_equal(fa, fb)
    series = [data.OHLCV(*(f[0] for f in data.synthetic_ohlcv(1, T, seed=T)))
              for T in (30, 17, 45)]
    got = data.pad_and_stack(series, lane_multiple=8)
    want = ref_data.pad_and_stack(
        [ref_data.OHLCV(*s) for s in series], lane_multiple=8)
    for fa, fb in zip(got[0], want[0]):
        np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def _metric_rows(P, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(P).astype(np.float32) for _ in range(9)]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_dbxm_bytes_identical_both_ways(as_tensor):
    rows = _metric_rows(37)
    port_in = metrics.Metrics(*(torch.from_numpy(r) if as_tensor else r
                                for r in rows))
    raw = wire.metrics_to_bytes(port_in)
    assert raw == ref_wire.metrics_to_bytes(ref_metrics.Metrics(*rows))
    for fa, fb in zip(wire.metrics_from_bytes(raw),
                      ref_wire.metrics_from_bytes(raw)):
        np.testing.assert_array_equal(fa, fb)
    with pytest.raises(ValueError, match="bad magic"):
        wire.metrics_from_bytes(b"XXXX" + raw[4:])
    with pytest.raises(ValueError, match="truncated"):
        wire.metrics_from_bytes(raw[:-1])


@pytest.mark.parametrize("n,P", [(5, 37), (1, 1), (0, 4)])
def test_metrics_blocks_equal_per_row_blocks(n, P):
    planes = np.random.default_rng(n + P).standard_normal(
        (9, n, P)).astype(np.float32)
    got = wire.metrics_blocks(planes)
    assert got == [ref_wire.metrics_to_bytes(
        ref_metrics.Metrics(*planes[:, i])) for i in range(n)]
    assert wire.metrics_blocks(planes.astype(np.float64)) == got


def test_grid_helpers_match_reference():
    job = ref_pb.JobSpec(grid=ref_wire.grid_to_proto(
        {"slow": np.float32([10, 12]), "fast": np.float32([3, 4, 5])}))
    got, want = wire.grid_from_proto(job.grid), ref_wire.grid_from_proto(
        job.grid)
    assert list(got) == list(want) == ["fast", "slow"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert wire.grid_n_combos(job.grid) == ref_wire.grid_n_combos(job.grid) == 6
    assert wire.grid_n_combos(ref_pb.JobSpec().grid) == 1


@pytest.mark.parametrize("name", ["backtesting.proto", "backtesting_pb2.py"])
def test_proto_copy_is_byte_identical(name):
    import pathlib

    port = pathlib.Path(pb.__file__).with_name(name).read_bytes()
    ref = pathlib.Path(ref_pb.__file__).with_name(name).read_bytes()
    assert port == ref


def test_pb2_copies_interoperate():
    spec = ref_pb.JobSpec(id="j", strategy="sma_crossover", cost=1e-3,
                          grid=ref_wire.grid_to_proto({"fast": [3.0]}))
    back = pb.JobSpec.FromString(spec.SerializeToString())
    assert back.id == "j" and back.grid["fast"].values == [3.0]
    assert back.SerializeToString() == spec.SerializeToString()


def test_metric_sign_and_fields_match_reference():
    assert metrics.Metrics._fields == ref_metrics.Metrics._fields
    for name in metrics.Metrics._fields:
        assert metrics.metric_sign(name) == ref_metrics.metric_sign(name)
    with pytest.raises(KeyError):
        metrics.metric_sign("alpha")


def test_metrics_from_reductions_matches_reference():
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    P = 50
    kw = dict(s1=rng.normal(0, 0.1, P), s2=rng.uniform(0.01, 0.2, P),
              downside_sq_sum=rng.uniform(0, 0.1, P),
              mdd=rng.uniform(0, 0.5, P), eq_final=rng.uniform(0.5, 2, P),
              wins_sum=rng.integers(0, 100, P).astype(float),
              active_sum=rng.integers(100, 200, P).astype(float),
              turnover=rng.integers(0, 40, P).astype(float))
    kw = {k: v.astype(np.float32) for k, v in kw.items()}
    got = metrics.metrics_from_reductions(
        **{k: torch.from_numpy(v) for k, v in kw.items()}, n=200,
        periods_per_year=252)
    want = ref_metrics.metrics_from_reductions(
        **{k: jnp.asarray(v) for k, v in kw.items()}, n=200,
        periods_per_year=252)
    for name in want._fields:
        np.testing.assert_allclose(to_np(getattr(got, name)),
                                   to_np(getattr(want, name)),
                                   rtol=2e-6, atol=1e-7, err_msg=name)


def _one(T, seed):
    return data.OHLCV(*(f[0] for f in data.synthetic_ohlcv(1, T, seed=seed)))


@pytest.mark.parametrize("T,seed", [(20, 2), (1, 4), (251, 6)])
def test_csv_bytes_identical(T, seed):
    one = _one(T, seed)
    raw = data.to_csv_bytes(one)
    assert raw == ref_data.to_csv_bytes(ref_data.OHLCV(*one))
    for fa, fb in zip(data.from_csv_bytes(raw), one):
        np.testing.assert_array_equal(fa, fb)
    with pytest.raises(ValueError, match="single ticker"):
        data.to_csv_bytes(data.synthetic_ohlcv(2, 5))


@pytest.mark.parametrize("T,seed", [(20, 2), (251, 6)])
def test_parquet_bytes_identical_both_ways(T, seed):
    one = _one(T, seed)
    raw = data.to_parquet_bytes(one)
    assert raw == ref_data.to_parquet_bytes(ref_data.OHLCV(*one))
    for fa, fb in zip(data.from_parquet_bytes(raw),
                      ref_data.from_parquet_bytes(raw)):
        assert fa.dtype == fb.dtype == np.float32
        np.testing.assert_array_equal(fa, fb)
    with pytest.raises(ValueError, match="Parquet"):
        data.from_parquet_bytes(b"not parquet")


def test_codec_modules_import_without_pyarrow_and_grpc():
    import subprocess
    import sys

    code = ("import sys\n"
            "sys.modules['pyarrow'] = None\n"
            "sys.modules['grpc'] = None\n"
            "from distributed_backtesting_exploration_tpu_torch.utils "
            "import data\n"
            "from distributed_backtesting_exploration_tpu_torch.rpc import "
            "compute, executor, panel_store, wire\n"
            "one = data.OHLCV(*(f[0] for f in data.synthetic_ohlcv(1, 4)))\n"
            "try:\n"
            "    data.from_parquet_bytes(b'x')\n"
            "except ValueError as e:\n"
            "    assert 'pyarrow is required' in str(e)\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_splice_wire_bytes_identical():
    base, delta = _one(30, 7), _one(5, 8)
    got = data.splice_wire_bytes(data.to_wire_bytes(base),
                                 data.to_wire_bytes(delta))
    want = ref_data.splice_wire_bytes(
        ref_data.to_wire_bytes(ref_data.OHLCV(*base)),
        ref_data.to_wire_bytes(ref_data.OHLCV(*delta)))
    assert got == want
    assert data.from_wire_bytes(got).n_bars == 35
    empty = data.to_wire_bytes(data.OHLCV(*(f[:0] for f in delta)))
    with pytest.raises(ValueError, match="empty delta"):
        data.splice_wire_bytes(data.to_wire_bytes(base), empty)


@pytest.mark.parametrize("T,seed", [(64, 0), (1260, 3)])
def test_panel_digest_matches_reference(T, seed):
    raw = data.to_wire_bytes(_one(T, seed))
    d = panel_store.panel_digest(raw)
    assert d == ref_store.panel_digest(raw) and len(d) == 32
    assert panel_store.panel_digest(raw + b"x") != d


def test_byte_lru_evicts_by_bytes():
    lru = panel_store.ByteLRU(10)
    lru.put("a", b"xxxx")
    lru.put("b", b"yyyy")
    assert lru.get("a") == b"xxxx"            # "a" is now the most recent
    lru.put("c", b"zzz")                      # 11 bytes: "b" goes first
    assert "b" not in lru and "a" in lru and "c" in lru
    assert lru.bytes == 7 and lru.evictions == 1
    lru.put("d", b"w" * 20)                   # larger than the bound
    assert len(lru) == 0 and lru.bytes == 0 and lru.evictions == 4
    lru.put("e", object(), nbytes=3)
    lru.put("e", object(), nbytes=2)          # a refresh recharges the key
    assert len(lru) == 1 and lru.bytes == 2


def _topk_block(k, seed):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(50)[:k].astype(np.int64)
    return idx, [rng.standard_normal(k).astype(np.float32) for _ in range(9)]


@pytest.mark.parametrize("k,name", [(4, "sharpe"), (1, "max_drawdown"),
                                    (0, "turnover")])
def test_dbxs_bytes_identical_both_ways(k, name):
    idx, rows = _topk_block(k, k)
    raw = wire.topk_to_bytes(torch.from_numpy(idx),
                             metrics.Metrics(*rows), name)
    assert raw == ref_wire.topk_to_bytes(idx, ref_metrics.Metrics(*rows),
                                         name)
    gi, gm, gname = wire.topk_from_bytes(raw)
    ri, rm, rname = ref_wire.topk_from_bytes(raw)
    assert gname == rname == name
    np.testing.assert_array_equal(gi, ri)
    for fa, fb in zip(gm, rm):
        np.testing.assert_array_equal(fa, fb)
    assert wire.result_kind(raw) == "topk"
    with pytest.raises(ValueError, match="bad magic"):
        wire.topk_from_bytes(b"DBXM" + raw[4:])
    with pytest.raises(ValueError, match="truncated"):
        wire.topk_from_bytes(raw[:12])
    if k:
        with pytest.raises(ValueError, match="truncated"):
            wire.topk_from_bytes(raw[:-1])


@pytest.mark.parametrize("T,grid_idx", [(96, 7), (1, 0)])
def test_dbxp_bytes_identical_both_ways(T, grid_idx):
    rng = np.random.default_rng(T)
    row = [np.float32([v]) for v in rng.standard_normal(9)]
    ret = rng.standard_normal(T).astype(np.float32)
    raw = wire.best_returns_to_bytes(grid_idx, metrics.Metrics(*row),
                                     torch.from_numpy(ret), "sortino")
    assert raw == ref_wire.best_returns_to_bytes(
        grid_idx, ref_metrics.Metrics(*row), ret, "sortino")
    g = wire.best_returns_from_bytes(raw)
    r = ref_wire.best_returns_from_bytes(raw)
    assert g[0] == r[0] == grid_idx and g[3] == r[3] == "sortino"
    np.testing.assert_array_equal(g[2], r[2])
    np.testing.assert_array_equal(np.float32(list(g[1])),
                                  np.float32(list(r[1])))
    assert wire.result_kind(raw) == "returns"
    with pytest.raises(ValueError, match="bad magic"):
        wire.best_returns_from_bytes(b"DBXS" + raw[4:])
    with pytest.raises(ValueError, match="truncated"):
        wire.best_returns_from_bytes(raw[:-1])


def test_result_kind_matches_reference():
    blocks = [b"", wire.metrics_to_bytes(metrics.Metrics(
        *_metric_rows(3))), b"DBXS", b"DBXP"]
    for b in blocks:
        assert wire.result_kind(b) == ref_wire.result_kind(b)
    for bad in (b"XXXX", b"DBX1"):
        with pytest.raises(ValueError, match="unknown result block"):
            wire.result_kind(bad)


def test_grid_to_proto_round_trips_and_matches_reference():
    axes = {"slow": np.float32([10, 12]), "fast": [3.0, 4.0, 5.5],
            "k": torch.tensor([0.5, 1.0])}
    got = pb.JobSpec(grid=wire.grid_to_proto(axes))
    want = ref_pb.JobSpec(grid=ref_wire.grid_to_proto(
        {k: np.asarray(v) for k, v in axes.items()}))
    assert got.SerializeToString(deterministic=True) == \
        want.SerializeToString(deterministic=True)
    back = wire.grid_from_proto(got.grid)
    assert list(back) == ["fast", "k", "slow"]
    for k, v in axes.items():
        np.testing.assert_array_equal(back[k], np.asarray(v, np.float32))
