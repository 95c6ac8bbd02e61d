"""The port's data and wire codecs are byte-identical to the reference's.

A mixed fleet of JAX and PyTorch workers shares one dispatcher: both must
decode the same DBX1 payloads and produce the same DBXM blocks, and the
protobuf copy must not drift from the reference's.
"""

import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.ops import metrics as ref_metrics
from distributed_backtesting_exploration_tpu.rpc import (
    backtesting_pb2 as ref_pb, wire as ref_wire)
from distributed_backtesting_exploration_tpu.utils import data as ref_data
from distributed_backtesting_exploration_tpu_torch.ops import metrics
from distributed_backtesting_exploration_tpu_torch.rpc import (
    backtesting_pb2 as pb, wire)
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
