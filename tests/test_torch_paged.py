"""Paged mode of the port against the reference: the page pool, the paged
sweep and the backend's paged route (reference ``tests/test_paged.py``).

- ``page_key``/``paginate`` give the reference's bytes and keys;
- ``fused_paged_sweep`` is bit-equal to the port's dense wrapper on each
  page-count bin (uniform and ragged groups, all 13 families) and within
  ``torch_parity``'s rule of the reference's paged sweep (interpret mode)
  on the same pool contents;
- the pool shares pages along an append chain and across overlapping
  histories, stays in its bounds, evicts and rejects as the reference's;
- the backend groups mixed lengths of jobs with digests into one group and
  matches ``JaxSweepBackend``'s blocks; a rejected group falls back to the
  dense stacks, split again by length bucket, and is counted;
- a writer that holds the pool's lock from ``prepare`` to its gather reads
  its own pages while another thread evicts them.

Tiny shapes on the CPU, a page of 16 bars.
"""

import math
import threading

import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu import obs as ref_obs
from distributed_backtesting_exploration_tpu.models import (
    donchian as ref_donchian, stochastic as ref_stochastic)
from distributed_backtesting_exploration_tpu.ops import fused as ref_fused
from distributed_backtesting_exploration_tpu.rpc import (
    backtesting_pb2 as ref_pb, compute as ref_compute, page_pool as ref_pool)
from distributed_backtesting_exploration_tpu.rpc.dispatcher import parse_grid
from distributed_backtesting_exploration_tpu_torch.ops import fused
from distributed_backtesting_exploration_tpu_torch.ops.metrics import Metrics
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.rpc import (
    compute, page_pool, panel_store, wire)
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import assert_metrics_match

B = 16   # the tests' page size: small panels span several pages

# Two values an axis: windows small and integral, MACD/TRIX fast < slow.
AXIS_VALUES = {"fast": [2.0, 3.0], "slow": [8.0, 13.0], "window": [3.0, 5.0],
               "k": [0.5, 1.0], "lookback": [2.0, 4.0],
               "period": [3.0, 5.0], "band": [10.0, 20.0],
               "signal": [2.0, 3.0], "span": [2.0, 3.0]}
SMA_AXES = {"fast": np.float32([2.0, 3.0]), "slow": np.float32([8.0, 13.0])}


def _grid(strategy):
    axes = fused._PAGED_FAMILIES[strategy].axes
    return {k: v.numpy() for k, v in sweep.product_grid(
        **{a: np.float32(AXIS_VALUES[a]) for a in axes}).items()}


def _series(t: int, seed: int, cut: int | None = None) -> data.OHLCV:
    panel = data.synthetic_ohlcv(1, t, seed=seed)
    return data.OHLCV(*(np.asarray(f)[0, :cut or t] for f in panel))


def _pool(series, fields, **kw):
    pool = page_pool.PagePool(device="cpu", page_bars=B, **kw)
    prep = pool.prepare([f"d{i}" for i in range(len(series))], series,
                        fields)
    assert prep is not None
    return pool, prep


def _dense(strategy, series, idx, grid):
    """The port's dense wrapper on rows ``idx``, repeat-last stacked to
    their longest (``t_real`` where ragged)."""
    fam = fused._PAGED_FAMILIES[strategy]
    fields, call = fam.fields, fam.call
    lens = [series[i].n_bars for i in idx]
    arrays = [compute._stack_field_ragged([series[i] for i in idx],
                                          max(lens), f) for f in fields]
    t_real = None if len(set(lens)) == 1 else np.int32(lens)
    return call(arrays, grid, t_real=t_real, cost=1e-3, device="cpu")


def _rows(m: Metrics, idx) -> Metrics:
    return Metrics(*(f[idx] for f in m))


def _assert_bit_equal(got: Metrics, want: Metrics, what: str):
    for name, a, b in zip(Metrics._fields, got, want):
        assert torch.equal(a, b), (what, name)


def test_page_key_and_paginate_match_the_reference():
    rng = np.random.default_rng(3)
    for n in (1, B - 1, B, B + 3, 5 * B):
        v = rng.standard_normal(n).astype(np.float32)
        got, want = page_pool.paginate(v, B), ref_pool.paginate(v, B)
        assert len(got) == len(want) == -(-n // B)
        for a, b in zip(got, want):
            assert a.tobytes() == b.tobytes()
            assert page_pool.page_key(a.tobytes()) == ref_pool.page_key(
                b.tobytes())
        assert (got[-1][(n - 1) % B:] == v[-1]).all()
    # A full-page prefix of a longer series hashes alike (the sharing the
    # append-chain test drives end to end).
    w = np.arange(2 * B, dtype=np.float32)
    assert page_pool.page_key(page_pool.paginate(w, B)[0].tobytes()) == \
        page_pool.page_key(page_pool.paginate(w[:B + 3], B)[0].tobytes())


@pytest.mark.parametrize("strategy", sorted(fused._PAGED_FAMILIES))
def test_paged_sweep_all_families(strategy):
    fields = fused._PAGED_FAMILIES[strategy].fields
    grid = _grid(strategy)
    # Three bins (4, 3 and 2 pages): ragged within the first.
    lens = [52, 41, 50, 23]
    series = [_series(52, 40 + i, t) for i, t in enumerate(lens)]
    _, (pool, tables, _) = _pool(series, fields)
    got = fused.fused_paged_sweep(strategy, pool, tables, lens, grid,
                                  cost=1e-3)
    for idx in ([0, 2], [1], [3]):
        _assert_bit_equal(_rows(got, idx),
                          _dense(strategy, series, idx, grid),
                          f"{strategy} bin {idx}")
    # A uniform group is one bin and the wrapper's static-length call.
    uni = [_series(40, 60 + i) for i in range(3)]
    _, (pool_u, tables_u, _) = _pool(uni, fields)
    _assert_bit_equal(fused.fused_paged_sweep(strategy, pool_u, tables_u,
                                              [40] * 3, grid, cost=1e-3),
                      _dense(strategy, uni, [0, 1, 2], grid),
                      f"{strategy} uniform")
    # Against the reference's paged sweep (interpret mode) on one ragged
    # bin of the same pool contents.
    pair = [series[0], series[2]]
    _, (pool_p, tables_p, _) = _pool(pair, fields)
    mine = fused.fused_paged_sweep(strategy, pool_p, tables_p, [52, 50],
                                   grid, cost=1e-3)
    rpool = ref_pool.PagePool(page_bars=B, registry=ref_obs.Registry())
    rpool_arr, rtables, _ = rpool.prepare(["a", "b"], pair, fields)
    ref = ref_fused.fused_paged_sweep(strategy, rpool_arr, rtables,
                                      [52, 50], grid, cost=1e-3,
                                      interpret=True)
    assert_metrics_match(mine, ref)


def test_paged_ragged_repeat_last_contract():
    # Against each job's own unpadded sweep: pad bars earn zero and hold
    # the last position, within f32 association.
    lens = [52, 37, 29]
    series = [_series(52, 30 + i, t) for i, t in enumerate(lens)]
    _, (pool, tables, _) = _pool(series, ("close",))
    for strategy in ("sma_crossover", "bollinger"):
        grid = _grid(strategy)
        paged = fused.fused_paged_sweep(strategy, pool, tables, lens, grid,
                                        cost=1e-3)
        for i in range(len(series)):
            solo = _dense(strategy, series, [i], grid)
            for name, a, b in zip(Metrics._fields, _rows(paged, [i]), solo):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                           atol=2e-6,
                                           err_msg=f"{strategy}:{name}:{i}")


def test_paged_gather_repeats_the_last_real_bar():
    pool = torch.arange(4 * B, dtype=torch.float32).reshape(4, B)
    table = torch.tensor([[2, 0], [1, 3]])
    out = fused._paged_gather(pool, table, torch.tensor([B + 2, 5]), B + 4)
    np.testing.assert_array_equal(out[0, :B + 2].numpy(),
                                  np.r_[32:48, 0:2].astype(np.float32))
    assert (out[0, B + 2:] == 1.0).all()
    assert (out[1, :5] == torch.arange(16, 21)).all()
    assert (out[1, 5:] == 20.0).all()


def test_append_chain_shares_base_pages():
    t_base, dt = 7 * B + 5, 9
    full = _series(t_base + dt, seed=7)
    base = data.OHLCV(*(f[:t_base] for f in full))
    pool = page_pool.PagePool(device="cpu", page_bars=B)
    assert pool.prepare(["base"], [base], ("close",)) is not None
    st0 = pool.stats()
    assert st0["pages"] == -(-t_base // B)
    prep = pool.prepare(["ext"], [full], ("close",))
    assert prep is not None
    added = pool.stats()["pages"] - st0["pages"]
    assert 0 < added <= -(-dt // B) + 1
    assert prep[2]["pages_new"] == added
    assert pool.stats()["bytes"] - st0["bytes"] == added * B * 4
    pool_arr, tables, _ = prep
    _assert_bit_equal(
        fused.fused_paged_sweep("sma_crossover", pool_arr, tables,
                                [t_base + dt], _grid("sma_crossover"),
                                cost=1e-3),
        _dense("sma_crossover", [full], [0], _grid("sma_crossover")),
        "append chain")


def test_overlapping_histories_share_pages_across_digests():
    s = _series(6 * B, seed=9)
    a = data.OHLCV(*(f[:5 * B] for f in s))
    pool = page_pool.PagePool(device="cpu", page_bars=B)
    assert pool.prepare(["da"], [a], ("close",)) is not None
    before = pool.stats()
    assert pool.prepare(["db"], [s], ("close",)) is not None
    after = pool.stats()
    assert after["pages"] - before["pages"] == 1     # only the new tail
    assert after["hits"]["close"] == 5 and after["misses"]["close"] == 6


def test_pool_bounds_eviction_and_reject():
    pool = page_pool.PagePool(device="cpu", page_bars=B, max_bytes=4 * B * 4)
    assert pool.capacity == 4
    assert pool.prepare(["d1"], [_series(3 * B, 1)], ("close",)) is not None
    assert pool.stats()["pages"] == 3
    # A second 3-page panel fits by evicting the first's least recent.
    prep = pool.prepare(["d2"], [_series(3 * B, 2)], ("close",))
    assert prep is not None
    st = pool.stats()
    assert st["pages"] == 4 and st["bytes"] <= pool.max_bytes
    assert st["alloc_slots"] <= st["capacity_slots"] == 4
    pool_arr, tables, _ = prep
    np.testing.assert_array_equal(
        fused._paged_gather(pool_arr, torch.from_numpy(
            tables["close"].astype(np.int64)), torch.tensor([3 * B]),
            3 * B).numpy()[0], _series(3 * B, 2).close)
    # A group larger than the whole pool is rejected, not thrashed.
    assert pool.prepare(["d3"], [_series(6 * B, 3)], ("close",)) is None
    assert pool.stats()["rejects"] == 1


def test_pool_counts_and_growth():
    pool = page_pool.PagePool(device="cpu", page_bars=B)
    s = _series(2 * B + 3, seed=4)
    _, _, info = pool.prepare(["d"], [s], ("close", "volume"))
    assert info == {"pages_new": 6, "pad_bars_new": 2 * (B - 3)}
    _, _, info = pool.prepare(["d"], [s], ("close", "volume"))
    assert info == {"pages_new": 0, "pad_bars_new": 0}
    st = pool.stats()
    assert st["misses"]["close"] == st["hits"]["close"] == 3
    assert st["pages"] == 6 and st["bytes"] == 6 * B * 4
    assert st["alloc_slots"] == 8 and st["pad_bars_new"] == 2 * (B - 3)
    # The tensor grows geometrically past the floor of 8 slots.
    pool.prepare(["e"], [_series(9 * B, seed=5)], ("close",))
    assert pool.stats()["alloc_slots"] == 16


def test_kill_switch_and_knob_messages(monkeypatch):
    # The port's paged route is off unless DBX_PAGED=1 (on the H100 it was
    # slower than the dense stacks); the reference's is on by default.
    monkeypatch.delenv("DBX_PAGED", raising=False)
    assert not fused.paged_enabled()
    assert not compute.TorchSweepBackend(device="cpu").use_paged
    monkeypatch.setenv("DBX_PAGED", "0")
    assert not fused.paged_enabled()
    assert not compute.TorchSweepBackend(device="cpu").use_paged
    monkeypatch.setenv("DBX_PAGED", "1")
    assert fused.paged_enabled()
    assert compute.TorchSweepBackend(device="cpu").use_paged
    for bad in ("x", "-8", "12", "4"):
        monkeypatch.setenv("DBX_PAGE_BARS", bad)
        with pytest.raises(ValueError) as mine:
            fused.resolve_page_bars()
        with pytest.raises(ValueError) as ref:
            ref_fused.resolve_page_bars()
        assert str(mine.value) == str(ref.value)
    monkeypatch.setenv("DBX_PAGE_BARS", "64")
    assert fused.resolve_page_bars() == 64
    assert page_pool.PagePool(device="cpu").page_bars == 64
    monkeypatch.setenv("DBX_PAGE_POOL_MB", "0.5")
    assert page_pool.pool_max_bytes() == 512 * 1024
    monkeypatch.delenv("DBX_PAGE_BARS")
    monkeypatch.delenv("DBX_PAGE_POOL_MB")
    assert fused.resolve_page_bars() == 512
    assert page_pool.pool_max_bytes() == 64 * 1024 * 1024


def test_registry_fields_match_the_reference():
    # One registry: the backend's routing rows are built from
    # fused._PAGED_FAMILIES, and both agree with the reference's two.
    assert set(fused._PAGED_FAMILIES) == set(ref_fused._PAGED_FAMILIES)
    assert set(compute._FUSED_STRATEGIES) == set(fused._PAGED_FAMILIES)
    for strategy, fam in fused._PAGED_FAMILIES.items():
        ref_fields, ref_axes, _ = ref_fused._PAGED_FAMILIES[strategy]
        assert (fam.fields, fam.axes) == (ref_fields, ref_axes), strategy
        spec = compute._FUSED_STRATEGIES[strategy]
        ref_spec = ref_compute.JaxSweepBackend._FUSED_STRATEGIES[strategy]
        assert spec.fields == ref_spec.fields == fused.paged_fields(strategy)
        assert spec.axes == ref_spec.axes == frozenset(fam.axes)
        assert set(spec.window_axes) == set(ref_spec.window_axes) == set(
            fam.window_axes), strategy
        ref_max = {"stochastic": ref_stochastic.MAX_WINDOW,
                   "donchian": ref_donchian.MAX_WINDOW,
                   "donchian_hl": ref_donchian.MAX_WINDOW}.get(strategy,
                                                                math.inf)
        assert spec.max_window == fam.max_window == ref_max, strategy


def _specs(series_list, axes, strategy="sma_crossover", digests=True):
    out = []
    for i, s in enumerate(series_list):
        raw = data.to_wire_bytes(s)
        out.append(ref_pb.JobSpec(
            id=f"j{i}", strategy=strategy, ohlcv=raw,
            panel_digest=panel_store.panel_digest(raw) if digests else "",
            panel_bytes_len=len(raw), grid=wire.grid_to_proto(axes),
            cost=1e-3, periods_per_year=252, trace_id=f"t{i}"))
    return out


def _blocks(completions, n):
    by_id = {c.job_id: wire.metrics_from_bytes(c.metrics)
             for c in completions}
    return Metrics(*(np.stack([getattr(by_id[f"j{i}"], f)
                               for i in range(n)]) for f in Metrics._fields))


def _paged_env(monkeypatch, pool_mb: float = 4.0):
    monkeypatch.setenv("DBX_PAGED", "1")
    monkeypatch.setenv("DBX_PAGE_BARS", str(B))
    monkeypatch.setenv("DBX_PAGE_POOL_MB", str(pool_mb))


@pytest.mark.parametrize("strategy", ["sma_crossover", "keltner"])
def test_backend_mixed_lengths_fuse_into_one_group(strategy, monkeypatch):
    _paged_env(monkeypatch)
    axes = parse_grid("fast=2:4,slow=8:14:5" if strategy == "sma_crossover"
                      else "window=3:6:2,k=1:3")
    lens = (64, 41, 52, 64, 200)
    series = [_series(200, 50 + i, t) for i, t in enumerate(lens)]
    specs = _specs(series, axes, strategy)
    backend = compute.TorchSweepBackend(device="cpu")
    assert backend.use_paged
    assert {backend._length_bucket(j, axes) for j in specs} == {0}
    pend = backend.submit(specs)
    assert len(pend) == 1                        # one group, five lengths
    got = _blocks(backend.collect(pend), len(lens))
    want = _blocks(ref_compute.JaxSweepBackend(use_fused=True).process(
        specs), len(lens))
    assert_metrics_match(got, want)
    st = backend.stats()
    pool = st["panel_cache"]["page_pool"]
    assert pool["pages"] > 0 and sum(pool["misses"].values()) > 0
    assert st["pad_bars"]["paged"] > 0 and st["pad_bars"]["dense"] == 0
    # A warm resubmit hits every page and uploads none; the same bytes.
    misses = dict(pool["misses"])
    again = backend.process(specs)
    pool = backend.stats()["panel_cache"]["page_pool"]
    assert pool["misses"] == misses and sum(pool["hits"].values()) > 0
    for a, b in zip(_blocks(again, len(lens)), got):
        np.testing.assert_array_equal(a, b)


def test_backend_grouping_unchanged_where_paging_does_not_serve(monkeypatch):
    axes = {"fast": np.float32([2.0]), "slow": np.float32([8.0])}
    job = ref_pb.JobSpec(strategy="sma_crossover", panel_digest="d" * 32,
                         panel_bytes_len=1000)
    monkeypatch.setenv("DBX_PAGED", "0")
    off = compute.TorchSweepBackend(device="cpu")
    assert off._length_bucket(job, axes) == (1000).bit_length()
    monkeypatch.setenv("DBX_PAGED", "1")
    on = compute.TorchSweepBackend(device="cpu")
    assert on._length_bucket(job, axes) == 0
    keep = [
        ref_pb.JobSpec(strategy="sma_crossover", wf_train=10,
                       panel_digest="d" * 32, panel_bytes_len=1000),
        ref_pb.JobSpec(strategy="sma_crossover", best_returns=True,
                       panel_digest="d" * 32, panel_bytes_len=1000),
        ref_pb.JobSpec(strategy="sma_crossover", panel_bytes_len=1000),
        ref_pb.JobSpec(strategy="pairs", panel_digest="d" * 32,
                       panel_bytes_len=1000),
    ]
    for j in keep:
        assert on._length_bucket(j, axes) == (1000).bit_length(), j
    assert on._length_bucket(job, {"fast": np.float32([2.5]),
                                   "slow": np.float32([8.0])}) == 10


def test_backend_pool_reject_falls_back_and_resplits(monkeypatch, caplog):
    # A pool of one slot rejects every group: the merged mixed-length
    # group is served from the dense stacks, split again by the power-of-
    # two length bucket (no pad across buckets), logged and counted.
    _paged_env(monkeypatch, pool_mb=B * 4 / (1024 * 1024))
    lens = (256, 48, 250)
    series = [_series(256, 80 + i, t) for i, t in enumerate(lens)]
    axes = {"fast": np.float32([2.0]), "slow": np.float32([8.0])}
    specs = _specs(series, axes)
    backend = compute.TorchSweepBackend(device="cpu")
    with caplog.at_level("WARNING", logger="dbx.torch.compute"):
        pend = backend.submit(specs)
    assert len(pend) == 2
    assert "page pool rejected" in caplog.text
    st = backend.stats()
    assert st["paged_fallbacks"] == {"rejected": 1, "disabled": 0}
    assert st["panel_cache"]["page_pool"]["rejects"] == 1
    assert st["pad_bars"] == {"dense": 6, "paged": 0}
    got = _blocks(backend.collect(pend), 3)
    monkeypatch.setenv("DBX_PAGED", "0")
    dense = compute.TorchSweepBackend(device="cpu")
    want = _blocks(dense.process(specs), 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert dense.stats()["paged_fallbacks"] == {"rejected": 0,
                                                "disabled": 2}


def test_prefetch_uploads_the_pages_submit_gathers(monkeypatch):
    _paged_env(monkeypatch)
    series = [_series(40, 70 + i, t) for i, t in enumerate((40, 33))]
    specs = _specs(series, SMA_AXES)
    backend = compute.TorchSweepBackend(device="cpu")
    assert backend.prefetch(specs) == 2
    pool = backend.panel_cache.pages.stats()
    assert pool["pages"] == 3 + 3 and pool["misses"]["close"] == 6
    backend.process([_specs(series, SMA_AXES)[i] for i in (0, 1)])
    pool = backend.panel_cache.pages.stats()
    assert pool["misses"]["close"] == 6 and pool["hits"]["close"] == 6


def test_two_writers_gather_their_own_pages():
    # The compute thread holds the pool's writer lock from prepare until
    # its gathers are taken; a prefetch thread meanwhile prepares groups
    # that evict the first group's pages (the pool holds one group).
    pool = page_pool.PagePool(device="cpu", page_bars=B, max_bytes=4 * B * 4)
    mine = [_series(2 * B, 100), _series(2 * B, 101)]
    theirs = [[_series(2 * B, 200 + 2 * k), _series(2 * B, 201 + 2 * k)]
              for k in range(8)]
    want = torch.from_numpy(np.stack([s.close for s in mine]))
    bad, stop = [], threading.Event()

    def prefetcher():
        k = 0
        while not stop.is_set():
            assert pool.prepare([f"p{k % 8}a", f"p{k % 8}b"],
                                theirs[k % 8], ("close",)) is not None
            k += 1

    t = threading.Thread(target=prefetcher)
    t.start()
    try:
        for _ in range(200):
            with pool.lock:
                pool_arr, tables, _ = pool.prepare(["m0", "m1"], mine,
                                                   ("close",))
                got = fused._paged_gather(
                    pool_arr, torch.from_numpy(
                        tables["close"].astype(np.int64)),
                    torch.tensor([2 * B, 2 * B]), 2 * B).clone()
            if not torch.equal(got, want):
                bad.append(got)
    finally:
        stop.set()
        t.join()
    assert not bad and pool.stats()["pages"] <= 4
