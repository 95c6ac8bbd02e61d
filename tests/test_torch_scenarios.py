"""Scenario batches of the port against the reference: the threefry
primitives, the seed derivation, the generator and the spec-batch route
(reference ``tests/test_scenario_fused.py``).

- ``prng_key``, ``fold_in``, ``split``, ``random_bits``, ``randint`` and
  ``uniform`` are bit-exact against ``jax.random`` over seeds hypothesis
  picks; ``normal`` (XLA's ``erf_inv``, another ``log1p``) at rtol=1e-6;
- ``scenario_seed``, ``seed_words`` and ``seed_to_int64`` equal the
  reference's;
- ``generate`` against ``synth.generate``: the draws (block keys, starts,
  regime path, shock hits) exact, the panels at rtol=1e-5 (``log``,
  ``exp`` and the sums round otherwise in XLA and torch), the bar
  invariants held;
- a carrier job through ``process`` completes its K specs under their ids
  on the fused route, bit-equal on the CPU to the materialized rung it
  takes under ``DBX_SCENARIO_FUSED=0`` (counted), within the flip rule of
  ``JaxSweepBackend``'s fused route; a failure of the fused sweep is not
  hidden behind the materialized rung;
- the worker declares the capability, and a JAX ``Dispatcher`` over gRPC
  coalesces K scenario records into one carrier that the torch worker
  drains with nothing failed or re-queued.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from distributed_backtesting_exploration_tpu import scenarios as ref_scn
from distributed_backtesting_exploration_tpu.rpc import (
    backtesting_pb2 as ref_pb, compute as ref_compute, wire as ref_wire)
from distributed_backtesting_exploration_tpu.rpc.dispatcher import (
    Dispatcher, DispatcherServer, JobQueue, JobRecord, PeerRegistry,
    parse_grid, scenario_jobs)
from distributed_backtesting_exploration_tpu.utils import data as ref_data
from distributed_backtesting_exploration_tpu_torch.ops import fused
from distributed_backtesting_exploration_tpu_torch.ops.metrics import Metrics
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.rpc import (
    compute, panel_store, wire)
from distributed_backtesting_exploration_tpu_torch.rpc.worker import Worker
from distributed_backtesting_exploration_tpu_torch.scenarios import (
    synth, threefry)
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import assert_metrics_match

GRID = parse_grid("fast=3:5,slow=10:14:2")
PARAMS = {"n_bars": 64, "block": 8, "regimes": 2, "vol_scale": 1.5,
          "shock": 0.01}
# A small grid of each family.
GRIDS = {
    "sma_crossover": GRID,
    "bollinger": parse_grid("window=10:20:5,k=1:3"),
    "bollinger_touch": parse_grid("window=8:16:4,k=1:3"),
    "stochastic": parse_grid("window=10:14:2,band=20:40:10"),
    "momentum": parse_grid("lookback=5:21:8"),
    "donchian": parse_grid("window=10:30:10"),
    "donchian_hl": parse_grid("window=8:24:8"),
    "rsi": parse_grid("period=7:21:7,band=15:30:10"),
    "keltner": parse_grid("window=10:20:5,k=1:3"),
    "macd": parse_grid("fast=5:13:4,slow=20:40:10,signal=5:13:4"),
    "trix": parse_grid("span=5:13:4,signal=4:14:5"),
    "obv_trend": parse_grid("window=6:30:8"),
    "vwap_reversion": parse_grid("window=8:20:6,k=1:3"),
}


def _u32(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(-2**31, 2**31 - 1), data_=st.integers(0, 2**32 - 1),
       span=st.integers(1, 2**31 - 1))
def test_threefry_primitives_match_jax(seed, data_, span):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), data_)
    kt = threefry.fold_in(threefry.prng_key(seed), data_)
    np.testing.assert_array_equal(kt.numpy(), _u32(kj))
    np.testing.assert_array_equal(threefry.split(kt, 5).numpy(),
                                  _u32(jax.random.split(kj, 5)))
    np.testing.assert_array_equal(threefry.random_bits(kt, (3, 5)).numpy(),
                                  _u32(jax.random.bits(kj, (3, 5))))
    np.testing.assert_array_equal(threefry.uniform(kt, (64,)).numpy(),
                                  np.asarray(jax.random.uniform(kj, (64,))))
    for lo, hi in ((0, span), (-7, 3), (5, 5)):
        np.testing.assert_array_equal(
            threefry.randint(kt, (16,), lo, hi).numpy(),
            np.asarray(jax.random.randint(kj, (16,), lo, hi)))
    assert int(threefry.randint(kt, (), 0, span)) == int(
        jax.random.randint(kj, (), 0, span))
    np.testing.assert_allclose(threefry.normal(kt, (256,)).numpy(),
                               np.asarray(jax.random.normal(kj, (256,))),
                               rtol=1e-6, atol=0)


def test_batched_keys_draw_as_single_keys():
    keys = threefry.fold_in(threefry.prng_key(torch.tensor([3, 9])),
                            torch.tensor([7, 1]))
    u = threefry.uniform(keys, (4,))
    for i, (s, d) in enumerate(((3, 7), (9, 1))):
        kj = jax.random.fold_in(jax.random.PRNGKey(s), d)
        np.testing.assert_array_equal(u[i].numpy(), np.asarray(
            jax.random.uniform(kj, (4,))))


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999])
    got = threefry.erf_inv(x).numpy()
    assert got[0] == -np.inf and got[1] == np.inf and got[2] == 0.0
    np.testing.assert_allclose(got[3:], np.asarray(
        jax.lax.erf_inv(jnp.asarray(x.numpy()[3:]))), rtol=1e-6)


def test_seed_derivation_matches_the_reference():
    base_d = "ab" * 16
    for p in (synth.ScenarioParams(),
              synth.ScenarioParams(**PARAMS, seed=5),
              synth.ScenarioParams(n_bars=100, block=3, regimes=4,
                                   vol_scale=0.5, shock=0.3, seed=2**40)):
        rp = ref_scn.ScenarioParams(**p.to_dict())
        assert p.canonical() == rp.canonical()
        assert synth.ScenarioParams.from_dict(
            {**p.to_dict(), "base": base_d}) == p
        eff = synth.scenario_seed(base_d, p)
        assert eff == ref_scn.scenario_seed(base_d, rp)
        assert synth.seed_words(eff) == ref_scn.seed_words(eff)
    for s in (0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1,
              11734379837973679516):
        w = synth.seed_to_int64(s)
        assert w == ref_scn.seed_to_int64(s)
        assert synth.seed_words(w) == synth.seed_words(s)


def _base(bars: int = 96, seed: int = 42) -> data.OHLCV:
    s = data.synthetic_ohlcv(1, bars, seed=seed)
    return data.OHLCV(*(np.asarray(f[0]) for f in s))


def _ref_draws(lo, hi, n_blocks, t_base, block, regimes, shock):
    """The reference generator's draws, block by block with jax.random."""
    key = jax.random.fold_in(jax.random.PRNGKey(lo), hi)
    keys, start, path, hit = [], [], [], []
    state = 0
    for b in range(n_blocks):
        kb = jax.random.fold_in(key, b)
        keys.append(_u32(kb))
        k_start, k_sw, k_pick, k_shock, _ = jax.random.split(kb, 5)
        start.append(int(jax.random.randint(
            k_start, (), 0, max(t_base - block + 1, 1))))
        if regimes > 1:
            u = np.asarray(jax.random.uniform(k_sw, (block,)))
            cand = np.asarray(jax.random.randint(k_pick, (block,), 0,
                                                 regimes))
            for t in range(block):
                state = int(cand[t]) if u[t] < np.float32(1.0 - 0.96) \
                    else state
                path.append(state)
        hit.append(np.asarray(jax.random.uniform(k_shock, (block,)))
                   < np.float32(shock))
    return np.stack(keys), np.int64(start), np.int64(path), np.stack(hit)


CASES = [synth.ScenarioParams(n_bars=64, block=8, regimes=3, vol_scale=1.5,
                              shock=0.05, seed=3),
         synth.ScenarioParams(n_bars=0, block=16, regimes=1, vol_scale=2.0,
                              shock=0.0, seed=1),
         synth.ScenarioParams(n_bars=97, block=5, regimes=4, vol_scale=3.0,
                              shock=0.2, seed=9)]


@pytest.mark.parametrize("params", CASES, ids=["r3", "r1", "r4-odd"])
def test_generate_matches_the_reference(params):
    base = _base()
    eff = synth.scenario_seed("cd" * 16, params)
    lo, hi = synth.seed_words(eff)
    n_bars, block, regimes = synth.check_shape(
        base.n_bars, params.n_bars, params.block, params.regimes)
    n_blocks = -(-n_bars // block)
    keys = synth.block_keys([lo], [hi], n_blocks, "cpu")
    d = synth.draws(keys, base.n_bars - 1, block, regimes,
                    torch.tensor([params.shock]))
    r_keys, r_start, r_path, r_hit = _ref_draws(
        lo, hi, n_blocks, base.n_bars - 1, block, regimes, params.shock)
    np.testing.assert_array_equal(keys[0].numpy(), r_keys)
    np.testing.assert_array_equal(d["start"][0].numpy(), r_start)
    np.testing.assert_array_equal(d["hit"][0].numpy(), r_hit)
    if regimes > 1:
        np.testing.assert_array_equal(d["path"][0].reshape(-1).numpy(),
                                      r_path)
    got = synth.generate(base, params, eff, device="cpu")
    want = ref_scn.generate(ref_data.OHLCV(*base),
                            ref_scn.ScenarioParams(**params.to_dict()), eff)
    for f in data._FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.shape == b.shape == (n_bars,) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=f)
    # The volume is the base's, resampled: exact when the starts are.
    np.testing.assert_array_equal(got.volume, np.asarray(want.volume))


def test_generated_bars_hold_their_invariants_and_repeat():
    base = _base(300, seed=7)
    blob = data.to_wire_bytes(base)
    for p in CASES:
        p = synth.ScenarioParams(**{**p.to_dict(), "shock": 0.3})
        one = synth.scenario_panel_bytes(blob, p, device="cpu")
        assert one == synth.scenario_panel_bytes(blob, p, device="cpu")
        s = data.from_wire_bytes(one)
        assert (s.high >= np.maximum(s.open, s.close)).all()
        assert (np.minimum(s.open, s.close) >= s.low).all()
        assert (s.low > 0).all() and np.isfinite(np.stack(s)).all()
    with pytest.raises(ValueError, match="n_bars"):
        synth.check_shape(10, 2**21, 4, 2)
    with pytest.raises(ValueError, match=">= 2 bars"):
        synth.check_shape(1, 5, 4, 2)


def _carrier(strategy, k, *, base_bars=96, params=PARAMS, grid=None):
    base = _base(base_bars)
    blob = data.to_wire_bytes(base)
    digest = panel_store.panel_digest(blob)
    job = ref_pb.JobSpec(
        id="s0", strategy=strategy, ohlcv=blob,
        grid=ref_wire.grid_to_proto(grid or GRIDS[strategy]), cost=1e-3,
        periods_per_year=252, panel_digest=digest, panel_bytes_len=len(blob))
    for i in range(k):
        p = synth.ScenarioParams(**{**params, "seed": i})
        job.scenario_batch.add(
            base_digest=digest, n_bars=p.n_bars, block=p.block,
            regimes=p.regimes, vol_scale=p.vol_scale, shock=p.shock,
            seed=synth.seed_to_int64(synth.scenario_seed(digest, p)),
            id=f"s{i}", trace_id=f"t{i}")
    return job


@pytest.mark.parametrize("strategy", sorted(GRIDS))
def test_fused_route_equals_the_materialized_rung(strategy, monkeypatch):
    job = _carrier(strategy, 5)
    backend = compute.TorchSweepBackend(device="cpu")
    assert backend.accepts_scenario_batch
    fused_out = backend.process([job])
    assert [(c.job_id, c.trace_id) for c in fused_out] == [
        (f"s{i}", f"t{i}") for i in range(5)]
    assert backend.stats()["scenarios"] == {"fused": 5, "materialized": 0}
    monkeypatch.setenv("DBX_SCENARIO_FUSED", "0")
    mat = compute.TorchSweepBackend(device="cpu")
    assert not mat.accepts_scenario_batch
    mat_out = mat.process([job])
    assert mat.stats()["scenarios"] == {"fused": 0, "materialized": 5}
    assert [c.job_id for c in mat_out] == [c.job_id for c in fused_out]
    for a, b in zip(fused_out, mat_out):
        assert a.metrics and a.metrics == b.metrics, (strategy, a.job_id)
        m = wire.metrics_from_bytes(a.metrics)
        assert m.sharpe.shape == (wire.grid_n_combos(job.grid),)


def test_fused_route_matches_the_reference_backend():
    job = _carrier("sma_crossover", 4, base_bars=160,
                   params={**PARAMS, "n_bars": 96, "regimes": 3})
    got = compute.TorchSweepBackend(device="cpu").process([job])
    want = {c.job_id: c.metrics for c in
            ref_compute.JaxSweepBackend().process([job])}
    ids = [c.job_id for c in got]
    assert sorted(ids) == sorted(want)

    def stack(blobs):
        rows = [wire.metrics_from_bytes(b) for b in blobs]
        return Metrics(*(np.stack([getattr(r, f) for r in rows])
                         for f in Metrics._fields))

    assert_metrics_match(stack([c.metrics for c in got]),
                         stack([want[i] for i in ids]))


def test_fused_sweep_rows_are_single_scenarios():
    # Row k of a K-row launch is the sweep of scenario k alone: each chunk
    # of rows is its own tickers (chunks of 2 rows forced here).
    base = _base()
    words = [synth.seed_words(synth.scenario_seed(
        "ef" * 16, synth.ScenarioParams(seed=i))) for i in range(5)]
    axes = {k: v.numpy() for k, v in sweep.product_grid(**GRID).items()}
    kw = dict(n_bars=64, block=8, regimes=2, cost=1e-3, device="cpu")
    args = ("sma_crossover", base._asdict(), [w[0] for w in words],
            [w[1] for w in words], [1.5] * 5, [0.01] * 5, axes)
    whole = fused.fused_scenario_sweep(*args, **kw)
    solo = [fused.fused_scenario_sweep(
        "sma_crossover", base._asdict(), [w[0]], [w[1]], [1.5], [0.01],
        axes, **kw) for w in words]
    for k, m in enumerate(solo):
        for name, a, b in zip(Metrics._fields, whole, m):
            np.testing.assert_allclose(a[k].numpy(), b[0].numpy(),
                                       rtol=2e-5, atol=2e-6, err_msg=name)
    with pytest.raises(ValueError, match="no scenario execution row"):
        fused.fused_scenario_sweep("pairs", *args[1:], **kw)
    with pytest.raises(ValueError, match="empty spec batch"):
        fused.fused_scenario_sweep("sma_crossover", base._asdict(), [], [],
                                   [], [], axes, **kw)


def test_degradations_are_logged_and_counted(monkeypatch, caplog):
    # A grid the kernel does not take and an invalid batch take the
    # materialized rung; a spec shape that cannot generate completes empty
    # there; a failure of the fused sweep itself propagates.
    backend = compute.TorchSweepBackend(device="cpu")
    odd = _carrier("sma_crossover", 2,
                   grid={"fast": np.float32([3.5]),
                         "slow": np.float32([10.0])})
    with caplog.at_level("WARNING", logger="dbx.torch.compute"):
        out = backend.process([odd])
    assert [c.job_id for c in out] == ["s0", "s1"]
    assert all(c.metrics for c in out)
    assert "materialized rung" in caplog.text
    bad = _carrier("sma_crossover", 2, params={**PARAMS, "n_bars": 2**21})
    out = backend.process([bad])
    assert [(c.job_id, c.metrics) for c in out] == [("s0", b""), ("s1", b"")]
    assert backend.stats()["scenarios"] == {"fused": 0, "materialized": 4}

    def boom(*a, **kw):
        raise RuntimeError("a failure on the card")

    monkeypatch.setattr(fused, "fused_scenario_sweep", boom)
    with pytest.raises(RuntimeError, match="failure on the card"):
        backend.process([_carrier("sma_crossover", 2)])


def test_worker_declares_the_capability(monkeypatch):
    seen = []

    class Stub:
        def RequestJobs(self, req, timeout):
            seen.append(req.accepts_scenario_batch)
            return ref_pb.JobsReply()

    backend = compute.TorchSweepBackend(device="cpu")
    w = Worker("localhost:1", backend)
    assert w._poll(Stub()) == []
    monkeypatch.setenv("DBX_SCENARIO_FUSED", "0")
    assert w._poll(Stub()) == []
    assert seen == [True, False]


def test_dispatcher_coalesces_scenarios_for_the_torch_worker():
    k = 4
    base = _base()
    blob = data.to_wire_bytes(base)
    queue = JobQueue()
    base_rec = JobRecord(id="base", strategy="sma_crossover", grid=GRID,
                         ohlcv=blob)
    queue.enqueue(base_rec)
    recs = scenario_jobs(base_rec.panel_digest, k, "sma_crossover", GRID,
                         params=PARAMS)
    for rec in recs:
        queue.enqueue(rec)
    disp = Dispatcher(queue, PeerRegistry(prune_window_s=30.0))
    srv = DispatcherServer(disp, bind="localhost:0",
                           prune_interval_s=5.0).start()
    backend = compute.TorchSweepBackend(device="cpu")
    w = Worker(f"localhost:{srv.port}", backend, poll_interval_s=0.02,
               status_interval_s=0.5, jobs_per_chip=k + 1)
    t = threading.Thread(target=lambda: w.run(max_idle_polls=10),
                         daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 60.0
        while not queue.drained and time.monotonic() < deadline:
            time.sleep(0.02)
        assert queue.drained, queue.stats()
    finally:
        w.stop()
        t.join(timeout=10)
        srv.stop()
    s = queue.stats()
    assert s["jobs_completed"] == k + 1
    assert s["jobs_failed"] == s["jobs_requeued"] == 0
    assert backend.stats()["scenarios"] == {"fused": k, "materialized": 0}
    # Each record's block is its spec's row of one direct fused sweep.
    words = [synth.seed_words(synth.scenario_seed(
        base_rec.panel_digest, synth.ScenarioParams(**{**PARAMS,
                                                       "seed": i})))
             for i in range(k)]
    m = fused.fused_scenario_sweep(
        "sma_crossover", base._asdict(), [x[0] for x in words],
        [x[1] for x in words], [PARAMS["vol_scale"]] * k,
        [PARAMS["shock"]] * k,
        {a: v.numpy() for a, v in sweep.product_grid(**GRID).items()},
        n_bars=64, block=8, regimes=2, device="cpu")
    for i, rec in enumerate(recs):
        got = wire.metrics_from_bytes(disp.results[rec.id])
        for name in Metrics._fields:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(m, name)[i].numpy())
