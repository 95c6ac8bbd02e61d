"""The port's walk-forward (``parallel/walkforward.py`` and the backend's
walk-forward routes) against the reference.

Same seed-made inputs through both packages at the reference tests' small
sizes (3 jobs x 200 bars, train 80, test 30, grids of 2-4 combos), the
port on the CPU (its plain versions), the reference as its own tests run
it: the generic functions, and ``JaxSweepBackend(use_fused=True)`` with
``_WF_FUSED_MIN_COMBOS = 1`` (its Pallas kernels in interpret mode).

Where the two generic paths take identical positions (sma_crossover,
momentum, donchian, donchian_hl, obv_trend) the chosen params must be
identical and the stitched returns agree at rtol=1e-5, atol=1e-6 (the
reference's ``tests/test_pairs_walkforward.py`` tolerance). Elsewhere a
train-metric tie at a knife edge can flip a window's choice, so the
reference's flip-aware rule holds (``tests/test_walkforward_fused_wire.py``):
a ticker whose stitched sharpe is off by more than 0.01 + 1% counts as
flipped, every other metric of the rest agrees at rtol=2e-3, atol=2e-4,
and at most one ticker or job of three may flip.
"""

import functools
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.models import (
    base as ref_base)
from distributed_backtesting_exploration_tpu.parallel import (
    sweep as ref_sweep, walkforward as ref_wf)
from distributed_backtesting_exploration_tpu.rpc import (
    backtesting_pb2 as ref_pb, compute as ref_compute, wire as ref_wire)
from distributed_backtesting_exploration_tpu.rpc.dispatcher import (
    synthetic_jobs)
from distributed_backtesting_exploration_tpu.utils import data as ref_data
from distributed_backtesting_exploration_tpu_torch.models import get_strategy
from distributed_backtesting_exploration_tpu_torch.ops.metrics import Metrics
from distributed_backtesting_exploration_tpu_torch.parallel import (
    sweep, walkforward)
from distributed_backtesting_exploration_tpu_torch.rpc import compute, wire

from torch_parity import CRAFTED, to_np

TRAIN, TEST, COST = 80, 30, 1e-3
# A grid of 2-4 combos of each single-asset family.
GRIDS = {
    "sma_crossover": {"fast": [3.0, 5.0], "slow": [13.0, 21.0]},
    "bollinger": {"window": [10.0, 15.0], "k": [1.0, 2.0]},
    "bollinger_touch": {"window": [8.0, 12.0], "k": [1.0, 2.0]},
    "stochastic": {"window": [8.0, 12.0], "band": [15.0, 25.0]},
    "momentum": {"lookback": [5.0, 13.0]},
    "donchian": {"window": [10.0, 20.0]},
    "donchian_hl": {"window": [8.0, 16.0]},
    "rsi": {"period": [7.0, 14.0], "band": [15.0, 25.0]},
    "keltner": {"window": [10.0, 15.0], "k": [1.0, 2.0]},
    "macd": {"fast": [5.0, 9.0], "slow": [20.0], "signal": [5.0, 9.0]},
    "trix": {"span": [5.0, 9.0], "signal": [4.0, 9.0]},
    "obv_trend": {"window": [6.0, 14.0, 22.0]},
    "vwap_reversion": {"window": [8.0, 14.0], "k": [1.0, 2.0]},
}
PAIRS_GRID = {"lookback": [8.0, 12.0], "z_entry": [0.8, 1.5]}
# The families whose generic paths in the two packages take identical
# positions.
TWINS = ("sma_crossover", "momentum", "donchian", "donchian_hl", "obv_trend")


def _grids(axes):
    """The same flat grid in both packages, axes in sorted order (the
    wire's)."""
    axes = {k: np.float32(axes[k]) for k in sorted(axes)}
    return (sweep.product_grid(**axes),
            ref_sweep.product_grid(**{k: jnp.asarray(v)
                                      for k, v in axes.items()}))


def _panel(n=3, T=200, seed=210):
    ohlcv = ref_data.synthetic_ohlcv(n, T, seed=seed)
    return ohlcv, type(ohlcv)(*(jnp.asarray(f) for f in ohlcv))


def _rows(m):
    """Metrics of (N,) fields -> one Metrics of numpy scalars per ticker."""
    fields = [to_np(f) for f in m]
    return [Metrics(*(f[i] for f in fields)) for i in range(len(fields[0]))]


def _assert_flip_aware(got, want, *, max_flips):
    """Per-row Metrics lists under the reference's flip-aware rule; returns
    the flipped rows' indices."""
    assert len(got) == len(want)
    flipped = []
    for i, (a, b) in enumerate(zip(got, want)):
        if np.abs(a.sharpe - b.sharpe) > 0.01 + 0.01 * np.abs(b.sharpe):
            flipped.append(i)
            continue
        for name in Metrics._fields:
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       rtol=2e-3, atol=2e-4,
                                       err_msg=f"row {i}/{name}")
    assert len(flipped) <= max_flips, f"flipped rows {flipped}"
    return flipped


def _assert_twins(got, want, grid_names):
    for k in grid_names:
        np.testing.assert_array_equal(to_np(got.chosen[k]),
                                      np.asarray(want.chosen[k]), err_msg=k)
    np.testing.assert_array_equal(to_np(got.oos_positions),
                                  np.asarray(want.oos_positions))
    np.testing.assert_allclose(to_np(got.oos_returns),
                               np.asarray(want.oos_returns),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(got.train_metric),
                               np.asarray(want.train_metric),
                               rtol=2e-4, atol=2e-5)
    for name in Metrics._fields:
        np.testing.assert_allclose(to_np(getattr(got.oos_metrics, name)),
                                   np.asarray(getattr(want.oos_metrics, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def _assert_matches(strategy, got, want, grid_names):
    if strategy in TWINS:
        _assert_twins(got, want, grid_names)
        return
    flipped = _assert_flip_aware(_rows(got.oos_metrics),
                                 _rows(want.oos_metrics), max_flips=1)
    same = [i for i in range(len(got.oos_returns)) if i not in flipped
            and all(np.array_equal(to_np(got.chosen[k])[i],
                                   np.asarray(want.chosen[k])[i])
                    for k in grid_names)]
    np.testing.assert_allclose(to_np(got.oos_returns)[same],
                               np.asarray(want.oos_returns)[same],
                               rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("strategy", sorted(GRIDS))
def test_walk_forward_matches_reference(strategy):
    ohlcv, panel = _panel()
    grid, ref_grid = _grids(GRIDS[strategy])
    want = ref_wf.walk_forward(panel, ref_base.get_strategy(strategy),
                               ref_grid, train=TRAIN, test=TEST, cost=COST)
    got = walkforward.walk_forward(ohlcv, get_strategy(strategy), grid,
                                   train=TRAIN, test=TEST, cost=COST,
                                   device="cpu")
    n_windows = (200 - TRAIN) // TEST
    assert got.oos_returns.shape == (3, n_windows * TEST)
    assert got.train_metric.shape == (3, n_windows)
    _assert_matches(strategy, got, want, grid)


@pytest.mark.parametrize("strategy", ["sma_crossover", "stochastic",
                                      "obv_trend", "bollinger"])
def test_walk_forward_fused_matches_reference(strategy):
    # Each package's walk_forward_fused with its own fused sweep (the
    # reference's in interpret mode, the port's plain version) as the train
    # sweep, over the fields its backend's routing row names.
    ohlcv, panel = _panel(seed=230)
    grid, ref_grid = _grids(GRIDS[strategy])
    g = {k: v.numpy() for k, v in grid.items()}
    ref_spec = ref_compute.JaxSweepBackend._FUSED_STRATEGIES[strategy]
    spec = compute._FUSED_STRATEGIES[strategy]
    assert tuple(ref_spec.fields) == tuple(spec.fields)
    want = ref_wf.walk_forward_fused(
        panel, ref_base.get_strategy(strategy), ref_grid,
        lambda *fs: ref_spec.run(*fs, g, COST, 252, None), train=TRAIN,
        test=TEST, cost=COST, fields=ref_spec.fields)
    got = walkforward.walk_forward_fused(
        ohlcv, get_strategy(strategy), grid,
        lambda *fs: spec.run(dict(zip(spec.fields, fs)), g, cost=COST,
                             periods_per_year=252, device="cpu"),
        train=TRAIN, test=TEST, cost=COST, fields=spec.fields, device="cpu")
    _assert_matches(strategy, got, want, grid)


def test_walk_forward_fused_matches_generic_on_sma():
    # The reference's own check (tests/test_pairs_walkforward.py): the
    # two-phase split reproduces the generic refit where the argmax agrees.
    ohlcv, _ = _panel(n=4, T=260, seed=21)
    grid, _ = _grids(GRIDS["sma_crossover"])
    strategy = get_strategy("sma_crossover")
    want = walkforward.walk_forward(ohlcv, strategy, grid, train=120,
                                    test=40, cost=COST, device="cpu")
    from distributed_backtesting_exploration_tpu_torch.ops import fused
    got = walkforward.walk_forward_fused(
        ohlcv, strategy, grid,
        functools.partial(fused.fused_sma_sweep, fast=grid["fast"].numpy(),
                          slow=grid["slow"].numpy(), cost=COST,
                          device="cpu"),
        train=120, test=40, cost=COST, device="cpu")
    for k in grid:
        torch.testing.assert_close(got.chosen[k], want.chosen[k], rtol=0,
                                   atol=0)
    torch.testing.assert_close(got.oos_positions, want.oos_positions,
                               rtol=0, atol=0)
    torch.testing.assert_close(got.oos_returns, want.oos_returns, rtol=1e-5,
                               atol=1e-6)


def test_walk_forward_pairs_matches_reference():
    ohlcv = ref_data.synthetic_ohlcv(6, 240, seed=17)
    y, x = ohlcv.close[:3], ohlcv.close[3:]
    grid, ref_grid = _grids(PAIRS_GRID)
    want = ref_wf.walk_forward_pairs(jnp.asarray(y), jnp.asarray(x),
                                     dict(ref_grid), train=120, test=40,
                                     cost=COST)
    got = walkforward.walk_forward_pairs(y, x, grid, train=120, test=40,
                                         cost=COST, device="cpu")
    # The two packages take the rolling OLS's sums in other orders, so the
    # hedged returns agree to the reference's pairs tolerance.
    flipped = _assert_flip_aware(_rows(got.oos_metrics),
                                 _rows(want.oos_metrics), max_flips=1)
    same = [i for i in range(3) if i not in flipped]
    for k in grid:
        np.testing.assert_array_equal(to_np(got.chosen[k])[same],
                                      np.asarray(want.chosen[k])[same])
    np.testing.assert_allclose(to_np(got.oos_returns)[same],
                               np.asarray(want.oos_returns)[same],
                               rtol=2e-4, atol=2e-5)


def test_pairs_refit_on_tensors_keeps_the_legs_dtype():
    ohlcv = ref_data.synthetic_ohlcv(4, 200, seed=5)
    y, x = (torch.as_tensor(f, dtype=torch.float64)
            for f in (ohlcv.close[:2], ohlcv.close[2:]))
    grid, _ = _grids(PAIRS_GRID)
    r64 = walkforward._walk_forward_pairs(y, x, grid, train=TRAIN,
                                          test=TEST, cost=COST)
    r32 = walkforward.walk_forward_pairs(y.numpy(), x.numpy(), grid,
                                         train=TRAIN, test=TEST, cost=COST,
                                         device="cpu")
    assert r64.oos_returns.dtype == torch.float64
    assert r32.oos_returns.dtype == torch.float32
    _assert_flip_aware(_rows(r32.oos_metrics), _rows(r64.oos_metrics),
                       max_flips=1)


def test_walk_forward_boundary_rebalance_cost():
    # The reference's hand-built case: the stitched series prices exactly
    # the positions it reports, window boundaries included.
    cost = 1e-2
    ohlcv, _ = _panel(n=2, T=512, seed=21)
    grid, _ = _grids({"fast": [3.0, 6.0], "slow": [12.0, 24.0]})
    train, test = 128, 64
    res = walkforward.walk_forward(ohlcv, get_strategy("sma_crossover"),
                                   grid, train=train, test=test, cost=cost,
                                   device="cpu")
    pos = to_np(res.oos_positions).astype(np.float64)
    close = np.asarray(ohlcv.close, np.float64)
    W = (512 - train) // test
    idx = np.concatenate([np.arange(w * test + train, w * test + train + test)
                          for w in range(W)])
    r = close[:, idx] / close[:, idx - 1] - 1.0
    prev = np.concatenate([np.zeros((2, 1)), pos[:, :-1]], axis=1)
    want = prev * r - cost * np.abs(pos - prev)
    np.testing.assert_allclose(to_np(res.oos_returns), want, rtol=1e-4,
                               atol=1e-6)


def test_stitch_boundary_matches_reference():
    # _stitch on hand-made window-major outputs, in both packages.
    rng = np.random.default_rng(3)
    W, N, test = 4, 3, 5
    oos_r = rng.normal(0, 0.01, (W, N, test)).astype(np.float32)
    oos_p = rng.choice([-1.0, 0.0, 1.0], (W, N, test)).astype(np.float32)
    prev_in = rng.choice([-1.0, 0.0, 1.0], (W, N)).astype(np.float32)
    rf = rng.normal(0, 0.01, (W, N)).astype(np.float32)
    best = rng.normal(0, 1, (W, N)).astype(np.float32)
    want = ref_wf._stitch(jnp.asarray(oos_r), jnp.asarray(oos_p),
                          jnp.asarray(prev_in), jnp.asarray(rf),
                          jnp.asarray(best), {}, n_tickers=N, cost=COST,
                          periods_per_year=252)
    got = walkforward._stitch(*(torch.as_tensor(a) for a in
                                (oos_r, oos_p, prev_in, rf, best)), {},
                              cost=COST, periods_per_year=252)
    np.testing.assert_allclose(to_np(got.oos_returns),
                               np.asarray(want.oos_returns), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_array_equal(to_np(got.oos_positions),
                                  np.asarray(want.oos_positions))
    np.testing.assert_array_equal(to_np(got.train_metric),
                                  np.asarray(want.train_metric))


def test_walk_forward_lower_is_better_metric():
    ohlcv, panel = _panel(n=2, T=512, seed=11)
    grid, ref_grid = _grids({"fast": [3.0, 6.0], "slow": [12.0, 24.0]})
    kw = dict(train=128, test=64, metric="max_drawdown")
    want = ref_wf.walk_forward(panel, ref_base.get_strategy("sma_crossover"),
                               ref_grid, **kw)
    got = walkforward.walk_forward(ohlcv, get_strategy("sma_crossover"), grid,
                                   device="cpu", **kw)
    _assert_twins(got, want, grid)
    # The chosen train drawdown is each window's smallest.
    per_combo = sweep.run_sweep(
        type(ohlcv)(*(f[:, :128] for f in ohlcv)),
        get_strategy("sma_crossover"), grid, device="cpu").max_drawdown
    torch.testing.assert_close(got.train_metric[:, 0],
                               per_combo.min(dim=1).values, rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("chunk", [1, 2, 3, 8])
@pytest.mark.parametrize("metric", ["sharpe", "max_drawdown"])
def test_refit_argmax_is_jnp_argmax_across_chunks(monkeypatch, chunk, metric):
    # Crafted train metrics with NaN, ties, +-0 and +-inf, cut into param
    # chunks of every size: the running argmax must give jnp.argmax's
    # index (the first NaN wins; among equal values the first index).
    rows = torch.as_tensor(CRAFTED)                     # (7, 8)
    N, P = rows.shape
    monkeypatch.setattr(sweep, "_CHUNK_ELEMS", chunk)
    grid = {"x": np.arange(P, dtype=np.float32)}
    tag = torch.arange(P, dtype=torch.float32)

    def one_chunk(sub):
        j = sub["x"][:, 0].long()
        return rows[:, j], tag[j].expand(N, -1)[..., None].repeat(1, 1, 2)

    sign = -1.0 if metric == "max_drawdown" else 1.0
    val, idx, out = walkforward._refit(grid, 1, torch.device("cpu"), sign,
                                       one_chunk)
    want = np.asarray(jnp.argmax(sign * jnp.asarray(CRAFTED), axis=-1))
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(out.numpy(), np.repeat(
        want.astype(np.float32)[:, None], 2, axis=1))
    np.testing.assert_array_equal(val.numpy(), CRAFTED[np.arange(N), want])


def test_argmax_nan_first_on_crafted_rows():
    for sign in (1.0, -1.0):
        want = np.asarray(jnp.argmax(sign * jnp.asarray(CRAFTED), axis=-1))
        got = walkforward.argmax_nan_first(sign * torch.as_tensor(CRAFTED))
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(walkforward.argmax_nan_first(
        torch.tensor([1.0, np.nan, 2.0, np.nan]))) == 1
    assert int(walkforward.argmax_nan_first(torch.tensor([2.0, 1.0, 2.0]))) \
        == 0


def test_window_schedule():
    np.testing.assert_array_equal(walkforward.window_starts_np(1260, 600, 55),
                                  np.arange(12) * 55)
    np.testing.assert_array_equal(walkforward.window_starts_np(200, 80, 30),
                                  ref_wf.window_starts_np(200, 80, 30))
    with pytest.raises(ValueError, match="too short"):
        walkforward.window_starts_np(100, 80, 30)
    close = torch.arange(2 * 20, dtype=torch.float32).reshape(2, 20)
    stacked = walkforward._stack_train_windows(close, np.arange(3) * 4, 6)
    assert stacked.shape == (6, 6)
    # Window-major rows: window w, ticker n at row w * N + n.
    torch.testing.assert_close(stacked[3], close[1, 4:10])


# --- the backend's walk-forward routes -------------------------------------

def _wf_specs(recs, **fields):
    return [ref_pb.JobSpec(id=r.id, strategy=r.strategy, ohlcv=r.ohlcv,
                           ohlcv2=r.ohlcv2 or b"",
                           grid=ref_wire.grid_to_proto(r.grid), cost=r.cost,
                           wf_train=r.wf_train, wf_test=r.wf_test,
                           wf_metric=r.wf_metric, **fields) for r in recs]


def _jobs(strategy, grid, n=3, bars=200, seed=210, **kw):
    kw = {"wf_train": TRAIN, "wf_test": TEST, "wf_metric": "sharpe", **kw}
    return synthetic_jobs(n, bars, strategy,
                          {k: np.float32(v) for k, v in grid.items()},
                          cost=COST, seed=seed, **kw)


def _port(specs, min_combos=None):
    backend = compute.TorchSweepBackend(device="cpu")
    if min_combos is not None:
        backend._WF_FUSED_MIN_COMBOS = min_combos
    return {c.job_id: c.metrics for c in backend.process(specs)}


def _reference(specs, min_combos=None):
    backend = ref_compute.JaxSweepBackend(use_fused=True, use_mesh=False)
    if min_combos is not None:
        backend._WF_FUSED_MIN_COMBOS = min_combos
    return {c.job_id: c.metrics for c in backend.process(specs)}


def _assert_blocks_match(got, want, *, max_flips=1):
    assert set(got) == set(want)
    ids = sorted(want)
    rows = []
    for blocks in (got, want):
        ms = [wire.metrics_from_bytes(blocks[i]) for i in ids]
        for m in ms:
            assert m.sharpe.shape == (1,)       # one stitched row a job
        rows.append([Metrics(*(f[0] for f in m)) for m in ms])
    _assert_flip_aware(*rows, max_flips=max_flips)


@pytest.mark.parametrize("strategy", ["sma_crossover", "stochastic",
                                      "obv_trend"])
def test_backend_fused_train_route_matches_reference(strategy, caplog):
    # The reference's wire tests (tests/test_walkforward_fused_wire.py):
    # the fused-train route forced on a tiny grid, logged, and held to the
    # reference backend's on the same route.
    specs = _wf_specs(_jobs(strategy, GRIDS[strategy], seed=240))
    with caplog.at_level(logging.INFO, logger="dbx.torch.compute"):
        got = _port(specs, min_combos=1)
    assert "fused-train route" in caplog.text
    _assert_blocks_match(got, _reference(specs, min_combos=1))


def test_backend_small_grid_stays_generic(caplog):
    specs = _wf_specs(_jobs("sma_crossover", GRIDS["sma_crossover"],
                            n=2, seed=260))
    assert compute.TorchSweepBackend._WF_FUSED_MIN_COMBOS == 512
    with caplog.at_level(logging.INFO, logger="dbx.torch.compute"):
        got = _port(specs)
    assert "fused-train route" not in caplog.text
    _assert_blocks_match(got, _reference(specs))


def test_backend_pairs_walk_forward_matches_reference():
    # Pairs walk-forward is generic-only, as in the reference.
    specs = _wf_specs(_jobs("pairs", PAIRS_GRID, seed=31))
    _assert_blocks_match(_port(specs, min_combos=1), _reference(specs))


@pytest.mark.parametrize("strategy,grid", [
    ("sma_crossover", GRIDS["sma_crossover"]), ("pairs", PAIRS_GRID)])
def test_backend_ragged_group_refits_per_job(strategy, grid):
    # 170 and 200 bars share a payload length bucket: one ragged group.
    recs = (_jobs(strategy, grid, n=2, bars=200, seed=50)
            + _jobs(strategy, grid, n=1, bars=170, seed=51))
    specs = _wf_specs(recs)
    _assert_blocks_match(_port(specs), _reference(specs))


@pytest.mark.parametrize("strategy,grid", [
    ("sma_crossover", GRIDS["sma_crossover"]), ("pairs", PAIRS_GRID)])
@pytest.mark.parametrize("case,fields,message", [
    ("unknown_metric", {"wf_metric": "nope"}, "'nope'"),
    ("wf_test0", {"wf_test": 0}, "wf_test > 0"),
])
def test_backend_invalid_walk_forward_completes_empty(
        strategy, grid, case, fields, message, caplog):
    # Validated-bad, as in the reference: every job of the group completes
    # with an empty block and a logged error, none stays leased.
    specs = _wf_specs(_jobs(strategy, grid, n=2, **fields))
    with caplog.at_level(logging.ERROR, logger="dbx.torch.compute"):
        got = _port(specs)
    assert got == {s.id: b"" for s in specs}
    assert message in caplog.text
    assert _reference(specs) == got


@pytest.mark.parametrize("strategy,grid", [
    ("sma_crossover", GRIDS["sma_crossover"]), ("pairs", PAIRS_GRID)])
def test_backend_short_job_completes_empty_beside_a_good_one(
        strategy, grid, caplog):
    specs = _wf_specs(_jobs(strategy, grid, n=1, bars=200, seed=60)
                      + _jobs(strategy, grid, n=1, bars=100, seed=61))
    good, short = specs
    with caplog.at_level(logging.ERROR, logger="dbx.torch.compute"):
        got = _port(specs)
    assert got[short.id] == b"" and got[good.id]
    assert f"job {short.id} needs" in caplog.text
    want = _reference(specs)
    assert want[short.id] == b""
    _assert_blocks_match({good.id: got[good.id]}, {good.id: want[good.id]})


def test_backend_best_returns_with_walk_forward_completes_empty(caplog):
    specs = _wf_specs(_jobs("sma_crossover", GRIDS["sma_crossover"], n=2),
                      best_returns=True)
    with caplog.at_level(logging.ERROR, logger="dbx.torch.compute"):
        got = _port(specs)
    assert got == {s.id: b"" for s in specs}
    assert "best_returns is not supported for walk-forward" in caplog.text
    assert _reference(specs) == got


def test_backend_top_k_with_walk_forward_returns_the_stitched_row():
    # A walk-forward job's one row is not reduced: top_k is ignored and the
    # block is DBXM, as the reference's.
    specs = _wf_specs(_jobs("sma_crossover", GRIDS["sma_crossover"]),
                      top_k=2, rank_metric="sharpe")
    got = _port(specs)
    assert {wire.result_kind(b) for b in got.values()} == {"metrics"}
    want = _reference(specs)
    assert {ref_wire.result_kind(b) for b in want.values()} == {"metrics"}
    _assert_blocks_match(got, want)
