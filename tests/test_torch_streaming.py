"""The port's streaming checkpoints (``streaming/``) against the reference.

The reference's fixtures (``tests/test_streaming.py``): T_BASE = 128 bars,
ΔT = 16, the 14 families' small grids, ``synthetic_ohlcv(2, 144, seed=3)``
and pairs' x leg from seed 6; T_BASE exceeds every family's tail, so the
appends run the partial-tail heads, the serving path. The port runs on the
CPU; the reference as its own tests run it.

Against the reference: the scan form's accumulators (counts bit-exact, the
moment sums and the equity state at rtol=1e-6; pairs, whose hedge ratio
comes from another cumsum order, at the reference's pairs budget of
rtol=5e-3, atol=5e-4), its EMA state at rtol=1e-6 (the reference jits its
build, which rounds the EMA ladder in another order than eager), the
appended metrics under ``torch_parity``'s flip rule, the metric advance on
crafted positions (equity bit-equal, sums at 1e-6), the codec both ways,
``stream_key``, ``tail_bars`` and ``stream_fields``. The port's own
cold-versus-append parity under the reference's ``_assert_parity``
budgets, the store's levels, and the fused wrappers' ``carry_out=True``.
"""

import functools

import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.parallel.sweep import (
    product_grid)
from distributed_backtesting_exploration_tpu.streaming import (
    recurrent as ref_rc)
from distributed_backtesting_exploration_tpu.utils import data
from distributed_backtesting_exploration_tpu_torch.ops import fused
from distributed_backtesting_exploration_tpu_torch.streaming import (
    CarryStore, recurrent as rc)

from torch_parity import assert_metrics_match, to_np

T_BASE, DT = 128, 16
T_FULL = T_BASE + DT
CPU = torch.device("cpu")

_GRIDS = {
    "sma_crossover": dict(fast=[3.0, 5.0], slow=[10.0, 12.0]),
    "momentum": dict(lookback=[4.0, 9.0]),
    "bollinger": dict(window=[8.0, 12.0], k=[1.0, 1.5]),
    "bollinger_touch": dict(window=[8.0, 12.0], k=[1.0, 1.5]),
    "obv_trend": dict(window=[6.0, 10.0]),
    "donchian": dict(window=[6.0, 10.0]),
    "donchian_hl": dict(window=[6.0, 10.0]),
    "stochastic": dict(window=[6.0, 10.0], band=[15.0, 25.0]),
    "keltner": dict(window=[6.0, 10.0], k=[1.0, 1.5]),
    "vwap_reversion": dict(window=[5.0, 8.0], k=[1.0, 1.5]),
    "rsi": dict(period=[5.0, 8.0], band=[10.0, 20.0]),
    "macd": dict(fast=[3.0, 5.0], slow=[8.0, 12.0], signal=[4.0]),
    "trix": dict(span=[4.0, 6.0], signal=[3.0]),
    "pairs": dict(lookback=[5.0, 8.0], z_entry=[1.0, 1.5], z_exit=[0.0]),
}
FAMILIES = sorted(_GRIDS)

_PANEL = data.synthetic_ohlcv(2, T_FULL, seed=3)
_PAIR_X = data.synthetic_ohlcv(2, T_FULL, seed=6)

_EXACT = ("turnover", "n_trades", "hit_rate")
_COUNTS = ("wins", "active", "turnover", "pos_last")
_MOMENTS = ("s1", "s2", "dsum", "cum", "peak", "mdd")
# The signal lines are EMAs of differences that cancel (macd's ef - es,
# trix's e3 / prev - 1): their error is about an ulp of the terms (up to
# 5e-7 here), whatever their own size.
_STATE_ATOL = {"esig": 1e-6}


def _grid(strategy):
    return {k: np.asarray(v)
            for k, v in product_grid(**_GRIDS[strategy]).items()}


def _fields(strategy, hi, lo=0):
    out = {f: np.asarray(getattr(_PANEL, f))[:, lo:hi]
           for f in rc.stream_fields(strategy) if f != "close2"}
    if "close2" in rc.stream_fields(strategy):
        out["close2"] = np.asarray(_PAIR_X.close)[:, lo:hi]
    return out


@functools.lru_cache(maxsize=None)
def _ref_base(strategy):
    return ref_rc.build_carry(strategy, _fields(strategy, T_BASE),
                              _grid(strategy))


@functools.lru_cache(maxsize=None)
def _base(strategy):
    return rc.build_carry(strategy, _fields(strategy, T_BASE),
                          _grid(strategy), device="cpu")


def _assert_parity(got, want, *, rtol=2e-5, atol=2e-6, what="",
                   max_flips=0):
    """The reference's cold-versus-append rule (``tests/test_streaming.py``
    ``_assert_parity``) with its budgets: flipped lanes count against
    ``max_flips``; on the rest the count metrics are bit-exact and the
    others agree at ``rtol``/``atol``. The reference calls a lane flipped
    where its turnover differs; here also where its hit rate differs,
    since both are exact functions of the position path, and an entry and
    exit each a bar late (a z at the band) keeps the turnover and moves
    the rest (pairs, lane 0, at this seed)."""
    flips = ((to_np(got.turnover) != to_np(want.turnover))
             | (to_np(got.hit_rate) != to_np(want.hit_rate)))
    assert flips.sum() <= max_flips, (
        f"{what}: {int(flips.sum())} flipped lanes exceed {max_flips}")
    ok = ~flips
    for name in want._fields:
        g, w = to_np(getattr(got, name)), to_np(getattr(want, name))
        if name in _EXACT:
            assert np.array_equal(g[ok], w[ok]), f"{what}: {name}"
        else:
            np.testing.assert_allclose(g[ok], w[ok], rtol=rtol, atol=atol,
                                       err_msg=f"{what}: {name}")


def _assert_bits(got, want):
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("strategy", FAMILIES)
def test_build_carry_matches_reference(strategy):
    ref, got = _ref_base(strategy), _base(strategy)
    assert got.n_bars == ref.n_bars == T_BASE
    assert set(got.metric) == set(ref.metric)
    assert set(got.state) == set(ref.state)
    for f in ref.tail:
        np.testing.assert_array_equal(to_np(got.tail[f]),
                                      np.asarray(ref.tail[f]))
    for name in _COUNTS:
        np.testing.assert_array_equal(to_np(got.metric[name]),
                                      np.asarray(ref.metric[name]), name)
    tol = ({"rtol": 5e-3, "atol": 5e-4} if strategy == "pairs"
           else {"rtol": 1e-6, "atol": 0})
    for name in _MOMENTS:
        np.testing.assert_allclose(to_np(got.metric[name]),
                                   np.asarray(ref.metric[name]),
                                   err_msg=name, **tol)
    for name, v in ref.state.items():
        np.testing.assert_allclose(to_np(got.state[name]), np.asarray(v),
                                   rtol=1e-6, atol=_STATE_ATOL.get(name, 0),
                                   err_msg=name)
    for name, v in got.metric.items():
        assert v.dtype == torch.float32 and v.device == CPU, name


@pytest.mark.parametrize("strategy", FAMILIES)
def test_append_matches_reference(strategy):
    delta = _fields(strategy, T_FULL, T_BASE)
    got = rc.append_step(_base(strategy), delta)
    want = ref_rc.append_step(_ref_base(strategy), delta)
    assert got.n_bars == want.n_bars == T_FULL
    for f in want.tail:
        np.testing.assert_array_equal(to_np(got.tail[f]),
                                      np.asarray(want.tail[f]))
    assert_metrics_match(rc.finalize(got), ref_rc.finalize(want),
                         **({"rtol": 2e-3, "atol": 2e-4}
                            if strategy == "pairs" else {}))


@pytest.mark.parametrize("strategy", FAMILIES)
def test_append_matches_cold_build(strategy):
    """build at T + append of ΔT against the cold build at T + ΔT, through
    the partial-tail heads, under the reference's budgets as written."""
    base = _base(strategy)
    assert base.tail["close"].shape[-1] < base.n_bars
    cold = rc.finalize(rc.build_carry(strategy, _fields(strategy, T_FULL),
                                      _grid(strategy), device="cpu"))
    stepped = rc.append_step(base, _fields(strategy, T_FULL, T_BASE))
    pairs = strategy == "pairs"
    _assert_parity(rc.finalize(stepped), cold, what=strategy,
                   rtol=5e-3 if pairs else 2e-5, atol=5e-4 if pairs else 2e-6,
                   max_flips=1 if pairs else 0)


@pytest.mark.parametrize("strategy", ["bollinger", "macd", "rsi"])
def test_append_leaves_its_base_as_it_was(strategy):
    """An append writes nothing into its base, and two appends from one
    base are bit-equal (a retried job advances the stored base again)."""
    base = rc.build_carry(strategy, _fields(strategy, T_BASE),
                          _grid(strategy), device="cpu")
    before = rc.carry_to_bytes(base)
    snap = {ns: {k: v.clone() for k, v in getattr(base, ns).items()}
            for ns in ("tail", "state", "metric")}
    delta = _fields(strategy, T_FULL, T_BASE)
    one, two = rc.append_step(base, delta), rc.append_step(base, delta)
    for ns, d in snap.items():
        for k, v in d.items():
            assert torch.equal(getattr(base, ns)[k], v), (ns, k)
    assert rc.carry_to_bytes(base) == before
    _assert_bits(rc.finalize(one), rc.finalize(two))
    for ns in ("tail", "state", "metric"):
        for k, v in getattr(one, ns).items():
            assert v.data_ptr() != getattr(base, ns)[k].data_ptr(), (ns, k)


def _crafted(n=3, p=4, d=37, seed=5):
    """Positions in {-1, 0, 1} and returns with a NaN, an inf and large
    steps, for the metric advance."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(-1, 2, (n, p, d)).astype(np.float32)
    ret = (rng.standard_normal((n, 1, d)) * 0.05).astype(np.float32)
    ret[0, 0, 7] = np.nan
    ret[1, 0, 11] = np.inf
    ret[2, 0, 20:] = -0.9
    return pos, ret


@pytest.mark.parametrize("block", [1, 8, 16, 37])
def test_advance_metrics_matches_reference_on_crafted_positions(block):
    import jax.numpy as jnp

    pos, ret = _crafted()
    n, p, _ = pos.shape
    cost = 1e-3
    want = ref_rc._metric_init(n, p)
    got = rc._metric_init(n, p, CPU)
    # Two advances: the second from a non-zero state.
    for lo, hi in ((0, 20), (20, 37)):
        want = ref_rc._advance_metrics(want, jnp.asarray(pos[..., lo:hi]),
                                       jnp.asarray(ret[..., lo:hi]),
                                       cost=cost, block=block)
        got = rc._advance_metrics(got, torch.from_numpy(pos[..., lo:hi]),
                                  torch.from_numpy(ret[..., lo:hi]),
                                  cost=cost, block=block)
    for name in ("cum", "peak", "mdd", *_COUNTS):
        np.testing.assert_array_equal(to_np(got[name]),
                                      np.asarray(want[name]), name)
    for name in ("s1", "s2", "dsum"):
        np.testing.assert_allclose(to_np(got[name]), np.asarray(want[name]),
                                   rtol=1e-6, atol=0, err_msg=name)
    ref_m = ref_rc.finalize(ref_rc.StreamCarry(
        "sma_crossover", {}, cost, 252, 37, {}, {}, want))
    got_m = rc._finalize(got, 37, 252)
    for name in ("max_drawdown", "total_return", "turnover", "n_trades",
                 "hit_rate"):
        np.testing.assert_array_equal(to_np(getattr(got_m, name)),
                                      np.asarray(getattr(ref_m, name)), name)


@pytest.mark.parametrize("block", [1, 4, 8, 50])
def test_equity_advance_is_the_references_bits(block):
    from distributed_backtesting_exploration_tpu.ops import (
        fused as ref_fused)

    rng = np.random.default_rng(9)
    net = (rng.standard_normal((3, 5, 50)) * 0.1).astype(np.float32)
    net[0, 1, 10] = np.nan
    net[1, 2, 30:] = -2.0
    net[2, 0, 5] = -np.inf
    state = [np.zeros((3, 5), np.float32),
             np.full((3, 5), -np.inf, np.float32),
             np.zeros((3, 5), np.float32)]
    want = ref_fused._equity_advance(net, block, *state)
    got = fused._equity_advance(torch.from_numpy(net), block,
                                *(torch.from_numpy(s) for s in state))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    x = torch.from_numpy(net[1, 0])
    assert torch.equal(fused._cumsum_last(x),
                       torch.from_numpy(np.asarray(
                           ref_fused._cumsum_last(net[1, 0]))))
    assert torch.equal(fused._cummax_last(x),
                       torch.from_numpy(np.asarray(
                           ref_fused._cummax_last(net[1, 0]))))


@pytest.mark.parametrize("n,epilogue", [(16, None), (1260, None),
                                        (8208, None), (100, "scan:16"),
                                        (100, "ladder"), (3, None)])
def test_block_schedule_is_the_references(n, epilogue):
    assert rc._block(n, epilogue) == ref_rc._block(n, epilogue)


@pytest.mark.parametrize("strategy", ["bollinger", "macd", "pairs"])
def test_codec_interop_both_ways(strategy):
    """The reference's bytes load in the port and append to the port's own
    append; the port's bytes load in the reference into its carry."""
    delta = _fields(strategy, T_FULL, T_BASE)
    ref_bytes = ref_rc.carry_to_bytes(_ref_base(strategy))
    loaded = rc.carry_from_bytes(ref_bytes, device="cpu")
    assert loaded.n_bars == T_BASE and loaded.strategy == strategy
    assert all(v.device == CPU and v.dtype == torch.float32
               for d in (loaded.tail, loaded.state, loaded.metric)
               for v in d.values())
    assert_metrics_match(
        rc.finalize(rc.append_step(loaded, delta)),
        ref_rc.finalize(ref_rc.append_step(_ref_base(strategy), delta)),
        **({"rtol": 2e-3, "atol": 2e-4} if strategy == "pairs" else {}))

    port = _base(strategy)
    back = ref_rc.carry_from_bytes(rc.carry_to_bytes(port))
    assert (back.strategy, back.n_bars, back.cost, back.ppy) == (
        port.strategy, port.n_bars, port.cost, port.ppy)
    for ns in ("tail", "state", "metric"):
        mine, theirs = getattr(port, ns), getattr(back, ns)
        assert set(mine) == set(theirs), ns
        for k in mine:
            np.testing.assert_array_equal(np.asarray(theirs[k]),
                                          to_np(mine[k]), f"{ns}/{k}")
    for k in port.grid:
        np.testing.assert_array_equal(np.asarray(back.grid[k]), port.grid[k])
    # The reference appends to the port's carry as to its own.
    assert_metrics_match(
        rc.finalize(rc.append_step(port, delta)),
        ref_rc.finalize(ref_rc.append_step(back, delta)),
        **({"rtol": 2e-3, "atol": 2e-4} if strategy == "pairs" else {}))


def test_stream_key_is_the_references():
    grid = _grid("sma_crossover")
    for strategy, g, cost, ppy in (
            ("sma_crossover", grid, 0.0, 252),
            ("sma_crossover", grid, 1e-3, 252),
            ("sma_crossover", {**grid, "fast": grid["fast"] + 1.0}, 0.0,
             252),
            ("momentum", grid, 0.0, 365)):
        key = rc.stream_key(strategy, g, cost, ppy)
        assert key == ref_rc.stream_key(strategy, g, cost, ppy)
        assert key == rc.stream_key(
            strategy, {k: torch.from_numpy(np.asarray(v, np.float32))
                       for k, v in reversed(list(g.items()))}, cost, ppy)
    keys = {rc.stream_key(s, grid, 0.0, 252) for s in ("a", "b")}
    assert len(keys) == 2


@pytest.mark.parametrize("strategy", FAMILIES)
def test_tail_bars_and_fields_are_the_references(strategy):
    g = _grid(strategy)
    assert rc.tail_bars(strategy, g) == ref_rc.tail_bars(strategy, g)
    assert rc.stream_fields(strategy) == ref_rc.stream_fields(strategy)
    assert rc.supports_strategy(strategy)


def test_streamable_families_pin_the_dispatchers_set():
    from distributed_backtesting_exploration_tpu.rpc.dispatcher import (
        STREAMABLE_STRATEGIES)

    assert set(rc._STREAM_FAMILIES) == set(ref_rc._STREAM_FAMILIES)
    assert {s for s in rc._STREAM_FAMILIES if s != "pairs"} == \
        STREAMABLE_STRATEGIES
    assert not rc.supports_strategy("nope")


def test_append_in_two_slices_matches_one():
    base = _base("bollinger")
    one = rc.append_step(base, _fields("bollinger", T_FULL, T_BASE))
    half = T_BASE + DT // 2
    two = rc.append_step(
        rc.append_step(base, _fields("bollinger", half, T_BASE)),
        _fields("bollinger", T_FULL, half))
    assert two.n_bars == one.n_bars == T_FULL
    _assert_parity(rc.finalize(two), rc.finalize(one), what="2-slice")


def test_full_cover_append_while_tail_holds_history():
    grid = _grid("sma_crossover")
    t0 = rc.tail_bars("sma_crossover", grid)
    base = rc.build_carry("sma_crossover", _fields("sma_crossover", t0),
                          grid, device="cpu")
    assert base.tail["close"].shape[-1] == base.n_bars == t0
    stepped = rc.append_step(base, _fields("sma_crossover", t0 + 8, t0))
    cold = rc.finalize(rc.build_carry(
        "sma_crossover", _fields("sma_crossover", t0 + 8), grid,
        device="cpu"))
    _assert_parity(rc.finalize(stepped), cold, what="full-cover")
    # macd re-extracts its state over the window while the tail covers it.
    g = _grid("macd")
    t0 = rc.tail_bars("macd", g)
    base = rc.build_carry("macd", _fields("macd", t0), g, device="cpu")
    stepped = rc.append_step(base, _fields("macd", t0 + 8, t0))
    want = ref_rc.append_step(
        ref_rc.build_carry("macd", _fields("macd", t0), g),
        _fields("macd", t0 + 8, t0))
    for k, v in want.state.items():
        np.testing.assert_allclose(to_np(stepped.state[k]), np.asarray(v),
                                   rtol=1e-6, atol=_STATE_ATOL.get(k, 0),
                                   err_msg=k)


def test_validation_errors():
    grid = _grid("sma_crossover")
    with pytest.raises(ValueError, match="no streaming family"):
        rc.build_carry("nope", {"close": np.ones((1, 8), np.float32)},
                       grid, device="cpu")
    with pytest.raises(ValueError, match="needs fields"):
        rc.build_carry("obv_trend", {"close": np.ones((1, 8), np.float32)},
                       _grid("obv_trend"), device="cpu")
    carry = _base("sma_crossover")
    with pytest.raises(ValueError, match="empty delta"):
        rc.append_step(carry, {"close": np.ones((2, 0), np.float32)})
    with pytest.raises(ValueError, match="delta fields"):
        rc.append_step(carry, {"volume": np.ones((2, 4), np.float32)})
    if not torch.cuda.is_available():
        # The default device is cuda, with no fallback.
        with pytest.raises(RuntimeError, match="cuda"):
            rc.build_carry("sma_crossover",
                           _fields("sma_crossover", T_BASE), grid)


def test_checkpoint_roundtrip_evict_restore_bit_matches():
    base = _base("bollinger")
    delta = _fields("bollinger", T_FULL, T_BASE)
    want = rc.finalize(rc.append_step(base, delta))
    store = CarryStore(max_bytes=1 << 22, device="cpu")
    key = ("digest-abc", rc.stream_key("bollinger", base.grid, 0.0, 252))
    store.put(key, base)
    store.evict_device(key)
    assert store.stats()["device_carries"] == 0
    restored = store.get(key)                     # host-level deserialize
    assert restored is not None and restored.n_bars == T_BASE
    assert restored is not base
    _assert_bits(rc.finalize(rc.append_step(restored, delta)), want)
    assert store.get(key) is restored             # re-primed


def test_carry_store_levels_bounds_and_counters(monkeypatch):
    carry = _base("momentum")
    store = CarryStore(max_bytes=1 << 22, device="cpu")
    key = ("d1", "s1")
    assert store.get(key) is None                 # cold: both levels miss
    assert store.misses == {"host": 1, "device": 1}
    store.put(key, carry)
    assert store.get(key) is carry                # device hit
    assert store.hits["device"] == 1
    store.evict_device(key)
    assert store.get(key) is not None             # host restore
    assert store.hits["host"] == 1
    st = store.stats()
    assert st["host_carries"] == st["device_carries"] == 1
    assert st["device_bytes"] == carry.nbytes > 0 and st["host_bytes"] > 0
    assert st["max_bytes"] == 1 << 22
    # A bound below one checkpoint keeps nothing, and raises nothing.
    tiny = CarryStore(max_bytes=16, device="cpu")
    tiny.put(key, carry)
    assert tiny.get(key) is None
    # The budget is read when a store is made.
    monkeypatch.setenv("DBX_CARRY_CACHE_MB", "2")
    assert CarryStore(device="cpu").max_bytes == 2 * 1024 * 1024
    monkeypatch.delenv("DBX_CARRY_CACHE_MB")
    assert CarryStore(device="cpu").max_bytes == 64 * 1024 * 1024


def test_carry_store_reprime_does_not_overwrite_racer(monkeypatch):
    older = _base("momentum")
    newer = rc.append_step(older, _fields("momentum", T_FULL, T_BASE))
    store = CarryStore(max_bytes=1 << 22, device="cpu")
    key = ("d-race", "s-race")
    store.put(key, older)
    store.evict_device(key)               # the host blob: the older state
    real = rc.carry_from_bytes

    def racing_deserialize(blob, device):
        out = real(blob, device)
        # A racer checkpoints the key between this thread's two locks.
        with store._lock:
            store._device.put(key, newer, newer.nbytes)
        return out

    monkeypatch.setattr(rc, "carry_from_bytes", racing_deserialize)
    assert store.get(key) is newer
    with store._lock:
        assert store._device.get(key) is newer


def test_append_epilogue_substrates_agree():
    base = _base("sma_crossover")
    delta = _fields("sma_crossover", T_FULL, T_BASE)
    scan = rc.finalize(rc.append_step(base, delta, epilogue="scan:8"))
    ladder = rc.finalize(rc.append_step(base, delta, epilogue="ladder"))
    _assert_parity(scan, ladder, what="scan-vs-ladder")
    with pytest.raises(ValueError, match="epilogue"):
        rc.append_step(base, delta, epilogue="scan:7")


def _pg(strategy):
    return {k: np.asarray(v, np.float32) for k, v in _grid(strategy).items()}


# Each fused wrapper with its fields and grid (the family's argument order).
WRAPPERS = {
    "sma_crossover": lambda f, g, **kw: fused.fused_sma_sweep(
        f["close"], g["fast"], g["slow"], **kw),
    "bollinger": lambda f, g, **kw: fused.fused_bollinger_sweep(
        f["close"], g["window"], g["k"], **kw),
    "bollinger_touch": lambda f, g, **kw: fused.fused_bollinger_touch_sweep(
        f["close"], g["window"], g["k"], **kw),
    "stochastic": lambda f, g, **kw: fused.fused_stochastic_sweep(
        f["close"], f["high"], f["low"], g["window"], g["band"], **kw),
    "momentum": lambda f, g, **kw: fused.fused_momentum_sweep(
        f["close"], g["lookback"], **kw),
    "donchian": lambda f, g, **kw: fused.fused_donchian_sweep(
        f["close"], g["window"], **kw),
    "donchian_hl": lambda f, g, **kw: fused.fused_donchian_hl_sweep(
        f["close"], f["high"], f["low"], g["window"], **kw),
    "rsi": lambda f, g, **kw: fused.fused_rsi_sweep(
        f["close"], g["period"], g["band"], **kw),
    "keltner": lambda f, g, **kw: fused.fused_keltner_sweep(
        f["close"], f["high"], f["low"], g["window"], g["k"], **kw),
    "vwap_reversion": lambda f, g, **kw: fused.fused_vwap_sweep(
        f["close"], f["volume"], g["window"], g["k"], **kw),
    "macd": lambda f, g, **kw: fused.fused_macd_sweep(
        f["close"], g["fast"], g["slow"], g["signal"], **kw),
    "trix": lambda f, g, **kw: fused.fused_trix_sweep(
        f["close"], g["span"], g["signal"], **kw),
    "obv_trend": lambda f, g, **kw: fused.fused_obv_sweep(
        f["close"], f["volume"], g["window"], **kw),
    "pairs": lambda f, g, **kw: fused.fused_pairs_sweep(
        f["close"], f["close2"], g["lookback"], g["z_entry"],
        z_exit=g["z_exit"], **kw),
}


@pytest.mark.parametrize("strategy", FAMILIES)
def test_fused_wrapper_carry_out_mode(strategy):
    """``carry_out=True``: the kernel's metrics untouched beside the
    build's carry, which appends like :func:`build_carry`'s; ragged panels
    are refused before the kernel runs."""
    f, g = _fields(strategy, T_BASE), _pg(strategy)
    kw = dict(cost=1e-3, device="cpu")
    plain = WRAPPERS[strategy](f, g, **kw)
    m, carry = WRAPPERS[strategy](f, g, carry_out=True, **kw)
    _assert_bits(m, plain)
    assert carry.n_bars == T_BASE and carry.strategy == strategy
    assert carry.cost == pytest.approx(1e-3)
    want = rc.build_carry(strategy, f, g, cost=1e-3, device="cpu")
    _assert_bits(rc.finalize(carry), rc.finalize(want))
    # The carry's scan-form metrics agree with the kernel's plain version
    # to the fused-vs-generic budget.
    assert_metrics_match(rc.finalize(carry), m,
                         **({"rtol": 2e-3, "atol": 2e-4}
                            if strategy in ("pairs", "macd", "trix",
                                            "keltner", "vwap_reversion")
                            else {}))
    delta = _fields(strategy, T_FULL, T_BASE)
    _assert_bits(rc.finalize(rc.append_step(carry, delta)),
                 rc.finalize(rc.append_step(want, delta)))
    with pytest.raises(ValueError, match="uniform full-history"):
        WRAPPERS[strategy](f, g, carry_out=True,
                           t_real=np.asarray([T_BASE, T_BASE - 5]), **kw)


def test_bollinger_carry_out_needs_exit_at_the_mean():
    f = _fields("bollinger", T_BASE)
    with pytest.raises(ValueError, match="z_exit=0"):
        fused.fused_bollinger_sweep(f["close"], [8.0], [1.0], z_exit=0.5,
                                    carry_out=True, device="cpu")
    m = fused.fused_bollinger_sweep(f["close"], [8.0], [1.0], z_exit=0.5,
                                    device="cpu")
    assert m.sharpe.shape == (2, 1)
