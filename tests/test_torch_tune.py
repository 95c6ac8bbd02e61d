"""The port's tune layer (``tune/``, the tuned-schedule resolvers of
``ops/fused.py``, the backend's consultation) against the reference's.

The schedule registry is a copy: the same records give the same journal
and wire bytes in both packages. The resolution chain (explicit argument >
env > tuned schedule > default) is run on both packages' ``ops.fused``.
The autotuner's search space and prior are the port's own (only the knobs
that select other code on the card), so its modes, pruning and pinned axes
are checked with a fake measurement. The compile cache's store is the
reference's; its sync holds the ``nvcc``-built libraries, and each
package refuses the other's entries.
"""

import json

import numpy as np
import pytest

from distributed_backtesting_exploration_tpu import tune as ref_tune
from distributed_backtesting_exploration_tpu.ops import fused as ref_fused
from distributed_backtesting_exploration_tpu.rpc.dispatcher import (
    parse_grid, synthetic_jobs)
from distributed_backtesting_exploration_tpu_torch import obs, tune
from distributed_backtesting_exploration_tpu_torch.ops import _kernels, fused
from distributed_backtesting_exploration_tpu_torch.parallel import sweep
from distributed_backtesting_exploration_tpu_torch.rpc import (
    backtesting_pb2 as pb, compute, panel_store, wire)
from distributed_backtesting_exploration_tpu_torch.tune import (
    autotune, compile_cache)

SMA_GRID = parse_grid("fast=3:5,slow=10:14:2")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("DBX_AUTOTUNE", "DBX_AUTOTUNE_TRIALS", "DBX_AUTOTUNE_REPS",
                "DBX_SCHEDULE_DIR", "DBX_LANES_CAP", "DBX_PAGE_BARS",
                "DBX_EPILOGUE", "DBX_SMA_TABLE", "DBX_PAGED",
                "DBX_COMPILE_CACHE_DIR", "DBX_COMPILE_CACHE_MB"):
        monkeypatch.delenv(var, raising=False)
    yield
    fused.set_tuned_defaults(None)
    ref_fused.set_tuned_defaults(None)


# --- the schedule registry -------------------------------------------------

def test_shape_bucket_is_the_references():
    for T in (1, 2, 63, 64, 65, 500, 1260, 4096, 70000):
        for P in (0, 1, 128, 129, 1000, 2000, 5000):
            assert tune.shape_bucket(T, P) == ref_tune.shape_bucket(T, P)
    assert tune.registry.KNOWN_SUBSTRATES == \
        ref_tune.registry.KNOWN_SUBSTRATES
    assert tune.registry._FILENAME == ref_tune.registry._FILENAME


def test_group_bucket_adds_the_rows_to_the_references_bucket():
    for T, P in ((1260, 2000), (96, 9), (70000, 5000)):
        for n, rail in ((1, 8), (8, 8), (9, 16), (32, 32), (500, 512),
                        (1000, 1024), (9000, 4096)):
            assert tune.group_bucket(T, P, n) == \
                f"{ref_tune.shape_bucket(T, P)}_n{rail}"
    # A 32-row group and a 500-row one of one (T, P) are tuned apart.
    assert tune.group_bucket(1260, 2000, 32) != \
        tune.group_bucket(1260, 2000, 500)


_RECORDS = [
    ("sma_crossover", "t2048_p2048", "torch-cuda-sm90",
     {"lanes_cap": 256, "bogus": "dropped"}, 3, 1234.5),
    ("pairs", "t2048_p512", "torch-cuda-sm90", {"lanes_cap": "512"}, 3,
     None),
    ("bollinger", "t64_p128", "cpu", {"epilogue": "scan:32",
                                      "table_boll": "hbm"}, 0, None),
    ("sma_crossover", "t2048_p2048", "torch-cuda-sm90",
     {"lanes_cap": "0"}, 3, 999.0),
    ("macd", "t128_p128", "torch-cpu", {"page_bars": "256"}, 1, 5.0),
]


def _recorded(mod, path):
    reg = mod.ScheduleRegistry(str(path) if path else None)
    for fam, bucket, plat, subs, trials, best in _RECORDS:
        reg.record(fam, bucket, plat, subs, trials=trials, best_us=best)
    return reg


def test_records_give_the_references_journal_and_wire_bytes(tmp_path):
    ref = _recorded(ref_tune, tmp_path / "ref.jsonl")
    port = _recorded(tune, tmp_path / "port.jsonl")
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()
    assert port.to_json() == ref.to_json()
    assert port.take_dirty_json() == ref.take_dirty_json()
    assert port.take_dirty_json() == "" == ref.take_dirty_json()
    # An identical record adds nothing to the journal.
    assert not port.record("pairs", "t2048_p512", "torch-cuda-sm90",
                           {"lanes_cap": "512"}, trials=3)
    # Replay: later lines win, a corrupt line is skipped and counted.
    with open(tmp_path / "port.jsonl", "a") as fh:
        fh.write("{not json\n" + json.dumps({"v": 2}) + "\n")
    again = tune.ScheduleRegistry(str(tmp_path / "port.jsonl"))
    assert again.corrupt_entries == 2
    assert again.to_json() == ref.to_json()
    assert again.lookup("sma_crossover", "t2048_p2048",
                        "torch-cuda-sm90") == {"lanes_cap": "0"}


def test_open_default_follows_the_schedule_dir(tmp_path, monkeypatch):
    assert tune.ScheduleRegistry.open_default().path is None
    monkeypatch.setenv("DBX_SCHEDULE_DIR", str(tmp_path / "s"))
    reg = tune.ScheduleRegistry.open_default()
    reg.record("trix", "t2048_p1024", "torch-cpu", {"lanes_cap": "256"},
               trials=2, best_us=1.0)
    assert (tmp_path / "s" / "schedule.v1.jsonl").exists()
    assert tune.ScheduleRegistry.open_default().lookup(
        "trix", "t2048_p1024", "torch-cpu") == {"lanes_cap": "256"}


def test_merge_adopts_the_other_packages_json_under_its_platform():
    ref = _recorded(ref_tune, None)
    port = tune.ScheduleRegistry()
    assert port.merge_json(ref.to_json()) == len(ref)
    assert port.to_json() == ref.to_json()
    back = ref_tune.ScheduleRegistry()
    assert back.merge_json(port.to_json()) == len(port)
    # A lookup under a foreign platform never sees an entry: the JAX
    # package's platforms are jax backends, the port's torch-*.
    assert port.lookup("bollinger", "t64_p128", "torch-cpu") is None
    assert port.lookup("bollinger", "t64_p128", "cpu") is not None
    assert back.lookup("pairs", "t2048_p512", "gpu") is None
    for e in json.loads(port.to_json()):
        assert e["platform"] in ("cpu", "torch-cpu", "torch-cuda-sm90")
    # Conflicts resolve as in the reference: more trials win, a tie by line.
    for mod, reg in ((tune, port), (ref_tune, back)):
        more = [dict(json.loads(reg.to_json())[0], trials=99,
                     substrates={"lanes_cap": "256"})]
        assert reg.merge_json(json.dumps(more), mark_dirty=True) == 1
        assert reg.merge_json("not json") == 0 and reg.corrupt_entries == 1
        reg.remark_dirty(reg.take_dirty_json())
    assert port.to_json() == back.to_json()
    assert port.take_dirty_json() == back.take_dirty_json() != ""


# --- the resolution chain ---------------------------------------------------

@pytest.mark.parametrize("mod", [ref_fused, fused], ids=["jax", "torch"])
def test_env_beats_tuned_beats_default_for_every_knob(mod, monkeypatch):
    sched = {"lanes_cap": "256", "page_bars": "256"}
    assert mod.resolve_lanes_cap() == 0
    assert mod.resolve_page_bars() == 512
    with mod.tuned_schedule(sched):
        assert mod.resolve_lanes_cap() == 256
        assert mod.resolve_page_bars() == 256
        monkeypatch.setenv("DBX_LANES_CAP", "512")
        monkeypatch.setenv("DBX_PAGE_BARS", "1024")
        assert mod.resolve_lanes_cap() == 512
        assert mod.resolve_page_bars() == 1024
        monkeypatch.setenv("DBX_LANES_CAP", "0")
        assert mod.resolve_lanes_cap() == 0
    monkeypatch.delenv("DBX_LANES_CAP")
    monkeypatch.delenv("DBX_PAGE_BARS")
    assert mod.resolve_lanes_cap() == 0
    assert mod.resolve_page_bars() == 512


def test_epilogue_and_table_are_checked_and_never_tuned(monkeypatch):
    """The port runs one design for every epilogue and table value, so
    those knobs have no env or tuned layer: an argument is validated, and
    None is the default whatever the env or the schedule say."""
    monkeypatch.setenv("DBX_EPILOGUE", "ladder")
    monkeypatch.setenv("DBX_SMA_TABLE", "vmem")
    with fused.tuned_schedule({"epilogue": "scan:32", "table_sma": "hbm"}):
        assert fused._resolve_epilogue(None) == "scan"
        assert fused._resolve_epilogue("scan:16") == "scan:16"
        fused._check_table(None)
        fused._check_table("hbm")
    for bad in ("warp", "scan:12"):
        with pytest.raises(ValueError):
            fused._resolve_epilogue(bad)
    with pytest.raises(ValueError):
        fused._check_table("vmem")


@pytest.mark.parametrize("mod", [ref_fused, fused], ids=["jax", "torch"])
def test_invalid_tuned_values_degrade_and_invalid_env_raises(mod,
                                                             monkeypatch):
    with mod.tuned_schedule({"lanes_cap": "100", "page_bars": "13"}):
        assert mod.resolve_lanes_cap() == 0
        assert mod.resolve_page_bars() == 512
    with mod.tuned_schedule({"lanes_cap": "wide", "page_bars": "x"}):
        assert mod.resolve_lanes_cap() == 0
        assert mod.resolve_page_bars() == 512
    for var, value, call in (
            ("DBX_LANES_CAP", "100", mod.resolve_lanes_cap),
            ("DBX_LANES_CAP", "wide", mod.resolve_lanes_cap),
            ("DBX_PAGE_BARS", "13", mod.resolve_page_bars)):
        monkeypatch.setenv(var, value)
        with pytest.raises(ValueError):
            call()
        monkeypatch.delenv(var)
    with pytest.raises(ValueError):
        mod._resolve_epilogue("warp")


@pytest.mark.parametrize("mod", [ref_fused, fused], ids=["jax", "torch"])
def test_process_defaults_sit_below_the_thread_schedule(mod):
    mod.set_tuned_defaults({"page_bars": "1024", "lanes_cap": "512"})
    assert mod.resolve_page_bars() == 1024
    assert mod.resolve_lanes_cap() == 512
    with mod.tuned_schedule({"lanes_cap": "256"}):
        assert mod.resolve_lanes_cap() == 256
        assert mod.resolve_page_bars() == 1024
    mod.set_tuned_defaults(None)
    assert mod.resolve_page_bars() == 512
    assert mod.resolve_lanes_cap() == 0


def test_tile_width_is_the_shipped_one_capped(monkeypatch):
    assert fused.tile_lanes(1024) == 1024
    with fused.tuned_schedule({"lanes_cap": "256"}):
        assert fused.tile_lanes(1024) == 256
        assert fused.tile_lanes(128) == 128     # a cap never widens
        monkeypatch.setenv("DBX_LANES_CAP", "512")
        assert fused.tile_lanes(1024) == 512
    assert {s for s in fused._PAGED_FAMILIES if fused.shipped_lanes(s)} \
        | {"pairs"} == set(autotune._TILE_KEYS)
    assert fused.shipped_lanes("pairs") == fused._PAIRS_LANES
    assert fused.shipped_lanes("rsi") is None


def test_sweep_resolves_its_width_once_and_passes_it_down(monkeypatch):
    seen = []
    entry = fused.fused_sma

    def spy(*args, lanes=None, **kw):
        seen.append(lanes)
        return entry(*args, **kw)

    monkeypatch.setattr(fused, "fused_sma", spy)
    close = np.float32(np.linspace(10, 20, 40)).reshape(2, 20)
    run = lambda: fused.fused_sma_sweep(  # noqa: E731
        close, np.float32([2, 3]), np.float32([5, 8]), device="cpu")
    want = run()
    with fused.tuned_schedule({"lanes_cap": "128"}):
        got = run()
    monkeypatch.setenv("DBX_LANES_CAP", "256")
    run()
    assert seen == [1024, 128, 256]
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError):
        fused.fused_sma_sweep(close, np.float32([2]), np.float32([5]),
                              table="vmem", device="cpu")
    assert len(seen) == 3     # an invalid argument raises before a launch


# --- the autotuner ----------------------------------------------------------

def test_modes_follow_the_env(monkeypatch):
    assert autotune.autotune_mode() == "off"
    for raw, mode in (("0", "off"), ("off", "off"), ("model", "model"),
                      ("1", "measure"), ("measure", "measure")):
        monkeypatch.setenv("DBX_AUTOTUNE", raw)
        assert autotune.autotune_mode() == mode == ref_tune.autotune_mode()
    monkeypatch.setenv("DBX_AUTOTUNE_TRIALS", "x")
    assert autotune.autotune_trials() == 4 == ref_tune.autotune_trials()


def test_candidate_space_holds_only_knobs_that_select_other_code():
    assert autotune.candidate_space("sma_crossover") == [
        {"lanes_cap": "0"}, {"lanes_cap": "256"}, {"lanes_cap": "512"}]
    # 512 lanes shipped: a cap of 512 runs the shipped code.
    assert autotune.candidate_space("bollinger") == [
        {"lanes_cap": "0"}, {"lanes_cap": "256"}]
    for s in ("momentum", "rsi", "stochastic", "donchian"):
        assert autotune.candidate_space(s) == []
        assert autotune.default_substrates(s) == {}
    assert len(autotune.candidate_space("rsi", paged=True)) == 3
    assert len(autotune.candidate_space("trix", paged=True)) == 9
    assert not any("epilogue" in c or any(k.startswith("table_") for k in c)
                   for c in autotune.candidate_space("sma_crossover",
                                                     paged=True))


def test_prior_is_deterministic_and_counts_waves_and_windows():
    g = {k: v.numpy() for k, v in sweep.product_grid(
        **parse_grid("fast=5:25,slow=30:230:2")).items()}
    kw = dict(n_bars=1260, n_combos=2000, n_rows=500, grid=g)
    costs = {c["lanes_cap"]: autotune.modeled_cost("sma_crossover", c, **kw)
             for c in autotune.candidate_space("sma_crossover")}
    assert costs == {c["lanes_cap"]: autotune.modeled_cost(
        "sma_crossover", c, **kw)
        for c in autotune.candidate_space("sma_crossover")}
    # Narrower tiles form more window values a lane.
    assert autotune._tile_windows("sma_crossover", g, 256, 2000) / 256 > \
        autotune._tile_windows("sma_crossover", g, 1024, 2000) / 1024
    # 500 pairs on 1024-lane tiles waste half of each CTA.
    pg = {"lookback": np.repeat(np.arange(20, 70, 5), 50).astype(np.float32)}
    pkw = dict(n_bars=1260, n_combos=500, n_rows=1000, grid=pg)
    assert autotune.modeled_cost("pairs", {"lanes_cap": "512"}, **pkw) < \
        autotune.modeled_cost("pairs", {"lanes_cap": "0"}, **pkw)
    assert autotune.modeled_cost("sma_crossover", {"page_bars": "1024"},
                                 **kw) > autotune.modeled_cost(
        "sma_crossover", {"page_bars": "256"}, **kw)


def _tuner():
    reg = obs.Registry()
    return autotune.Autotuner(tune.ScheduleRegistry(registry=reg),
                              registry=reg), reg


def test_off_model_and_measure_modes(monkeypatch):
    tuner, reg = _tuner()
    kw = dict(n_bars=1260, n_combos=2000, n_rows=500)
    assert tuner.tune("sma_crossover", "b", "torch-cpu", **kw) is None
    monkeypatch.setenv("DBX_AUTOTUNE", "model")
    calls = []
    won = tuner.tune("sma_crossover", "b", "torch-cpu",
                     measure=lambda c: calls.append(c) or 1.0, **kw)
    prior = min(autotune.candidate_space("sma_crossover"), key=lambda c: (
        autotune.modeled_cost("sma_crossover", c, **kw),
        tune.entry_line(c)))
    assert won == prior and calls == []
    assert tuner.schedule.entries()[0]["trials"] == 0
    monkeypatch.setenv("DBX_AUTOTUNE", "1")
    monkeypatch.setenv("DBX_AUTOTUNE_REPS", "3")
    times = {"0": 3.0, "256": 1.0, "512": 2.0}
    won = tuner.tune("sma_crossover", "b2", "torch-cpu",
                     measure=lambda c: calls.append(c) or times[
                         c["lanes_cap"]], **kw)
    assert won == {"lanes_cap": "256"} and len(calls) == 9
    assert reg.peek("dbx_autotune_trials_total",
                    family="sma_crossover") == 3
    e = [x for x in tuner.schedule.entries() if x["bucket"] == "b2"][0]
    assert e["trials"] == 3 and e["best_us"] == 1e6
    # No knob: nothing measured, nothing recorded.
    assert tuner.tune("rsi", "b", "torch-cpu", measure=lambda c: 1 / 0,
                      **kw) is None
    # Every candidate failing: no winner.
    assert tuner.tune("trix", "b", "torch-cpu", measure=lambda c: 1 / 0,
                      **kw) is None
    assert reg.peek("dbx_autotune_trials_total", family="trix") == 0


def test_pruning_keeps_the_incumbent(monkeypatch):
    monkeypatch.setenv("DBX_AUTOTUNE", "1")
    monkeypatch.setenv("DBX_AUTOTUNE_TRIALS", "1")
    scored = sorted(autotune.candidate_space("obv_trend", paged=True),
                    key=tune.entry_line, reverse=True)
    kept = autotune.Autotuner._pruned("obv_trend", scored, 1)
    assert kept[0] == {"lanes_cap": "0"} and len(kept) == 2
    assert kept[1] == scored[0]
    tuner, _ = _tuner()
    seen = []
    tuner.tune("obv_trend", "b", "torch-cpu", n_bars=64, n_combos=9,
               measure=lambda c: seen.append(dict(c)) or 1.0)
    # Two candidates, each in every one of the default three rounds.
    assert {"lanes_cap": "0"} in seen and len(seen) == 2 * 3


_STEADY = [1.0, 1.0, 1.0]


@pytest.mark.parametrize("times, winner", [
    # Noise below the least gain: the incumbent stays.
    ({"0": _STEADY, "256": [0.99, 0.985, 0.99], "512": [0.98, 0.99, 0.98]},
     "0"),
    # A gain inside the incumbent's own spread (interquartile 0.3): stays.
    ({"0": [1.0, 1.4, 0.8], "256": [0.85] * 3, "512": [0.9] * 3}, "0"),
    # Clear of both: the fastest challenger by median wins.
    ({"0": [1.0, 1.4, 0.8], "256": [0.6, 0.5, 0.65], "512": [0.55] * 3},
     "512"),
    ({"0": _STEADY, "256": [0.9, 5.0, 0.9], "512": [0.96] * 3}, "256"),
], ids=["noise", "spread", "clear", "median"])
def test_a_challenger_must_beat_the_incumbent_by_more_than_noise(
        times, winner, monkeypatch):
    monkeypatch.setenv("DBX_AUTOTUNE", "1")
    tuner, _ = _tuner()
    order = []

    def measure(c):
        cap = c["lanes_cap"]
        order.append(cap)
        return times[cap][order.count(cap) - 1]

    won = tuner.tune("sma_crossover", "b", "torch-cpu", measure=measure,
                     n_bars=1260, n_combos=2000, n_rows=500)
    assert won == {"lanes_cap": winner}
    # Three interleaved rounds, the incumbent first in each.
    assert len(order) == 9 and order == order[:3] * 3 and order[0] == "0"
    e = tuner.schedule.entries()[0]
    assert e["best_us"] == round(float(np.median(times[winner])) * 1e6, 3)


def test_env_pinned_axes_are_not_searched_or_recorded(monkeypatch):
    monkeypatch.setenv("DBX_AUTOTUNE", "1")
    monkeypatch.setenv("DBX_LANES_CAP", "256")
    assert autotune.env_pinned_keys("sma_crossover") == {"lanes_cap"}
    tuner, _ = _tuner()
    assert tuner.tune("sma_crossover", "b", "torch-cpu", n_bars=64,
                      n_combos=9, measure=lambda c: 1.0) is None
    monkeypatch.setenv("DBX_AUTOTUNE", "model")
    won = tuner.tune("sma_crossover", "b", "torch-cpu", n_bars=64,
                     n_combos=9, paged=True)
    assert set(won) == {"page_bars"} and len(tuner.schedule) == 1
    # The reference's epilogue and table knobs pin nothing here.
    monkeypatch.setenv("DBX_EPILOGUE", "ladder")
    monkeypatch.setenv("DBX_SMA_TABLE", "inline")
    assert autotune.env_pinned_keys("sma_crossover") == {"lanes_cap"}


# --- the compile cache ------------------------------------------------------

def test_store_evicts_the_references_keys():
    ref = ref_tune.CompileStore(max_bytes=100, registry=None)
    port = tune.CompileStore(max_bytes=100, registry=obs.Registry())
    offers = [("k%d" % i, "libx-%016x.so" % i, b"x" * n)
              for i, n in enumerate((30, 40, 50, 10, 101, 20, 0))]
    offers.append(("k1", "again", b"yy"))
    for o in offers:
        assert port.offer(*o) == ref.offer(*o)
        assert port.keys() == ref.keys()
    for k in ("k0", "k3", "k5", "nope"):
        assert port.get(k) == ref.get(k)
        assert port.keys() == ref.keys()
    assert port.stats() == ref.stats()


def _lib(tmp_path, name="fused_sma", n=1):
    path = tmp_path / f"lib{name}-{n:016x}.so"
    path.write_bytes(b"\x7fELF fake " + bytes([n]))
    return path


def test_sync_offers_installs_and_refuses_the_jax_packages(tmp_path):
    tag = compile_cache._runtime_tag()
    assert tag.count("|") == 3 and tag.startswith("torch ")
    assert "nvcc" in tag and "sm_90a" in tag
    ref_tag = ref_tune.compile_cache._runtime_tag()
    assert tag != ref_tag and ref_tag.count("|") == 1
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    _lib(a, n=1)
    (a / ".nvcc-partial.so").write_bytes(b"partial")
    (a / "tmp1234.so").write_bytes(b"not a library name")
    reg = obs.Registry()
    sync_a = tune.CacheSync(str(a), registry=reg)
    assert reg.peek("dbx_compile_cache_hits_total", source="local") == 1
    _lib(a, "ema_rows", 2)
    offers = sync_a.poll_new()
    assert [o[1] for o in offers] == ["libema_rows-0000000000000002.so"]
    assert sync_a.poll_new() == []
    sync_a.unmark(offers)
    assert sync_a.poll_new() == offers
    store = tune.CompileStore(registry=reg)
    for o in offers:
        store.offer(*o)
    sync_b = tune.CacheSync(str(b), registry=reg)
    assert sync_b.install((k, *store.get(k))
                          for k in sync_b.missing(store.keys())) == 1
    assert (b / offers[0][1]).read_bytes() == offers[0][2]
    assert sync_b.missing(store.keys()) == []
    # A JAX worker's entry (its name and its key) and a port entry under
    # a JAX key: refused and remembered.
    jax_name = "jit_sweep-5d2c9a0e4b1f7a33e2d1"
    jax_key = ref_tune.entry_key(jax_name, ref_tag)
    bad = [(jax_key, jax_name, b"xla"),
           (ref_tune.entry_key(offers[0][1] + "x", ref_tag),
            "libother-0000000000000003.so", b"so"),
           (tune.entry_key("../libx-0000000000000004.so", tag),
            "../libx-0000000000000004.so", b"so")]
    assert sync_b.install(bad) == 0
    assert sync_b.missing([k for k, _, _ in bad]) == []
    sync_b.count_fleet_misses(2)
    assert reg.peek("dbx_compile_cache_misses_total", source="fleet") == 2
    assert reg.peek("dbx_compile_cache_hits_total", source="fleet") == 1
    # The reference's sync refuses the port's entry the same way.
    ref_sync = ref_tune.CacheSync(str(tmp_path / "jax"), runtime_tag=ref_tag)
    assert ref_sync.install(offers) == 0
    assert ref_sync.missing([offers[0][0]]) == []
    assert store.stats()["entries"] == 1
    assert reg.peek("dbx_compile_store_entries") == 1


def test_configure_points_the_build_at_an_installed_library(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(_kernels, "BUILD_DIR", None)
    assert _kernels.build_dir() == _kernels.DEFAULT_BUILD_DIR
    monkeypatch.setenv("DBX_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    assert _kernels.build_dir() == tmp_path / "env"
    assert tune.default_cache_dir() == str(tmp_path / "env")
    assert tune.configure(str(tmp_path / "cc")) == str(tmp_path / "cc")
    assert _kernels.build_dir() == tmp_path / "cc"
    want = _kernels.library_path("ema_rows")
    assert want.parent == tmp_path / "cc"
    assert compile_cache._LIB_NAME.match(want.name)
    want.write_bytes(b"installed")

    def no_nvcc():
        raise AssertionError("nvcc must not run for an installed library")

    monkeypatch.setattr(_kernels, "_nvcc", no_nvcc)
    assert _kernels.build("ema_rows") == want
    sync = tune.attach(registry=obs.Registry())
    assert sync.cache_dir == str(tmp_path / "cc")
    assert sync.poll_new() == []     # already there: a local hit


# --- the backend ------------------------------------------------------------

def _jobs(strategy="sma_crossover", grid=SMA_GRID, n=3, bars=96, seed=5):
    recs = synthetic_jobs(n, bars, strategy, grid, cost=1e-3, seed=seed)
    return [pb.JobSpec(id=r.id, strategy=r.strategy, ohlcv=r.ohlcv,
                       ohlcv2=r.ohlcv2 or b"",
                       grid=wire.grid_to_proto(r.grid), cost=r.cost,
                       periods_per_year=252) for r in recs]


def _spy_widths(monkeypatch):
    seen = []
    entry = fused.fused_sma

    def spy(*args, lanes=None, **kw):
        seen.append(lanes)
        return entry(*args, **kw)

    monkeypatch.setattr(fused, "fused_sma", spy)
    return seen


def test_backend_serves_the_tuned_schedule_below_env(monkeypatch):
    seen = _spy_widths(monkeypatch)
    jobs = _jobs()
    want = {c.job_id: c.metrics
            for c in compute.TorchSweepBackend(device="cpu").process(jobs)}
    backend = compute.TorchSweepBackend(device="cpu")
    assert backend.platform == "torch-cpu"
    bucket = tune.group_bucket(96, 9, 3)
    backend.schedule_registry.record("sma_crossover", bucket, "cpu",
                                     {"lanes_cap": "128"})
    assert {c.job_id: c.metrics for c in backend.process(jobs)} == want
    backend.schedule_registry.record("sma_crossover", bucket, "torch-cpu",
                                     {"lanes_cap": "256"})
    got = {c.job_id: c.metrics for c in backend.process(jobs)}
    monkeypatch.setenv("DBX_LANES_CAP", "512")
    backend.process(jobs)
    assert seen == [1024, 1024, 256, 512]
    assert got == want
    # A group of 12 rows is another bucket: the 3-row winner is not its.
    monkeypatch.delenv("DBX_LANES_CAP")
    backend.process(_jobs(n=12))
    assert seen[4:] == [1024]
    assert obs.get_registry().peek(
        "dbx_tuned_substrate_info", kernel="sma_crossover", bucket=bucket,
        epilogue="default", table="default", lanes_cap="256",
        page_bars="default") == 1


def test_backend_records_a_first_contact_winner(monkeypatch, tmp_path):
    monkeypatch.setenv("DBX_AUTOTUNE", "model")
    monkeypatch.setenv("DBX_SCHEDULE_DIR", str(tmp_path))
    backend = compute.TorchSweepBackend(device="cpu")
    jobs = _jobs()
    backend.process(jobs)
    bucket = tune.group_bucket(96, 9, 3)
    won = backend.schedule_registry.lookup("sma_crossover", bucket,
                                           "torch-cpu")
    assert won is not None and set(won) == {"lanes_cap"}
    pairs = _jobs("pairs", parse_grid("lookback=8:20:6,z_entry=1:3"), n=2)
    assert len(backend.process(pairs)) == 2
    assert backend.schedule_registry.lookup(
        "pairs", tune.group_bucket(96, 6, 2), "torch-cpu") is not None
    # A family whose entry runs no tiles has nothing to tune.
    backend.process(_jobs("rsi", parse_grid("period=7:21:7,band=15:30:10")))
    assert len(backend.schedule_registry) == 2
    assert "sma_crossover" in backend.schedule_registry.take_dirty_json()
    # The journal outlives the backend; measure mode on a new backend
    # finds the entry and measures nothing.
    monkeypatch.setenv("DBX_AUTOTUNE", "1")
    again = compute.TorchSweepBackend(device="cpu")
    assert again.schedule_registry.lookup("sma_crossover", bucket,
                                          "torch-cpu") == won
    again._autotune_measure = lambda make_run: pytest.fail("measured")
    again.process(jobs)


def test_backend_measures_its_groups_own_sweep(monkeypatch):
    monkeypatch.setenv("DBX_AUTOTUNE", "1")
    monkeypatch.setenv("DBX_AUTOTUNE_REPS", "2")
    seen = _spy_widths(monkeypatch)
    backend = compute.TorchSweepBackend(device="cpu")
    jobs = _jobs(n=4)
    before = obs.get_registry().peek("dbx_autotune_trials_total",
                                     family="sma_crossover") or 0
    backend.process(jobs)
    after = obs.get_registry().peek("dbx_autotune_trials_total",
                                    family="sma_crossover")
    assert after - before == 3
    # 3 candidates x 2 reps x (warm + 3 timed), then the group itself.
    runs = 1 + compute.TorchSweepBackend._MEASURE_RUNS
    assert sorted(set(seen[:-1])) == [256, 512, 1024]
    assert len(seen) == 3 * 2 * runs + 1
    e = backend.schedule_registry.entries()[0]
    assert e["platform"] == "torch-cpu" and e["trials"] == 3
    assert seen[-1] == min(1024, int(e["substrates"]["lanes_cap"]) or 1024)


def test_backend_measures_a_paged_group_on_the_paged_route(monkeypatch):
    """A group the pool serves is timed on the paged sweep over its
    resolved pages: no dense stack of it is made."""
    monkeypatch.setenv("DBX_AUTOTUNE", "1")
    monkeypatch.setenv("DBX_PAGED", "1")
    monkeypatch.setenv("DBX_PAGE_POOL_MB", "4")
    jobs = _jobs(n=4)
    for j in jobs:
        j.panel_digest = panel_store.panel_digest(j.ohlcv)
        j.panel_bytes_len = len(j.ohlcv)
    want = {c.job_id: c.metrics
            for c in compute.TorchSweepBackend(device="cpu").process(jobs)}
    backend = compute.TorchSweepBackend(device="cpu")
    assert backend.use_paged
    calls = []
    entry = fused.fused_paged_sweep
    monkeypatch.setattr(fused, "fused_paged_sweep", lambda *a, **kw: (
        calls.append(fused.resolve_lanes_cap()) or entry(*a, **kw)))
    monkeypatch.setattr(backend, "_device_fields",
                        lambda *a: pytest.fail("dense stack made"))
    got = {c.job_id: c.metrics for c in backend.process(jobs)}
    assert got == want
    runs = 1 + compute.TorchSweepBackend._MEASURE_RUNS
    assert len(calls) == 3 * 3 * runs + 1
    assert sorted(set(calls[:-1])) == [0, 256, 512]
    e = backend.schedule_registry.entries()[0]
    assert e["trials"] == 3 and backend.paged_fallbacks["rejected"] == 0
    assert calls[-1] == int(e["substrates"]["lanes_cap"])


def test_backend_takes_the_page_size_of_a_restored_registry(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("DBX_SCHEDULE_DIR", str(tmp_path))
    reg = tune.ScheduleRegistry.open_default()
    for i, (plat, pb_) in enumerate((("torch-cpu", "1024"),
                                     ("torch-cpu", "256"),
                                     ("cpu", "256"), ("cpu", "256"))):
        reg.record("sma_crossover", f"t{i}", plat, {"page_bars": pb_})
    compute.TorchSweepBackend(device="cpu")
    assert fused.resolve_page_bars() == 256   # a tie: the smaller
    fused.set_tuned_defaults(None)
    assert fused.resolve_page_bars() == 512
