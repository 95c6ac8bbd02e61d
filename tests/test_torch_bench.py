"""The port's bench (``distributed_backtesting_exploration_tpu_torch.bench``)
run in-process on the CPU at the reference bench test's tiny size: every
config reports a rate, and the roofline stage keys are the reference's,
read from ``tests/test_z_bench_roofline.py`` so that the two cannot drift.

A structure test, not a measurement: on the CPU the bench runs the plain
versions, and its times are the CPU's.
"""

import ast
import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu_torch import bench, roofline
from distributed_backtesting_exploration_tpu_torch.analysis import modelcheck

REF_TEST = Path(__file__).resolve().parent / "test_z_bench_roofline.py"


def _ref_constants() -> dict:
    """The literal module constants of the reference bench's test."""
    out = {}
    for node in ast.parse(REF_TEST.read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def _ref_keys(test_name: str) -> list[tuple]:
    """The key tuples that the reference bench test ``test_name`` loops
    over (``for key in (...)``), in order."""
    for node in ast.parse(REF_TEST.read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name == test_name:
            return [ast.literal_eval(n.iter) for n in ast.walk(node)
                    if isinstance(n, ast.For) and isinstance(n.iter,
                                                             ast.Tuple)
                    and isinstance(n.target, ast.Name)
                    and n.target.id == "key"]
    raise LookupError(test_name)


REF = _ref_constants()
TINY = {k: v for k, v in REF["_TINY_ENV"].items()
        if k not in ("DBX_BENCH_CONFIGS", "DBX_BENCH_CACHE")}
# The paged and scenario configs at a tiny size of their own.
TINY.update(DBX_BENCH_RAGGED_TICKERS="16", DBX_BENCH_SCENARIO_BARS="96",
            DBX_BENCH_SCENARIO_N="3", DBX_BENCH_MEGAKERNEL_BARS="64",
            DBX_BENCH_MEGAKERNEL_K="4", DBX_BENCH_LC_BARS="301",
            DBX_BENCH_LC_SHARDS="4", DBX_BENCH_LOCAL_JOBS="64",
            DBX_BENCH_LOCAL_WORKERS="1,2", DBX_BENCH_DEDUPE_BARS="64",
            DBX_BENCH_FLEET_JOBS="32", DBX_BENCH_FLEET_POLL_S="0.05")
# The reference's control-plane configs at the tiny sizes of its own tests
# (tests/test_z_bench_roofline.py's _FANOUT_ENV, _TENANT_ENV,
# _PLACEMENT_ENV, _PIPELINE_ENV).
TINY.update(DBX_BENCH_QUEUE_JOBS="500", DBX_BENCH_SUB_N="12",
            DBX_BENCH_SUB_SYMBOLS="3", DBX_BENCH_SUB_CONNS="4",
            DBX_BENCH_TENANT_SMALL_JOBS="6", DBX_BENCH_TENANT_WHALE_JOBS="18",
            DBX_BENCH_TENANT_WHALE_COMBOS="16", DBX_BENCH_PL_SCALE="0.25",
            DBX_BENCH_PL_CHAINS="3", DBX_BENCH_PL_LINKS="4",
            DBX_BENCH_PIPELINE_JOBS="8", DBX_BENCH_PIPELINE_BARS="128",
            DBX_BENCH_PIPELINE_FAST="2", DBX_BENCH_PIPELINE_SLOW="2",
            DBX_BENCH_PIPELINE_BATCH="2")
# dbxmc's sweep at the size of the reference's _MC_ENV, and dbxcert's
# families at its _CERTIFY_ENV's.
TINY.update(DBX_BENCH_MC_SCHEDULES="30",
            DBX_BENCH_CERTIFY_FAMILIES="sma_crossover,bollinger")
FUSED_CONFIGS = ("sma_fused", "bollinger_fused", "bollinger_touch_fused",
                 "momentum_fused", "donchian_fused", "donchian_hl_fused",
                 "vwap_fused", "keltner_fused", "stochastic_fused",
                 "rsi_fused", "macd_fused", "trix_fused", "obv_fused",
                 "pairs")


@pytest.fixture(scope="module")
def result():
    """One tiny in-process run of every config, as printed."""
    assert TINY["DBX_BENCH_CPU"] == "1"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(TINY)
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_reference_keys_are_read():
    assert {"SMA_STAGE_KEYS", "BOLL_STAGE_KEYS", "ATTRIBUTION_KEYS",
            "_TINY_ENV"} <= set(REF)
    assert TINY["DBX_BENCH_TICKERS"] == "2"


def test_top_level_keys(result):
    assert {"metric", "value", "unit", "vs_baseline", "configs",
            "roofline", "device"} <= set(result)
    assert result["unit"] == "backtests/sec"
    assert result["value"] == result["configs"]["sma_fused"]
    assert result["vs_baseline"] == result["value"]
    assert result["metric"] == bench.METRIC


def test_every_config_reports_a_positive_rate(result):
    configs = result["configs"]
    for name in FUSED_CONFIGS:
        assert configs[name] > 0.0, name
    assert configs["roofline_stages_full"] > 0.0
    assert configs["roofline_stages_boll_full"] > 0.0
    assert configs["walkforward"] > 0.0
    assert configs["streaming_append"] > 0.0
    for name in ("ragged_paged", "scenario_sweep", "scenario_megakernel",
                 "long_context", "autotune"):
        assert configs[name] > 0.0, name
    # The dispatch loop's configs, through the port's dispatcher.
    for name in ("e2e", "e2e_topk", "e2e_local_w1", "e2e_local_w2",
                 "e2e_local_dedupe_on", "e2e_local_dedupe_off"):
        assert configs[name] > 0.0, name
    dedupe = result["roofline"]["e2e_local"]["dedupe"]
    assert dedupe["wire_bytes_per_job_on"] < dedupe["wire_bytes_per_job_off"]
    # The observability configs, the control plane alone.
    for name in ("fleet_telemetry", "flight"):
        assert configs[name] > 0.0, name
    ft = result["roofline"]["fleet_telemetry"]
    assert ft["all_workers_visible"] and ft["straggler_flagged"]
    assert ft["histogram_merge_exact"] and ft["frame_bytes_p50"] > 0
    fl = result["roofline"]["flight"]
    assert fl["quiet_ok"] and fl["capture_smoke_ok"]
    assert len(FUSED_CONFIGS) + 22 == 36 == len(bench.CONFIGS)


@pytest.mark.parametrize("wf_fused", ["0", "1"], ids=["generic", "fused"])
def test_walkforward_config_runs_either_route(wf_fused):
    # The reference's walk-forward config: generic by default, the fused
    # train sweep with DBX_BENCH_WF_FUSED=1; tickers x combos x windows.
    env = dict(TINY, DBX_BENCH_CONFIGS="walkforward",
               DBX_BENCH_WF_FUSED=wf_fused)
    assert bench.settings_from_env(env).wf_fused == (wf_fused == "1")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(env)
    out = json.loads(buf.getvalue())
    assert set(out["configs"]) == {"walkforward"}
    assert out["configs"]["walkforward"] > 0.0


def test_streaming_append_keys_are_the_references():
    # The reference's streaming A/B keys (tests/test_z_bench_roofline.py
    # `test_streaming_append_keys_present`), at its tiny T and ΔT.
    env = dict(TINY, DBX_BENCH_CONFIGS="streaming_append",
               DBX_BENCH_STREAM_T="192", DBX_BENCH_STREAM_DT="8",
               DBX_BENCH_ITERS="2")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(env)
    out = json.loads(buf.getvalue())
    sa = out["roofline"]["streaming_append"]
    for key in ("bars_base", "delta_bars", "updates", "combos",
                "append_s_per_update", "full_reprice_s_per_update",
                "append_speedup", "wire_bytes_full", "wire_bytes_delta",
                "wire_reduction"):
        assert key in sa, key
    assert (sa["bars_base"], sa["delta_bars"], sa["updates"],
            sa["combos"]) == (192, 8, 3, 32)
    assert sa["append_s_per_update"] > 0.0
    assert sa["full_reprice_s_per_update"] > 0.0
    assert sa["wire_bytes_delta"] < sa["wire_bytes_full"]
    assert out["configs"] == {"streaming_append": pytest.approx(
        1.0 / sa["append_s_per_update"])}


def test_paged_and_scenario_keys_are_the_references(result):
    # The reference bench's keys of the three configs (apart from the
    # panel-store curve that its scenario config reads off a dispatcher's
    # queue; the port's e2e configs are tested above).
    rp = result["roofline"]["ragged_paged"]
    for key in ("tickers", "t_max", "t_min", "total_bars", "uniform_bars",
                "combos", "page_bars", "paged_s_per_sweep",
                "uniform_s_per_sweep", "paged_vs_uniform_ratio", "ratio_ok",
                "launches_dense", "launches_paged", "pad_bars_dense",
                "pad_bars_paged", "pool_bytes", "pool_bytes_per_ticker"):
        assert key in rp, key
    assert (rp["tickers"], rp["combos"], rp["t_max"]) == (16, 32, 64)
    assert rp["pad_bars_paged"] <= rp["pad_bars_dense"]
    sw = result["roofline"]["scenario_sweep"]
    for key in ("panels", "bars", "gen_s_per_panel", "panels_per_s",
                "bar_rate", "digest_deterministic", "panel_bytes",
                "spec_bytes", "spec_wire_reduction"):
        assert key in sw, key
    assert sw["digest_deterministic"] is True
    assert sw["panel_bytes"] == 8 + 20 * 96 > sw["spec_bytes"]
    mk = result["roofline"]["scenario_megakernel"]
    for key in ("scenarios", "bars", "combos", "fused_scn_per_s",
                "materialized_scn_per_s", "speedup", "speedup_min",
                "speedup_max", "fused_s", "materialized_s"):
        assert key in mk, key
    assert mk["speedup_min"] <= mk["speedup_max"]
    assert len(mk["fused_s"]) == len(mk["materialized_s"]) >= 3
    assert [p["k"] for p in mk["by_k_fused"]] == [2, 4]
    assert all(p["peak_device_bytes"] is None for p in mk["by_k_fused"])


def test_sma_stage_keys_are_the_references(result):
    stages = result["roofline"]["sma_stages"]
    for key in REF["SMA_STAGE_KEYS"]:
        assert stages[key] > 0.0, key
    for key in REF["ATTRIBUTION_KEYS"] + ("inline_table_speedup",):
        assert key in stages, key
    assert stages["epilogue_scan_speedup"] > 0.0


def test_bollinger_stage_keys_are_the_references(result):
    stages = result["roofline"]["bollinger_stages"]
    for key in REF["BOLL_STAGE_KEYS"]:
        assert stages[key] > 0.0, key
    for key in REF["ATTRIBUTION_KEYS"] + ("compose_delta_pct",
                                          "compose_ladder_delta_pct"):
        assert key in stages, key


def test_config_roofline_entries_name_no_device_share_off_the_card(result):
    for name in FUSED_CONFIGS:
        entry = result["roofline"][name]
        assert entry["bound"] in ("fp32", "hbm"), name
        assert entry["ops_per_cell_bar"] > 0, name
        # A CPU run gives no share of the H100's peaks.
        assert entry["fp32_util"] is None and entry["hbm_util"] is None


def test_device_is_named_and_no_tpu_figure_is_printed(result):
    assert result["device"] == {"platform": "cpu", "name": "cpu",
                                "power_limit": None, "count": 0}
    text = json.dumps(result).lower()
    for word in ("v5e", "tpu", "mxu", "vpu"):
        assert word not in text, word


def test_utilization_at_a_rate():
    model = roofline.config_model("sma_crossover", 120, 2000, 1260)
    u = roofline.utilization(1e7, 1260, model)
    assert u["bound"] == "fp32"
    assert u["fp32_util"] == pytest.approx(
        1e7 * 1260 * model["ops"] / roofline.PEAK_FP32_OPS)
    assert 0 < u["hbm_util"] < u["fp32_util"]


def test_tile_entries_count_per_window_work_once_per_window():
    # K1's SMA (sub, div) and K2 inline's z (13 ops) are functions of the
    # window: counted once per (ticker, distinct window, bar) from the
    # first bar a lane reads the window, beside the metric update and the
    # per-lane difference and sign (K1) or machine (K2).
    assert roofline.OPS_SIGNAL["fused_sma"] == 2
    assert roofline.OPS_WINDOW["fused_sma"] == 2
    assert roofline.OPS_SIGNAL["band_inline"] == 4
    assert roofline.OPS_WINDOW["band_inline"] == 13
    sma = roofline.config_model("sma_crossover", 120, 2000, 1260)
    boll = roofline.config_model("bollinger", 20, 1000, 1260)
    assert sma["ops"] == pytest.approx(22.12)
    assert boll["ops"] == pytest.approx(24.26)
    # The bounds at the headline, 500 tickers x 1260 bars.
    tr = np.full(500, 1260)
    axes = roofline.bench_axes(2000)
    g = roofline.product(axes["sma_crossover"])
    fast, slow = g["fast"].astype(int), g["slow"].astype(int)
    warm = np.maximum(fast, slow)
    ops = (roofline.OPS_PER_BAR * 500 * 1260 * 2000
           + 2 * roofline.signal_bars(tr, warm)
           + 2 * roofline.window_signal_bars(tr, warm, fast, slow))
    n_bytes = 4 * (2 * 500 * 1260 + 500 + 3 * 2000 + 9 * 500 * 2000)
    assert roofline.bound_ms(ops, n_bytes) == (
        pytest.approx(0.8239, abs=1e-4), "operations")
    win = roofline.product(axes["bollinger"])["window"].astype(int)
    ops = (roofline.OPS_PER_BAR * 500 * 1260 * 1000
           + 4 * roofline.signal_bars(tr, win)
           + 13 * roofline.window_signal_bars(tr, win, win))
    assert roofline.bound_ms(ops, 0.0)[0] == pytest.approx(0.4545, abs=1e-4)


def test_obv_and_momentum_count_their_signal_once_per_window():
    # K6's SMA of the OBV, the difference and its sign, and momentum's
    # price change and its sign are functions of (ticker, window, bar):
    # counted once per distinct window, none per lane beside the update.
    assert roofline.OPS_SIGNAL["obv"] == roofline.OPS_SIGNAL["momentum"] == 0
    assert roofline.OPS_WINDOW["obv"] == 4
    assert roofline.OPS_WINDOW["momentum"] == 2
    # The bench grids: 125 distinct windows over 2000 lanes.
    obv = roofline.config_model("obv_trend", 125, 2000, 1260)
    mom = roofline.config_model("momentum", 125, 2000, 1260)
    assert obv["ops"] == pytest.approx(20.25)
    assert mom["ops"] == pytest.approx(20.125)


def test_window_signal_bars_start_at_the_first_lane_reading_a_window():
    # Window 5 is read from bar 9 (warm 10) by one lane and from bar 2 by
    # another, so from bar 2: 8 bars of a 10-bar ticker and 5 of a 7-bar
    # one; window 12 only from bar 11, past both tickers' ends.
    tr = np.asarray([10, 7])
    warm = np.asarray([10, 3, 12])
    fast = np.asarray([5, 5, 12])
    assert roofline.window_signal_bars(tr, warm, fast) == 8 + 5
    assert roofline.window_signal_bars(tr, warm, fast, fast) == 8 + 5


def test_bench_grids_have_the_reference_sizes():
    sizes = {s: int(np.prod([len(v) for v in ax.values()]))
             for s, ax in roofline.bench_axes(2000).items()}
    assert sizes == {"sma_crossover": 2000, "momentum": 2000,
                     "obv_trend": 2000, "pairs": 500,
                     **{s: 1000 for s in (
                         "bollinger", "bollinger_touch", "donchian",
                         "donchian_hl", "vwap_reversion", "keltner",
                         "stochastic", "rsi", "macd", "trix")}}
    g = roofline.product(roofline.bench_axes(2000)["rsi"])
    # bench.py's rsi grid: the band repeated over the 25 periods.
    np.testing.assert_array_equal(g["period"][:26],
                                  np.r_[np.arange(5, 55, 2), 5])


def test_stage_bounds():
    warm = np.full(2000, 1)
    ms, by = roofline.stage_bound("sma", "touch", N=500, T_pad=1264,
                                  W_pad=120, tr=1260, warm=warm)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * 4 * (500 * 120 * 1264 + 9 * 500 * 2000)
                               / roofline.PEAK_HBM_BYTES)
    ms_full, by = roofline.stage_bound("sma", "full", N=500, T_pad=1264,
                                       W_pad=120, tr=1260, warm=warm)
    assert by == "operations" and ms_full > ms


def test_without_the_cpu_request_the_bench_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    s = bench.settings_from_env({**TINY, "DBX_BENCH_CPU": "0",
                                 "DBX_BENCH_CONFIGS": "sma_fused"})
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run(s)


def test_unknown_configs_stop_the_bench():
    s = bench.settings_from_env({**TINY,
                                 "DBX_BENCH_CONFIGS": "no_such_config"})
    with pytest.raises(SystemExit, match="no configs ran"):
        bench.run(s)


def test_long_context_runs_time_sharded_on_a_mesh_and_generic_without():
    # The reference's long_context config (one history, the 32-combo SMA
    # grid) at a tiny length: over a mesh of 4 CPU shards where one is
    # given, the generic sweep on one device otherwise; the same rates'
    # units (combos a second).
    for shards, route in (("4", "time-sharded over 4 shards"),
                          ("0", "generic sweep on one device")):
        env = dict(TINY, DBX_BENCH_CONFIGS="long_context",
                   DBX_BENCH_LC_SHARDS=shards)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench.main(env)
        out = json.loads(buf.getvalue())
        assert out["configs"]["long_context"] > 0.0
        assert out["roofline"]["long_context"]["route"] == route
        assert out["roofline"]["long_context"]["combos"] == 32


def test_dispatch_loop_counts_only_its_workers_wire_bytes():
    """The loop counts its workers' serialized request and reply bytes on
    their own channels: the module's stub stays the service's, and a stub
    that another caller opens meanwhile is not counted."""
    import grpc

    from distributed_backtesting_exploration_tpu_torch.rpc import (
        backtesting_pb2 as pb, compute, dispatcher, panel_store, service)

    stub_cls = service.DispatcherStub
    recs = dispatcher.synthetic_jobs(
        12, 32, "sma_crossover",
        {"fast": np.arange(5.0, 9.0, dtype=np.float32)}, seed=3)
    with bench.DispatchLoop([compute.InstantBackend()], device="cpu",
                            jobs_per_chip=4, poll_interval_s=0.001) as loop:
        assert service.DispatcherStub is stub_cls
        loop.drain(recs)
        # Every job's panel went out inline, at most 4 to a batch.
        assert loop.wire_bytes("RequestJobs") > sum(len(r.ohlcv)
                                                    for r in recs)
        assert loop.wire_bytes("CompleteJobs") > 0
        assert loop.batches >= 3
        # The instant backend never fetches a payload; an outsider's
        # fetch on a stub of its own stays out of the count.
        assert loop.wire_bytes("FetchPayload") == 0
        digest = panel_store.panel_digest(recs[0].ohlcv)
        with grpc.insecure_channel(f"localhost:{loop.server.port}") as ch:
            rep = service.DispatcherStub(ch).FetchPayload(
                pb.PayloadRequest(worker_id="outsider", digest=digest))
        assert rep.payload == recs[0].ohlcv
        assert loop.wire_bytes("FetchPayload") == 0
    assert service.DispatcherStub is stub_cls


def test_direct_dispatch_keys_are_the_references(result):
    (lockdep_keys,) = _ref_keys("test_direct_dispatch_lockdep_ab_keys_present")
    floor = result["roofline"]["direct_dispatch_floor"]
    assert floor["floor"] == bench.DIRECT_FLOOR == 2000
    assert isinstance(floor["floor_ok"], bool)
    assert floor["wire_bytes_per_job"]["b32"] > 0.0
    assert floor["wire_bytes_per_job"]["b128"] > 0.0
    ld = floor["lockdep"]
    assert set(lockdep_keys) <= set(ld)
    assert ld["batch32_jobs_per_s"] > 0.0 and ld["violations"] == 0
    for b in (32, 128):
        assert result["configs"][f"direct_dispatch_b{b}"] > 0.0


def test_decision_plane_keys_are_the_references(result):
    (keys,) = _ref_keys("test_decision_plane_keys_present")
    dp = result["roofline"]["decision_plane"]
    assert set(keys) <= set(dp)
    assert len(dp["overhead_rounds_pct"]) == 5
    # The synthetic stream's answers are exact: 16 scored, 12 agree.
    assert dp["shadow_scored"] == 16
    assert dp["shadow_agreement_pct"] == 75.0
    assert dp["regret_p95"] >= dp["regret_p50"] >= 0.0
    assert result["configs"]["decision_plane"] > 0.0


def test_placement_keys_are_the_references(result):
    (keys,) = _ref_keys("test_placement_keys_present")
    pl = result["roofline"]["e2e_local_placement"]
    assert set(keys) <= set(pl)
    assert pl["jobs"] > 0 and pl["workers"] == 2
    assert pl["scored_shadow"] > 0 and pl["scored_live"] > 0
    assert set(pl["admit_counts"]) <= {"served", "deferred", "cap"}
    assert pl["admit_counts"]["served"] > 0
    assert 0.0 <= pl["defer_rate"] <= 1.0
    assert result["configs"]["e2e_local_placement"] > 0.0


def test_queue_machine_rates_are_the_references(result):
    # Both substrates, and the C-ABI grain from the port-built binary.
    for name in ("queue_machine_python", "queue_machine_native",
                 "queue_machine_native_cabi"):
        assert result["configs"][name] > 0.0, name


def test_modelcheck_keys_are_the_references(result):
    (keys,) = _ref_keys("test_modelcheck_bench_keys")
    mc = result["roofline"]["modelcheck"]
    assert set(mc) == set(keys)
    n_subs = len(modelcheck.available_substrates())
    assert mc["schedules"] == 30 * n_subs
    assert mc["crash_points"] >= 10 * n_subs
    assert mc["boundaries"] > mc["crash_points"]
    assert mc["violations"] == 0 and mc["wall_s"] > 0.0
    assert result["configs"]["modelcheck"] > 0.0


def test_certify_keys_are_the_references(result):
    """dbxcert's wall a family and for the digest cones, at the reference
    test's two families: 4 rows each and the 3 digest cones."""
    cf = result["roofline"]["certify"]
    for key in ("certify_wall_s", "rows", "wall_s_total"):
        assert key in cf, key
    walls = cf["certify_wall_s"]
    assert set(walls) == {"sma_crossover", "bollinger", "digest"}
    assert all(w > 0.0 for w in walls.values())
    assert cf["rows"] == 2 * 4 + 3
    assert cf["wall_s_total"] > 0.0
    assert result["configs"]["certify"] > 0.0
    assert bench.CONFIGS.index("certify") + 1 == bench.CONFIGS.index(
        "modelcheck")


def test_fanout_keys_are_the_references(result):
    (keys,) = _ref_keys("test_fanout_keys_present")
    fb = result["roofline"]["fanout"]
    assert set(keys) <= set(fb)
    # Exact at any size: 3 ticks, one advance a stream, 12 pushes.
    assert fb["advances_total"] == 3 and fb["advances_per_tick"] == 1.0
    assert fb["advances_eq_streams"] is True
    assert fb["pushes_delivered"] == 12 and fb["pushes_dropped"] == 0
    assert fb["pushes_per_advance"] == 4.0
    assert fb["tick_to_push_p99_s"] > 0.0


def test_tenant_keys_are_the_references(result):
    (keys,) = _ref_keys("test_tenant_fairness_keys_present")
    tb = result["roofline"]["e2e_local_tenants"]
    assert set(keys) <= set(tb)
    assert tb["tenant_p95_queue_wait_solo"] > 0.0
    assert tb["tenant_p95_queue_wait_contended"] > 0.0
    assert set(tb["per_tenant_p95_contended"]) == {"whale", "small_a",
                                                   "small_b"}
    assert result["configs"]["e2e_local_tenants"] > 0.0


def test_pipeline_keys_are_the_references(result):
    (keys,) = _ref_keys("test_pipeline_ab_keys_present")
    pl = result["roofline"]["pipeline"]
    assert set(keys) <= set(pl)
    assert pl["jobs_per_s_serial"] > 0.0 and pl["jobs_per_s_pipelined"] > 0.0
    assert pl["host_stage_ms"] > 0.0 and pl["device_stage_ms"] > 0.0
    assert pl["overlap_factor"] >= 1.0
    assert pl["overlap_factor_serial"] == pytest.approx(1.0, abs=0.25)
    for stages in (pl["stages_serial"], pl["stages_pipelined"]):
        assert stages.get("execute", 0.0) > 0.0
        assert stages.get("d2h", 0.0) > 0.0


def _sweep_counts(monkeypatch) -> dict:
    """Count the generic sweeps' calls through the bench, by param_chunk."""
    calls = {"chunked_sweep": [], "chunked_pairs_sweep": []}
    for mod, name in ((bench.sweep, "chunked_sweep"),
                      (bench.pairs_mod, "chunked_pairs_sweep")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name].append(kw["param_chunk"])
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("name", ["sma_fused", "pairs"])
def test_generic_arm_matches_the_fused_arm(name, monkeypatch):
    # The reference bench's DBX_BENCH_GENERIC=1 A/B: sma_fused on the
    # generic chunked sweep (DBX_BENCH_CHUNK combos a chunk), pairs on
    # chunked_pairs_sweep (50), within the reference's budgets of fused
    # against generic: tests/test_fused.py's rtol=2e-4, atol=2e-5 for sma,
    # its pairs budget (_check_pairs: rtol=2e-3, atol=2e-4, at most
    # max(1, 1%) cells flipped) for pairs.
    from torch_parity import assert_metrics_match

    calls = _sweep_counts(monkeypatch)
    env = dict(TINY, DBX_BENCH_CONFIGS=name, DBX_BENCH_CHUNK="8")
    got = {}
    for generic in ("0", "1"):
        s = bench.settings_from_env(dict(env, DBX_BENCH_GENERIC=generic))
        assert s.generic == (generic == "1") and s.generic_chunk == 8
        got[generic] = bench._Bench(s, torch.device("cpu")).sweep_call(name)()
    assert calls == ({"chunked_sweep": [8], "chunked_pairs_sweep": []}
                     if name == "sma_fused" else
                     {"chunked_sweep": [], "chunked_pairs_sweep": [50]})
    for f in got["0"]._fields:
        assert getattr(got["1"], f).shape == getattr(got["0"], f).shape
    if name == "pairs":
        assert_metrics_match(got["1"], got["0"], rtol=2e-3, atol=2e-4)
    else:
        for f in got["0"]._fields:
            np.testing.assert_allclose(
                getattr(got["1"], f).numpy(), getattr(got["0"], f).numpy(),
                rtol=2e-4, atol=2e-5, err_msg=f)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(dict(env, DBX_BENCH_GENERIC="1"))
    out = json.loads(buf.getvalue())
    assert set(out["configs"]) == {name} and out["configs"][name] > 0.0


def test_without_generic_the_bench_is_as_it_was(result, monkeypatch):
    # With DBX_BENCH_GENERIC unset the settings are the defaults (the
    # generic chunk read but unused), the fused configs call their kernels'
    # sweeps and never a generic one, and the result line has its keys.
    s = bench.settings_from_env({})
    assert s == bench.Settings() and not s.generic
    assert bench.settings_from_env({"DBX_BENCH_CHUNK": "5"}) == \
        bench.Settings(generic_chunk=5)
    calls = _sweep_counts(monkeypatch)
    b = bench._Bench(bench.settings_from_env(TINY), torch.device("cpu"))
    for name in ("sma_fused", "pairs"):
        b.sweep_call(name)()
    assert calls == {"chunked_sweep": [], "chunked_pairs_sweep": []}
    assert set(result["configs"]) >= set(FUSED_CONFIGS)
    assert set(result["roofline"]) >= set(FUSED_CONFIGS)
