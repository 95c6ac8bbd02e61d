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


REF = _ref_constants()
TINY = {k: v for k, v in REF["_TINY_ENV"].items()
        if k not in ("DBX_BENCH_CONFIGS", "DBX_BENCH_CACHE")}
# The paged and scenario configs at a tiny size of their own.
TINY.update(DBX_BENCH_RAGGED_TICKERS="16", DBX_BENCH_SCENARIO_BARS="96",
            DBX_BENCH_SCENARIO_N="3", DBX_BENCH_MEGAKERNEL_BARS="64",
            DBX_BENCH_MEGAKERNEL_K="4", DBX_BENCH_LC_BARS="301",
            DBX_BENCH_LC_SHARDS="4")
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
                 "long_context"):
        assert configs[name] > 0.0, name
    assert len(FUSED_CONFIGS) + 7 == 21 == len(bench.CONFIGS)


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
    # The reference bench's keys of the three configs (its dispatcher's
    # e2e and panel-store keys aside: the port has no dispatcher).
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
    s = bench.settings_from_env({**TINY, "DBX_BENCH_CONFIGS": "e2e"})
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
