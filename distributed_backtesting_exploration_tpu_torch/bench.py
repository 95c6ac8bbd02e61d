"""The port's benchmark: backtests/s of each fused sweep on one card, and
the roofline stage attribution of its SMA and bollinger kernels.

Run on the card from the repository root:

    python -m distributed_backtesting_exploration_tpu_torch.bench

It is the counterpart of the reference's ``bench.py`` for the configs the
port serves: the 14 fused sweeps (``sma_fused`` the headline: 500 tickers x
1260 daily bars x a 2000-combo SMA-crossover grid) with the reference's
grids, ``roofline_stages``, the stage scaffolds of K8 (``ops/stages.py``),
and ``walkforward``, the reference's walk-forward config (the bars' second
half less 30 as the train span, 12 refit windows, the 400-combo SMA grid
fast 5..24 x slow 30..125 step 5; backtests are tickers x combos x
windows), on the generic ``walk_forward``, or with ``DBX_BENCH_WF_FUSED=1``
on ``walk_forward_fused`` with K1 as its train sweep, and
``streaming_append``, the reference's streaming A/B: one ticker (seed 77)
of ``DBX_BENCH_STREAM_T`` bars (8192) on the 32-combo SMA grid fast 5..12
x slow 30..42 step 4, each update a ``DBX_BENCH_STREAM_DT``-bar slice (16)
priced by advancing the carry checkpoint
(``streaming.recurrent.append_step``) against a full scan-form reprice of
the whole T + ΔT bars; its rate is updates/s of the append, and its
``roofline`` entry the seconds an update of each, their ratio and the wire
bytes of a delta against the whole panel. Then the reference's paged and
scenario configs: ``ragged_paged``, ``DBX_BENCH_RAGGED_TICKERS`` tickers
(1024) of lengths log-spaced from max(bars / 8, 64) to the bars, on the
32-combo SMA grid, through the page pool (``fused.fused_paged_sweep``, one
launch a page-count bin) against one uniform sweep of the same total bars,
with the dense route's power-of-two buckets beside the paged bins, the pad
bars each computes (bars past a ticker's length up to its bucket's or
bin's longest) and the pool's bytes a ticker; ``scenario_sweep``, the
generator alone: ``DBX_BENCH_SCENARIO_N`` (32) panels of
``DBX_BENCH_SCENARIO_BARS`` (2048) bars of one base (seed 900; block 16, 3
regimes, vol_scale 2, shock 0.01) as DBX1 bytes one spec at a time, and in
one batch, panels/s and bars/s, determinism, and a panel's bytes against a
spec's; ``scenario_megakernel``, ``DBX_BENCH_MEGAKERNEL_K`` (48) specs of
``DBX_BENCH_MEGAKERNEL_BARS`` (512) bars (seed 910) on the 16-combo SMA grid
fast 3..6 x slow 12..36 step 8 as one carrier job through
``TorchSweepBackend.process`` on the fused route and with
``DBX_SCENARIO_FUSED=0`` (the materialized rung), scenarios/s of each (the
median of ``max(DBX_BENCH_ITERS // 2, 3)`` legs at K a route, the routes
alternating, with the speedup of each pair of legs) and the peak device
bytes of each at K/4, K/2 and K; ``long_context``, the reference's
long-context config: one history of ``DBX_BENCH_LC_BARS`` (65537) bars on
the 32-combo SMA grid fast 5..12 x slow 30..60 step 10, time-sharded over
a mesh (``DBX_BENCH_LC_SHARDS=n`` shards of the bench's one device, or
every GPU of a host with two or more) or else the generic sweep on one
device; ``autotune``, the reference's autotune config: (a) for its
families (sma_crossover, bollinger, momentum, stochastic, obv_trend) on
the bench panel and grids, the autotuner's measured winner of the tile
width (``tune.Autotuner``, ``DBX_AUTOTUNE_REPS``), s a sweep at the
defaults and at the winner, and the measured and modeled speedups
(momentum and stochastic run no tiles: no knob, winner None); (b) the
build wall of a second worker: ``AUTOTUNE_LIB`` (``fused_sma``) built by
``nvcc`` into an empty directory (cold) against installed from a
``tune.CompileStore`` that the first worker offered it to and loaded
(fleet-warm). The offer and the fetch go in-process through the store,
not over the dispatcher's RPCs. Half (b) needs ``nvcc`` and does not run
on the CPU. Part (c), ``width_by_rows``: the six tile families (K1, K2 inline, K4, K5, K6,
K7) on the first 8, 32 and 128 rows of the bench panel and on all of it,
at the shipped CTA width and each narrower width of the ladder, in
interleaved rounds: the wall of a sweep (CUDA events around back-to-back
runs) and the device time of its tile kernel (``torch.profiler``), so
whether a narrower tile pays where few rows leave SMs idle. Then the
reference's dispatch-loop configs, through the port's dispatcher
(:class:`DispatchLoop`, loopback gRPC): ``e2e``, backtests/s of
``DBX_BENCH_TICKERS`` sma jobs a drain on a 20 x ``DBX_BENCH_PARAMS // 20``
grid through one port worker (``jobs_per_chip=100``, polling every 5 ms),
and ``e2e_topk``, the same with ``top_k=16``; ``e2e_local``, the control
plane alone: port workers with ``compute.InstantBackend``, jobs/s and wire
bytes a job at each count of ``DBX_BENCH_LOCAL_WORKERS`` (1,2,4) over
``DBX_BENCH_LOCAL_JOBS`` (1500) jobs, and dispatch by digest on and off
over jobs sharing one ``DBX_BENCH_DEDUPE_BARS``-bar panel (4096). It prints
one JSON line to
stdout with the reference's top-level keys:

    {"metric": ..., "value": N, "unit": "backtests/sec", "vs_baseline": N,
     "configs": {name: rate, ...}, "roofline": {...}, "device": {...}}

``roofline`` holds ``sma_stages`` and ``bollinger_stages`` (seconds per
sweep of each stage and the attribution the reference derives from them)
and, per config, its shares of the H100's fp32 and memory peaks
(:mod:`.roofline`); ``device`` the card's name and power limit. The
reference's baseline is 1 backtest/s, so ``vs_baseline`` is the rate.

Method, as the reference's: the first call (here the kernel build) is
excluded, then ``DBX_BENCH_WARMUP`` calls, then ``DBX_BENCH_ITERS`` timed
calls whose sharpe sums chain into one device accumulator, synchronized
once at the end. The panel is made from seed 0 (pairs: seed 1, 2 legs a
pair) and put on the device before timing. Unlike the reference, whose
stage calls each rebuild their table, the stage kernels here are timed on
tables built once: the table build is its own case, ``prep``.

The port has one kernel design per family, a sequential pass per lane, so
the reference's substrate A/Bs (``full_ladder``, ``signal_ladder``,
``table_hbm``/``table_inline``, ``epilogue_ladder``/``epilogue_scan``) run
the same code on both sides and their ratios read about 1 by construction.

Environment: ``DBX_BENCH_TICKERS`` (500), ``DBX_BENCH_BARS`` (1260),
``DBX_BENCH_PARAMS`` (2000), ``DBX_BENCH_ITERS`` (10),
``DBX_BENCH_WARMUP`` (12), ``DBX_BENCH_CONFIGS`` (a comma list, default
all), ``DBX_BENCH_WF_FUSED=1``, ``DBX_BENCH_STREAM_T`` (8192),
``DBX_BENCH_STREAM_DT`` (16), the paged and scenario sizes above,
``DBX_PAGE_BARS`` (512) and ``DBX_BENCH_CPU=1``, the explicit
request to run the plain versions on the CPU (a structure check; its
times are the CPU's). Without it the bench runs on CUDA and raises where
there is no card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import device as device_mod
from . import roofline, tune
from .models import get_strategy
from .ops import _kernels, fused, stages
from .parallel import sharding, sweep, timeshard, walkforward
from .rpc import backtesting_pb2 as pb
from .rpc import compute, panel_store, wire
from .rpc.page_pool import PagePool
from .scenarios import synth
from .streaming import recurrent as stream_rc
from .utils import data

COST = 1e-3
HEADLINE = "sma_fused"
METRIC = ("backtests/sec/chip (ticker x param combos), SMA-crossover sweep, "
          "5y daily bars")

# Bench config -> (strategy, sweep, panel fields, grid axes in the sweep's
# argument order); the grids are the reference bench's
# (roofline.bench_axes). pairs takes two close legs.
FUSED = {
    "sma_fused": ("sma_crossover", fused.fused_sma_sweep, ("close",),
                  ("fast", "slow")),
    "bollinger_fused": ("bollinger", fused.fused_bollinger_sweep,
                        ("close",), ("window", "k")),
    "bollinger_touch_fused": ("bollinger_touch",
                              fused.fused_bollinger_touch_sweep, ("close",),
                              ("window", "k")),
    "momentum_fused": ("momentum", fused.fused_momentum_sweep, ("close",),
                       ("lookback",)),
    "donchian_fused": ("donchian", fused.fused_donchian_sweep, ("close",),
                       ("window",)),
    "donchian_hl_fused": ("donchian_hl", fused.fused_donchian_hl_sweep,
                          ("close", "high", "low"), ("window",)),
    "vwap_fused": ("vwap_reversion", fused.fused_vwap_sweep,
                   ("close", "volume"), ("window", "k")),
    "keltner_fused": ("keltner", fused.fused_keltner_sweep,
                      ("close", "high", "low"), ("window", "k")),
    "stochastic_fused": ("stochastic", fused.fused_stochastic_sweep,
                         ("close", "high", "low"), ("window", "band")),
    "rsi_fused": ("rsi", fused.fused_rsi_sweep, ("close",),
                  ("period", "band")),
    "macd_fused": ("macd", fused.fused_macd_sweep, ("close",),
                   ("fast", "slow", "signal")),
    "trix_fused": ("trix", fused.fused_trix_sweep, ("close",),
                   ("span", "signal")),
    "obv_fused": ("obv_trend", fused.fused_obv_sweep, ("close", "volume"),
                  ("window",)),
    "pairs": ("pairs", fused.fused_pairs_sweep, None,
              ("lookback", "z_entry")),
}
# The reference bench's order: roofline_stages second, walkforward after
# the fused sweeps.
CONFIGS = ("sma_fused", "roofline_stages", *list(FUSED)[1:], "walkforward",
           "streaming_append", "ragged_paged", "scenario_sweep",
           "scenario_megakernel", "long_context", "autotune", "e2e",
           "e2e_topk", "e2e_local")
# The worker RPCs whose serialized request and reply bytes count as its
# wire bytes (the reference's dbx_worker_wire_bytes_total methods).
WIRE_METHODS = ("RequestJobs", "CompleteJobs", "FetchPayload")
# The reference bench's autotune families, as bench configs.
AUTOTUNE_CONFIGS = ("sma_fused", "bollinger_fused", "momentum_fused",
                    "stochastic_fused", "obv_fused")
# Part (c) of autotune: the tile families' configs, and the group sizes
# (rows) beside the bench's own.
TILE_CONFIGS = ("sma_fused", "bollinger_fused", "macd_fused", "trix_fused",
                "obv_fused", "pairs")
WIDTH_ROWS = (8, 32, 128)
# Part (b) of autotune: the library a second worker builds or installs.
AUTOTUNE_LIB = "fused_sma"
_WINDOW_AXES = {"fast", "slow", "window", "lookback", "period", "span"}

# (stage, lanes) cases of the SMA scaffold (the reference's bench.py
# roofline_stages list) and the bollinger scaffold's stages (at 128 lanes).
SMA_CASES = (("prep", 128), ("touch", 128), ("matmul", 128),
             ("signal", 128), ("no_ladders", 128), ("full", 128),
             ("full_ladder", 128), ("full", 256), ("full", 512),
             ("full", 1024), ("no_ladders", 512))
BOLL_CASES = tuple((s, 128) for s in stages.BOLL_STAGES)


class Settings(NamedTuple):
    n_tickers: int = 500
    n_bars: int = 1260
    n_params: int = 2000
    iters: int = 10
    warmup: int = 12
    configs: frozenset | None = None
    cpu: bool = False
    wf_fused: bool = False
    stream_bars: int = 8192
    stream_delta: int = 16
    ragged_tickers: int = 1024
    scenario_bars: int = 2048
    scenario_n: int = 32
    megakernel_bars: int = 512
    megakernel_k: int = 48
    lc_bars: int = 65537
    lc_shards: int = 0          # long_context's shards of the one device
    local_jobs: int = 1500
    local_workers: tuple = (1, 2, 4)
    dedupe_bars: int = 4096


def settings_from_env(env) -> Settings:
    only = env.get("DBX_BENCH_CONFIGS")
    return Settings(
        n_tickers=int(env.get("DBX_BENCH_TICKERS", 500)),
        n_bars=int(env.get("DBX_BENCH_BARS", 1260)),
        n_params=int(env.get("DBX_BENCH_PARAMS", 2000)),
        iters=int(env.get("DBX_BENCH_ITERS", 10)),
        warmup=int(env.get("DBX_BENCH_WARMUP", 12)),
        configs=frozenset(only.split(",")) if only else None,
        cpu=env.get("DBX_BENCH_CPU") == "1",
        wf_fused=env.get("DBX_BENCH_WF_FUSED") == "1",
        stream_bars=int(env.get("DBX_BENCH_STREAM_T", 8192)),
        stream_delta=int(env.get("DBX_BENCH_STREAM_DT", 16)),
        ragged_tickers=int(env.get("DBX_BENCH_RAGGED_TICKERS", 1024)),
        scenario_bars=int(env.get("DBX_BENCH_SCENARIO_BARS", 2048)),
        scenario_n=int(env.get("DBX_BENCH_SCENARIO_N", 32)),
        megakernel_bars=int(env.get("DBX_BENCH_MEGAKERNEL_BARS", 512)),
        megakernel_k=max(int(env.get("DBX_BENCH_MEGAKERNEL_K", 48)), 4),
        lc_bars=int(env.get("DBX_BENCH_LC_BARS", 65537)),
        lc_shards=int(env.get("DBX_BENCH_LC_SHARDS", 0)),
        local_jobs=int(env.get("DBX_BENCH_LOCAL_JOBS", 1500)),
        local_workers=tuple(int(x) for x in env.get(
            "DBX_BENCH_LOCAL_WORKERS", "1,2,4").split(",")),
        dedupe_bars=int(env.get("DBX_BENCH_DEDUPE_BARS", 4096)))


def device_info(dev: torch.device) -> dict:
    """The device a run measured: for a card its name, ``nvidia-smi``'s
    power limit (None where it gives none) and the card count."""
    if dev.type == "cpu":
        return {"platform": "cpu", "name": "cpu", "power_limit": None,
                "count": 0}
    limit = None
    try:
        smi = subprocess.run(
            ["nvidia-smi", "-i", str(dev.index or 0),
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        fields = smi.stdout.strip().split(",")
        if smi.returncode == 0 and len(fields) == 2:
            limit = fields[1].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "name": torch.cuda.get_device_name(dev),
            "power_limit": limit, "count": torch.cuda.device_count()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _event_ms(run: Callable[[], torch.Tensor], n: int) -> float:
    """CUDA-event ms a call of ``run`` over ``n`` back-to-back calls after
    one untimed call, the device synchronized before and after."""
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def _measure(run: Callable[[], torch.Tensor], n_backtests: int, *,
             iters: int, warmup: int, name: str, dev: torch.device) -> float:
    """Backtests/s of ``run`` (returning its (N, P) sharpe or stage row):
    the first call (the build) and ``warmup`` calls untimed, then ``iters``
    calls chained into one accumulator, synchronized once."""
    t0 = time.perf_counter()
    first = run()
    if not bool(torch.isfinite(first).all()):
        raise RuntimeError(f"{name}: non-finite output")
    build_s = time.perf_counter() - t0
    acc = torch.zeros((), dtype=torch.float64, device=dev)
    for _ in range(warmup):
        acc = acc + run().sum()
    _sync(dev)
    t0 = time.perf_counter()
    acc = torch.zeros((), dtype=torch.float64, device=dev)
    for _ in range(iters):
        acc = acc + run().sum()
    total = float(acc)   # the synchronizing fetch
    elapsed = time.perf_counter() - t0
    if not np.isfinite(total):
        raise RuntimeError(f"{name}: non-finite accumulator")
    rate = n_backtests * iters / elapsed
    print(f"bench[{name}]: first call {build_s:.3f}s, {iters}x "
          f"{n_backtests} backtests in {elapsed:.6f}s -> {rate / 1e6:.4f}M/s",
          file=sys.stderr)
    return rate


def _attribution(times: dict, full_key: str = "full_l128") -> dict:
    """The reference's consecutive-delta attribution of stage times."""
    full_s = times[full_key]
    out = {
        "selection_matmul_pct": 100 * times["matmul_l128"] / full_s,
        "signal_delta_pct": 100 * (times["signal_l128"]
                                   - times["matmul_l128"]) / full_s,
        "reductions_delta_pct": 100 * (times["no_ladders_l128"]
                                       - times["signal_l128"]) / full_s,
        "ladders_delta_pct": 100 * (full_s - times["no_ladders_l128"])
        / full_s,
    }
    if "full_ladder_l128" in times:
        out["ladder_fallback_delta_pct"] = 100 * (
            times["full_ladder_l128"] - times["no_ladders_l128"]) / times[
                "full_ladder_l128"]
        out["epilogue_scan_speedup"] = times["full_ladder_l128"] / full_s
    return out


class _Bench:
    def __init__(self, s: Settings, dev: torch.device):
        self.s, self.dev = s, dev
        self.rates: dict[str, float] = {}
        self.roofline: dict = {}
        panel = data.synthetic_ohlcv(s.n_tickers, s.n_bars, seed=0)
        self.panel = {f: torch.as_tensor(getattr(panel, f), device=dev)
                      for f in data._FIELDS}
        self.axes = roofline.bench_axes(s.n_params)
        _sync(dev)

    def measure(self, run, n_backtests, name):
        return _measure(run, n_backtests, name=name, dev=self.dev,
                        iters=self.s.iters, warmup=self.s.warmup)

    def grid(self, strategy: str) -> dict[str, np.ndarray]:
        return roofline.product(self.axes[strategy])

    def fused_config(self, name: str) -> None:
        strategy, sweep, names, inputs = self._inputs(name)
        g = self.grid(strategy)
        P = len(g[names[0]])
        n_rows = int(inputs[0].shape[0])
        iters, warmup = self.s.iters, self.s.warmup
        if FUSED[name][2] is None:
            # bench.py's pairs: fewer runs.
            iters, warmup = max(iters // 2, 3), max(warmup // 3, 2)
        args = inputs + tuple(g[n] for n in names)
        _sync(self.dev)
        rate = _measure(
            lambda: sweep(*args, cost=COST, device=self.dev).sharpe,
            n_rows * P, name=name, dev=self.dev, iters=iters, warmup=warmup)
        self.rates[name] = rate
        n_distinct = np.unique(np.concatenate(
            [g[n] for n in names if n in _WINDOW_AXES])).size
        # macd forms its line once per distinct (fast, slow) pair.
        n_series = (np.unique(np.stack([g["fast"], g["slow"]]), axis=1)
                    .shape[1] if strategy == "macd" else None)
        self.roofline[name] = roofline.utilization(
            rate if self.dev.type == "cuda" else None, self.s.n_bars,
            roofline.config_model(strategy, n_distinct, P, self.s.n_bars,
                                  n_series))

    def _stage_times(self, kind: str, cases, a, b) -> dict[str, float]:
        close = self.panel["close"]
        make, stage_fn = ((stages.sma_stage_inputs, stages.sma_stage)
                          if kind == "sma" else
                          (stages.boll_stage_inputs, stages.boll_stage))
        inp = make(close, a, b, device=self.dev)
        n_bt = self.s.n_tickers * len(a)
        times = {}
        for stage, lanes in cases:
            if stage == "prep":
                def run():
                    return stages.prep_value(make(close, a, b,
                                                  device=self.dev))
            else:
                def run(stage=stage, lanes=lanes):
                    return stage_fn(inp, stage=stage, lanes=lanes)[0]
            rate = self.measure(run, n_bt, f"{kind}_stage_{stage}_l{lanes}")
            times[f"{stage}_l{lanes}"] = n_bt / rate
        return times

    def _sweep_time(self, sweep, args, n_bt, name, **kw) -> float:
        rate = self.measure(
            lambda: sweep(*args, cost=COST, device=self.dev, **kw).sharpe,
            n_bt, name)
        return n_bt / rate

    def roofline_stages(self) -> None:
        close = self.panel["close"]
        g = self.grid("sma_crossover")
        fast, slow = g["fast"], g["slow"]
        n_bt = self.s.n_tickers * len(fast)
        p_pad = -(-len(fast) // 128) * 128
        # Lane counts the padded grid does not fill are skipped, as the
        # reference skips them.
        cases = [(st, n) for st, n in SMA_CASES
                 if p_pad >= n and p_pad % n == 0]
        times = self._stage_times("sma", cases, fast, slow)
        attr = _attribution(times)
        if "full_l512" in times:
            attr["wide_block_speedup_l512"] = (times["full_l128"]
                                               / times["full_l512"])
        for mode in ("hbm", "inline"):
            times[f"table_{mode}"] = self._sweep_time(
                fused.fused_sma_sweep, (close, fast, slow), n_bt,
                f"sma_table_{mode}", table=mode)
        attr["inline_table_speedup"] = (times["table_hbm"]
                                        / times["table_inline"])
        for mode in ("ladder", "scan"):
            times[f"epilogue_{mode}"] = self._sweep_time(
                fused.fused_sma_sweep, (close, fast, slow), n_bt,
                f"sma_epilogue_{mode}", epilogue=mode)
        attr["epilogue_e2e_speedup"] = (times["epilogue_ladder"]
                                        / times["epilogue_scan"])
        self.roofline["sma_stages"] = {
            **{f"{k}_s_per_sweep": v for k, v in times.items()}, **attr}
        self.rates["roofline_stages_full"] = n_bt / times["full_l128"]
        print(f"bench[roofline_stages]: attribution {attr}", file=sys.stderr)

        bg = self.grid("bollinger")
        window, k = bg["window"], bg["k"]
        b_bt = self.s.n_tickers * len(window)
        btimes = self._stage_times("boll", BOLL_CASES, window, k)
        battr = _attribution(btimes)
        battr["compose_delta_pct"] = 100 * (
            btimes["signal_l128"] - btimes["matmul_l128"]) / btimes[
                "full_l128"]
        battr["compose_ladder_delta_pct"] = 100 * (
            btimes["signal_ladder_l128"] - btimes["matmul_l128"]) / btimes[
                "full_l128"]
        for mode in ("ladder", "scan"):
            btimes[f"epilogue_{mode}"] = self._sweep_time(
                fused.fused_bollinger_sweep, (close, window, k), b_bt,
                f"boll_epilogue_{mode}", epilogue=mode)
        battr["epilogue_e2e_speedup"] = (btimes["epilogue_ladder"]
                                         / btimes["epilogue_scan"])
        self.roofline["bollinger_stages"] = {
            **{f"{k}_s_per_sweep": v for k, v in btimes.items()}, **battr}
        self.rates["roofline_stages_boll_full"] = b_bt / btimes["full_l128"]
        print(f"bench[roofline_stages/bollinger]: attribution {battr}",
              file=sys.stderr)


    def walkforward(self) -> None:
        """The reference bench's walk-forward config at this panel."""
        n_bars = self.s.n_bars
        train = n_bars // 2 - 30
        test = max((n_bars - train) // 12, 1)
        grid = sweep.product_grid(fast=np.arange(5, 25, dtype=np.float32),
                                  slow=np.arange(30, 130, 5, dtype=np.float32))
        n_windows = (n_bars - train) // test
        panel = data.OHLCV(*(self.panel[f] for f in data._FIELDS))
        kw = dict(train=train, test=test, cost=COST, device=self.dev)
        strategy = get_strategy("sma_crossover")
        if self.s.wf_fused:
            fast, slow = grid["fast"].numpy(), grid["slow"].numpy()

            def run():
                return walkforward.walk_forward_fused(
                    panel, strategy, grid,
                    lambda close: fused.fused_sma_sweep(
                        close, fast, slow, cost=COST, device=self.dev),
                    **kw).oos_metrics.sharpe
        else:
            def run():
                return walkforward.walk_forward(
                    panel, strategy, grid, **kw).oos_metrics.sharpe
        self.rates["walkforward"] = _measure(
            run, self.s.n_tickers * sweep.grid_size(grid) * n_windows,
            iters=max(self.s.iters // 2, 3),
            warmup=max(self.s.warmup // 3, 2), name="walkforward",
            dev=self.dev)

    def long_context(self) -> None:
        """The reference bench's long-context config: one history of
        ``lc_bars`` bars (seed 7) on the 32-combo SMA grid fast 5..12 x
        slow 30..60 step 10, cost 1e-3; on a mesh (``lc_shards`` shards of
        the bench's device, or every GPU of a host with two or more) each
        combo one time-sharded backtest
        (:func:`~.parallel.timeshard.sharded_sma_backtest`, the bars
        right-padded to a mesh multiple with their real length passed),
        else the generic sweep on the bench's device. Backtests are
        combos."""
        bars = self.s.lc_bars
        mesh = None
        if self.s.lc_shards > 0:
            mesh = sharding.make_mesh([self.dev] * self.s.lc_shards)
        elif self.dev.type == "cuda" and torch.cuda.device_count() > 1:
            mesh = sharding.make_mesh()
        grid = sweep.product_grid(fast=np.arange(5, 13, dtype=np.float32),
                                  slow=np.arange(30, 70, 10,
                                                 dtype=np.float32))
        P = sweep.grid_size(grid)
        panel = data.synthetic_ohlcv(1, bars, seed=7)
        if mesh is not None and mesh.size > 1:
            tmesh = sharding.Mesh(mesh.devices, timeshard.TIME_AXIS)
            T_pad = -(-bars // tmesh.size) * tmesh.size
            close = torch.as_tensor(np.concatenate(
                [panel.close, np.repeat(panel.close[:, -1:], T_pad - bars,
                                        axis=1)], axis=1),
                device=tmesh.devices[0])
            combos = [(int(f), int(s)) for f, s in zip(grid["fast"],
                                                        grid["slow"])]
            t_real = None if T_pad == bars else bars

            def run():
                return torch.stack([timeshard.sharded_sma_backtest(
                    tmesh, close, f, s, cost=COST, t_real=t_real).sharpe
                    for f, s in combos], dim=-1)
            route = f"time-sharded over {tmesh.size} shards"
        else:
            fields = data.OHLCV(*(torch.as_tensor(f, device=self.dev)
                                  for f in panel))
            strategy = get_strategy("sma_crossover")

            def run():
                return sweep.run_sweep(fields, strategy, grid, cost=COST,
                                       device=self.dev).sharpe
            route = "generic sweep on one device"
        self.rates["long_context"] = _measure(
            run, P, iters=max(self.s.iters // 2, 3),
            warmup=max(self.s.warmup // 3, 2), name="long_context",
            dev=self.dev)
        self.roofline["long_context"] = {
            "bars": bars, "combos": P, "route": route,
            "s_per_sweep": P / self.rates["long_context"]}

    def streaming_append(self) -> None:
        """The reference bench's streaming A/B: the same ΔT-bar update
        priced by the append (the carry advanced, its metrics finalized and
        fetched) and by a full reprice of the T + ΔT bars, each timed over
        ``updates`` updates after one warm-up of both."""
        T, D = self.s.stream_bars, self.s.stream_delta
        updates = max(min(self.s.iters, 10), 3)
        grid = {k: v.numpy() for k, v in sweep.product_grid(
            fast=np.arange(5.0, 13.0, dtype=np.float32),
            slow=np.arange(30.0, 46.0, 4.0, dtype=np.float32)).items()}
        close = torch.as_tensor(data.synthetic_ohlcv(
            1, T + D * (updates + 1), seed=77).close, device=self.dev)
        kw = dict(device=self.dev)

        def full():
            return stream_rc.finalize(stream_rc.build_carry(
                "sma_crossover", {"close": close[:, :T + D]}, grid,
                **kw)).sharpe.cpu()

        carry0 = stream_rc.build_carry("sma_crossover",
                                       {"close": close[:, :T]}, grid, **kw)
        stream_rc.finalize(stream_rc.append_step(
            carry0, {"close": close[:, T:T + D]})).sharpe.cpu()
        full()
        t0 = time.perf_counter()
        c = carry0
        for i in range(updates):
            lo = T + i * D
            c = stream_rc.append_step(c, {"close": close[:, lo:lo + D]})
            stream_rc.finalize(c).sharpe.cpu()      # the served result
        t_append = (time.perf_counter() - t0) / updates
        t0 = time.perf_counter()
        for _ in range(updates):
            full()
        t_full = (time.perf_counter() - t0) / updates
        wire_full = 8 + 4 * 5 * (T + D)     # DBX1: magic, T, 5 f32 rows
        wire_delta = 8 + 4 * 5 * D
        self.roofline["streaming_append"] = {
            "bars_base": T, "delta_bars": D, "updates": updates,
            "combos": int(grid["fast"].size),
            "append_s_per_update": t_append,
            "full_reprice_s_per_update": t_full,
            "append_speedup": t_full / t_append,
            "wire_bytes_full": wire_full, "wire_bytes_delta": wire_delta,
            "wire_reduction": wire_full / wire_delta}
        self.rates["streaming_append"] = 1.0 / t_append
        print(f"bench[streaming_append]: T={T} dT={D} P={grid['fast'].size}:"
              f" append {t_append * 1e3:.3f} ms/update vs full reprice "
              f"{t_full * 1e3:.3f} ms -> {t_full / t_append:.2f}x (wire "
              f"{wire_full}B -> {wire_delta}B)", file=sys.stderr)


    def ragged_paged(self) -> None:
        """The reference's ``ragged_paged``: a log-spaced mixed-length
        fleet swept from the page pool against one uniform dense sweep of
        the same total bars."""
        n, t_max = self.s.ragged_tickers, self.s.n_bars
        B = fused.resolve_page_bars()
        lens = np.unique(np.round(np.geomspace(
            max(t_max / 8, 64), t_max, n)).astype(np.int64))
        lens = np.sort(np.resize(lens, n))
        total = int(lens.sum())
        t_uni = max(total // n, 64)
        grid = {k: v.numpy() for k, v in sweep.product_grid(
            fast=np.arange(5.0, 13.0, dtype=np.float32),
            slow=np.arange(30.0, 46.0, 4.0, dtype=np.float32)).items()}
        P = int(grid["fast"].size)
        panel = data.synthetic_ohlcv(n, t_max, seed=11)
        series = [data.OHLCV(*(np.asarray(f)[i, :t] for f in panel))
                  for i, t in enumerate(lens)]
        pool = PagePool(device=self.dev,
                        max_bytes=2 * n * -(-t_max // B) * B * 4)
        prep = pool.prepare([f"rp{i}" for i in range(n)], series, ("close",))
        if prep is None:
            raise SystemExit("bench[ragged_paged]: the page pool rejected "
                             "the fleet")
        pool_arr, tables, _ = prep
        t_real = lens.astype(np.int32)
        close = torch.as_tensor(panel.close[:, :t_uni], device=self.dev)

        def paged():
            return fused.fused_paged_sweep("sma_crossover", pool_arr, tables,
                                           t_real, grid, cost=COST).sharpe

        def uniform():
            return fused.fused_sma_sweep(close, grid["fast"], grid["slow"],
                                         cost=COST, device=self.dev).sharpe

        kw = dict(iters=max(min(self.s.iters, 5), 2),
                  warmup=max(min(self.s.warmup, 2), 1), dev=self.dev)
        t_paged = n * P / _measure(paged, n * P, name="ragged_paged", **kw)
        t_uni_s = n * P / _measure(uniform, n * P,
                                   name="ragged_paged_uniform", **kw)
        # The dense route's counterfactual: power-of-two buckets of the
        # DBX1 wire length (8 + 20 T bytes), each padded to its longest.
        buckets: dict[int, list[int]] = {}
        for t in lens.tolist():
            buckets.setdefault((8 + 20 * t).bit_length(), []).append(t)
        pad_dense = sum(max(ts) * len(ts) - sum(ts)
                        for ts in buckets.values())
        pages = -(-lens // B)
        bins = np.unique(pages)
        pad_paged = int(sum(lens[pages == p].max() * (pages == p).sum()
                            - lens[pages == p].sum() for p in bins))
        st = pool.stats()
        ratio = t_paged / t_uni_s
        self.roofline["ragged_paged"] = {
            "tickers": n, "t_max": int(lens.max()), "t_min": int(lens.min()),
            "total_bars": total, "uniform_bars": t_uni, "combos": P,
            "page_bars": B, "paged_s_per_sweep": t_paged,
            "uniform_s_per_sweep": t_uni_s,
            "paged_vs_uniform_ratio": ratio, "ratio_ok": ratio <= 1.3,
            "launches_dense": len(buckets), "launches_paged": int(bins.size),
            "pad_bars_dense": int(pad_dense), "pad_bars_paged": pad_paged,
            "pool_bytes": st["bytes"],
            "pool_bytes_per_ticker": st["bytes"] / n}
        self.rates["ragged_paged"] = n * P / t_paged
        print(f"bench[ragged_paged]: {n} tickers x {P} combos, lengths "
              f"{int(lens.min())}..{int(lens.max())} (B={B}): paged/uniform "
              f"{ratio:.3f}x, launches {len(buckets)} dense -> {bins.size} "
              f"paged, pad bars {pad_dense} -> {pad_paged}", file=sys.stderr)

    def scenario_sweep(self) -> None:
        """The generator half of the reference's ``scenario_sweep``: panels
        generated as DBX1 bytes one spec at a time (and in one batch),
        their determinism, and a panel's bytes against a spec's."""
        T, n = self.s.scenario_bars, self.s.scenario_n
        base = data.synthetic_ohlcv(1, T, seed=900)
        blob = data.to_wire_bytes(data.OHLCV(*(f[0] for f in base)))
        p0 = synth.ScenarioParams(block=16, regimes=3, vol_scale=2.0,
                                  shock=0.01)
        kw = dict(device=self.dev)
        synth.scenario_panel_bytes(blob, p0, **kw)     # warm
        t0 = time.perf_counter()
        blobs = [synth.scenario_panel_bytes(
            blob, dataclasses.replace(p0, seed=i), **kw) for i in range(n)]
        gen_s = time.perf_counter() - t0
        deterministic = synth.scenario_panel_bytes(
            blob, dataclasses.replace(p0, seed=0), **kw) == blobs[0]
        digest = panel_store.panel_digest(blob)
        words = [synth.seed_words(synth.scenario_seed(
            digest, dataclasses.replace(p0, seed=i))) for i in range(n)]
        t0 = time.perf_counter()
        for _, rows in synth.generate_rows(
                data.from_wire_bytes(blob)._asdict(),
                [w[0] for w in words], [w[1] for w in words], [2.0] * n,
                [0.01] * n, n_bars=T, block=16, regimes=3, **kw):
            rows["close"].sum().item()
        batch_s = time.perf_counter() - t0
        spec_bytes = 32 + pb.ScenarioSpec(
            base_digest=digest, n_bars=T, block=16, regimes=3,
            vol_scale=2.0, shock=0.01, seed=n).ByteSize()
        self.roofline["scenario_sweep"] = {
            "panels": n, "bars": T, "gen_s_per_panel": gen_s / n,
            "panels_per_s": n / gen_s, "bar_rate": n * T / gen_s,
            "batched_panels_per_s": n / batch_s,
            "digest_deterministic": bool(deterministic),
            "panel_bytes": len(blobs[0]), "spec_bytes": spec_bytes,
            "spec_wire_reduction": len(blobs[0]) / spec_bytes}
        self.rates["scenario_sweep"] = n / gen_s
        print(f"bench[scenario_sweep]: {n} panels x {T} bars at "
              f"{n / gen_s:.1f} panels/s one at a time, {n / batch_s:.1f} "
              f"batched (deterministic={deterministic}), spec {spec_bytes}B "
              f"vs panel {len(blobs[0])}B", file=sys.stderr)

    def scenario_megakernel(self) -> None:
        """The reference's ``scenario_megakernel`` without its dispatcher:
        one carrier job of K scenario specs through
        ``TorchSweepBackend.process`` on the fused route and on the
        materialized rung (``DBX_SCENARIO_FUSED=0``), after a warm-up at
        the full K: the median of several legs at K a route, and a leg at
        each of K/4, K/2 and K for the peak device bytes."""
        T, K = self.s.megakernel_bars, self.s.megakernel_k
        axes = {"fast": np.arange(3.0, 7.0, dtype=np.float32),
                "slow": np.arange(12.0, 44.0, 8.0, dtype=np.float32)}
        P = axes["fast"].size * axes["slow"].size
        base = data.synthetic_ohlcv(1, T, seed=910)
        blob = data.to_wire_bytes(data.OHLCV(*(f[0] for f in base)))
        digest = panel_store.panel_digest(blob)

        def carrier(k: int) -> pb.JobSpec:
            job = pb.JobSpec(id="scn-0", strategy="sma_crossover",
                             ohlcv=blob, grid=wire.grid_to_proto(axes),
                             periods_per_year=252, panel_digest=digest,
                             panel_bytes_len=len(blob))
            for i in range(k):
                p = synth.ScenarioParams(n_bars=T, block=16, regimes=3,
                                         vol_scale=2.0, shock=0.01, seed=i)
                job.scenario_batch.add(
                    base_digest=digest, n_bars=T, block=16, regimes=3,
                    vol_scale=2.0, shock=0.01, id=f"scn-{i}",
                    seed=synth.seed_to_int64(synth.scenario_seed(digest, p)))
            return job

        def leg(k: int, on: bool) -> tuple[float, int | None]:
            prior = os.environ.get("DBX_SCENARIO_FUSED")
            os.environ["DBX_SCENARIO_FUSED"] = "1" if on else "0"
            try:
                backend = compute.TorchSweepBackend(device=self.dev)
                job = carrier(k)
                _sync(self.dev)
                if self.dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(self.dev)
                    base_bytes = torch.cuda.memory_allocated(self.dev)
                t0 = time.perf_counter()
                out = backend.process([job])
                elapsed = time.perf_counter() - t0
                route = "fused" if on else "materialized"
                if (len(out) != k or not all(c.metrics for c in out)
                        or backend.scenarios[route] != k):
                    raise RuntimeError(f"scenario_megakernel: the {route} "
                                       f"route did not serve {k} specs")
                peak = (torch.cuda.max_memory_allocated(self.dev)
                        - base_bytes if self.dev.type == "cuda" else None)
                return elapsed, peak
            finally:
                if prior is None:
                    os.environ.pop("DBX_SCENARIO_FUSED", None)
                else:
                    os.environ["DBX_SCENARIO_FUSED"] = prior

        leg(K, True)
        leg(K, False)
        # The rates: medians of legs at K, the two routes alternating; the
        # spread: the speedup of each pair of legs.
        secs = {True: [], False: []}
        for _ in range(max(self.s.iters // 2, 3)):
            for on in (True, False):
                secs[on].append(leg(K, on)[0])
        pairs = sorted(m / f for f, m in zip(secs[True], secs[False]))
        ks = sorted({max(K // 4, 2), max(K // 2, 2), K})
        curves = {}
        for on in (True, False):
            curves[on] = [dict(zip(("k", "elapsed_s", "peak_device_bytes"),
                                   (k, *leg(k, on)))) for k in ks]
        fused_rate = K / statistics.median(secs[True])
        mat_rate = K / statistics.median(secs[False])
        self.roofline["scenario_megakernel"] = {
            "scenarios": K, "bars": T, "combos": int(P),
            "fused_scn_per_s": fused_rate,
            "materialized_scn_per_s": mat_rate,
            "speedup": fused_rate / mat_rate,
            "speedup_min": pairs[0], "speedup_max": pairs[-1],
            "fused_s": secs[True], "materialized_s": secs[False],
            "by_k_fused": curves[True], "by_k_materialized": curves[False]}
        self.rates["scenario_megakernel"] = fused_rate
        print(f"bench[scenario_megakernel]: {K} scenarios x {P} combos @ "
              f"{T} bars -> fused {fused_rate:.1f} scn/s vs materialized "
              f"{mat_rate:.1f} scn/s ({fused_rate / mat_rate:.2f}x, pairs "
              f"{pairs[0]:.2f}-{pairs[-1]:.2f}x)", file=sys.stderr)


    def autotune(self) -> None:
        """The reference's ``autotune`` config: (a) the tuned tile width
        against the defaults for its families, (b) a second worker's build
        wall, cold against fleet-warm (module docstring)."""
        from .rpc.compute import platform_of

        reps = max(min(self.s.iters, 5), 2)
        platform = platform_of(self.dev)
        prior_mode = os.environ.get("DBX_AUTOTUNE")
        os.environ["DBX_AUTOTUNE"] = prior_mode or "1"
        tuner = tune.Autotuner(tune.ScheduleRegistry())
        rows, speedups, modeled = {}, {}, {}
        try:
            for name in AUTOTUNE_CONFIGS:
                strategy, sweep, fields, names = FUSED[name]
                g = self.grid(strategy)
                P = len(g[names[0]])
                args = (tuple(self.panel[f] for f in fields)
                        + tuple(g[n] for n in names))

                def wall(subs=None, sweep=sweep, args=args):
                    with fused.tuned_schedule(subs):
                        sweep(*args, cost=COST, device=self.dev)
                        _sync(self.dev)
                        t0 = time.perf_counter()
                        for _ in range(reps):
                            sweep(*args, cost=COST, device=self.dev)
                        _sync(self.dev)
                        return (time.perf_counter() - t0) / reps

                bucket = tune.group_bucket(self.s.n_bars, P,
                                           self.s.n_tickers)
                prior = dict(n_bars=self.s.n_bars, n_combos=P,
                             n_rows=self.s.n_tickers, grid=g)
                winner = tuner.tune(strategy, bucket, platform,
                                    measure=wall, **prior)
                t_default, t_tuned = wall(), wall(winner)
                incumbent = tune.autotune.default_substrates(strategy)
                m_default = tune.modeled_cost(strategy, incumbent, **prior)
                m_tuned = tune.modeled_cost(strategy, winner or incumbent,
                                            **prior)
                speedups[strategy] = t_default / max(t_tuned, 1e-12)
                modeled[strategy] = m_default / max(m_tuned, 1e-12)
                rows[strategy] = {"bucket": bucket,
                                  "default_s_per_sweep": t_default,
                                  "tuned_s_per_sweep": t_tuned,
                                  "substrates": winner}
                print(f"bench[autotune:{strategy}]: default "
                      f"{t_default * 1e3:.4f} ms -> tuned "
                      f"{t_tuned * 1e3:.4f} ms ({speedups[strategy]:.3f}x, "
                      f"modeled {modeled[strategy]:.3f}x) {winner}",
                      file=sys.stderr)
        finally:
            if prior_mode is None:
                os.environ.pop("DBX_AUTOTUNE", None)
            else:
                os.environ["DBX_AUTOTUNE"] = prior_mode
        out = {"bars": self.s.n_bars, "tickers": self.s.n_tickers,
               "platform": platform,
               "autotuned_vs_default_speedup": speedups,
               "autotuned_vs_default_speedup_modeled": modeled,
               "families": rows,
               "speedup_families_ok": sum(1 for v in speedups.values()
                                          if v >= 1.2)}
        out.update(self._compile_cache_ab())
        if self.dev.type == "cuda":
            out["width_by_rows"] = self._width_by_rows()
        self.roofline["autotune"] = out
        self.rates["autotune"] = 1.0 / max(
            sum(r["tuned_s_per_sweep"] for r in rows.values()), 1e-12)

    def _inputs(self, name: str, n_rows: int | None = None):
        """A fused config's strategy, sweep, grid names and leading
        arguments, on the first ``n_rows`` rows of its panel (None: all of
        them). The pairs config, as the reference bench's: 2 * n_pairs
        synthetic tickers (at most 1000 pairs), seed 1."""
        strategy, sweep, fields, names = FUSED[name]
        if fields is None:
            n = min(2 * self.s.n_tickers, 1000)
            legs = torch.as_tensor(data.synthetic_ohlcv(
                2 * n, self.s.n_bars, seed=1).close, device=self.dev)
            inputs = (legs[:n], legs[n:])
        else:
            inputs = tuple(self.panel[f] for f in fields)
        if n_rows is not None:
            inputs = tuple(a[:n_rows].contiguous() for a in inputs)
        return strategy, sweep, names, inputs

    def _width_by_rows(self) -> dict:
        """Part (c) of ``autotune`` (module docstring): ms a sweep and the
        tile kernel's device ms by CTA width, for each tile family and
        group size, the medians of interleaved rounds."""
        from torch.profiler import ProfilerActivity, profile

        rounds, runs = 5, 3
        out = {}
        for name in TILE_CONFIGS:
            strategy, sweep, names, full = self._inputs(name)
            shipped = fused.shipped_lanes(strategy)
            widths = [w for w in (128, 256, 512, 1024) if w <= shipped]
            tile_kernel = rf"\b{roofline.ENTRY[strategy]}_kernel\b"
            g = self.grid(strategy)
            fam = {}
            for n in (*WIDTH_ROWS, int(full[0].shape[0])):
                args = tuple(a[:n].contiguous() for a in full) + tuple(
                    g[k] for k in names)

                def run(args=args):
                    return sweep(*args, cost=COST, device=self.dev).sharpe

                wall = {w: [] for w in widths}
                for _ in range(rounds):
                    for w in widths:
                        with fused.tuned_schedule({"lanes_cap": str(w)}):
                            wall[w].append(_event_ms(run, runs))
                kernel = {}
                for w in widths:
                    with fused.tuned_schedule({"lanes_cap": str(w)}):
                        with profile(activities=[ProfilerActivity.CUDA]) as pr:
                            for _ in range(runs):
                                run()
                            _sync(self.dev)
                    kernel[w] = sum(
                        e.device_time_total for e in pr.key_averages()
                        if re.search(tile_kernel, e.key)) / (runs * 1e3)
                ms = {w: statistics.median(v) for w, v in wall.items()}
                best = min(ms, key=ms.get)
                kbest = min(kernel, key=kernel.get)
                fam[n] = {"sweep_ms": ms, "kernel_ms": kernel,
                          "best_sweep_lanes": best,
                          "best_kernel_lanes": kbest,
                          "sweep_gain": ms[shipped] / ms[best],
                          "kernel_gain": (kernel[shipped] / kernel[kbest]
                                          if kernel[kbest] else None)}
                print(f"bench[autotune:rows] {strategy} {n} rows: sweep ms "
                      + ", ".join(f"{w} {t:.4f}" for w, t in ms.items())
                      + "; tile kernel ms " + ", ".join(
                          f"{w} {t:.4f}" for w, t in kernel.items())
                      + f"; best {best} ({fam[n]['sweep_gain']:.3f}x of "
                      f"{shipped}) / kernel {kbest}", file=sys.stderr)
            out[strategy] = {"shipped_lanes": shipped, "rows": fam}
        return out

    def _compile_cache_ab(self) -> dict:
        """Half (b) of ``autotune``: worker A builds a library with nvcc
        into an empty directory and offers it to a ``CompileStore``; worker
        B, another empty directory, fetches and installs it from the store
        and loads it. The two walls, each to a loaded library."""
        if self.dev.type != "cuda":
            return {"compile_cache": "not run: no nvcc where the bench runs "
                                     "on the CPU"}
        lib = AUTOTUNE_LIB
        prior_dir = _kernels.BUILD_DIR
        root = tempfile.mkdtemp(prefix="dbx-autotune-")
        try:
            a, b = os.path.join(root, "a"), os.path.join(root, "b")
            sync_a = tune.CacheSync(a)
            store = tune.CompileStore()
            _kernels.BUILD_DIR = Path(a)
            t0 = time.perf_counter()
            ctypes.CDLL(str(_kernels.build(lib)))
            wall_cold = time.perf_counter() - t0
            offers = sync_a.poll_new()
            for key, name, payload in offers:
                store.offer(key, name, payload)
            t0 = time.perf_counter()
            sync_b = tune.CacheSync(b)
            miss = sync_b.missing(store.keys())
            installed = sync_b.install((k, *store.get(k)) for k in miss)
            _kernels.BUILD_DIR = Path(b)
            ctypes.CDLL(str(_kernels.build(lib)))
            wall_warm = time.perf_counter() - t0
        finally:
            _kernels.BUILD_DIR = prior_dir
            shutil.rmtree(root, ignore_errors=True)
        print(f"bench[autotune]: {lib} second-worker build wall "
              f"{wall_cold:.4f} s cold -> {wall_warm:.4f} s fleet-warm "
              f"({installed} installed from the store)", file=sys.stderr)
        return {"library": lib,
                "second_worker_compile_wall_cold_s": wall_cold,
                "second_worker_compile_wall_warm_s": wall_warm,
                "compile_wall_reduction": wall_cold / max(wall_warm, 1e-12),
                "fleet_entries_offered": len(offers),
                "fleet_entries_installed": installed,
                "fleet_store_bytes": store.stats()["bytes"],
                "compile_exchange": "in-process through tune.CompileStore"}

    # --- the dispatch loop ------------------------------------------------

    def e2e(self, name: str, *, top_k: int = 0) -> None:
        """The reference's ``e2e`` (and ``e2e_topk``, ``top_k=16``):
        backtests/s through the port's dispatcher and one port worker over
        loopback gRPC, inline DBX1 payloads, the worker's decode, RPCs and
        result packing included. ``DBX_BENCH_TICKERS`` jobs a drain on the
        grid fast 5..24 x ``DBX_BENCH_PARAMS // 20`` slows from 30 step 2;
        one drain to warm up, then ``max(DBX_BENCH_ITERS // 3, 2)`` timed
        drains."""
        from .rpc import dispatcher

        s = self.s
        n_jobs = s.n_tickers
        grid = {"fast": np.arange(5, 25, dtype=np.float32),
                "slow": np.arange(30, 30 + 2 * max(s.n_params // 20, 1), 2,
                                  dtype=np.float32)}
        combos = int(np.prod([v.size for v in grid.values()]))
        kw = dict(top_k=top_k, rank_metric="sharpe") if top_k else {}

        def recs(seed):
            return dispatcher.synthetic_jobs(n_jobs, s.n_bars,
                                             "sma_crossover", grid,
                                             cost=COST, seed=seed, **kw)

        iters = max(s.iters // 3, 2)
        with DispatchLoop([compute.TorchSweepBackend(device=self.dev)],
                          device=str(self.dev), jobs_per_chip=100,
                          poll_interval_s=0.005) as loop:
            t0 = time.perf_counter()
            loop.drain(recs(100))
            warm_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for i in range(iters):
                loop.drain(recs(101 + i))
            elapsed = time.perf_counter() - t0
        rate = n_jobs * combos * iters / elapsed
        print(f"bench[{name}]: warmup {warm_s:.1f}s, {iters}x "
              f"{n_jobs * combos} backtests through the dispatch loop in "
              f"{elapsed:.3f}s -> {rate / 1e6:.2f}M/s", file=sys.stderr)
        self.rates[name] = rate

    def e2e_local(self) -> None:
        """The reference's ``e2e_local``: the control plane alone. N port
        workers with ``compute.InstantBackend`` drain small inline jobs
        (32 bars, 4 combos) over loopback gRPC, jobs/s and wire bytes a job
        for each worker count of ``DBX_BENCH_LOCAL_WORKERS`` (1,2,4); then
        the dispatch-by-digest A/B on ``DBX_BENCH_LOCAL_JOBS // 2`` jobs
        sharing one ``DBX_BENCH_DEDUPE_BARS``-bar panel, dedupe on and
        off."""
        from .rpc import dispatcher

        s = self.s
        lgrid = {"fast": np.arange(5.0, 9.0, dtype=np.float32)}

        def synthetic(n, seed):
            return dispatcher.synthetic_jobs(n, 32, "sma_crossover", lgrid,
                                             seed=seed)

        def run_local(n_workers, n_jobs, job_recs, name, dedupe=True):
            with DispatchLoop([compute.InstantBackend()
                               for _ in range(n_workers)],
                              device=str(self.dev), jobs_per_chip=32,
                              poll_interval_s=0.001,
                              panel_dedupe=dedupe) as loop:
                loop.drain(job_recs(max(n_jobs // 4, 64), 300))
                wire0 = loop.wire_bytes()
                t0 = time.perf_counter()
                loop.drain(job_recs(n_jobs, 301))
                elapsed = time.perf_counter() - t0
                wire = (loop.wire_bytes() - wire0) / n_jobs
                substrate = loop.queue.substrate
            rate = n_jobs / elapsed
            print(f"bench[{name}]: {n_jobs} instant jobs, {n_workers} "
                  f"worker(s), substrate={substrate}, dedupe="
                  f"{'on' if dedupe else 'off'} -> {rate:.0f} jobs/s, "
                  f"{wire:.0f} wire B/job", file=sys.stderr)
            self.rates[name] = rate
            return rate, wire

        wire_cols = {}
        for n_workers in s.local_workers:
            _, wb = run_local(n_workers, s.local_jobs, synthetic,
                              f"e2e_local_w{n_workers}")
            wire_cols[f"w{n_workers}"] = wb
        series = data.synthetic_ohlcv(1, s.dedupe_bars, seed=500)
        blob = data.to_wire_bytes(data.OHLCV(*(np.asarray(f[0])
                                               for f in series)))
        n_dd = max(s.local_jobs // 2, 48)

        def shared(n, seed):
            return [dispatcher.JobRecord(
                id=f"dd-{seed}-{i}", strategy="sma_crossover", grid=lgrid,
                ohlcv=blob) for i in range(n)]

        r_on, wb_on = run_local(1, n_dd, shared, "e2e_local_dedupe_on")
        r_off, wb_off = run_local(1, n_dd, shared, "e2e_local_dedupe_off",
                                  dedupe=False)
        self.roofline["e2e_local"] = {
            "wire_bytes_per_job": wire_cols,
            "dedupe": {
                "panel_bytes": len(blob), "jobs": n_dd,
                "jobs_per_s_on": r_on, "jobs_per_s_off": r_off,
                "dedupe_speedup": r_on / max(r_off, 1e-9),
                "wire_bytes_per_job_on": wb_on,
                "wire_bytes_per_job_off": wb_off,
                "wire_reduction": wb_off / max(wb_on, 1e-9)}}


class _CountingChannel:
    """A worker's gRPC channel that counts into ``loop`` the serialized
    bytes of its ``WIRE_METHODS`` requests and replies, and the
    ``RequestJobs`` replies that carried jobs. It wraps each method's
    serializers, so it measures the bytes that serialization makes
    anyway; every other attribute is the channel's own."""

    def __init__(self, channel, loop: "DispatchLoop"):
        self._channel = channel
        self._loop = loop

    def __getattr__(self, name):
        return getattr(self._channel, name)

    def unary_unary(self, method, request_serializer=None,
                    response_deserializer=None, **kw):
        name = method.rsplit("/", 1)[-1]
        if name in WIRE_METHODS:
            count = self._loop._count

            def serialize(msg, _ser=request_serializer):
                b = _ser(msg)
                count(name, len(b))
                return b

            def deserialize(b, _de=response_deserializer):
                rep = _de(b)
                count(name, len(b),
                      batch=name == "RequestJobs" and len(rep.jobs) > 0)
                return rep

            request_serializer = serialize
            response_deserializer = deserialize
        return self._channel.unary_unary(
            method, request_serializer=request_serializer,
            response_deserializer=response_deserializer, **kw)


class DispatchLoop:
    """The port's dispatcher on ``localhost:0`` and one port worker a
    backend, each polling from its own thread; a context manager.

    :meth:`drain` enqueues records and waits until the queue has no job
    pending or leased; :meth:`wire_bytes` is the serialized bytes of the
    workers' ``WIRE_METHODS`` requests and replies so far, and ``batches``
    the ``RequestJobs`` replies that carried jobs, both counted on the
    workers' own channels (:class:`_CountingChannel`; the port's worker
    keeps no such counter).
    """

    def __init__(self, backends, *, device: str, jobs_per_chip: int,
                 poll_interval_s: float, panel_dedupe: bool = True,
                 journal: str | None = None, results_dir: str | None = None,
                 timeout_s: float = 600.0):
        self.backends = backends
        self.device = device
        self.jobs_per_chip = jobs_per_chip
        self.poll_interval_s = poll_interval_s
        self.panel_dedupe = panel_dedupe
        self.journal = journal
        self.results_dir = results_dir
        self.timeout_s = timeout_s
        self._bytes = {m: 0 for m in WIRE_METHODS}
        self.batches = 0
        self._lock = threading.Lock()

    def _count(self, method: str, n_bytes: int, batch: bool = False) -> None:
        with self._lock:
            self._bytes[method] += n_bytes
            self.batches += batch

    def wire_bytes(self, method: str | None = None) -> int:
        with self._lock:
            return (self._bytes[method] if method
                    else sum(self._bytes.values()))

    def __enter__(self) -> "DispatchLoop":
        from . import obs
        from .rpc import dispatcher, journal
        from .rpc.worker import Worker

        self._tmp = None
        if self.results_dir is None:
            self._tmp = tempfile.mkdtemp(prefix="dbx-e2e-")
            self.results_dir = self._tmp
        self.queue = dispatcher.JobQueue(journal.Journal(self.journal),
                                         device=self.device)
        self.dispatcher = dispatcher.Dispatcher(
            self.queue, dispatcher.PeerRegistry(prune_window_s=30.0),
            results_dir=self.results_dir, registry=obs.Registry(),
            panel_dedupe=self.panel_dedupe)
        self.server = dispatcher.DispatcherServer(
            self.dispatcher, bind="localhost:0",
            prune_interval_s=0.5).start()
        loop = self

        class CountedWorker(Worker):
            def _channel(self):
                return _CountingChannel(super()._channel(), loop)

        self.workers = [CountedWorker(f"localhost:{self.server.port}", b,
                               worker_id=f"loop-{i}",
                               poll_interval_s=self.poll_interval_s,
                               status_interval_s=0.5,
                               jobs_per_chip=self.jobs_per_chip)
                        for i, b in enumerate(self.backends)]
        self.threads = [threading.Thread(target=w.run, daemon=True)
                        for w in self.workers]
        for t in self.threads:
            t.start()
        return self

    def drain(self, recs) -> None:
        """Enqueue ``recs`` (``enqueue_s`` keeps the seconds that took,
        journal appends included) and wait for the queue to drain."""
        t0 = time.perf_counter()
        self.queue.enqueue_many(list(recs))
        self.enqueue_s = time.perf_counter() - t0
        deadline = time.monotonic() + self.timeout_s
        while not self.queue.drained:
            if time.monotonic() > deadline:
                raise RuntimeError(f"dispatch loop drain wedged for "
                                   f"{self.timeout_s:.0f} s: "
                                   f"{self.queue.stats()}")
            time.sleep(0.002)

    def __exit__(self, *exc) -> None:
        for w in self.workers:
            w.stop()
        for t in self.threads:
            t.join(timeout=60)
        self.server.stop()
        self.queue._journal.close()
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)


def run(s: Settings) -> dict:
    """Run the configs of ``s`` and return the result line's object."""
    dev = (torch.device("cpu") if s.cpu
           else device_mod.resolve(device_mod.DEFAULT_DEVICE))
    print(f"bench: device={dev} tickers={s.n_tickers} bars={s.n_bars} "
          f"params={s.n_params}", file=sys.stderr)
    b = _Bench(s, dev)
    for name in CONFIGS:
        if s.configs is not None and name not in s.configs:
            continue
        if name == "roofline_stages":
            b.roofline_stages()
        elif name == "walkforward":
            b.walkforward()
        elif name in ("streaming_append", "ragged_paged", "scenario_sweep",
                      "scenario_megakernel", "long_context", "autotune",
                      "e2e_local"):
            getattr(b, name)()
        elif name in ("e2e", "e2e_topk"):
            b.e2e(name, top_k=16 if name == "e2e_topk" else 0)
        else:
            b.fused_config(name)
    if not b.rates:
        raise SystemExit(f"bench: no configs ran: DBX_BENCH_CONFIGS="
                         f"{','.join(sorted(s.configs or ()))} matched "
                         f"nothing (known: {', '.join(CONFIGS)})")
    headline = HEADLINE if HEADLINE in b.rates else next(iter(b.rates))
    metric = METRIC if headline == HEADLINE else (
        f"backtests/sec/chip (ticker x param combos), config={headline}")
    return {"metric": metric, "value": b.rates[headline],
            "unit": "backtests/sec", "vs_baseline": b.rates[headline],
            "configs": b.rates, "roofline": b.roofline,
            "device": device_info(dev)}


def main(env=None) -> None:
    """Print the result line of a run set by ``env`` (default the process
    environment)."""
    print(json.dumps(run(settings_from_env(os.environ if env is None
                                           else env))))


if __name__ == "__main__":
    main()
