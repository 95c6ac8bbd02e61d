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
over jobs sharing one ``DBX_BENCH_DEDUPE_BARS``-bar panel (4096). Then the
reference's observability configs, the control plane alone:
``fleet_telemetry``, (a) jobs/s of a direct poll-and-complete loop
(``DBX_BENCH_LOCAL_JOBS`` jobs, 32 a poll) against the port's dispatcher
without and with a telemetry frame on each poll (the best of three
interleaved trials an arm), the overhead and the frame's bytes, and (b)
``DBX_BENCH_FLEET_WORKERS`` (2) port workers with ``InstantBackend``
polling every ``DBX_BENCH_FLEET_POLL_S`` (0.25 s) and two probes (a fast
and an artificially slow execute stream) draining
``DBX_BENCH_FLEET_JOBS`` (600) jobs while the fleet view is sampled: every
worker visible on the served ``/fleet.json``, the frames' staleness p95
against two poll periods, the slow probe flagged a straggler, the fleet's
execute histogram equal to the fold of the workers'; ``flight``, the same
direct loop with the flight recorder armed (``DBX_FLIGHT_DIR`` set) and
not, no bundle written while armed, a ``capture_now`` that writes one,
and a synthetic residual stream through the cost model's tracker. Then
the reference's other control-plane configs, through the port's
dispatcher over loopback gRPC with its printed names and ``roofline``
keys: ``direct_dispatch`` (the direct loop at batch 32 and 128, wire bytes
a job, the 2k jobs/s floor printed, and with the port's lockdep);
``decision_plane`` (the direct loop with the decision plane killed and
recording, five paired rounds, and a synthetic shadow-scored stream);
``e2e_local_placement`` (a mixed append-chain workload on two workers
that sleep what they hold, placement off and live; ``DBX_BENCH_PL_SCALE``,
``_PL_CHAINS``, ``_PL_LINKS``); ``queue_machine`` (``JobQueue`` alone on
each substrate, ``DBX_BENCH_QUEUE_JOBS``, and ``cpp/dbx_core_bench.cc``
built by the port at the C-ABI grain); ``certify`` (dbxcert,
``analysis.certify``: its wall a family and for the digest cones, its
rate rows/s; ``DBX_BENCH_CERTIFY_FAMILIES`` subsets the families);
``modelcheck`` (dbxmc,
``analysis.modelcheck``, over the port's dispatcher on every available
substrate: ``DBX_MC_OPS`` (12), ``DBX_MC_SEED`` (0),
``DBX_BENCH_MC_SCHEDULES`` (120) schedules a substrate; its rate is
schedules/s); ``fanout`` (``DBX_BENCH_SUB_N``
subscriptions over ``_SUB_SYMBOLS`` streams on ``_SUB_CONNS``
connections, one tick a symbol); ``e2e_local_tenants`` (two small
tenants alone and behind a whale, ``DBX_BENCH_TENANT_SMALL_JOBS``,
``_WHALE_JOBS``, ``_WHALE_COMBOS``); ``pipeline`` (one port worker with
``TorchSweepBackend`` serial against pipelined, ``DBX_BENCH_PIPELINE_JOBS``,
``_BARS``, ``_FAST``, ``_SLOW``, ``_BATCH``). It prints one JSON line to
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

import contextlib
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
           "e2e_topk", "e2e_local", "direct_dispatch", "fleet_telemetry",
           "flight", "decision_plane", "e2e_local_placement",
           "queue_machine", "certify", "modelcheck", "fanout",
           "e2e_local_tenants", "pipeline")
# The reference's control-plane configs, each a method of _Bench.
CONTROL_CONFIGS = ("direct_dispatch", "decision_plane",
                   "e2e_local_placement", "queue_machine", "certify",
                   "modelcheck", "fanout", "e2e_local_tenants", "pipeline")
# The reference's printed regression floor of the direct loop at batch 32
# (jobs/s): a check printed beside the rate, never a failure.
DIRECT_FLOOR = 2000
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
    fleet_jobs: int = 600
    fleet_workers: int = 2
    fleet_poll_s: float = 0.25
    queue_jobs: int = 20000
    certify_families: tuple | None = None   # None: the whole registry
    mc_ops: int = 12
    mc_seed: int = 0
    mc_schedules: int = 120
    sub_n: int = 10000
    sub_symbols: int = 1000
    sub_conns: int = 32
    tenant_small_jobs: int = 64
    tenant_whale_jobs: int = 512
    tenant_whale_combos: int = 64
    pl_scale: float = 1.0
    pl_chains: int = 10
    pl_links: int = 20
    pipeline_jobs: int = 64
    pipeline_bars: int = 512
    pipeline_fast: int = 8
    pipeline_slow: int = 8
    pipeline_batch: int = 4


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
        dedupe_bars=int(env.get("DBX_BENCH_DEDUPE_BARS", 4096)),
        fleet_jobs=int(env.get("DBX_BENCH_FLEET_JOBS", 600)),
        fleet_workers=int(env.get("DBX_BENCH_FLEET_WORKERS", 2)),
        fleet_poll_s=float(env.get("DBX_BENCH_FLEET_POLL_S", 0.25)),
        queue_jobs=int(env.get("DBX_BENCH_QUEUE_JOBS", 20000)),
        certify_families=tuple(
            f.strip() for f in env.get("DBX_BENCH_CERTIFY_FAMILIES",
                                       "").split(",") if f.strip()) or None,
        mc_ops=int(env.get("DBX_MC_OPS", 12)),
        mc_seed=int(env.get("DBX_MC_SEED", 0)),
        mc_schedules=int(env.get("DBX_BENCH_MC_SCHEDULES", 120)),
        sub_n=int(env.get("DBX_BENCH_SUB_N", 10000)),
        sub_symbols=int(env.get("DBX_BENCH_SUB_SYMBOLS", 1000)),
        sub_conns=int(env.get("DBX_BENCH_SUB_CONNS", 32)),
        tenant_small_jobs=int(env.get("DBX_BENCH_TENANT_SMALL_JOBS", 64)),
        tenant_whale_jobs=int(env.get("DBX_BENCH_TENANT_WHALE_JOBS", 512)),
        tenant_whale_combos=int(env.get("DBX_BENCH_TENANT_WHALE_COMBOS",
                                        64)),
        pl_scale=float(env.get("DBX_BENCH_PL_SCALE", 1.0)),
        pl_chains=int(env.get("DBX_BENCH_PL_CHAINS", 10)),
        pl_links=int(env.get("DBX_BENCH_PL_LINKS", 20)),
        pipeline_jobs=int(env.get("DBX_BENCH_PIPELINE_JOBS", 64)),
        pipeline_bars=int(env.get("DBX_BENCH_PIPELINE_BARS", 512)),
        pipeline_fast=int(env.get("DBX_BENCH_PIPELINE_FAST", 8)),
        pipeline_slow=int(env.get("DBX_BENCH_PIPELINE_SLOW", 8)),
        pipeline_batch=int(env.get("DBX_BENCH_PIPELINE_BATCH", 4)))


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

    def fleet_telemetry(self) -> None:
        """The reference's ``fleet_telemetry``: (a) the direct loop's
        jobs/s without and with a telemetry frame a poll, the best of three
        interleaved trials an arm (run-to-run jitter is of the overhead
        bar's order); (b) the loopback fleet of :func:`_fleet_e2e`."""
        from .obs import timeline

        s, dev = self.s, str(self.dev)
        r_off, r_on, on_frames = 0.0, 0.0, []
        for _ in range(3):
            r, _, _ = _direct_dispatch(dev, 32, s.local_jobs)
            r_off = max(r_off, r)
            r, f, _ = _direct_dispatch(dev, 32, s.local_jobs,
                                       telemetry=True)
            if r > r_on:
                r_on, on_frames = r, f
        overhead_pct = (r_off - r_on) / max(r_off, 1e-9) * 100
        doc, ages, e2e_frames = _fleet_e2e(dev, s.fleet_workers,
                                           s.fleet_jobs, s.fleet_poll_s)
        frames = sorted(e2e_frames or on_frames)
        frame_p50 = frames[len(frames) // 2] if frames else 0
        stale_p95 = timeline._quantile(sorted(ages), 0.95) if ages else 0.0
        stale_bar = 2 * s.fleet_poll_s
        expected = ({f"fleet-{i}" for i in range(s.fleet_workers)}
                    | {"fleet-fast", "fleet-slow"})
        seen = set(doc.get("workers", {}))
        flagged = "execute" in doc["workers"].get(
            "fleet-slow", {}).get("stragglers", [])
        exact = fleet_merge_exact(doc)
        self.rates["fleet_telemetry"] = r_on
        self.roofline["fleet_telemetry"] = {
            "jobs": s.local_jobs, "batch": 32,
            "jobs_per_s_off": r_off, "jobs_per_s_on": r_on,
            "telemetry_overhead_pct": overhead_pct,
            "overhead_ok": overhead_pct <= 5.0,
            "frame_bytes_p50": frame_p50, "frames_sampled": len(frames),
            "e2e_jobs": s.fleet_jobs, "e2e_workers": s.fleet_workers,
            "e2e_poll_s": s.fleet_poll_s, "workers_seen": len(seen),
            "all_workers_visible": expected <= seen,
            "fleet_staleness_p95_s": stale_p95,
            "staleness_bar_s": stale_bar,
            "staleness_ok": stale_p95 <= stale_bar,
            "straggler_flagged": flagged, "histogram_merge_exact": exact}
        print(f"bench[fleet_telemetry]: direct b32 off {r_off:.0f} -> on "
              f"{r_on:.0f} jobs/s ({overhead_pct:+.1f}%), frame p50 "
              f"{frame_p50} B; e2e {s.fleet_workers}+2 workers @ poll "
              f"{s.fleet_poll_s * 1e3:.0f}ms -> {len(seen)} visible, "
              f"staleness p95 {stale_p95 * 1e3:.0f}ms (bar "
              f"{stale_bar * 1e3:.0f}ms), straggler "
              f"{'flagged' if flagged else 'NOT FLAGGED'}, merge "
              f"{'exact' if exact else 'MISMATCH'}", file=sys.stderr)

    def flight(self) -> None:
        """The reference's ``flight``: (a) the direct loop's jobs/s with
        the flight recorder armed (``DBX_FLIGHT_DIR`` set) and not, the
        best of three interleaved trials an arm, no bundle written while
        armed, then a ``capture_now`` that must write one; (b) a synthetic
        residual stream through a private ``CostModelTracker`` (durations
        computed from the op model, so the answer is known)."""
        from .obs import Registry, costmodel, flight as flight_mod

        s, dev = self.s, str(self.dev)
        r_off = r_on = 0.0
        try:
            with _env_set(DBX_FLIGHT_DIR=None), \
                    tempfile.TemporaryDirectory() as fdir:
                for _ in range(3):
                    os.environ.pop("DBX_FLIGHT_DIR", None)
                    flight_mod.reset()
                    r_off = max(r_off, _direct_dispatch(dev, 32,
                                                        s.local_jobs)[0])
                    os.environ["DBX_FLIGHT_DIR"] = fdir
                    flight_mod.reset()
                    r_on = max(r_on, _direct_dispatch(dev, 32,
                                                      s.local_jobs)[0])
                bundles = len([f for f in os.listdir(fdir)
                               if f.endswith(".json")])
                capture_ok = flight_mod.capture_now(
                    "admin", subject="bench-smoke") is not None
        finally:
            flight_mod.reset()
        overhead_pct = (r_off - r_on) / max(r_off, 1e-9) * 100
        tr = costmodel.CostModelTracker(registry=Registry())
        spu0 = 1e-6
        base = {"name": "worker.execute", "kernel": "fused:sma_crossover",
                "bars": 2048, "combos": 64, "jobs": 1}
        units = costmodel._model_units("sma_crossover", 2048, 64)
        for r_log2 in ([0.0] * costmodel.warmup_n() + [3.5] + [0.1] * 8
                       + [0.5] * 8 + [2.0] * 3):
            tr.observe(dict(base, dur_s=units * spu0 * (2.0 ** r_log2)))
        snap = tr.snapshot()
        res_p50 = costmodel.residual_quantile(snap["buckets"], 0.5)
        res_p95 = costmodel.residual_quantile(snap["buckets"], 0.95)
        self.rates["flight"] = r_on
        self.roofline["flight"] = {
            "jobs": s.local_jobs, "batch": 32, "jobs_per_s_off": r_off,
            "jobs_per_s_on": r_on, "overhead_pct": overhead_pct,
            "overhead_ok": overhead_pct <= 2.0,
            "bundles_during_run": bundles, "quiet_ok": bundles == 0,
            "capture_smoke_ok": capture_ok,
            "costmodel_obs": snap["n"], "costmodel_blowouts": snap["blowouts"],
            "costmodel_residual_p50": res_p50,
            "costmodel_residual_p95": res_p95}
        print(f"bench[flight]: direct b32 off {r_off:.0f} -> armed "
              f"{r_on:.0f} jobs/s ({overhead_pct:+.1f}%), {bundles} "
              f"bundle(s) during run, capture smoke "
              f"{'ok' if capture_ok else 'FAILED'}; synthetic residuals "
              f"p50 {res_p50:+.2f} / p95 {res_p95:+.2f} log2, "
              f"{snap['blowouts']} blowout(s)", file=sys.stderr)

    # --- the reference's control-plane keys -------------------------------

    def direct_dispatch(self) -> None:
        """The reference's ``direct_dispatch``: jobs/s of the direct
        poll-and-complete loop against the port's dispatcher at batch 32
        and 128 over ``DBX_BENCH_LOCAL_JOBS`` jobs, each with its wire
        bytes a job; the reference's 2k jobs/s floor at batch 32, printed,
        not enforced; then batch 32 with the port's runtime lockdep
        installed (``analysis.lockdep``): its jobs/s, overhead, edges and
        violations, the tables' state before restored."""
        from .analysis import lockdep

        s, dev = self.s, str(self.dev)
        r32, _, wb32 = _direct_dispatch(dev, 32, s.local_jobs, wire=True)
        r128, _, wb128 = _direct_dispatch(dev, 128, s.local_jobs, wire=True)
        for batch, r, wb in ((32, r32, wb32), (128, r128, wb128)):
            self.rates[f"direct_dispatch_b{batch}"] = r
            print(f"bench[direct_dispatch_b{batch}]: {s.local_jobs} inline "
                  f"jobs, bare client cycle, batch {batch} -> {r:.0f} "
                  f"jobs/s, {wb:.0f} wire B/job", file=sys.stderr)
        if r32 < DIRECT_FLOOR:
            print(f"bench[direct_dispatch]: WARNING batch-32 ceiling "
                  f"{r32:.0f} jobs/s is below the {DIRECT_FLOOR} jobs/s "
                  "regression floor", file=sys.stderr)
        was_active = lockdep.active()
        if was_active:
            base = lockdep.report()
            base_edges, base_viol = base["edges"], len(base["violations"])
        else:
            lockdep.install()
            lockdep.reset()
            base_edges = base_viol = 0
        try:
            r_ld, _, _ = _direct_dispatch(dev, 32, s.local_jobs)
            ld = lockdep.report()
        finally:
            if not was_active:
                lockdep.uninstall()
        edges = ld["edges"] - base_edges
        violations = len(ld["violations"]) - base_viol
        overhead = (r32 - r_ld) / max(r32, 1e-9) * 100
        print(f"bench[direct_dispatch]: lockdep on -> {r_ld:.0f} jobs/s "
              f"({overhead:+.1f}% vs off), {edges} edges, {violations} "
              "violations", file=sys.stderr)
        self.roofline["direct_dispatch_floor"] = {
            "batch32_jobs_per_s": r32, "floor": DIRECT_FLOOR,
            "floor_ok": r32 >= DIRECT_FLOOR,
            "wire_bytes_per_job": {"b32": wb32, "b128": wb128},
            "lockdep": {"batch32_jobs_per_s": r_ld, "overhead_pct": overhead,
                        "floor_ok": r_ld >= DIRECT_FLOOR, "edges": edges,
                        "violations": violations}}

    def decision_plane(self) -> None:
        """The reference's ``decision_plane``: (a) five paired rounds of
        the direct loop at batch 32 with the decision plane killed
        (``DBX_DECISIONS=0``) then recording, the median of the rounds'
        deltas; (b) a synthetic stream of 16 decisions over a two-worker
        fleet (12 on the worker holding the panel) through a private
        ``DecisionPlane``: agreement and regret have known answers."""
        from .obs import Registry, decisions

        s, dev = self.s, str(self.dev)
        r_off = r_on = 0.0
        deltas = []
        with _env_set(DBX_DECISIONS=None):
            for _ in range(5):
                os.environ["DBX_DECISIONS"] = "0"
                ro = _direct_dispatch(dev, 32, s.local_jobs)[0]
                os.environ["DBX_DECISIONS"] = "1"
                rn = _direct_dispatch(dev, 32, s.local_jobs)[0]
                r_off, r_on = max(r_off, ro), max(r_on, rn)
                deltas.append((ro - rn) / max(ro, 1e-9) * 100)
        overhead = sorted(deltas)[len(deltas) // 2]
        digest, panel_b = "ab" * 32, 100_000_000

        class Fleet:
            def snapshot(self):
                return {"workers": {
                    "fast": {"stale": False, "age_s": 0.1, "caches": {
                        "panel_topk": [{"d": digest[:12], "b": 1}]}},
                    "slow": {"stale": False, "age_s": 0.1, "caches": {}}}}

        plane = decisions.DecisionPlane(fleet=Fleet(), registry=Registry())
        try:
            plane.submit([
                {"jid": f"dp-{i}", "trace_id": f"dp-{i}", "worker": wid,
                 "tenant": "default", "strategy": "sma_crossover",
                 "combos": 64.0, "affinity_skips": 0, "wfq": None,
                 "digest": digest, "panel_b": panel_b, "append_parent": "",
                 "base_len": 0, "bars": 2048, "t_take": float(i),
                 "route": "full"}
                for i, wid in enumerate(["fast"] * 12 + ["slow"] * 4)])
            scored = plane.flush(timeout=30.0)
            snap = plane.snapshot()
        finally:
            plane.close()
        want_regret = panel_b / decisions.h2d_rate_bps()
        self.rates["decision_plane"] = r_on
        self.roofline["decision_plane"] = {
            "jobs": s.local_jobs, "batch": 32, "jobs_per_s_off": r_off,
            "jobs_per_s_on": r_on, "decision_overhead_delta_pct": overhead,
            "overhead_rounds_pct": deltas, "overhead_ok": overhead <= 2.0,
            "floor_ok": r_on >= DIRECT_FLOOR,
            "shadow_scored": snap["n_scored"] if scored else -1,
            "shadow_agreement_pct": snap["agreement"]["pct"],
            "regret_p50": snap["regret"]["p50_s"],
            "regret_p95": snap["regret"]["p95_s"],
            "regret_expected_s": want_regret}
        print(f"bench[decision_plane]: direct b32 killed {r_off:.0f} -> "
              f"recording {r_on:.0f} jobs/s (median paired delta "
              f"{overhead:+.1f}%); shadow stream {snap['n_scored']} scored, "
              f"agreement {snap['agreement']['pct']:.0f}%, regret p50 "
              f"{snap['regret']['p50_s']:.4f}s / p95 "
              f"{snap['regret']['p95_s']:.4f}s (expected {want_regret:.4f}s "
              "per mis-placement)", file=sys.stderr)

    def e2e_local_placement(self) -> None:
        """The reference's ``e2e_local_placement``: one mixed workload
        (``DBX_BENCH_PL_CHAINS`` append chains of ``DBX_BENCH_PL_LINKS``
        links, repeats of 4 panels, cold panels) drained by two port
        workers whose backend sleeps the stage ladder of what it holds
        (a carry hit, a full reprice, a panel transfer on top; seconds
        scaled by ``DBX_BENCH_PL_SCALE``), placement off
        (``DBX_PLACEMENT=0``) then live: jobs/s, the shadow scorer's
        regret of each arm, the placement verdicts."""
        from .rpc import dispatcher, panel_store

        s = self.s
        reprice_s, carry_s, transfer_s = (0.100 * s.pl_scale,
                                          0.002 * s.pl_scale,
                                          0.060 * s.pl_scale)
        bars, step, n_panels = 1024, 64, 4
        repeats, n_cold = min(4, s.pl_links), min(8, s.pl_links)
        grid = {"fast": np.arange(5.0, 9.0, dtype=np.float32)}

        class LocalityBackend:
            """Sleeps the ladder of what this worker holds, keyed on
            digests alone."""

            chips = 1

            def __init__(self):
                self.held: set[str] = set()

            def process(self, jobs):
                out = []
                for job in jobs:
                    base = job.append_parent_digest
                    if base and base in self.held:
                        dt = carry_s
                    else:
                        dt = reprice_s + (transfer_s if job.panel_digest
                                          not in self.held else 0.0)
                    time.sleep(dt)
                    self.held.add(job.panel_digest)
                    out.append(compute.Completion(job.id, b"", dt,
                                                  trace_id=job.trace_id))
                return out

        def blob(seed, n):
            x = data.synthetic_ohlcv(1, n, seed=seed)
            return data.to_wire_bytes(data.OHLCV(*(np.asarray(f[0][:n])
                                                   for f in x)))

        def records():
            master = data.synthetic_ohlcv(1, bars + s.pl_links * step,
                                          seed=700)
            chains = []
            for c in range(s.pl_chains):
                links, prev_d, prev_n = [], "", 0
                for k in range(s.pl_links):
                    n = bars + k * step
                    b = data.to_wire_bytes(data.OHLCV(*(
                        np.asarray(f[0][:n]) + c for f in master)))
                    links.append(dispatcher.JobRecord(
                        id=f"pl-c{c}-l{k}", strategy="sma_crossover",
                        grid=grid, ohlcv=b, append_parent=prev_d,
                        append_base_len=prev_n))
                    prev_d, prev_n = panel_store.panel_digest(b), n
                chains.append(links)
            rep_blobs = [blob(710 + p, bars) for p in range(n_panels)]
            cold_blobs = [blob(730 + i, bars) for i in range(n_cold)]
            recs = []
            for r in range(s.pl_links):
                recs += [links[r] for links in chains]
                if r < repeats:
                    recs += [dispatcher.JobRecord(
                        id=f"pl-r{p}-{r}", strategy="sma_crossover",
                        grid=grid, ohlcv=b) for p, b in enumerate(rep_blobs)]
                if r < n_cold:
                    recs.append(dispatcher.JobRecord(
                        id=f"pl-x{r}", strategy="sma_crossover", grid=grid,
                        ohlcv=cold_blobs[r]))
            return recs

        def arm(tag, live):
            recs = records()
            with _env_set(DBX_PLACEMENT="1" if live else "0",
                          DBX_PLACEMENT_DEFER_CAP="64",
                          DBX_DECISIONS_H2D_GBPS="0.0007",
                          DBX_DECISIONS_RATE="100000"), \
                    DispatchLoop([LocalityBackend(), LocalityBackend()],
                                 device=str(self.dev), jobs_per_chip=2,
                                 poll_interval_s=0.002) as loop:
                t0 = time.perf_counter()
                loop.drain(recs)
                elapsed = time.perf_counter() - t0
                disp = loop.dispatcher
                disp.decisions.flush(timeout=30.0)
                snap = disp.decisions.snapshot()
                counts = {o: disp.obs.counter("dbx_placement_total",
                                              outcome=o).value
                          for o in ("served", "deferred", "cap")}
            rate = len(recs) / elapsed
            print(f"bench[e2e_local_placement/{tag}]: {len(recs)} jobs, 2 "
                  f"workers -> {rate:.0f} jobs/s, regret sum "
                  f"{snap['regret']['sum_s']:.3f}s over {snap['n_scored']} "
                  f"scored, placement counts {counts}", file=sys.stderr)
            return rate, snap, counts, len(recs)

        r_blind, snap_blind, _, _ = arm("blind", False)
        r_live, snap_live, counts, n = arm("live", True)
        polls = sum(counts.values())
        speedup = r_live / max(r_blind, 1e-9)
        regret_shadow = snap_blind["regret"]["sum_s"]
        regret_live = snap_live["regret"]["sum_s"]
        self.rates["e2e_local_placement"] = r_live
        self.roofline["e2e_local_placement"] = {
            "jobs": n, "workers": 2, "jobs_per_s_blind": r_blind,
            "jobs_per_s_live": r_live, "placement_speedup": speedup,
            "defer_rate": counts["deferred"] / max(polls, 1),
            "admit_counts": {o: int(v) for o, v in counts.items()},
            "regret_seconds_shadow": regret_shadow,
            "regret_seconds_live": regret_live,
            "scored_shadow": snap_blind["n_scored"],
            "scored_live": snap_live["n_scored"],
            "speedup_ok": speedup >= 1.5,
            "regret_ok": regret_live < regret_shadow}
        print(f"bench[e2e_local_placement]: blind {r_blind:.0f} -> live "
              f"{r_live:.0f} jobs/s ({speedup:.2f}x), regret "
              f"{regret_shadow:.3f}s -> {regret_live:.3f}s, defer rate "
              f"{counts['deferred'] / max(polls, 1):.3f}", file=sys.stderr)

    def queue_machine(self) -> None:
        """The reference's ``queue_machine``: the port's ``JobQueue``
        state machine alone, ``DBX_BENCH_QUEUE_JOBS`` jobs through
        enqueue (32 a call), ``take(32)`` and ``complete_batch`` on each
        substrate (python, native), the best of three; then
        ``cpp/dbx_core_bench.cc`` built by the port into ``_build/``
        (``runtime._core.build_core_bench``), the same cycle at the C-ABI
        grain over 200000 jobs."""
        from .rpc import dispatcher
        from .runtime import _core as native_core

        s = self.s
        recs = [dispatcher.JobRecord(id=f"q{i}", strategy="s", grid={},
                                     ohlcv=b"x")
                for i in range(s.queue_jobs)]
        for substrate in ("python", "native"):
            if substrate == "native" and not native_core.available():
                print("bench[queue_machine]: native core unavailable, "
                      "skipping", file=sys.stderr)
                continue
            best = 0.0
            for _ in range(3):
                q = dispatcher.JobQueue(use_native=substrate == "native",
                                        device=str(self.dev))
                assert q.substrate == substrate
                t0 = time.perf_counter()
                for i in range(0, len(recs), 32):
                    q.enqueue_many(recs[i:i + 32])
                while True:
                    got = q.take(32, "w")
                    if not got:
                        break
                    q.complete_batch([r.id for r, _ in got], "w")
                elapsed = time.perf_counter() - t0
                assert q.drained and (q.stats()["jobs_completed"]
                                      == len(recs))
                best = max(best, len(recs) / elapsed)
            print(f"bench[queue_machine_{substrate}]: {len(recs)} full "
                  "enqueue->take(32)->complete_batch cycles, best of 3 -> "
                  f"{best / 1e3:.0f}k jobs/s", file=sys.stderr)
            self.rates[f"queue_machine_{substrate}"] = best
        try:
            binary = native_core.build_core_bench()
            out = subprocess.run([binary, "200000"], capture_output=True,
                                 text=True, timeout=120)
        except (native_core.ToolchainError, OSError,
                subprocess.SubprocessError) as e:
            print(f"bench[queue_machine_native_cabi]: skipped ({e})",
                  file=sys.stderr)
            return
        m = re.search(r"-> (\d+) jobs/s", out.stdout)
        if out.returncode == 0 and m:
            self.rates["queue_machine_native_cabi"] = float(m.group(1))
            print("bench[queue_machine_native_cabi]: " + out.stdout.strip(),
                  file=sys.stderr)

    def certify(self) -> None:
        """The reference's ``certify``: dbxcert's analysis cost, a CI
        gate's, per family (its 4 rows: 2 substrates x 2 forms) and for
        the digest cones, on the CPU wherever the bench runs (the
        certifier traces the plain versions)."""
        from .analysis import certify as dbxcert

        t0 = time.perf_counter()
        rows, walls = dbxcert.timed_rows(
            families=(list(self.s.certify_families)
                      if self.s.certify_families else None))
        total = time.perf_counter() - t0
        self.roofline["certify"] = {
            "certify_wall_s": {k: round(v, 4) for k, v in walls.items()},
            "rows": len(rows),
            "wall_s_total": round(total, 4)}
        self.rates["certify"] = len(rows) / max(total, 1e-9)
        print(f"bench[certify]: {len(rows)} rows in {total:.2f}s "
              f"({len(walls) - 1} families + digest cones)",
              file=sys.stderr)

    def modelcheck(self) -> None:
        """The reference's ``modelcheck``: dbxmc's exploration cost, a CI
        gate's, summed over every available substrate of the port's
        dispatcher (python, and native where the port's core loads)."""
        from .analysis import modelcheck as dbxmc

        s = self.s
        res = dbxmc.explore(dbxmc.MCConfig(ops=s.mc_ops, seed=s.mc_seed,
                                           schedules=s.mc_schedules),
                            dbxmc.available_substrates())
        self.roofline["modelcheck"] = {
            "schedules": res["schedules"],
            "crash_points": res["crash_points"],
            "boundaries": res["boundaries"],
            "violations": len(res["violations"]),
            "wall_s": res["wall_s"]}
        self.rates["modelcheck"] = res["schedules"] / max(res["wall_s"],
                                                          1e-9)
        print(f"bench[modelcheck]: {res['schedules']} schedules, "
              f"{res['crash_points']} crash points, "
              f"{len(res['violations'])} violations in "
              f"{res['wall_s']:.2f}s", file=sys.stderr)

    def fanout(self) -> None:
        """The reference's ``fanout``: ``DBX_BENCH_SUB_SYMBOLS`` 64-bar
        symbols drained once by a port worker with ``InstantBackend``,
        then ``DBX_BENCH_SUB_N`` subscriptions over
        ``DBX_BENCH_SUB_CONNS`` ``Subscribe`` streams (a symbol's
        subscribers on distinct connections) and one one-bar
        ``AppendBars`` tick a symbol: advances (one a stream), pushes
        delivered and dropped, tick-to-push latency by the client's
        clock."""
        import grpc

        from . import obs
        from .obs import timeline
        from .rpc import dispatcher, service
        from .rpc.worker import Worker

        s = self.s
        n_sub, n_sym = s.sub_n, s.sub_symbols
        n_conns = min(s.sub_conns, n_sub)
        bars = 64
        grid = {"fast": np.arange(5.0, 9.0, dtype=np.float32)}
        hist = data.synthetic_ohlcv(n_sym, bars + 1, seed=700)

        def cut(i, lo, hi):
            return data.to_wire_bytes(data.OHLCV(*(np.asarray(f[i, lo:hi])
                                                   for f in hist)))

        base = [dispatcher.JobRecord(id=f"fan-{i}", strategy="sma_crossover",
                                     grid=grid, ohlcv=cut(i, 0, bars))
                for i in range(n_sym)]
        per_sym = n_sub // n_sym
        if per_sym > n_conns:
            raise SystemExit(f"bench[fanout]: DBX_BENCH_SUB_CONNS "
                             f"({n_conns}) < subscribers per symbol "
                             f"({per_sym}): a connection would name one "
                             "stream twice, which dedupes to one push")

        class Collector:
            """Drains one Subscribe stream, sampling tick-to-receipt."""

            def __init__(self, stub, request, expected):
                self.lat: list[float] = []
                self.expected = expected
                self._call = stub.Subscribe(request)
                self.thread = threading.Thread(target=self._drain,
                                               daemon=True)
                self.thread.start()

            def _drain(self):
                try:
                    for item in self._call:
                        if item.tick_unix:
                            self.lat.append(time.time() - item.tick_unix)
                        if len(self.lat) >= self.expected:
                            break
                except grpc.RpcError:
                    pass

            def stop(self):
                self._call.cancel()
                self.thread.join(timeout=10)

        q = dispatcher.JobQueue(device=str(self.dev))
        reg = obs.Registry()
        collectors = []
        with tempfile.TemporaryDirectory() as res:
            disp = dispatcher.Dispatcher(
                q, dispatcher.PeerRegistry(prune_window_s=60.0),
                results_dir=res, registry=reg)
            srv = dispatcher.DispatcherServer(
                disp, bind="localhost:0", prune_interval_s=0.5,
                max_workers=n_conns + 16).start()
            worker = Worker(f"localhost:{srv.port}", compute.InstantBackend(),
                            worker_id="fanout-worker", poll_interval_s=0.001,
                            status_interval_s=0.5, jobs_per_chip=64)
            wt = threading.Thread(target=worker.run, daemon=True)
            channel = grpc.insecure_channel(
                f"localhost:{srv.port}",
                options=service.default_channel_options())
            stub = service.DispatcherStub(channel)
            try:
                wt.start()
                q.enqueue_many(base)
                _wait_drained(q, 300.0, "fanout base")
                per_conn = [[] for _ in range(n_conns)]
                for j in range(n_sub):
                    sym, k = divmod(j, per_sym) if per_sym else (j, 0)
                    sym %= n_sym
                    per_conn[(sym + k) % n_conns].append(pb.JobSpec(
                        strategy="sma_crossover",
                        panel_digest=base[sym].panel_digest,
                        grid=wire.grid_to_proto(grid), periods_per_year=252))
                for c, interests in enumerate(per_conn):
                    collectors.append(Collector(stub, pb.SubscribeRequest(
                        subscriber_id=f"fan-c{c}", interests=interests),
                        expected=len(interests)))
                deadline = time.monotonic() + 120.0
                while disp.hub.stats()["interests"] < n_sub:
                    if time.monotonic() > deadline:
                        raise RuntimeError("bench[fanout]: subscriptions "
                                           f"never registered: "
                                           f"{disp.hub.stats()}")
                    time.sleep(0.01)
                t0 = time.perf_counter()
                for i, rec in enumerate(base):
                    r = stub.AppendBars(pb.AppendRequest(
                        worker_id="feed", panel_digest=rec.panel_digest,
                        base_len=bars, delta=cut(i, bars, bars + 1),
                        job=pb.JobSpec()))
                    if not r.ok:
                        raise RuntimeError(f"bench[fanout]: tick {i} "
                                           f"rejected: {r.detail}")
                t_ticks = time.perf_counter() - t0
                deadline = time.monotonic() + 300.0
                while any(len(c.lat) < c.expected for c in collectors):
                    if time.monotonic() > deadline:
                        got = sum(len(c.lat) for c in collectors)
                        print(f"bench[fanout]: {got}/{n_sub} pushes after "
                              "300s (rest dropped or late)", file=sys.stderr)
                        break
                    time.sleep(0.01)
                t_all = time.perf_counter() - t0
            finally:
                for c in collectors:
                    c.stop()
                worker.stop()
                wt.join(timeout=30)
                channel.close()
                srv.stop()
        lat = sorted(x for c in collectors for x in c.lat)
        advances = reg.counter("dbx_stream_advances_total").value
        dropped = reg.counter("dbx_sub_pushes_total", outcome="dropped").value
        p50, p99 = timeline._quantile(lat, 0.50), timeline._quantile(lat, 0.99)
        p99_bar = 2.0
        self.roofline["fanout"] = {
            "subscriptions": n_sub, "symbols": n_sym, "connections": n_conns,
            "unique_streams": n_sym, "ticks": n_sym,
            "advances_total": int(advances),
            "advances_per_tick": advances / max(n_sym, 1),
            "advances_eq_streams": advances == n_sym,
            "pushes_delivered": len(lat), "pushes_dropped": int(dropped),
            "pushes_per_advance": len(lat) / max(advances, 1),
            "tick_to_push_p50_s": p50, "tick_to_push_p99_s": p99,
            "p99_bar_s": p99_bar, "p99_ok": p99 <= p99_bar,
            "tick_wall_s": t_ticks, "drain_wall_s": t_all}
        self.rates["fanout"] = len(lat) / max(t_all, 1e-9)
        print(f"bench[fanout]: {n_sub} subs / {n_sym} symbols on {n_conns} "
              f"conns: {advances:.0f} advances, {len(lat)} pushes "
              f"({dropped:.0f} dropped), tick->push p50 {p50 * 1e3:.1f}ms "
              f"p99 {p99 * 1e3:.1f}ms, drain {t_all:.1f}s", file=sys.stderr)

    def e2e_local_tenants(self) -> None:
        """The reference's ``e2e_local_tenants``: two drains by one port
        worker with ``InstantBackend`` (8 jobs a poll) of the same two
        small tenants' ``DBX_BENCH_TENANT_SMALL_JOBS`` jobs each, alone
        and behind a whale's ``DBX_BENCH_TENANT_WHALE_JOBS`` jobs of
        ``DBX_BENCH_TENANT_WHALE_COMBOS`` combos enqueued first: each
        tenant's p95 queue wait from ``obs.timeline`` over the span ring,
        and the ratio of the small tenants' worst p95s."""
        from . import obs
        from .obs import timeline
        from .rpc import dispatcher

        s = self.s
        series = data.synthetic_ohlcv(1, 32, seed=910)
        blob = data.to_wire_bytes(data.OHLCV(*(np.asarray(f[0])
                                               for f in series)))
        small_grid = {"fast": np.arange(5.0, 9.0, dtype=np.float32)}
        whale_grid = {"fast": np.arange(5.0, 5.0 + s.tenant_whale_combos,
                                        dtype=np.float32)}

        def recs(tag, tenant, n, grid):
            return [dispatcher.JobRecord(id=f"{tag}:{tenant}-{i}",
                                         strategy="sma_crossover", grid=grid,
                                         ohlcv=blob, tenant=tenant)
                    for i in range(n)]

        def drain(groups):
            all_recs = [r for g in groups for r in g]
            with DispatchLoop([compute.InstantBackend()],
                              device=str(self.dev), jobs_per_chip=8,
                              poll_interval_s=0.001) as loop:
                t0 = time.perf_counter()
                loop.drain(all_recs)
                elapsed = time.perf_counter() - t0
            return len(all_recs) / elapsed

        def p95(tag, tenant):
            tls = timeline.reconstruct(obs.recent_spans())
            # A timeline torn by the ring's eviction lost its queue_wait
            # span first: leave it out rather than read its wait as ~0.
            tls = {t: tl for t, tl in tls.items()
                   if any(x["name"] == "job.queue_wait" for x in tl.spans)}
            per_job = (timeline.summarize(tls, min_straggler_jobs=1 << 30)
                       ["per_job"] if tls else [])
            waits = sorted(j["stages"]["queue_wait"] for j in per_job
                           if j["job"].startswith(f"{tag}:{tenant}-"))
            if not waits:
                raise SystemExit(f"bench[e2e_local_tenants]: no queue_wait "
                                 f"timelines survive for {tag}:{tenant}; "
                                 "the span ring is too small")
            return timeline._quantile(waits, 0.95), len(waits)

        n_small, n_whale = s.tenant_small_jobs, s.tenant_whale_jobs
        # The drains' spans, about five a job, must outlive them in the
        # ring: the reference bench's ring size (DBX_SPAN_RING=32768)
        # unless the caller set one; the caller's ring comes back after.
        with _env_set(DBX_SPAN_RING=os.environ.get("DBX_SPAN_RING",
                                                   "32768")):
            obs.configure_ring()
            try:
                r_solo = drain([recs("solo", "small_a", n_small, small_grid),
                                recs("solo", "small_b", n_small,
                                     small_grid)])
                solo = {t: p95("solo", t) for t in ("small_a", "small_b")}
                r_cont = drain([recs("cont", "whale", n_whale, whale_grid),
                                recs("cont", "small_a", n_small, small_grid),
                                recs("cont", "small_b", n_small,
                                     small_grid)])
                cont = {t: p95("cont", t)
                        for t in ("whale", "small_a", "small_b")}
            finally:
                obs.configure_ring()
        p95_solo = max(v[0] for v in solo.values())
        per_tenant = {t: v[0] for t, v in cont.items()}
        p95_cont = max(per_tenant["small_a"], per_tenant["small_b"])
        ratio = p95_cont / max(p95_solo, 1e-9)
        self.roofline["e2e_local_tenants"] = {
            "tenant_queue_wait_samples": {
                **{f"solo_{t}": v[1] for t, v in solo.items()},
                **{f"contended_{t}": v[1] for t, v in cont.items()}},
            "small_jobs": n_small, "whale_jobs": n_whale,
            "small_combos_per_job": int(small_grid["fast"].size),
            "whale_combos_per_job": s.tenant_whale_combos,
            "tenant_p95_queue_wait_solo": p95_solo,
            "tenant_p95_queue_wait_contended": p95_cont,
            "fairness_ratio": ratio, "fairness_ok": ratio <= 2.0,
            "per_tenant_p95_contended": per_tenant,
            "jobs_per_s_solo": r_solo, "jobs_per_s_contended": r_cont}
        self.rates["e2e_local_tenants"] = r_cont
        print(f"bench[e2e_local_tenants]: whale {n_whale}x"
              f"{s.tenant_whale_combos} combos vs 2x{n_small} small jobs: "
              f"small p95 queue_wait {p95_solo * 1e3:.1f}ms solo -> "
              f"{p95_cont * 1e3:.1f}ms contended = {ratio:.2f}x (bar: <= "
              "2x)", file=sys.stderr)

    def pipeline(self) -> None:
        """The reference's ``pipeline``, on the live backend: one port
        worker with ``TorchSweepBackend`` on the bench's device drains
        ``DBX_BENCH_PIPELINE_JOBS`` sma jobs of ``DBX_BENCH_PIPELINE_BARS``
        bars on a ``_FAST`` x ``_SLOW`` grid, ``DBX_BENCH_PIPELINE_BATCH``
        a poll, serial (``DBX_PIPELINE=0``) and pipelined
        (``DBX_PIPELINE=1``, depth 2), prefetch off, each after a warm-up
        drain; jobs/s of each, the overlap factor and the stage seconds
        from ``obs.timeline`` over the measured drain's spans. The
        reference replays a calibrated host wall and models the device
        as a wait, since its CPU twin has no device apart from the host;
        here the host and device stage walls are the live backend's
        medians of ``submit`` and ``collect`` on one batch."""
        from . import obs
        from .obs import timeline
        from .rpc import dispatcher
        from .rpc.worker import Worker

        s = self.s
        grid = {"fast": np.arange(2.0, 2.0 + s.pipeline_fast,
                                  dtype=np.float32),
                "slow": np.arange(32.0, 32.0 + 2 * s.pipeline_slow, 2,
                                  dtype=np.float32)}

        def specs(recs):
            return [pb.JobSpec(id=r.id, strategy=r.strategy, ohlcv=r.ohlcv,
                               grid=wire.grid_to_proto(r.grid), cost=r.cost,
                               periods_per_year=252) for r in recs]

        cal = specs(dispatcher.synthetic_jobs(
            s.pipeline_batch, s.pipeline_bars, "sma_crossover", grid,
            seed=6999))
        backend = compute.TorchSweepBackend(device=self.dev)
        for _ in range(2):
            backend.process(cal)
        host, dev_w = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            h = backend.submit(cal)
            t1 = time.perf_counter()
            backend.collect(h)
            host.append(t1 - t0)
            dev_w.append(time.perf_counter() - t1)
        host_s, device_s = statistics.median(host), statistics.median(dev_w)

        def mode(pipelined: bool):
            q = dispatcher.JobQueue(device=str(self.dev))
            with _env_set(DBX_PIPELINE="1" if pipelined else "0",
                          DBX_PREFETCH="0"), \
                    tempfile.TemporaryDirectory() as res:
                disp = dispatcher.Dispatcher(
                    q, dispatcher.PeerRegistry(prune_window_s=60.0),
                    results_dir=res, registry=obs.Registry())
                srv = dispatcher.DispatcherServer(
                    disp, bind="localhost:0", prune_interval_s=1.0).start()
                # Four batches may wait ahead of the depth-2 pipeline, so a
                # slow poll starves neither mode.
                w = Worker(f"localhost:{srv.port}", backend,
                           poll_interval_s=0.001, status_interval_s=0.5,
                           jobs_per_chip=s.pipeline_batch,
                           max_inflight_batches=4)
                t = threading.Thread(target=w.run, daemon=True)
                seed = 7000 if pipelined else 8000
                try:
                    t.start()
                    q.enqueue_many(dispatcher.synthetic_jobs(
                        max(s.pipeline_jobs // 4, s.pipeline_batch * 3),
                        s.pipeline_bars, "sma_crossover", grid, seed=seed))
                    _wait_drained(q, 600.0, "pipeline warm-up")
                    obs.configure_ring()
                    t0 = time.perf_counter()
                    q.enqueue_many(dispatcher.synthetic_jobs(
                        s.pipeline_jobs, s.pipeline_bars, "sma_crossover",
                        grid, seed=seed + 1))
                    _wait_drained(q, 600.0, "pipeline")
                    elapsed = time.perf_counter() - t0
                finally:
                    w.stop()
                    t.join(timeout=60)
                    srv.stop()
            digest = timeline.summarize_spans(obs.recent_spans(),
                                              overlap=True)
            return s.pipeline_jobs / elapsed, digest

        r_serial, tl_serial = mode(False)
        r_piped, tl_piped = mode(True)
        obs.configure_ring()

        def totals(tl):
            return {k: v["total_s"] for k, v in tl.get("stages", {}).items()
                    if v["total_s"] > 0}

        ov_piped = tl_piped.get("overlap", {}).get("overlap_factor", 1.0)
        ov_serial = tl_serial.get("overlap", {}).get("overlap_factor", 1.0)
        self.rates["pipeline"] = r_piped
        self.roofline["pipeline"] = {
            "jobs": s.pipeline_jobs, "bars": s.pipeline_bars,
            "combos_per_job": s.pipeline_fast * s.pipeline_slow,
            "batch": s.pipeline_batch, "host_stage_ms": host_s * 1e3,
            "device_stage_ms": device_s * 1e3,
            "jobs_per_s_serial": r_serial, "jobs_per_s_pipelined": r_piped,
            "pipeline_speedup": r_piped / max(r_serial, 1e-9),
            "overlap_factor": ov_piped, "overlap_factor_serial": ov_serial,
            "stages_serial": totals(tl_serial),
            "stages_pipelined": totals(tl_piped)}
        print(f"bench[pipeline]: {s.pipeline_jobs} jobs x "
              f"{s.pipeline_fast * s.pipeline_slow} combos @ "
              f"{s.pipeline_bars} bars, batch={s.pipeline_batch}, submit "
              f"{host_s * 1e3:.2f} ms, collect {device_s * 1e3:.2f} ms -> "
              f"serial {r_serial:.2f} jobs/s, pipelined {r_piped:.2f} jobs/s"
              f" ({r_piped / max(r_serial, 1e-9):.2f}x), overlap "
              f"{ov_serial:.2f} -> {ov_piped:.2f}", file=sys.stderr)


@contextlib.contextmanager
def _env_set(**values):
    """Set (a value) or unset (None) environment variables for the block,
    then restore what was there."""
    prior = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _wait_drained(queue, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while not queue.drained:
        if time.monotonic() > deadline:
            raise RuntimeError(f"bench[{what}]: drain wedged for "
                               f"{timeout_s:.0f} s: {queue.stats()}")
        time.sleep(0.002)


def _direct_dispatch(device: str, batch: int, n_jobs: int, *,
                     telemetry: bool = False,
                     wire: bool = False) -> tuple[float, list, float]:
    """Jobs/s of one client polling ``RequestJobs`` (``batch`` jobs a
    poll) and completing each batch at once with ``CompleteJobs``, against
    the port's dispatcher over loopback gRPC: the control plane's floor
    (the reference bench's ``run_fleet_direct``, and with ``wire`` its
    ``run_direct_dispatch``, which also sums the serialized bytes of each
    request and reply). With ``telemetry`` each poll carries a
    ``WorkerTelemetry`` frame. Returns (jobs/s, the dispatcher's frame
    sizes, wire bytes a job or 0.0)."""
    import grpc

    from . import obs
    from .obs import fleet as fleet_mod
    from .rpc import dispatcher, journal, service

    lgrid = {"fast": np.arange(5.0, 9.0, dtype=np.float32)}
    queue = dispatcher.JobQueue(journal.Journal(None), device=device)
    done_jobs = [0]
    wire_bytes = [0]
    telem = (fleet_mod.WorkerTelemetry("direct", stats_fn=lambda: {
        "jobs_completed": done_jobs[0], "busy": 1}) if telemetry else None)
    with tempfile.TemporaryDirectory() as results_dir:
        disp = dispatcher.Dispatcher(
            queue, dispatcher.PeerRegistry(prune_window_s=30.0),
            results_dir=results_dir, registry=obs.Registry())
        srv = dispatcher.DispatcherServer(disp, bind="localhost:0",
                                          prune_interval_s=5.0).start()
        channel = grpc.insecure_channel(
            f"localhost:{srv.port}",
            options=service.default_channel_options(),
            compression=grpc.Compression.Gzip)
        stub = service.DispatcherStub(channel)

        def cycle(n, seed):
            queue.enqueue_many(dispatcher.synthetic_jobs(
                n, 32, "sma_crossover", lgrid, seed=seed))
            done = 0
            while done < n:
                req = pb.JobsRequest(
                    worker_id="direct", chips=1, jobs_per_chip=batch,
                    telemetry_json=(telem.take_frame_json()
                                    if telem is not None else ""))
                reply = stub.RequestJobs(req)
                if not reply.jobs:
                    break
                creq = pb.CompleteBatch(
                    worker_id="direct",
                    items=[pb.CompleteItem(id=j.id, metrics=b"",
                                           elapsed_s=0.0)
                           for j in reply.jobs])
                crep = stub.CompleteJobs(creq)
                if wire:
                    wire_bytes[0] += (req.ByteSize() + reply.ByteSize()
                                      + creq.ByteSize() + crep.ByteSize())
                done += len(reply.jobs)
                done_jobs[0] += len(reply.jobs)
            return done

        try:
            cycle(max(n_jobs // 4, 64), seed=700)      # warm the channel
            wire_bytes[0] = 0
            t0 = time.perf_counter()
            done = cycle(n_jobs, seed=701)
            elapsed = time.perf_counter() - t0
            frames = disp.fleet.frame_sizes()
        finally:
            channel.close()
            srv.stop()
    return done / elapsed, frames, wire_bytes[0] / max(done, 1)


def _fleet_e2e(device: str, n_workers: int, n_jobs: int,
               poll_s: float) -> tuple[dict, list, list]:
    """``n_workers`` port workers with ``InstantBackend`` and two probes
    (one fast and one artificially slow execute stream, polling the real
    ``RequestJobs`` leg) draining ``n_jobs`` jobs from the port's
    dispatcher, the fleet view sampled while they run (the reference
    bench's ``run_fleet_e2e``). Returns (the served ``/fleet.json``, the
    frames' ages sampled, the frame sizes)."""
    import urllib.request

    import grpc

    from . import obs
    from .obs import fleet as fleet_mod
    from .rpc import dispatcher, journal, service
    from .rpc.worker import Worker

    lgrid = {"fast": np.arange(5.0, 9.0, dtype=np.float32)}
    queue = dispatcher.JobQueue(journal.Journal(None), device=device)
    ages: list[float] = []
    probe_stats = {}
    for wid, durs in (("fleet-fast", [0.001] * 100),
                      ("fleet-slow", [0.8] * 4)):
        st = fleet_mod._StageStats()
        for d in durs:
            st.observe({"name": "worker.execute", "dur_s": d})
        probe_stats[wid] = st
    stop_probes = threading.Event()

    def probe_loop(wid, port):
        telem = fleet_mod.WorkerTelemetry(wid, stats_fn=lambda: {"busy": 0},
                                          stages=probe_stats[wid])
        ch = grpc.insecure_channel(f"localhost:{port}",
                                   options=service.default_channel_options())
        stub = service.DispatcherStub(ch)
        try:
            while not stop_probes.is_set():
                try:
                    reply = stub.RequestJobs(pb.JobsRequest(
                        worker_id=wid, chips=1, jobs_per_chip=1,
                        telemetry_json=telem.take_frame_json()),
                        timeout=10.0)
                    if reply.jobs:
                        stub.CompleteJobs(pb.CompleteBatch(
                            worker_id=wid, items=[pb.CompleteItem(
                                id=j.id, metrics=b"", elapsed_s=0.0)
                                for j in reply.jobs]), timeout=10.0)
                except grpc.RpcError:
                    pass
                stop_probes.wait(poll_s)
        finally:
            ch.close()

    with tempfile.TemporaryDirectory() as results_dir:
        disp = dispatcher.Dispatcher(
            queue, dispatcher.PeerRegistry(prune_window_s=30.0),
            results_dir=results_dir, registry=obs.Registry())
        srv = dispatcher.DispatcherServer(
            disp, bind="localhost:0", prune_interval_s=0.5, metrics_port=0,
            metrics_host="127.0.0.1").start()
        workers = [Worker(f"localhost:{srv.port}", compute.InstantBackend(),
                          worker_id=f"fleet-{i}", poll_interval_s=poll_s,
                          status_interval_s=0.5, jobs_per_chip=16)
                   for i in range(n_workers)]
        threads = [threading.Thread(target=w.run, daemon=True)
                   for w in workers]
        threads += [threading.Thread(target=probe_loop, args=(wid, srv.port),
                                     daemon=True) for wid in probe_stats]
        # "Staleness <= 2 poll periods" holds for idle workers only when
        # the heartbeat rides the poll cadence: the knob this config pins,
        # restored in the finally below.
        prior_hb = os.environ.get("DBX_FLEET_HEARTBEAT_S")
        os.environ["DBX_FLEET_HEARTBEAT_S"] = str(poll_s)
        try:
            for t in threads:
                t.start()
            queue.enqueue_many(dispatcher.synthetic_jobs(
                n_jobs, 32, "sma_crossover", lgrid, seed=702))
            deadline = time.monotonic() + 300.0
            while not queue.drained:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"bench[fleet_telemetry]: drain "
                                       f"wedged for 300 s: {queue.stats()}")
                ages.extend(w["age_s"] for w in
                            disp.fleet.snapshot()["workers"].values())
                time.sleep(0.01)
            deadline = time.monotonic() + 10.0
            while (len(disp.fleet.snapshot()["workers"])
                   < n_workers + len(probe_stats)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            url = f"http://127.0.0.1:{srv.metrics.port}/fleet.json"
            with urllib.request.urlopen(url, timeout=10) as resp:
                doc = json.loads(resp.read())
            frames = disp.fleet.frame_sizes()
        finally:
            stop_probes.set()
            for w in workers:
                w.stop()
            for t in threads:
                t.join(timeout=30)
            srv.stop()
            if prior_hb is None:
                os.environ.pop("DBX_FLEET_HEARTBEAT_S", None)
            else:
                os.environ["DBX_FLEET_HEARTBEAT_S"] = prior_hb
    return doc, ages, frames


def fleet_merge_exact(doc: dict) -> bool:
    """The fleet's execute histogram equals the fold of the live workers'
    rows: worker-scoped streams summed, process-scoped ones once a pid
    (the reference bench's rule)."""
    own_n, own_sum = 0, 0.0
    per_pid: dict = {}
    for w in doc["workers"].values():
        if w.get("stale"):
            continue
        st = w.get("stages", {}).get("execute", {"n": 0, "sum_s": 0.0})
        if w.get("scope") == "worker":
            own_n += st["n"]
            own_sum += st["sum_s"]
        else:
            cur = per_pid.get(w["pid"])
            if cur is None or st["n"] > cur[0]:
                per_pid[w["pid"]] = (st["n"], st["sum_s"])
    ex = doc["fleet"]["stages"]["execute"]
    return (ex["n"] == own_n + sum(n for n, _ in per_pid.values())
            and abs(ex["sum_s"] - own_sum
                    - sum(v for _, v in per_pid.values())) < 1e-6)


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
    workers' own channels (:class:`_CountingChannel`) for this loop alone:
    the workers' ``dbx_worker_wire_bytes_total`` counts the same bytes for
    the whole process, and the registry counts no batches.
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
                      "e2e_local", "fleet_telemetry", "flight",
                      *CONTROL_CONFIGS):
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
