"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive.

Run from the repository root with one CUDA card visible:

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero and prints no result):

1. The card's name and power limit (nvidia-smi), and CUDA must be present.
2. Build every kernel of the main path from ``csrc/`` (one nvcc per source,
   started together).
3. Each kernel against its plain PyTorch version on the same inputs on the
   card: at the main path's shape (500 tickers x 1260 bars x the 2000-combo
   headline grid, cost 1e-3), at cost 0, with ragged lengths and at T=251.
   Positions must be identical, so n_trades and turnover (sums of small
   integers) must be bit-equal; every other metric must agree at
   rtol=2e-4, atol=2e-5. Kernel and plain times come from CUDA events
   after warmup.
4. The main path at full width: 500 synthetic tickers x 1260 daily bars as
   DBX1 payloads in 500 sma_crossover JobSpecs with the headline grid,
   through ``TorchSweepBackend(device="cuda").process``. Every DBXM block
   decodes to 2000 combos with finite sharpe, and each kernel's launch
   count, reset just before the run, grew. A small batch on a 1/32 price
   tick grid (exact f32 cumsums) then goes through the same backend and
   must agree with the port's generic sweep, the golden path, at
   rtol=2e-4, atol=2e-5.
5. One JSON line with each kernel's launches, error, times and bound; then
   the JSON result line, last.

This script imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the tensor cores
# and HBM3 bandwidth. The bound of a kernel is the larger of its operations
# over the first and its bytes over the second.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

RTOL, ATOL = 2e-4, 2e-5
N_TICKERS, N_BARS, COST = 500, 1260, 1e-3
FAST_AXIS = np.arange(5, 25, dtype=np.float32)          # 20 fast windows
SLOW_AXIS = np.arange(30, 230, 2, dtype=np.float32)     # 100 slow windows

# Floating-point operations of K1 per (combo, bar), counted from
# csrc/fused_sma.cu: every bar does the PnL and metric updates (position
# change sub+abs, net mul+mul+sub, s1 add, s2 mul+add, downside min, its
# square mul+add, cumulative add, equity add, peak max, drawdown
# sub+max+div, mdd max, turnover add, active/win count 2 = 20); a bar past
# the warmup also forms the two SMAs (sub+div each) and their difference
# with its sign (2 more) = 6.
OPS_PER_BAR = 20
OPS_PER_SIGNAL_BAR = 6


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def _cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_card() -> str:
    _check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    _check(bool(line), f"nvidia-smi gave no card: {smi.stderr.strip()}")
    print(line)
    return line


def phase_build(kernels_mod) -> None:
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in kernels_mod.SRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        for name, path in zip(sources, pool.map(kernels_mod.build, sources)):
            kernels_mod.load(name)
            print(f"built {name}: {path.name}")
    print(f"build_s {time.perf_counter() - t0:.3f}")


def _k1_inputs(fused, pnl, close, t_real, fast, slow):
    dev = torch.device("cuda")
    c = torch.as_tensor(close, device=dev)
    fw, sw, warm = fused._grid_setup(fast, slow)
    tr = fused._check_t_real(t_real, *close.shape)
    return (torch.cumsum(c, 1).contiguous(), pnl.simple_returns(c).contiguous(),
            *(torch.from_numpy(a).to(dev) for a in (tr, fw, sw, warm)))


def _k1_compare(fused, label, inputs, cost):
    """Kernel vs plain on the same inputs; returns (max_abs, max_rel)."""
    got = fused.fused_sma_cuda(*inputs, cost=cost, ppy=252)
    ref = fused.fused_sma_plain(*inputs, cost=cost, ppy=252)
    torch.cuda.synchronize()
    names = fused.Metrics._fields
    max_abs = max_rel = 0.0
    for k, name in enumerate(names):
        a, b = got[k], ref[k]
        _check(bool(torch.isfinite(a).all()), f"{label}: {name} not finite")
        err = (a - b).abs()
        if name in ("n_trades", "turnover"):
            _check(bool(torch.equal(a, b)),
                   f"{label}: {name} differs (max {float(err.max())}): "
                   "positions are not identical")
        bad = err > ATOL + RTOL * b.abs()
        _check(not bool(bad.any()),
               f"{label}: {name} off in {int(bad.sum())} cells, max abs err "
               f"{float(err.max())}")
        max_abs = max(max_abs, float(err.max()))
        max_rel = max(max_rel, float((err / b.abs().clamp_min(1e-6)).max()))
    print(f"k1 {label}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e}")
    return max_abs, max_rel


def _k1_bound_ms(inputs) -> tuple[float, str]:
    cs, _, tr, fast, _, warm = inputs
    N, T = cs.shape
    P = fast.shape[0]
    trf = tr.double()[:, None]
    signal = (trf - (warm.double()[None, :] - 1)).clamp_min(0)
    ops = float(OPS_PER_BAR * trf.sum() * P
                + OPS_PER_SIGNAL_BAR * torch.minimum(signal, trf).sum())
    n_bytes = 4 * (2 * N * T + N + 3 * P + 9 * N * P)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, n_bytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_kernels(fused, pnl, data) -> dict:
    grid_f = np.repeat(FAST_AXIS, SLOW_AXIS.size)
    grid_s = np.tile(SLOW_AXIS, FAST_AXIS.size)
    head = data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=0).close
    main_in = _k1_inputs(fused, pnl, head, None, grid_f, grid_s)
    errs = [_k1_compare(fused, "headline 500x1260x2000 cost=1e-3", main_in,
                        COST)]
    small = head[:32]
    errs.append(_k1_compare(
        fused, "32x1260x2000 cost=0",
        _k1_inputs(fused, pnl, small, None, grid_f, grid_s), 0.0))
    lens = np.random.default_rng(1).integers(200, N_BARS + 1, 32)
    ragged = small.copy()
    for i, n in enumerate(lens):
        ragged[i, n:] = ragged[i, n - 1]
    errs.append(_k1_compare(
        fused, "ragged 32x1260x2000",
        _k1_inputs(fused, pnl, ragged, lens, grid_f, grid_s), COST))
    short = data.synthetic_ohlcv(32, 251, seed=3).close
    errs.append(_k1_compare(
        fused, "32x251x2000",
        _k1_inputs(fused, pnl, short, None, grid_f, grid_s), COST))

    ms = _cuda_ms(lambda: fused.fused_sma_cuda(*main_in, cost=COST, ppy=252),
                  reps=20, warmup=2)
    plain_ms = _cuda_ms(
        lambda: fused.fused_sma_plain(*main_in, cost=COST, ppy=252),
        reps=2, warmup=1)
    bound_ms, bound_by = _k1_bound_ms(main_in)
    print(f"k1 headline: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "fused_sma", "route": "cuda",
            "source": "distributed_backtesting_exploration_tpu_torch/csrc/"
                      "fused_sma.cu",
            "replaces": "distributed_backtesting_exploration_tpu/ops/"
                        "fused.py:728",
            "tpu_kernel": "ops/fused.py:_fused_call",
            "max_abs_err": max(e[0] for e in errs),
            "max_rel_err": max(e[1] for e in errs),
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _jobs_from_panel(pb, data, panel):
    grid = {"fast": pb.GridAxis(values=[float(v) for v in FAST_AXIS]),
            "slow": pb.GridAxis(values=[float(v) for v in SLOW_AXIS])}
    jobs = [pb.JobSpec(
        id=f"job-{i:04d}", strategy="sma_crossover",
        ohlcv=data.to_wire_bytes(data.OHLCV(*(f[i] for f in panel))),
        grid=grid, cost=COST, periods_per_year=252)
        for i in range(panel.close.shape[0])]
    return jobs


def _main_path_stages(jobs, data, wire, fused) -> None:
    """One batch's host stages timed apart, in the backend's order: DBX1
    decode, stacking, the fused sweep with its host<->device copies, and
    DBXM packing."""
    t = [time.perf_counter()]
    series = [data.from_wire_bytes(j.ohlcv) for j in jobs]
    t.append(time.perf_counter())
    close = np.stack([s.close for s in series])
    fast = np.repeat(FAST_AXIS, SLOW_AXIS.size)
    slow = np.tile(SLOW_AXIS, FAST_AXIS.size)
    t.append(time.perf_counter())
    m = fused.fused_sma_sweep(close, fast, slow, cost=COST, device="cuda")
    host = torch.stack(list(m)).cpu().numpy()
    t.append(time.perf_counter())
    for i in range(len(jobs)):
        wire.metrics_to_bytes(fused.Metrics(*host[:, i]))
    t.append(time.perf_counter())
    names = ("decode", "stack", "sweep+copies", "pack")
    print("main path stages (s): " + ", ".join(
        f"{n} {b - a:.4f}" for n, a, b in zip(names, t, t[1:])))


def phase_main_path(kernels_mod, compute, wire, pb, data, sweep, models,
                    fused):
    jobs = _jobs_from_panel(
        pb, data, data.synthetic_ohlcv(N_TICKERS, N_BARS, seed=7))
    backend = compute.TorchSweepBackend(device="cuda")
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    done = backend.process(jobs)
    batch_s = time.perf_counter() - t0
    launches = dict(kernels_mod.LAUNCHES)
    print(f"main path launches {launches}")
    _check(launches.get("fused_sma", 0) > 0,
           "the main path launched K1 no time")

    _check(len(done) == len(jobs), f"{len(done)} completions for "
           f"{len(jobs)} jobs")
    by_id = {c.job_id: wire.metrics_from_bytes(c.metrics) for c in done}
    _check(set(by_id) == {j.id for j in jobs}, "completion ids differ")
    n_combos = FAST_AXIS.size * SLOW_AXIS.size
    for jid, m in by_id.items():
        for f in m:
            _check(f.shape == (n_combos,), f"{jid}: shape {f.shape}")
        _check(bool(np.isfinite(m.sharpe).all()), f"{jid}: sharpe not finite")

    # The golden path (the port's generic sweep, independent code) on a
    # small batch through the same backend. Closes are on a 1/32 tick grid
    # so every cumsum is exact in f32 whatever its association: both paths
    # then take identical positions, and the metrics may differ only by
    # the order of their sums.
    k = 16
    small = data.synthetic_ohlcv(k, N_BARS, seed=11)
    small = data.OHLCV(*(np.round(f * 32) / np.float32(32) for f in small))
    _check(float(small.close.sum(axis=1).max()) * 32 < 2 ** 24,
           "tick-grid closes too large for an exact f32 cumsum")
    gjobs = _jobs_from_panel(pb, data, small)
    gdone = {c.job_id: wire.metrics_from_bytes(c.metrics)
             for c in backend.process(gjobs)}
    grid = sweep.product_grid(fast=FAST_AXIS, slow=SLOW_AXIS)
    gold = sweep.run_sweep(small, models.get_strategy("sma_crossover"), grid,
                           cost=COST, device="cuda")
    for name in gold._fields:
        a = np.stack([getattr(gdone[j.id], name) for j in gjobs])
        b = getattr(gold, name).cpu().numpy()
        bad = np.abs(a - b) > ATOL + RTOL * np.abs(b)
        _check(not bad.any(), f"main path vs golden path: {name} off in "
               f"{int(bad.sum())} cells, max abs err "
               f"{float(np.abs(a - b).max())}")
    print(f"main path vs golden path: {k} jobs x {n_combos} combos agree")

    # Host time of one batch varies by several times between identical
    # calls (the card's host shares its cores), so report min and median.
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        backend.process(jobs)
        times.append(time.perf_counter() - t0)
    med, best = statistics.median(times), min(times)
    n_bt = len(jobs) * n_combos
    print(f"main path: {len(jobs)} jobs x {n_combos} combos, first batch "
          f"{batch_s:.4f} s; 10 more: min {best:.4f} s "
          f"({n_bt / best:.1f} backtests/s), median {med:.4f} s "
          f"({n_bt / med:.1f} backtests/s), max {max(times):.4f} s")
    _main_path_stages(jobs, data, wire, fused)
    return launches


def main() -> None:
    phase_card()
    from distributed_backtesting_exploration_tpu_torch import models
    from distributed_backtesting_exploration_tpu_torch.ops import (
        _kernels, fused, pnl)
    from distributed_backtesting_exploration_tpu_torch.parallel import sweep
    from distributed_backtesting_exploration_tpu_torch.rpc import (
        backtesting_pb2 as pb, compute, wire)
    from distributed_backtesting_exploration_tpu_torch.utils import data

    phase_build(_kernels)
    k1 = phase_kernels(fused, pnl, data)
    launches = phase_main_path(_kernels, compute, wire, pb, data, sweep,
                               models, fused)
    k1["launches"] = launches.get("fused_sma", 0)
    print(json.dumps({"kernels": [k1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
