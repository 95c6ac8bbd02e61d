"""Host-clock rate of the worker's compute path on one CUDA card.

Times ``TorchSweepBackend.process``, one batch after another, against the
worker's pipelined executor (``rpc/executor.py``, depth 2: one thread
submits a batch while another collects the one before) on the same
batches: ``--batches`` batches of ``--jobs`` sma_crossover jobs, each a
synthetic 1260-bar DBX1 payload inline (no digest, so no cache) with the
bench's 2000-combo grid. Each timed run ends when the last completion is
packed. After an untimed pass, in which the pipelined blocks must equal
``process``'s byte for byte, the two alternate ``--reps`` times. Prints
one JSON line with every run's seconds, the medians as batches/s and
backtests/s, and the card's name and power limit.

    python3 worker_rate.py [--tree DIR] [--batches 8] [--jobs 500] [--reps 10]

``--tree DIR`` imports the package from another tree, such as an
unpacked parent commit, so that two trees are compared in one call on one
card; a tree without the executor reports ``process`` alone.
``chip_smoke.py`` calls :func:`measure` for its pipeline check.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

N_BARS, COST = 1260, 1e-3


def sma_batches(pb, data, roofline, n_batches: int, n_jobs: int) -> list:
    """``n_batches`` batches of ``n_jobs`` sma_crossover JobSpecs on one
    synthetic panel (seed 7, the main path's), the bench grid."""
    axes = roofline.bench_axes()["sma_crossover"]
    grid = {k: pb.GridAxis(values=[float(v) for v in axes[k]])
            for k in sorted(axes)}
    panel = data.synthetic_ohlcv(n_jobs, N_BARS, seed=7)
    raw = [data.to_wire_bytes(data.OHLCV(*(f[i] for f in panel)))
           for i in range(n_jobs)]
    return [[pb.JobSpec(id=f"b{b}-{i:04d}", strategy="sma_crossover",
                        grid=grid, cost=COST, periods_per_year=252,
                        ohlcv=raw[i]) for i in range(n_jobs)]
            for b in range(n_batches)]


def _pipelined(executor, backend, batches, *, keep: bool) -> list:
    """Run ``batches`` through a depth-2 executor; with ``keep`` return
    the completions, else drop them as they come, as the worker does
    once it has reported them."""
    ex = executor.Executor(backend, pipelined=True, depth=2)
    ex.start()
    out = []
    for b in batches:
        ex.inbox.put(b)
        done = ex.take_completions()
        if keep:
            out += done
    if not ex.close(timeout=600.0):
        raise RuntimeError("the pipelined executor did not drain")
    return out + ex.take_completions() if keep else out


def measure(compute, executor, batches, *, reps: int) -> dict:
    """Seconds of each timed run of ``process`` (and of the pipelined
    executor where ``executor`` is given) over ``batches``, the two in
    turns, each leading every other time.

    An untimed first pass builds and loads the kernels, warms the host's
    heap and pinned-memory cache, and raises if the pipelined blocks
    differ from ``process``'s. The timed runs drop each completion once
    packed, as a worker does once it has reported it, so that no run
    holds more than a few batches' blocks.
    """
    backend = compute.TorchSweepBackend(device="cuda")
    serial = [(c.job_id, c.metrics) for b in batches
              for c in backend.process(b)]
    runs: dict = {"process": []}
    if executor is not None:
        piped = [(c.job_id, c.metrics) for c in
                 _pipelined(executor, backend, batches, keep=True)]
        if piped != serial:
            raise RuntimeError("pipelined blocks differ from process's")
        runs["pipelined"] = []
        del piped
    del serial
    for rep in range(reps):
        order = list(runs) if rep % 2 == 0 else list(runs)[::-1]
        for mode in order:
            t0 = time.perf_counter()
            if mode == "process":
                for b in batches:
                    backend.process(b)
            else:
                _pipelined(executor, backend, batches, keep=False)
            runs[mode].append(time.perf_counter() - t0)
    return runs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--jobs", type=int, default=500)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    from distributed_backtesting_exploration_tpu_torch import roofline
    from distributed_backtesting_exploration_tpu_torch.rpc import (
        backtesting_pb2 as pb, compute)
    from distributed_backtesting_exploration_tpu_torch.utils import data
    try:
        from distributed_backtesting_exploration_tpu_torch.rpc import executor
    except ImportError:
        executor = None
    if not torch.cuda.is_available():
        sys.exit("worker_rate: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    batches = sma_batches(pb, data, roofline, args.batches, args.jobs)
    combos = len(batches[0][0].grid["fast"].values) * len(
        batches[0][0].grid["slow"].values)
    runs = measure(compute, executor, batches, reps=args.reps)
    out = {"tree": str(Path(args.tree).resolve()), "card": smi,
           "batches": args.batches, "jobs": args.jobs, "combos": combos,
           "seconds": runs}
    for mode, secs in runs.items():
        med = statistics.median(secs)
        out[f"{mode}_batches_per_s"] = args.batches / med
        out[f"{mode}_backtests_per_s"] = (args.batches * args.jobs * combos
                                          / med)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
