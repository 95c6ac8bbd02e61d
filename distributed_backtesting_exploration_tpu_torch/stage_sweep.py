"""K8's layout sweep on the card: ``csrc/stages.cu`` built with other
cluster sizes, block depths and rings (its ``DBX_STAGE_*`` build settings),
each build's stages run at the port bench's shape (500 tickers x 1260 bars
of its seed-0 panel, the SMA and bollinger grids) at 128 lanes, held
bit-equal to their plain versions and timed.

    python -m distributed_backtesting_exploration_tpu_torch.stage_sweep

The shipped build (clusters of 2 CTAs and of 16 for touch, a ring of 2,
blocks as deep as the table's width and the lanes allow) is the one the
wrappers launch; no setting changes a bit of the output. Prints one line a
(kind, stage, setting) with the device ms of one launch at each value (a
CUDA graph of 20 launches, so the host's launch cost is left out: the
layouts differ on the card alone), then the card's name and power limit.
Needs a CUDA card and nvcc; every variant builds at once.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor

import torch

from . import bench, roofline
from .ops import _kernels, stages
from .utils import data

# Each setting's values, the stages it is swept for (touch has no blocks:
# only the cluster size moves it) and the -D settings of one value.
SWEEPS = {
    "cluster": ((1, 2, 4, 8, 16),
                ("touch", "matmul", "signal", "no_ladders", "full"),
                lambda c: (f"DBX_STAGE_CLUSTER={c}",
                           f"DBX_TOUCH_CLUSTER={c}")),
    "bars": ((4, 8, 12, 20, 28, 36, 52, 68), ("matmul", "full"),
             lambda b: (f"DBX_STAGE_BARS={b}",)),
    "ring": ((2, 3, 4, 6, 8), ("matmul", "full"),
             lambda r: (f"DBX_STAGE_RING={r}",)),
}
LANES, REPS = 128, 20


def _device_ms(fn) -> float:
    """ms of one call of ``fn``, from a CUDA graph of REPS calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPS


def _inputs() -> dict:
    """Each kind's inputs, wrapper and plain version, as the bench runs."""
    close = torch.as_tensor(data.synthetic_ohlcv(500, 1260, seed=0).close,
                            device="cuda")
    axes = roofline.bench_axes()
    sg = roofline.product(axes["sma_crossover"])
    bg = roofline.product(axes["bollinger"])
    return {
        "sma": (stages.sma_stage_inputs(close, sg["fast"], sg["slow"],
                                        device="cuda"),
                stages.sma_stage_cuda, stages.sma_stage_plain),
        "boll": (stages.boll_stage_inputs(close, bg["window"], bg["k"],
                                          device="cuda"),
                 stages.boll_stage_cuda, stages.boll_stage_plain)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("stage_sweep needs a CUDA card")
    builds = [(key, v, make(v)) for key, (values, _, make) in SWEEPS.items()
              for v in values]
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        paths = list(pool.map(lambda b: _kernels.build("stages", b[2]),
                              builds))
    kinds = _inputs()
    refs = {(kind, stage): plain(inp, stage=stage)
            for kind, (inp, _, plain) in kinds.items()
            for stage in SWEEPS["cluster"][1]}
    times = {}
    for (key, value, _), path in zip(builds, paths):
        # The wrappers launch from whatever library stages_lib() holds.
        with _kernels._LOCK:
            _kernels._LIBS["stages"] = ctypes.CDLL(str(path))
        for kind, (inp, kernel, _) in kinds.items():
            for stage in SWEEPS[key][1]:
                got = kernel(inp, stage=stage, lanes=LANES)
                torch.cuda.synchronize()
                if not torch.equal(got, refs[kind, stage]):
                    raise SystemExit(f"{kind} {stage} at {key} {value} "
                                     "differs from its plain version")
                times.setdefault((kind, stage, key), []).append(
                    (value, _device_ms(lambda: kernel(inp, stage=stage,
                                                      lanes=LANES))))
    for (kind, stage, key), row in times.items():
        print(f"k8 {kind}_stage_{stage} {key} sweep (device ms at {LANES} "
              "lanes, every point bit-equal): "
              + ", ".join(f"{v} {t:.4f}" for v, t in row))
    dev = bench.device_info(torch.device("cuda"))
    print(f"card: {dev['name']}, {dev['power_limit']}")


if __name__ == "__main__":
    main()
