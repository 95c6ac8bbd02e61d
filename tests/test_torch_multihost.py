"""Process groups (``parallel/multihost.py``) and the slice worker
(``rpc/slice_worker.py``) of the port: two OS processes on gloo over
loopback, each with a mesh of ``["cpu"] * 2``.

``initialize()`` without arguments or cluster environment is a no-op
(the multihost half of ``tests/test_checkpoint_multihost.py``). Two ranks
each sweep their ``host_shard`` of a panel; gathered, the metrics equal the
one-process sweep bit for bit, and one ``run`` and one ``run_ts`` round of
the slice equal the single-host backend's blocks bit for bit. Then a slice
of two port processes drains a live JAX ``DispatcherServer`` in this
process: every block equals the single-host port backend's, and the job
kinds the slice does not implement complete empty. The children import no
JAX; each runs under a timeout and is killed at it.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from distributed_backtesting_exploration_tpu.rpc.dispatcher import (
    Dispatcher, DispatcherServer, JobQueue, PeerRegistry, synthetic_jobs)
from distributed_backtesting_exploration_tpu_torch.models import base
from distributed_backtesting_exploration_tpu_torch.parallel import (
    multihost, sharding, sweep)
from distributed_backtesting_exploration_tpu_torch.rpc import (
    backtesting_pb2 as pb, compute, wire)
from distributed_backtesting_exploration_tpu_torch.utils import data

REPO = Path(__file__).resolve().parent.parent
CHILD_S = 60
SMA = {"fast": [5.0, 8.0], "slow": [20.0, 30.0]}
MOM = {"lookback": [5.0, 9.0, 20.0]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(code: str, *args) -> list:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return [subprocess.Popen([sys.executable, "-c", code, str(rank), *args],
                             cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for rank in range(2)]


def _join(procs) -> list:
    """Wait for the children, killing every one at the timeout."""
    outs, deadline = [], time.monotonic() + CHILD_S
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1)))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a child did not finish in {CHILD_S} s")
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs


def test_initialize_is_a_noop_without_a_cluster(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize() == 1
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.host_shard(10) == slice(0, 10)
    assert multihost.host_shard(0) == slice(0, 0)


_ROUNDS = """
import pickle, sys
import numpy as np, torch
from distributed_backtesting_exploration_tpu_torch.models import base
from distributed_backtesting_exploration_tpu_torch.parallel import (
    multihost, sharding, sweep)
from distributed_backtesting_exploration_tpu_torch.rpc import slice_worker
from distributed_backtesting_exploration_tpu_torch.utils import data
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
assert multihost.initialize(f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank) == 2
assert multihost.host_shard(64) == (slice(0, 32) if rank == 0
                                    else slice(32, 64))
mesh = sharding.make_mesh(["cpu"] * 2)
panel = data.synthetic_ohlcv(64, 300, seed=3)
mine = data.OHLCV(*(f[multihost.host_shard(64)] for f in panel))
grid = sweep.product_grid(**{k: np.float32(v) for k, v in %(sma)r.items()})
m = sharding.sharded_sweep(mesh, mine, base.get_strategy("sma_crossover"),
                           grid, cost=1e-3)
parts = slice_worker._gather(torch.stack(list(m)).numpy())
runner = slice_worker.SliceRunner(mesh)
runner.backend._LONG_CONTEXT_BARS = 192
cost = float(np.float32(1e-3))
rounds = [("sma_crossover", %(sma)r, 5), ("momentum", %(mom)r, 1)]
blocks = []
for strategy, axes, n in rounds:
    msg = arrays = None
    if rank == 0:
        series = [data.OHLCV(*(f[i] for f in panel)) for i in range(n)]
        msg, arrays = slice_worker.group_message(
            strategy, {k: np.float32(v) for k, v in axes.items()}, cost, 252,
            series, runner)
    hdr, got = runner.round(msg, arrays)
    blocks.append((hdr["op"], got))
runner.round(slice_worker.STOP if rank == 0 else None)
assert "jax" not in sys.modules
if rank == 0:
    with open(out, "wb") as f:
        pickle.dump((np.concatenate(parts, axis=1), blocks, runner.chips,
                     runner.shards), f)
""" % {"sma": SMA, "mom": MOM}


def _spec(panel, i, strategy, axes):
    return pb.JobSpec(id=str(i), strategy=strategy, ohlcv=data.to_wire_bytes(
        data.OHLCV(*(f[i] for f in panel))), grid=wire.grid_to_proto(axes),
        cost=1e-3, periods_per_year=252)


def test_two_processes_sweep_and_run_slice_rounds(tmp_path):
    import pickle

    out = tmp_path / "rank0.pkl"
    _join(_spawn(_ROUNDS, str(_free_port()), str(out)))
    planes, blocks, chips, shards = pickle.loads(out.read_bytes())
    assert (chips, shards) == (1, 4)
    panel = data.synthetic_ohlcv(64, 300, seed=3)
    grid = sweep.product_grid(**{k: np.float32(v) for k, v in SMA.items()})
    one = sweep.run_sweep(panel, base.get_strategy("sma_crossover"), grid,
                          cost=1e-3, device="cpu")
    np.testing.assert_array_equal(planes, np.stack([f.numpy() for f in one]))
    backend = compute.TorchSweepBackend(mesh=sharding.make_mesh(["cpu"] * 2))
    backend._LONG_CONTEXT_BARS = 192
    for (op, got), (strategy, axes, n), want_op in zip(
            blocks, [("sma_crossover", SMA, 5), ("momentum", MOM, 1)],
            ["run", "run_ts"]):
        assert op == want_op
        done = backend.process([_spec(panel, i, strategy, axes)
                                for i in range(n)])
        assert got == [c.metrics for c in done]


_SLICE = """
import sys
from distributed_backtesting_exploration_tpu_torch.parallel import (
    multihost, sharding)
from distributed_backtesting_exploration_tpu_torch.rpc import slice_worker
rank, port, target = int(sys.argv[1]), sys.argv[2], sys.argv[3]
multihost.initialize(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
runner = slice_worker.SliceRunner(sharding.make_mesh(["cpu"] * 2))
runner.backend._LONG_CONTEXT_BARS = 192
worker = slice_worker.SliceWorker(target, runner, poll_interval_s=0.05,
                                  jobs_per_chip=16)
worker.run(max_idle_polls=20)
assert "jax" not in sys.modules
print("completed", worker.jobs_completed if rank == 0 else 0)
"""


def test_slice_of_two_processes_drains_the_jax_dispatcher():
    recs = (synthetic_jobs(5, 100, "sma_crossover", SMA, cost=1e-3, seed=1)
            + synthetic_jobs(1, 300, "momentum", MOM, cost=1e-3, seed=2)
            + synthetic_jobs(1, 100, "pairs", {"lookback": [8.0],
                                               "z_entry": [1.0]},
                             cost=1e-3, seed=3))
    queue = JobQueue()
    for r in recs:
        queue.enqueue(r)
    disp = Dispatcher(queue, PeerRegistry(prune_window_s=30.0))
    srv = DispatcherServer(disp, bind="localhost:0",
                           prune_interval_s=0.5).start()
    try:
        outs = _join(_spawn(_SLICE, str(_free_port()),
                            f"localhost:{srv.port}"))
        assert queue.drained, queue.stats()
    finally:
        srv.stop()
    assert outs[0][0].split() == ["completed", str(len(recs))]
    backend = compute.TorchSweepBackend(mesh=sharding.make_mesh(["cpu"] * 2))
    backend._LONG_CONTEXT_BARS = 192
    plain = [r for r in recs if r.strategy != "pairs"]
    want = {c.job_id: c.metrics for c in backend.process([
        pb.JobSpec(id=r.id, strategy=r.strategy, ohlcv=r.ohlcv,
                   grid=wire.grid_to_proto(r.grid), cost=r.cost,
                   periods_per_year=252) for r in plain])}
    for r in plain:
        assert disp.results[r.id] == want[r.id], r.strategy
    # Pairs are not in the slice: completed, with no block stored.
    assert queue.stats()["jobs_completed"] == len(recs)
    assert disp.results.get(recs[-1].id, b"") == b""
