"""The port worker's tune legs over the real RPCs of the reference's
dispatcher, on the CPU.

A port worker tunes a group (``DBX_AUTOTUNE=model``), pushes the winner up
on ``JobsRequest.schedule_json`` into the dispatcher's ``fleet_schedule``,
and offers a library its build wrote through ``OfferCompiled``; a second
port worker, started cold, installs that library through ``FetchCompiled``
and adopts the winner from ``GetStats``. The JAX package's ``CacheSync``
refuses the port's entries. The libraries are stand-in bytes under the
names ``ops/_kernels.build`` gives (no ``nvcc`` here).
"""

import threading
import time

import grpc

from distributed_backtesting_exploration_tpu import tune as ref_tune
from distributed_backtesting_exploration_tpu.rpc.dispatcher import (
    Dispatcher, DispatcherServer, JobQueue, PeerRegistry, parse_grid,
    synthetic_jobs)
from distributed_backtesting_exploration_tpu_torch import tune
from distributed_backtesting_exploration_tpu_torch.ops import _kernels
from distributed_backtesting_exploration_tpu_torch.rpc import compute
from distributed_backtesting_exploration_tpu_torch.rpc.worker import Worker

SMA = parse_grid("fast=3:5,slow=10:14:2")


def _until(cond, what: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def _start(target, backend):
    w = Worker(target, backend, poll_interval_s=0.02, status_interval_s=0.05)
    w.tune_sync_interval_s = 0.05
    t = threading.Thread(target=w.run, daemon=True)
    t.start()
    _until(lambda: w._compile_sync is not None, "the worker's cache sync")
    return w, t


def test_two_port_workers_share_a_winner_and_a_library(tmp_path,
                                                       monkeypatch):
    for var in ("DBX_SCHEDULE_DIR", "DBX_LANES_CAP", "DBX_COMPILE_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("DBX_AUTOTUNE", "model")
    monkeypatch.setattr(_kernels, "BUILD_DIR", None)
    queue = JobQueue()
    disp = Dispatcher(queue, PeerRegistry(prune_window_s=30.0))
    srv = DispatcherServer(disp, bind="localhost:0",
                           prune_interval_s=0.1).start()
    target = f"localhost:{srv.port}"
    workers = []
    try:
        # Worker A: its build directory, a group tuned on first contact.
        tune.configure(str(tmp_path / "a"))
        backend_a = compute.TorchSweepBackend(device="cpu")
        workers.append(_start(target, backend_a))
        recs = synthetic_jobs(3, 96, "sma_crossover", SMA, cost=1e-3,
                              seed=41)
        for r in recs:
            queue.enqueue(r)
        _until(lambda: queue.stats()["jobs_completed"] == len(recs),
               "worker A's jobs")
        bucket = tune.group_bucket(96, 9, 3)
        won = backend_a.schedule_registry.lookup("sma_crossover", bucket,
                                                 "torch-cpu")
        assert won is not None
        _until(lambda: disp.fleet_schedule.lookup(
            "sma_crossover", bucket, "torch-cpu") == won,
            "the winner in the dispatcher's fleet schedule")
        # A library worker A's build writes: offered on its next tick.
        lib = _kernels.library_path("fused_sma")
        assert lib.parent == tmp_path / "a"
        lib.write_bytes(b"\x7fELF stand-in library")
        _until(lambda: len(disp.compile_store.keys()) == 1,
               "the library in the dispatcher's store")
        key = disp.compile_store.keys()[0]
        assert key == tune.entry_key(lib.name)

        # Worker B, cold: another build directory, an empty registry.
        tune.configure(str(tmp_path / "b"))
        backend_b = compute.TorchSweepBackend(device="cpu")
        assert len(backend_b.schedule_registry) == 0
        workers.append(_start(target, backend_b))
        _until(lambda: backend_b.schedule_registry.lookup(
            "sma_crossover", bucket, "torch-cpu") == won,
            "worker B adopting the winner")
        installed = tmp_path / "b" / lib.name
        _until(installed.exists, "worker B installing the library")
        assert installed.read_bytes() == lib.read_bytes()
        assert _kernels.library_path("fused_sma") == installed
        # Adopted entries are not pushed back up.
        assert backend_b.schedule_registry.take_dirty_json() == ""
    finally:
        for w, t in workers:
            w.stop()
            t.join(timeout=30)
        srv.stop()
    assert all(not t.is_alive() for _, t in workers)

    # The JAX package's sync refuses the port's entries, and remembers.
    entries = [(k, *disp.compile_store.get(k))
               for k in disp.compile_store.keys()]
    jax_sync = ref_tune.CacheSync(str(tmp_path / "jax"))
    assert jax_sync.install(entries) == 0
    assert jax_sync.missing([key]) == []
    assert not any((tmp_path / "jax").iterdir())


class _Unavailable(grpc.RpcError):
    def code(self):
        return grpc.StatusCode.UNAVAILABLE


class _Down:
    """A stub whose every RPC fails."""

    def __getattr__(self, name):
        def call(*_a, **_k):
            raise _Unavailable(name)
        return call


def test_a_failed_leg_keeps_its_entries_for_the_next_tick(tmp_path,
                                                          monkeypatch):
    monkeypatch.delenv("DBX_SCHEDULE_DIR", raising=False)
    backend = compute.TorchSweepBackend(device="cpu")
    reg = backend.schedule_registry
    reg.record("trix", "t128_p128", "torch-cpu", {"lanes_cap": "256"},
               trials=3, best_us=2.0)
    w = Worker("localhost:1", backend)
    # The push leg: a failed poll marks its entries to be sent again.
    assert w._poll(_Down()) is None
    assert '"trix"' in reg.take_dirty_json()
    # The offer leg: a failed offer leaves the library to offer again.
    w._compile_sync = tune.CacheSync(str(tmp_path))
    (tmp_path / "libema_rows-00000000000000aa.so").write_bytes(b"lib")
    w._sync_tune(_Down())
    again = w._compile_sync.poll_new()
    assert [n for _, n, _ in again] == ["libema_rows-00000000000000aa.so"]
    assert again[0][2] == b"lib"
