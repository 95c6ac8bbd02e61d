"""The whole slice on the CPU: the port's dispatcher serving workers over
loopback gRPC.

Eight tickers x 256 bars, a small sma grid, cost 1e-3, explicit job ids.

- The port dispatcher and the port worker (``device="cpu"``) drain the
  jobs (one of them top-k) to blocks that agree with the JAX dispatcher
  and the JAX worker under ``tests/torch_parity.py``'s flip rule, and are
  bit-equal to ``TorchSweepBackend.process`` of the same jobs called
  directly; the journal replays to every job completed.
- A JAX worker draining the port dispatcher gives the JAX loop's blocks.
- A digest-only second pass, two ``AppendBars`` rounds on eight streams,
  scenario specs on both rungs (coalesced for the worker, materialized
  by the dispatcher) and a restart from the journal, each bit-equal to
  the direct backend.
"""

import dataclasses
import glob
import os
import threading
import time

import grpc
import numpy as np
import pytest

from distributed_backtesting_exploration_tpu.rpc import (
    compute as ref_compute, dispatcher as ref_disp, wire as ref_wire,
    worker as ref_worker)
from distributed_backtesting_exploration_tpu_torch import obs as port_obs
from distributed_backtesting_exploration_tpu_torch.rpc import (
    backtesting_pb2 as pb, compute, dispatcher as port_disp, service, wire)
from distributed_backtesting_exploration_tpu_torch.rpc.journal import Journal
from distributed_backtesting_exploration_tpu_torch.rpc.worker import Worker
from distributed_backtesting_exploration_tpu_torch.utils import data

from torch_parity import assert_metrics_match

GRID = port_disp.parse_grid("fast=3:7,slow=12:20:4")
N, BARS = 8, 256


def _recs(prefix="job", seed=11, **kw) -> list:
    return [dataclasses.replace(r, id=f"{prefix}-{i}")
            for i, r in enumerate(port_disp.synthetic_jobs(
                N, BARS, "sma_crossover", GRID, cost=1e-3, seed=seed,
                **kw))]


def _as(disp, recs):
    """``recs`` as records of ``disp``'s package (same fields)."""
    return [disp.JobRecord(**{f.name: getattr(r, f.name)
                              for f in dataclasses.fields(r)})
            for r in recs]


def _wait(pred, timeout=120.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


class _Loop:
    """One dispatcher server and one worker thread around it."""

    def __init__(self, disp, queue, worker_cls, backend, results_dir, *,
                 port=0, jobs_per_chip=4):
        self.disp = disp.Dispatcher(
            queue, disp.PeerRegistry(prune_window_s=30.0),
            results_dir=str(results_dir),
            **({"registry": port_obs.Registry()} if disp is port_disp
               else {}))
        self.srv = disp.DispatcherServer(
            self.disp, bind=f"localhost:{port}",
            prune_interval_s=0.2).start()
        self.queue = queue
        self.worker = worker_cls(f"localhost:{self.srv.port}", backend,
                                 worker_id="w-loop", poll_interval_s=0.005,
                                 status_interval_s=0.1,
                                 jobs_per_chip=jobs_per_chip)
        self.thread = threading.Thread(target=self.worker.run, daemon=True)
        self.thread.start()

    def drain(self, recs):
        for r in recs:
            self.queue.enqueue(r)
        _wait(lambda: self.queue.drained, msg=str(self.queue.stats()))

    def close(self):
        self.worker.stop()
        self.thread.join(timeout=60)
        self.srv.stop()
        self.disp.close()
        assert not self.thread.is_alive()


def _blocks(results_dir, ids) -> dict:
    out = {}
    for jid in ids:
        (path,) = glob.glob(os.path.join(str(results_dir), f"{jid}.*"))
        with open(path, "rb") as fh:
            out[jid] = fh.read()
    return out


def _specs(recs):
    return [pb.JobSpec(id=r.id, strategy=r.strategy, ohlcv=r.ohlcv,
                       grid=wire.grid_to_proto(r.grid), cost=r.cost,
                       periods_per_year=252, top_k=r.top_k,
                       rank_metric=r.rank_metric) for r in recs]


def _direct(recs) -> dict:
    return {c.job_id: c.metrics for c in
            compute.TorchSweepBackend(device="cpu").process(_specs(recs))}


def _jobs():
    return _recs() + [dataclasses.replace(r, id="topk-0") for r in _recs(
        seed=12, top_k=4, rank_metric="sharpe")[:1]]


@pytest.fixture(scope="module")
def jax_loop(tmp_path_factory):
    """The JAX dispatcher and the JAX worker over the same jobs."""
    res = tmp_path_factory.mktemp("jax-results")
    recs = _as(ref_disp, _jobs())
    loop = _Loop(ref_disp, ref_disp.JobQueue(), ref_worker.Worker,
                 ref_compute.JaxSweepBackend(use_fused=True), res)
    try:
        loop.drain(recs)
    finally:
        loop.close()
    return _blocks(res, [r.id for r in recs])


def _assert_agree(got: dict, want: dict):
    assert got.keys() == want.keys()
    for jid in want:
        kind = wire.result_kind(got[jid])
        assert kind == ref_wire.result_kind(want[jid])
        if kind == "topk":
            gi, gm, gr = wire.topk_from_bytes(got[jid])
            wi, wm, wr = ref_wire.topk_from_bytes(want[jid])
            assert gr == wr
            np.testing.assert_array_equal(gi, wi)
            assert_metrics_match(gm, wm)
        else:
            assert_metrics_match(wire.metrics_from_bytes(got[jid]),
                                 ref_wire.metrics_from_bytes(want[jid]))


def test_port_loop_agrees_with_the_jax_loop(tmp_path, jax_loop):
    recs = _jobs()
    jp = str(tmp_path / "q.jsonl")
    q = port_disp.JobQueue(Journal(jp), device="cpu")
    loop = _Loop(port_disp, q, Worker,
                 compute.TorchSweepBackend(device="cpu"), tmp_path / "res")
    try:
        loop.drain(recs)
    finally:
        loop.close()
        q._journal.close()
    got = _blocks(tmp_path / "res", [r.id for r in recs])
    assert got == _direct(recs)
    _assert_agree(got, jax_loop)
    st = Journal.replay(jp)
    assert len(st.completed) == len(recs) and not st.pending


def test_jax_worker_drains_the_port_dispatcher(tmp_path, jax_loop):
    recs = _jobs()
    q = port_disp.JobQueue(device="cpu")
    loop = _Loop(port_disp, q, ref_worker.Worker,
                 ref_compute.JaxSweepBackend(use_fused=True),
                 tmp_path / "res")
    try:
        loop.drain(recs)
    finally:
        loop.close()
    got = _blocks(tmp_path / "res", [r.id for r in recs])
    assert got.keys() == jax_loop.keys()
    for jid, blob in jax_loop.items():
        assert got[jid] == blob, jid


class _Recording(compute.TorchSweepBackend):
    """The port's backend, keeping a copy of every batch it is given."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.batches = []

    def submit(self, jobs):
        batch = []
        for j in jobs:
            c = pb.JobSpec()
            c.CopyFrom(j)
            batch.append(c)
        self.batches.append(batch)
        return super().submit(jobs)


def _replay(batches) -> dict:
    """A fresh backend's blocks for the same batches in the same order."""
    fresh = compute.TorchSweepBackend(device="cpu")
    out = {}
    for batch in batches:
        out.update((c.job_id, c.metrics) for c in fresh.process(batch))
    return out, fresh


def test_digest_only_pass_and_append_rounds(tmp_path):
    cold = _recs(prefix="cold", seed=21)
    again = [dataclasses.replace(r, id=f"again-{i}")
             for i, r in enumerate(cold)]
    q = port_disp.JobQueue(device="cpu")
    backend = _Recording(device="cpu")
    loop = _Loop(port_disp, q, Worker, backend, tmp_path / "res")
    full = data.synthetic_ohlcv(N, BARS + 32, seed=21)
    channel = grpc.insecure_channel(
        f"localhost:{loop.srv.port}",
        options=service.default_channel_options())
    stub = service.DispatcherStub(channel)
    tmpl = pb.JobSpec(strategy="sma_crossover",
                      grid=wire.grid_to_proto(GRID), cost=1e-3,
                      periods_per_year=252)
    digest_only = loop.disp._c_payloads["digest_only"]
    appended = []
    try:
        loop.drain(cold)
        d0 = digest_only.value
        loop.drain(again)
        assert digest_only.value - d0 == N
        heads = {r.id: (r.panel_digest, BARS) for r in cold}
        for lo in (BARS, BARS + 16):
            for i, r in enumerate(cold):
                dig, n = heads[r.id]
                delta = data.to_wire_bytes(data.OHLCV(*(
                    np.asarray(f[i, lo:lo + 16]) for f in full)))
                reply = stub.AppendBars(pb.AppendRequest(
                    worker_id="feed", panel_digest=dig, base_len=n,
                    delta=delta, job=tmpl))
                assert reply.ok, reply.detail
                heads[r.id] = (reply.panel_digest, reply.new_len)
                appended.append(reply.job_id)
            _wait(lambda: q.drained, msg="appends drained")
    finally:
        channel.close()
        loop.close()
    ids = [r.id for r in cold + again] + appended
    got = _blocks(tmp_path / "res", ids)
    for a, b in zip(cold, again):
        assert got[a.id] == got[b.id]
    want, fresh = _replay(backend.batches)
    assert {j: got[j] for j in want} == want and set(want) == set(ids)
    assert backend.appends == fresh.appends
    assert backend.appends["carry_hit"] == N


@pytest.mark.parametrize("fused", ["1", "0"])
def test_scenario_rungs_give_one_set_of_blocks(tmp_path, monkeypatch,
                                               fused):
    k = 6
    base = _recs(prefix="base", seed=31)[0]
    q = port_disp.JobQueue(device="cpu")
    q.enqueue(base)
    specs = port_disp.scenario_jobs(
        base.panel_digest, k, "sma_crossover", GRID, cost=1e-3,
        params={"n_bars": 192, "seed": 3})
    specs = [dataclasses.replace(r, id=f"scn-{i}")
             for i, r in enumerate(specs)]
    monkeypatch.setenv("DBX_SCENARIO_FUSED", fused)
    backend = _Recording(device="cpu")
    loop = _Loop(port_disp, q, Worker, backend, tmp_path / "res",
                 jobs_per_chip=k + 1)
    try:
        _wait(lambda: q.drained, msg="base drained")
        loop.drain(specs)
        store = q.panel_store.stats()["panels"]
    finally:
        loop.close()
    got = _blocks(tmp_path / "res", [r.id for r in specs])
    assert store == (1 if fused == "1" else 1 + k)
    routes = backend.stats()["scenarios"]
    if fused == "1":
        assert any(v for key, v in routes.items() if "fused" in key), routes
    # Both rungs give the blocks of the materialized panels swept directly.
    mat = port_disp.JobQueue(device="cpu")
    mat.enqueue(dataclasses.replace(base, id="base-again"))
    want = {}
    for r in specs:
        blob, _ = mat._scenario_payload(r.scenario)
        want.update(_direct([dataclasses.replace(r, ohlcv=blob)]))
    assert got == want


def test_restart_from_the_journal(tmp_path):
    recs = _recs(prefix="rs", seed=41)
    jp = str(tmp_path / "q.jsonl")
    q = port_disp.JobQueue(Journal(jp), device="cpu")
    loop = _Loop(port_disp, q, Worker,
                 compute.TorchSweepBackend(device="cpu"), tmp_path / "res",
                 jobs_per_chip=1)
    port = loop.srv.port
    for r in recs:
        q.enqueue(r)
    try:
        _wait(lambda: q.stats()["jobs_completed"] >= 1, msg="first")
        loop.srv.stop()
        loop.disp.close()
        q._journal.close()
        q2 = port_disp.JobQueue(Journal(jp), device="cpu")
        assert q2.restore(jp) >= 1
        d2 = port_disp.Dispatcher(
            q2, port_disp.PeerRegistry(prune_window_s=30.0),
            results_dir=str(tmp_path / "res"),
            registry=port_obs.Registry())
        srv2 = port_disp.DispatcherServer(
            d2, bind=f"localhost:{port}", prune_interval_s=0.2).start()
        try:
            _wait(lambda: q2.drained, msg=str(q2.stats()))
        finally:
            loop.worker.stop()
            loop.thread.join(timeout=60)
            srv2.stop()
            d2.close()
            q2._journal.close()
    finally:
        loop.worker.stop()
    files = sorted(os.listdir(tmp_path / "res"))
    assert files == sorted(f"{r.id}.dbxm" for r in recs)
    assert _blocks(tmp_path / "res", [r.id for r in recs]) == _direct(recs)
    st = Journal.replay(jp)
    assert not st.pending and st.completed == {r.id for r in recs}
