"""Slice-level worker: the processes of a slice serving the dispatcher as
one worker (the reference's ``rpc/slice_worker.py``).

The default scale-out is one worker a host (:mod:`.worker`). When a sweep
must span more devices than one host owns, the hosts form one gloo process
group (:func:`~..parallel.multihost.initialize`) and serve the same
dispatcher contract together:

- **The leader** (rank 0) owns the gRPC side: it polls ``RequestJobs``,
  decodes the payloads, groups the jobs as the single-host backend does
  (strategy, grid, cost, periods per year, bar count) and reports the
  completions. The dispatcher sees one worker advertising the slice's
  distinct devices.
- **A round** (:class:`SliceRunner`, which imports no ``grpc``): the leader
  broadcasts a control message (``run``, ``run_ts``, ``idle`` or ``stop``)
  and the group's arrays over gloo (:func:`_bcast_msg`); every rank runs
  the single-host code on its *local* mesh; one gloo gather brings the
  result blocks to the leader. A plain group splits its rows over the
  ranks (:func:`~..parallel.multihost.host_shard`), each rank's rows going
  through the backend's group path (:class:`~.compute.TorchSweepBackend`
  on the rank's mesh: the fused kernels on each of its shards). A
  long-context group (fewer tickers than the slice has shards, a history
  longer than ``_LONG_CONTEXT_BARS``) splits its grid's combos over the
  ranks, each running the time-sharded backtests
  (:mod:`..parallel.timeshard`) on its local mesh.

No collective inside a backtest crosses processes: where the reference
runs one SPMD program over the global mesh of the slice, here each process
runs its share on its own devices and only host buffers cross (gloo). The
results are the same; the difference is where the split is made.

Job kinds the slice does not implement (pairs, walk-forward, top-k,
best-returns) complete empty with a logged error, as the reference's do:
route them to single-host workers.

Every process of the slice runs, after
``multihost.initialize(init_method, world_size, rank)``,
``SliceWorker(target, SliceRunner(mesh)).run()``; the leader connects to
the dispatcher at ``target``.
"""

from __future__ import annotations

import json
import logging
import socket
import time
import uuid

import numpy as np
import torch
import torch.distributed as dist

from ..ops.metrics import Metrics
from ..parallel import multihost
from ..parallel import sharding
from ..parallel import timeshard
from ..utils import data as data_mod
from . import backtesting_pb2 as pb
from . import compute, wire

log = logging.getLogger("dbx.torch.slice_worker")

STOP = {"op": "stop"}
IDLE = {"op": "idle"}


def _bcast_msg(msg: dict | None, arrays=None):
    """Broadcast a JSON header and an f32 array block from the leader; the
    other ranks pass ``None`` and receive them. Two gloo broadcasts: the
    two lengths, then one byte buffer. Returns ``(header, f32 payload)``."""
    if msg is not None:
        header = json.dumps(msg).encode()
        blob = b"".join(np.ascontiguousarray(a, np.float32).tobytes()
                        for a in (arrays or []))
    if multihost.process_count() == 1:
        return msg, np.frombuffer(blob, np.float32)
    lens = (torch.tensor([len(header), len(blob)], dtype=torch.int64)
            if msg is not None else torch.zeros(2, dtype=torch.int64))
    dist.broadcast(lens, src=0)
    n_h, n_b = int(lens[0]), int(lens[1])
    buf = (torch.frombuffer(bytearray(header + blob), dtype=torch.uint8)
           if msg is not None else torch.empty(n_h + n_b, dtype=torch.uint8))
    dist.broadcast(buf, src=0)
    raw = buf.numpy().tobytes()
    return json.loads(raw[:n_h]), np.frombuffer(raw[n_h:], np.float32)


def _gather(obj):
    """Every rank's ``obj`` on the leader, in rank order (one gloo
    gather); None on the other ranks."""
    if multihost.process_count() == 1:
        return [obj]
    out = ([None] * multihost.process_count()
           if multihost.process_index() == 0 else None)
    dist.gather_object(obj, out, dst=0)
    return out


def _all_gather(obj) -> list:
    if multihost.process_count() == 1:
        return [obj]
    out = [None] * multihost.process_count()
    dist.all_gather_object(out, obj)
    return out


def device_keys(mesh: sharding.Mesh) -> set:
    """Names of the physical devices of ``mesh``, the same in every process
    of a host: a card by its UUID, the CPU by the host's name."""
    keys = set()
    for d in mesh.devices:
        if d.type == "cuda":
            props = torch.cuda.get_device_properties(d)
            keys.add(f"cuda:{getattr(props, 'uuid', d.index)}")
        else:
            keys.add(f"{socket.gethostname()}:{d.type}")
    return keys


class SliceRunner:
    """One rank's side of the slice's rounds; every rank makes one, after
    :func:`~..parallel.multihost.initialize`. Imports no ``grpc``.

    ``chips`` is the slice's distinct-device count (two ranks sharing one
    card count it once); ``shards`` the slice's shards, every rank's mesh
    added up."""

    def __init__(self, mesh: sharding.Mesh | None = None):
        self.mesh = sharding.make_mesh() if mesh is None else mesh
        self.backend = compute.TorchSweepBackend(mesh=self.mesh)
        self.is_leader = multihost.process_index() == 0
        meshes = _all_gather((sorted(device_keys(self.mesh)),
                              self.mesh.size))
        self.chips = len(set().union(*(set(k) for k, _ in meshes)))
        self.shards = sum(n for _, n in meshes)

    def long_context_reason(self, strategy: str, axes, n: int,
                            bars: int) -> str | None:
        """None when a group of ``n`` jobs of ``bars`` bars takes the
        ``run_ts`` round; otherwise why it takes ``run``."""
        if bars <= self.backend._LONG_CONTEXT_BARS or n >= self.shards:
            return "not long-context"
        return compute.timeshard_route_reason(strategy, axes, [bars],
                                              self.mesh.size)

    def round(self, msg: dict | None = None, arrays=None):
        """One round: the leader passes the control message and the group's
        arrays, the other ranks nothing. Returns ``(header, blocks)``:
        on the leader after a ``run`` or ``run_ts`` round one DBXM block a
        job, in the group's order; otherwise None."""
        hdr, payload = _bcast_msg(msg, arrays)
        if hdr["op"] == "run":
            return hdr, self._run(hdr, payload)
        if hdr["op"] == "run_ts":
            return hdr, self._run_ts(hdr, payload)
        return hdr, None

    def _run(self, hdr: dict, payload: np.ndarray):
        """A plain group: this rank's rows through the backend's group path
        on its mesh, the blocks gathered on the leader."""
        n, T = hdr["n"], hdr["bars"]
        panel = payload.reshape(len(data_mod._FIELDS), n, T)
        rows = range(n)[multihost.host_shard(n)]
        blobs = []
        if len(rows):
            grid = wire.grid_to_proto({k: np.float32(v)
                                       for k, v in hdr["grid"].items()})
            jobs = [pb.JobSpec(id=str(i), strategy=hdr["strategy"],
                               grid=grid, cost=hdr["cost"],
                               periods_per_year=hdr["ppy"]) for i in rows]
            series = [data_mod.OHLCV(*(np.array(panel[f, i])
                                       for f in range(panel.shape[0])))
                      for i in rows]
            done = self.backend.collect(self.backend._submit_group(
                jobs, series, time.perf_counter()))
            by_id = {c.job_id: c.metrics for c in done}
            blobs = [by_id[j.id] for j in jobs]
        parts = _gather(blobs)
        return None if parts is None else [b for p in parts for b in p]

    def _run_ts(self, hdr: dict, payload: np.ndarray):
        """A long-context group: this rank's share of the grid's combos, each
        a time-sharded backtest of the whole group on its mesh; the
        metric columns gathered and joined in combo order on the leader."""
        strategy, n, T = hdr["strategy"], hdr["n"], hdr["bars"]
        fn = getattr(timeshard,
                     compute._TIMESHARD_STRATEGIES[strategy].fn_name)
        fields = compute._FUSED_STRATEGIES[strategy].fields
        axes = {k: np.float32(v) for k, v in sorted(hdr["grid"].items())}
        combos = compute.timeshard_combos(strategy, axes)
        mine = combos[multihost.host_shard(len(combos))]
        tmesh = sharding.Mesh(self.mesh.devices, timeshard.TIME_AXIS)
        T_pad = -(-T // tmesh.size) * tmesh.size
        panel = payload.reshape(len(fields), n, T)
        arrays = [torch.from_numpy(np.concatenate(
            [a, np.repeat(a[:, -1:], T_pad - T, axis=1)], axis=1)).to(
                tmesh.devices[0]) for a in panel]
        cols = [torch.stack(list(fn(
            tmesh, *arrays, *cmb, cost=hdr["cost"],
            periods_per_year=hdr["ppy"],
            t_real=None if T == T_pad else T))).cpu().numpy()
            for cmb in mine]
        part = (np.stack(cols, axis=-1) if cols
                else np.zeros((len(Metrics._fields), n, 0), np.float32))
        parts = _gather(part)
        if parts is None:
            return None
        return wire.metrics_blocks(np.concatenate(parts, axis=-1))


def group_message(strategy: str, axes: dict, cost: float, ppy: int,
                  series: list, runner: SliceRunner):
    """The control message and arrays of one group of single-asset jobs of
    equal length: ``run_ts`` where the runner takes it long-context, else
    ``run``."""
    bars = series[0].n_bars
    msg = {"strategy": strategy, "cost": cost, "ppy": ppy, "bars": bars,
           "n": len(series),
           "grid": {k: np.asarray(v, np.float32).tolist()
                    for k, v in axes.items()}}
    reason = runner.long_context_reason(strategy, axes, len(series), bars)
    fields = (compute._FUSED_STRATEGIES[strategy].fields if reason is None
              else data_mod._FIELDS)
    msg["op"] = "run_ts" if reason is None else "run"
    return msg, [np.stack([np.asarray(getattr(s, f), np.float32)
                           for s in series]) for f in fields]


class SliceWorker:
    """The slice polling the dispatcher as one worker. Every process makes
    one and calls :meth:`run`; the leader drives, the others follow its
    broadcasts."""

    def __init__(self, connect: str, runner: SliceRunner, *,
                 worker_id: str | None = None, jobs_per_chip: int = 1,
                 poll_interval_s: float = 0.25):
        self.runner = runner
        self.jobs_completed = 0
        self.poll_interval_s = poll_interval_s
        self.jobs_per_chip = jobs_per_chip
        self.worker_id = worker_id or f"slice-{uuid.uuid4().hex[:8]}"
        self._stub = None
        if runner.is_leader:
            import grpc

            from . import service

            self._channel = grpc.insecure_channel(
                connect, options=service.default_channel_options())
            self._stub = service.DispatcherStub(self._channel)
            self._series = compute.PanelCache(device="cpu")
            log.info("slice worker %s: leader of %d processes, %d chips",
                     self.worker_id, multihost.process_count(), runner.chips)

    def run(self, *, max_idle_polls: int | None = None) -> None:
        """Serve until ``max_idle_polls`` consecutive empty polls (None:
        for ever); the other ranks follow the leader's rounds until its
        ``stop``."""
        if not self.runner.is_leader:
            while self.runner.round()[0]["op"] != "stop":
                pass
            return
        try:
            self._leader_loop(max_idle_polls)
        except BaseException:
            # The other ranks wait in the next broadcast; without a stop
            # they would wait for ever.
            try:
                self.runner.round(STOP)
            except Exception:
                pass
            raise

    def _leader_loop(self, max_idle_polls: int | None) -> None:
        idle = 0
        while True:
            reply = self._stub.RequestJobs(pb.JobsRequest(
                worker_id=self.worker_id, chips=self.runner.chips,
                jobs_per_chip=self.jobs_per_chip, accepts_digest_only=True),
                timeout=10.0)
            jobs = list(reply.jobs)
            if not jobs:
                idle += 1
                if max_idle_polls is not None and idle >= max_idle_polls:
                    self.runner.round(STOP)
                    log.info("slice worker %s: idle for %d polls; stopping "
                             "(%d jobs completed)", self.worker_id, idle,
                             self.jobs_completed)
                    return
                self.runner.round(IDLE)
                time.sleep(self.poll_interval_s)
                continue
            idle = 0
            groups, bad = self._group(jobs)
            if bad:
                self._complete([(j, b"", 0.0) for j in bad])
            for (strategy, grid_b, cost, ppy, _), (group, series) in \
                    groups.items():
                axes = {k: np.frombuffer(v, np.float32) for k, v in grid_b}
                msg, arrays = group_message(strategy, axes, cost, ppy,
                                            series, self.runner)
                t0 = time.perf_counter()
                _, blobs = self.runner.round(msg, arrays)
                per_job = (time.perf_counter() - t0) / len(group)
                self._complete([(j, b, per_job)
                                for j, b in zip(group, blobs)])

    def _group(self, jobs):
        """The poll batch grouped as the single-host backend groups it;
        returns ``(groups, bad)``: ``{key: (jobs, series)}`` and the jobs
        of kinds the slice does not implement, which complete empty. A job
        whose digest-only payload cannot be fetched stays leased."""
        groups: dict[tuple, tuple[list, list]] = {}
        bad = []
        for job in jobs:
            kind = ("pairs (two-legged)" if (job.strategy == "pairs"
                                             or job.ohlcv2
                                             or job.panel_digest2) else
                    "walk-forward" if job.wf_train > 0 else
                    "top-k reduction" if job.top_k > 0 else
                    "best-returns (DBXP) reduction" if job.best_returns else
                    None if job.strategy in compute._FUSED_STRATEGIES else
                    f"strategy {job.strategy!r}")
            if kind is not None:
                log.error("slice worker: job %s needs %s, which the slice "
                          "does not implement; completing with empty "
                          "metrics (route it to a single-host worker)",
                          job.id, kind)
                bad.append(job)
                continue
            series = self._resolve(job)
            if series is None:
                continue
            axes = wire.grid_from_proto(job.grid)
            key = (job.strategy,
                   tuple((k, v.tobytes()) for k, v in axes.items()),
                   job.cost, job.periods_per_year or 252, series.n_bars)
            g = groups.setdefault(key, ([], []))
            g[0].append(job)
            g[1].append(series)
        return groups, bad

    def _resolve(self, job):
        """A job's decoded panel: the leader's cache by digest, the inline
        bytes, or ``FetchPayload``; None (left leased) where none has it."""
        if job.panel_digest:
            s = self._series.get_series(job.panel_digest)
            if s is not None:
                return s
        raw = job.ohlcv
        if not raw and job.panel_digest:
            try:
                raw = self._stub.FetchPayload(pb.PayloadRequest(
                    worker_id=self.worker_id, digest=job.panel_digest),
                    timeout=10.0).payload
            except Exception:
                log.exception("slice worker: FetchPayload %s failed",
                              job.panel_digest[:16])
        if not raw:
            log.error("slice worker: job %s payload unavailable; leaving it "
                      "leased for requeue", job.id)
            return None
        s = data_mod.from_wire_bytes(raw)
        if job.panel_digest:
            self._series.put_series(job.panel_digest, s)
        return s

    def _complete(self, items) -> None:
        self._stub.CompleteJobs(pb.CompleteBatch(
            worker_id=self.worker_id,
            items=[pb.CompleteItem(id=j.id, metrics=b, elapsed_s=s,
                                   trace_id=j.trace_id)
                   for j, b, s in items]), timeout=10.0)
        self.jobs_completed += len(items)
