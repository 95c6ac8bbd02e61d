"""Worker compute backend of the port (reference ``rpc/compute.py``).

:class:`TorchSweepBackend` turns a batch of ``JobSpec`` protos into
:class:`Completion` objects carrying DBXM metric blocks, the way the
reference's ``JaxSweepBackend`` does for the SMA-crossover sweep: it
decodes each DBX1 payload, groups stackable jobs, runs one fused sweep per
group on the backend's device and packs one DBXM block per job.

The slice serves plain SMA-crossover sweeps only. Any other strategy, and
any job field the slice does not serve (streaming append, scenario spec
batches, walk-forward, pairs, top-k, best-returns), raises
``NotImplementedError`` naming it; nothing is computed some other way.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .. import device as device_mod
from ..models import base as models_base
from ..ops import fused
from ..ops.metrics import Metrics
from ..parallel import sweep as sweep_mod
from ..utils import data as data_mod
from . import wire

log = logging.getLogger("dbx.torch.compute")

_SMA = "sma_crossover"
_SMA_AXES = {"fast", "slow"}


class Completion:
    """One finished job: id + packed DBXM metrics + compute seconds.

    ``trace_id`` echoes the job's dispatcher-minted trace
    (``JobSpec.trace_id``); empty for jobs enqueued without one."""

    __slots__ = ("job_id", "metrics", "elapsed_s", "trace_id")

    def __init__(self, job_id: str, metrics: bytes, elapsed_s: float,
                 trace_id: str = ""):
        self.job_id = job_id
        self.metrics = metrics
        self.elapsed_s = elapsed_s
        self.trace_id = trace_id


def _stack_field_ragged(series_list, t_max: int,
                        field: str = "close") -> np.ndarray:
    """Single-column ragged stack with repeat-last padding to ``t_max`` bars.

    Repeat-last padding makes the pad bars' returns exactly zero, so a held
    position earns nothing there; the fused sweep also stops each ticker at
    its real length (``t_real``).
    """
    out = np.empty((len(series_list), t_max), np.float32)
    for i, s in enumerate(series_list):
        a = np.asarray(getattr(s, field), np.float32)
        out[i, :a.shape[0]] = a
        out[i, a.shape[0]:] = a[-1]
    return out


def _unsupported(job) -> str | None:
    """What in ``job`` the slice does not serve, or None."""
    if job.strategy != _SMA:
        return f"strategy {job.strategy!r}"
    if job.append_parent_digest:
        return "streaming append (append_parent_digest)"
    if job.scenario_batch:
        return "scenario spec batch (scenario_batch)"
    if job.wf_train > 0:
        return "walk-forward (wf_train)"
    if job.ohlcv2 or job.panel_digest2:
        return "pairs second leg (ohlcv2)"
    if job.top_k > 0:
        return "top-k selection (top_k)"
    if job.best_returns:
        return "best-returns block (best_returns)"
    return None


def _fused_demotion_reason(axes: dict) -> str | None:
    """None when an SMA group routes to the fused sweep; otherwise why it
    takes the generic path (the reference's ``_fused_demotion_reason``
    minus its TPU memory caps, which the Hopper kernel does not have)."""
    if set(axes) != _SMA_AXES:
        return (f"grid axes {sorted(axes)} do not match the fused contract "
                f"{sorted(_SMA_AXES)}")
    wins = np.concatenate([axes["fast"], axes["slow"]])
    if wins.size == 0:
        return "empty window grid"
    if not np.allclose(wins, np.round(wins)):
        return "non-integral window values in axes ['fast', 'slow']"
    return None


class TorchSweepBackend:
    """SMA-crossover sweep backend on one device (``"cuda"`` unless the
    caller asks for ``"cpu"``)."""

    def __init__(self, *, device: str | torch.device =
                 device_mod.DEFAULT_DEVICE):
        self.device = device_mod.resolve(device)

    @property
    def chips(self) -> int:
        """Device count to advertise to the dispatcher."""
        return 1

    def process(self, jobs) -> list[Completion]:
        """Run a job batch to completion and return one Completion per job.

        Jobs are grouped as the reference's ``submit`` groups them: by
        strategy, grid, power-of-two payload length bucket, cost and
        periods per year.
        """
        jobs = list(jobs)
        for job in jobs:
            what = _unsupported(job)
            if what is not None:
                raise NotImplementedError(
                    f"job {job.id}: {what} is not ported to the PyTorch "
                    "backend yet (see ROADMAP.md, Queue 1)")
        groups: dict[tuple, list] = {}
        for job in jobs:
            axes = wire.grid_from_proto(job.grid)
            key = (job.strategy,
                   tuple(sorted((k, v.tobytes()) for k, v in axes.items())),
                   (len(job.ohlcv) or job.panel_bytes_len).bit_length(),
                   job.cost, job.periods_per_year)
            groups.setdefault(key, []).append(job)
        out: list[Completion] = []
        for group in groups.values():
            out.extend(self._run_group(group))
        return out

    def _run_group(self, group) -> list[Completion]:
        t0 = time.perf_counter()
        for job in group:
            if not job.ohlcv:
                raise ValueError(
                    f"job {job.id}: no inline payload (digest-only "
                    "dispatch); this backend needs the DBX1 bytes inline")
        series = [data_mod.from_wire_bytes(j.ohlcv) for j in group]
        lengths = [s.n_bars for s in series]
        job0 = group[0]
        axes = wire.grid_from_proto(job0.grid)
        grid = sweep_mod.product_grid(**axes)
        cost = float(job0.cost)
        ppy = job0.periods_per_year or 252
        demotion = _fused_demotion_reason(axes)
        if demotion is None:
            if len(set(lengths)) > 1:
                close = _stack_field_ragged(series, max(lengths))
                t_real = np.asarray(lengths, np.int32)
            else:
                close = np.stack([s.close for s in series])
                t_real = None
            m = fused.fused_sma_sweep(
                close, grid["fast"], grid["slow"], t_real=t_real, cost=cost,
                periods_per_year=ppy, device=self.device)
        else:
            log.warning("jobs %s (%s) take the generic path: %s",
                        [j.id for j in group], job0.strategy, demotion)
            batch, _, mask = data_mod.pad_and_stack(series)
            m = sweep_mod.run_sweep(
                batch, models_base.get_strategy(job0.strategy), grid,
                cost=cost, bar_mask=mask, periods_per_year=ppy,
                device=self.device)
        host = torch.stack(list(m)).cpu().numpy()          # (9, N, P)
        per_job = (time.perf_counter() - t0) / len(group)
        return [Completion(job.id, wire.metrics_to_bytes(Metrics(*host[:, i])),
                           per_job, trace_id=job.trace_id)
                for i, job in enumerate(group)]
