"""Worker compute backend of the port (reference ``rpc/compute.py``).

:class:`TorchSweepBackend` turns a batch of ``JobSpec`` protos into
:class:`Completion` objects carrying DBXM metric blocks, the way the
reference's ``JaxSweepBackend`` does for the SMA-crossover sweep: it
decodes each DBX1 payload, groups stackable jobs, runs one fused sweep per
group on the backend's device and packs one DBXM block per job.

The port serves every strategy of the reference: the single-asset
families of ``_FUSED_STRATEGIES`` (sma_crossover on K1; bollinger,
bollinger_touch, stochastic, rsi, keltner and vwap_reversion on K2;
momentum, donchian and donchian_hl on K3; macd on K4, trix on K5,
obv_trend on K6) and the two-legged pairs jobs (K7, the second leg in
``JobSpec.ohlcv2``). A pairs
job without a second leg, or with legs of unequal length, completes with
an empty metric block and a logged error, as in the reference. A job
carrying a field the port does not serve yet (streaming append, scenario
batches, walk-forward, top-k, best-returns) is refused on its own: it gets
a logged warning naming the field and no completion, so it stays leased
and the dispatcher re-queues it when the lease runs out, while the other
jobs of its batch are served. Nothing is computed some other way.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..models import base as models_base
from ..models import donchian, pairs as pairs_mod, stochastic
from ..ops import fused
from ..ops.metrics import Metrics
from ..parallel import sweep as sweep_mod
from ..utils import data as data_mod
from . import wire

log = logging.getLogger("dbx.torch.compute")


class _FusedSpec(NamedTuple):
    """One fused-kernel routing row (the reference's ``_FusedSpec``)."""

    axes: frozenset            # the grid axes the fused sweep takes
    window_axes: tuple         # axes holding bar counts (must be integral)
    run: Callable              # (fields, grid, **kw) -> Metrics
    fields: tuple = ("close",)  # OHLCV columns the kernel consumes
    max_window: float = math.inf  # the generic path's channel view bound


# Strategy -> fused route, modelled on the reference's
# ``JaxSweepBackend._FUSED_STRATEGIES``. ``run`` gets the stacked fields by
# name and the flat grid.
_FUSED_STRATEGIES = {
    "sma_crossover": _FusedSpec(
        frozenset({"fast", "slow"}), ("fast", "slow"),
        lambda f, g, **kw: fused.fused_sma_sweep(
            f["close"], g["fast"], g["slow"], **kw)),
    "bollinger": _FusedSpec(
        frozenset({"window", "k"}), ("window",),
        lambda f, g, **kw: fused.fused_bollinger_sweep(
            f["close"], g["window"], g["k"], **kw)),
    "bollinger_touch": _FusedSpec(
        frozenset({"window", "k"}), ("window",),
        lambda f, g, **kw: fused.fused_bollinger_touch_sweep(
            f["close"], g["window"], g["k"], **kw)),
    "stochastic": _FusedSpec(
        frozenset({"window", "band"}), ("window",),
        lambda f, g, **kw: fused.fused_stochastic_sweep(
            f["close"], f["high"], f["low"], g["window"], g["band"], **kw),
        fields=("close", "high", "low"), max_window=stochastic.MAX_WINDOW),
    "momentum": _FusedSpec(
        frozenset({"lookback"}), ("lookback",),
        lambda f, g, **kw: fused.fused_momentum_sweep(
            f["close"], g["lookback"], **kw)),
    "donchian": _FusedSpec(
        frozenset({"window"}), ("window",),
        lambda f, g, **kw: fused.fused_donchian_sweep(
            f["close"], g["window"], **kw),
        max_window=donchian.MAX_WINDOW),
    "donchian_hl": _FusedSpec(
        frozenset({"window"}), ("window",),
        lambda f, g, **kw: fused.fused_donchian_hl_sweep(
            f["close"], f["high"], f["low"], g["window"], **kw),
        fields=("close", "high", "low"), max_window=donchian.MAX_WINDOW),
    "rsi": _FusedSpec(
        frozenset({"period", "band"}), ("period",),
        lambda f, g, **kw: fused.fused_rsi_sweep(
            f["close"], g["period"], g["band"], **kw)),
    "keltner": _FusedSpec(
        frozenset({"window", "k"}), ("window",),
        lambda f, g, **kw: fused.fused_keltner_sweep(
            f["close"], f["high"], f["low"], g["window"], g["k"], **kw),
        fields=("close", "high", "low")),
    "macd": _FusedSpec(
        frozenset({"fast", "slow", "signal"}), ("fast", "slow", "signal"),
        lambda f, g, **kw: fused.fused_macd_sweep(
            f["close"], g["fast"], g["slow"], g["signal"], **kw)),
    "trix": _FusedSpec(
        frozenset({"span", "signal"}), ("span", "signal"),
        lambda f, g, **kw: fused.fused_trix_sweep(
            f["close"], g["span"], g["signal"], **kw)),
    "obv_trend": _FusedSpec(
        frozenset({"window"}), ("window",),
        lambda f, g, **kw: fused.fused_obv_sweep(
            f["close"], f["volume"], g["window"], **kw),
        fields=("close", "volume")),
    "vwap_reversion": _FusedSpec(
        frozenset({"window", "k"}), ("window",),
        lambda f, g, **kw: fused.fused_vwap_sweep(
            f["close"], f["volume"], g["window"], g["k"], **kw),
        fields=("close", "volume")),
}
_PAIRS = "pairs"


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
    """What in ``job`` the port does not serve, or None."""
    if job.strategy != _PAIRS and job.strategy not in _FUSED_STRATEGIES:
        return (f"strategy {job.strategy!r} (served: "
                f"{', '.join(sorted([*_FUSED_STRATEGIES, _PAIRS]))})")
    if job.append_parent_digest:
        return "streaming append (append_parent_digest)"
    if job.scenario_batch:
        return "scenario spec batch (scenario_batch)"
    if job.wf_train > 0:
        return "walk-forward (wf_train)"
    if (job.ohlcv2 or job.panel_digest2) and job.strategy != _PAIRS:
        return (f"a second leg (ohlcv2) on strategy {job.strategy!r}; only "
                "pairs jobs take one")
    if job.top_k > 0:
        return "top-k selection (top_k)"
    if job.best_returns:
        return "best-returns block (best_returns)"
    return None


def _fused_demotion_reason(spec: _FusedSpec, axes: dict) -> str | None:
    """None when a group routes to its fused sweep; otherwise why it takes
    the generic path (the reference's ``_fused_demotion_reason`` minus its
    TPU memory caps, which the Hopper kernels do not have)."""
    if set(axes) != spec.axes:
        return (f"grid axes {sorted(axes)} do not match the fused contract "
                f"{sorted(spec.axes)}")
    wins = np.concatenate([axes[a] for a in spec.window_axes])
    if wins.size == 0:
        return "empty window grid"
    if not np.allclose(wins, np.round(wins)):
        return (f"non-integral window values in axes "
                f"{list(spec.window_axes)}")
    if float(wins.max()) > spec.max_window:
        # The generic channel paths poison windows beyond their view bound
        # to NaN; the fused kernels have no such bound, so larger windows
        # stay on the semantics-defining generic path.
        return (f"max window {int(wins.max())} exceeds the channel view "
                f"bound {spec.max_window}")
    return None


def _pairs_demotion_reason(axes: dict) -> str | None:
    """None when a pairs group routes to the fused pairs sweep; otherwise
    why it takes the generic path (the reference's pairs gates minus its
    TPU memory caps)."""
    lb = axes.get("lookback", np.empty(0))
    if lb.size == 0:
        return "no 'lookback' axis in grid"
    if not np.allclose(lb, np.round(lb)):
        return "non-integral lookback values"
    return None


def _decode(job, leg2: bool = False):
    """A job's leg as OHLCV; raises on a digest-only leg (this backend asks
    for inline payloads)."""
    payload = job.ohlcv2 if leg2 else job.ohlcv
    if not payload:
        raise ValueError(
            f"job {job.id}: no inline payload{' for leg 2' if leg2 else ''} "
            "(digest-only dispatch); this backend needs the DBX1 bytes "
            "inline")
    return data_mod.from_wire_bytes(payload)


class TorchSweepBackend:
    """Sweep backend on one device (``"cuda"`` unless the caller asks for
    ``"cpu"``)."""

    def __init__(self, *, device: str | torch.device =
                 device_mod.DEFAULT_DEVICE):
        self.device = device_mod.resolve(device)

    @property
    def chips(self) -> int:
        """Device count to advertise to the dispatcher."""
        return 1

    def process(self, jobs) -> list[Completion]:
        """Run a job batch and return one Completion per servable job.

        A job that ``_unsupported`` refuses is logged and left without a
        completion (it stays leased until the dispatcher re-queues it);
        the rest are grouped as the reference's ``submit`` groups them: by
        strategy, grid, power-of-two payload length bucket of each leg,
        cost and periods per year. A batch of refused jobs returns ``[]``.
        """
        served = []
        for job in jobs:
            what = _unsupported(job)
            if what is None:
                served.append(job)
            else:
                log.warning("job %s refused: %s is not ported to the "
                            "PyTorch backend yet (see ROADMAP.md, Queue 1); "
                            "it stays leased", job.id, what)
        groups: dict[tuple, list] = {}
        for job in served:
            axes = wire.grid_from_proto(job.grid)
            key = (job.strategy,
                   tuple(sorted((k, v.tobytes()) for k, v in axes.items())),
                   (len(job.ohlcv) or job.panel_bytes_len).bit_length(),
                   (len(job.ohlcv2) or job.panel_bytes_len2).bit_length(),
                   job.cost, job.periods_per_year)
            groups.setdefault(key, []).append(job)
        out: list[Completion] = []
        for group in groups.values():
            run = (self._run_pairs_group if group[0].strategy == _PAIRS
                   else self._run_group)
            out.extend(run(group))
        return out

    def _run_group(self, group) -> list[Completion]:
        t0 = time.perf_counter()
        series = [_decode(j) for j in group]
        lengths = [s.n_bars for s in series]
        job0 = group[0]
        axes = wire.grid_from_proto(job0.grid)
        grid = sweep_mod.product_grid(**axes)
        cost = float(job0.cost)
        ppy = job0.periods_per_year or 252
        spec = _FUSED_STRATEGIES[job0.strategy]
        demotion = _fused_demotion_reason(spec, axes)
        if demotion is None:
            if len(set(lengths)) > 1:
                fields = {f: _stack_field_ragged(series, max(lengths), field=f)
                          for f in spec.fields}
                t_real = np.asarray(lengths, np.int32)
            else:
                fields = {f: np.stack([getattr(s, f) for s in series])
                          for f in spec.fields}
                t_real = None
            m = spec.run(fields, {k: v.numpy() for k, v in grid.items()},
                         t_real=t_real, cost=cost, periods_per_year=ppy,
                         device=self.device)
        else:
            log.warning("jobs %s (%s) take the generic path: %s",
                        [j.id for j in group], job0.strategy, demotion)
            batch, _, mask = data_mod.pad_and_stack(series)
            m = sweep_mod.run_sweep(
                batch, models_base.get_strategy(job0.strategy), grid,
                cost=cost, bar_mask=mask, periods_per_year=ppy,
                device=self.device)
        return _completions(group, m, t0)

    def _run_pairs_group(self, group) -> list[Completion]:
        """Two-legged jobs (the reference's ``_submit_pairs_group`` for
        plain pairs jobs): stack both legs, run the fused pairs sweep, with
        ``t_real`` for a ragged group; a group the kernel does not take runs
        the generic ``run_pairs_sweep``, one job at a time when ragged (it
        has no bar mask). A job without a second leg, or with legs of
        unequal length, completes with an empty metric block."""
        t0 = time.perf_counter()
        good, bad = [], []
        for j in group:
            if not j.ohlcv2 and not j.panel_digest2:
                log.error("pairs job %s has no second leg (ohlcv2); "
                          "completing with empty metrics", j.id)
                bad.append(j)
                continue
            y, x = _decode(j), _decode(j, leg2=True)
            if y.n_bars != x.n_bars:
                log.error("pairs job %s legs differ in length (%d vs %d); "
                          "completing with empty metrics", j.id, y.n_bars,
                          x.n_bars)
                bad.append(j)
                continue
            good.append((j, y, x))
        out = [Completion(j.id, b"", 0.0, trace_id=j.trace_id) for j in bad]
        if not good:
            return out
        jobs = [j for j, _, _ in good]
        lens = np.asarray([y.n_bars for _, y, _ in good], np.int32)
        t_max = int(lens.max())
        y_close = _stack_field_ragged([y for _, y, _ in good], t_max)
        x_close = _stack_field_ragged([x for _, _, x in good], t_max)
        uniform = len(set(lens.tolist())) == 1
        job0 = jobs[0]
        axes = wire.grid_from_proto(job0.grid)
        grid = sweep_mod.product_grid(**axes)
        kw = dict(cost=float(job0.cost),
                  periods_per_year=job0.periods_per_year or 252,
                  device=self.device)
        demotion = _pairs_demotion_reason(axes)
        if demotion is None:
            g = {k: v.numpy() for k, v in grid.items()}
            m = fused.fused_pairs_sweep(
                y_close, x_close, g["lookback"], g["z_entry"],
                z_exit=g.get("z_exit", 0.0),
                t_real=None if uniform else lens, **kw)
        else:
            log.warning("jobs %s (pairs) take the generic path: %s",
                        [j.id for j in jobs], demotion)
            if uniform:
                m = pairs_mod.run_pairs_sweep(y_close, x_close, grid, **kw)
            else:
                rows = [pairs_mod.run_pairs_sweep(
                    y_close[i:i + 1, :n], x_close[i:i + 1, :n], grid, **kw)
                    for i, n in enumerate(lens)]
                m = Metrics(*(torch.cat(f, dim=0) for f in zip(*rows)))
        return out + _completions(jobs, m, t0)


def _completions(jobs, m: Metrics, t0: float) -> list[Completion]:
    """One DBXM block per job from the ``(N, P)`` metric fields of its
    group, with the group's seconds shared out per job."""
    host = torch.stack(list(m)).cpu().numpy()              # (9, N, P)
    per_job = (time.perf_counter() - t0) / len(jobs)
    return [Completion(job.id, wire.metrics_to_bytes(Metrics(*host[:, i])),
                       per_job, trace_id=job.trace_id)
            for i, job in enumerate(jobs)]
