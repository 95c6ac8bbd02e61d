"""Worker compute backend of the port (reference ``rpc/compute.py``).

:class:`TorchSweepBackend` turns a batch of ``JobSpec`` protos into
:class:`Completion` objects, as the reference's ``JaxSweepBackend`` does:
it resolves each job's DBX1 panel (inline bytes, the digest-keyed
:class:`PanelCache`, or the worker's ``payload_fetcher``), groups stackable
jobs, runs one sweep per group on the backend's device and packs one
result block per job. It is two-phase: :meth:`~TorchSweepBackend.submit`
launches a batch's sweeps and starts one device-to-host copy of each
group's results into pinned host memory without waiting for the card;
:meth:`~TorchSweepBackend.collect` waits for those copies and packs the
blocks; ``process = collect(submit(jobs))``. The worker overlaps the two
on separate threads (``rpc/executor.py``).

The port serves every strategy of the reference: the single-asset
families of ``_FUSED_STRATEGIES`` (sma_crossover on K1; bollinger,
bollinger_touch, stochastic, rsi, keltner and vwap_reversion on K2;
momentum, donchian and donchian_hl on K3; macd on K4, trix on K5,
obv_trend on K6) and the two-legged pairs jobs (K7, the second leg in
``JobSpec.ohlcv2``), each as a full DBXM block, as the top-k DBXS block
(``JobSpec.top_k``, selected on the card), for single-asset jobs as the
best-returns DBXP block (``JobSpec.best_returns``, on the generic sweep,
whose positions it reprices), or as a walk-forward job's one stitched
out-of-sample metrics row (``JobSpec.wf_train``, ``wf_test``,
``wf_metric``; :mod:`..parallel.walkforward`), whose train sweep runs on
the family's fused kernel where the grid has at least
``_WF_FUSED_MIN_COMBOS`` combos. A job the reference completes empty
completes empty here too, with the reference's logged error: a pairs job
without a second leg or with legs of unequal length, a top-k or
best-returns request by an unknown metric, a pairs or walk-forward
best-returns request, a walk-forward request by an unknown metric, with
``wf_test <= 0`` or on a history shorter than one train and test window.

Streaming append jobs (``JobSpec.append_parent_digest``, the dispatcher's
``AppendBars``) are served one at a time from the backend's
:class:`~..streaming.store.CarryStore`: the parent panel's carry
checkpoint advanced by the appended bars in O(ΔT)
(:func:`~..streaming.recurrent.append_step`), or where there is none a
full scan-form reprice over the extended panel
(:func:`~..streaming.recurrent.build_carry`), counted; either way the new
checkpoint is stored under the job's digest, and an advanced parent's is
dropped. A delta-only append (no
``ohlcv``, ``append_delta`` set) is spliced onto the cached base panel.
An append of pairs, of an unknown family, or of a grid the family cannot
price completes empty with the reference's logged error.

Paged mode (the reference's ragged paged batching), on with
``DBX_PAGED=1``: a fused group whose jobs all carry digests takes its
fields from the device page pool (:attr:`PanelCache.pages`,
:mod:`.page_pool`), mixed lengths in one group, one launch a page-count bin
(``fused.fused_paged_sweep``); where the pool rejects the group, it takes
the dense stacks, logged and counted. Unlike the reference's, the route is
off by default (``fused.paged_enabled``), and such groups then take the
dense stacks, counted.

Scenario spec batches (``JobSpec.scenario_batch``, declared by
:attr:`TorchSweepBackend.accepts_scenario_batch`) generate their panels on
the device and sweep them chunk by chunk (``fused.fused_scenario_sweep``),
each spec completed under its own id; ``DBX_SCENARIO_FUSED=0``, a family or
grid without the fused route, or an invalid batch take the materialized
rung (the panels as inline jobs), logged and counted.

A job carrying a field the port does not serve (a second leg on a
single-asset strategy, an unknown strategy) is refused on its own: it gets
a logged warning naming the field and no completion, so it stays leased
and the dispatcher re-queues it when the lease runs out, while the other
jobs of its batch are served. Nothing is computed some other way.

Multiple devices (the reference's mesh route): a backend given a
:class:`~..parallel.sharding.Mesh` (``TorchSweepBackend(mesh=...)``; by
default a mesh of every local GPU where there are two or more, and none on
one card) pads each group's rows to a multiple of the mesh with repeat-last
rows, runs the group's runner on each shard's rows on that shard's device
and concatenates the metrics in shard order (:meth:`~TorchSweepBackend.
_mesh_call`); pad rows are computed and never reported. That covers the
fused sweeps of the 13 single-asset families (ragged ``t_real`` split by
shard), the generic sweep (:func:`~..parallel.sharding.sharded_sweep`),
fused and generic pairs, the walk-forward refits (fused-train, generic and
pairs), top-k and best-returns. A long-context group, fewer tickers than
shards with a history longer than ``_LONG_CONTEXT_BARS``, shards its bars
instead (:mod:`..parallel.timeshard`, one composed backtest a combo; the
route of the reference's ``_submit_timeshard_groups``). The paged route and
the scenario route stay meshless, as in the reference.

Tuned schedules (the reference's tune layer, :mod:`..tune`): each fused
group (dense, paged or on the mesh, and the fused pairs groups) runs under
the tuned substrate schedule of its (family, shape bucket with the rows a
card sweeps, platform) in the backend's
:class:`~..tune.ScheduleRegistry` (``DBX_SCHEDULE_DIR``), below any env
knob. On Hopper the tuned knobs are the tile entries' CTA width
(``lanes_cap``) and the page size (``page_bars``, applied when the
backend is made); every width gives the same bits. Under
``DBX_AUTOTUNE=1`` the first group of a (family, bucket) with no entry
measures the candidates on warm runs of the group's own sweep, on the
route that serves it, and records the winner (``model``: the prior's
pick, nothing measured); a challenger must beat the shipped width by more
than the noise. The platform names the runtime and the card
(``torch-cuda-sm90``, ``torch-cpu``) and is never a JAX backend's name,
so neither kind of worker adopts the other's entries. A failed
consultation serves the defaults.

The worker CLI's ``--fused``, ``--mesh`` and ``--param-chunk`` map onto
``TorchSweepBackend(use_fused=, use_mesh=, param_chunk=)``, which take the
meaning of the reference's ``JaxSweepBackend`` arguments: ``use_fused=
False`` sends every single-asset and pairs group down the generic sweep,
walk-forward groups to the generic refit, scenario batches to the
materialized rung (and the worker then declares no spec batches), and
turns paging off; ``use_mesh=False`` gives no mesh even on a host of
several GPUs; None keeps the defaults (fused; a mesh of every local GPU
where there are two or more). ``param_chunk`` runs a generic sweep whose
grid it divides in chunks of that many combos
(:func:`~..parallel.sweep.chunked_sweep`). :class:`InstantBackend` and
:class:`SleepBackend` are the reference's control-plane fakes.

This module imports no ``grpc``: the worker injects the fetcher.
"""

from __future__ import annotations

import functools
import logging
import math
import os
import threading
import time
from typing import Callable, Iterable, NamedTuple, Protocol, runtime_checkable

import numpy as np
import torch

from .. import device as device_mod
from .. import obs
from .. import tune as tune_mod
from ..models import base as models_base
from ..models import pairs as pairs_mod
from ..ops import fused
from ..obs import flight as obs_flight
from ..ops.metrics import Metrics, metric_sign
from ..parallel import sharding
from ..parallel import sweep as sweep_mod
from ..parallel import timeshard
from ..parallel import walkforward
from ..scenarios import synth
from ..streaming import recurrent
from ..streaming.store import CarryStore
from ..utils import data as data_mod
from . import backtesting_pb2 as pb
from . import wire
from .page_pool import PagePool
from .panel_store import ByteLRU

log = logging.getLogger("dbx.torch.compute")

_DEFAULT_CACHE_MB = 256


def cache_max_bytes() -> int:
    """The panel cache's budget per level in bytes, ``DBX_PANEL_CACHE_MB``
    (default 256), read when a cache is made, not at import."""
    return int(float(os.environ.get("DBX_PANEL_CACHE_MB",
                                    _DEFAULT_CACHE_MB)) * 1024 * 1024)


class PanelCache:
    """Digest-keyed panel cache (the worker's half of dispatch by digest;
    the reference's ``PanelCache``).

    - **host level**: decoded :class:`~..utils.data.OHLCV` panels; a hit
      skips the DBX1 decode;
    - **device level**: the panel's ``(5, T)`` f32 field block on the
      backend's device; a hit also skips the host-to-device copy, and the
      group is stacked on the device;
    - **page level** (:attr:`pages`, made at first use on ``device``): the
      :class:`~.page_pool.PagePool` of the paged route
      (``DBX_PAGE_POOL_MB``).

    The host and device levels are each a :class:`~.panel_store.ByteLRU`
    bounded by ``max_bytes`` (``DBX_PANEL_CACHE_MB``). Eviction is not an
    error: the worker recovers a digest-only miss through
    ``FetchPayload``. Hit and miss counts by level are plain attributes
    that :meth:`stats` returns, this cache's own; the same events count
    into ``registry`` (the process's by default) as the reference's
    ``dbx_panel_cache_hits_total`` and ``dbx_panel_cache_misses_total``
    ``{level}``, with the two levels' bytes in the gauge
    ``dbx_panel_cache_bytes``. Thread-safe: the worker's control and
    prefetch threads probe and fill the host level while the compute
    thread serves from both. ``device`` is the backend's (a
    :class:`TorchSweepBackend` sets it where it is None).
    """

    def __init__(self, max_bytes: int | None = None, *,
                 device: str | torch.device | None = None,
                 registry: obs.Registry | None = None):
        self.max_bytes = (cache_max_bytes() if max_bytes is None
                          else int(max_bytes))
        self.device = device
        self._lock = threading.Lock()
        self._series = ByteLRU(self.max_bytes, self._nbytes)
        self._device = ByteLRU(self.max_bytes)   # put() passes nbytes
        self._pages: PagePool | None = None
        self.hits = {"host": 0, "device": 0}
        self.misses = {"host": 0, "device": 0}
        reg = self._reg = registry or obs.get_registry()
        self._c_hits = {
            lvl: reg.counter("dbx_panel_cache_hits_total",
                             help="panel-cache hits by level "
                                  "(host=decode skipped, device=h2d "
                                  "skipped too)", level=lvl)
            for lvl in ("host", "device")}
        self._c_misses = {
            lvl: reg.counter("dbx_panel_cache_misses_total",
                             help="panel-cache misses by level",
                             level=lvl)
            for lvl in ("host", "device")}
        self._g_bytes = reg.gauge(
            "dbx_panel_cache_bytes",
            help="approximate bytes resident in the worker panel cache "
                 "(host + device levels)")

    @property
    def pages(self) -> PagePool:
        """The page level, made at first use (``DBX_PAGE_BARS``,
        ``DBX_PAGE_POOL_MB`` read then)."""
        with self._lock:
            if self._pages is None:
                self._pages = PagePool(device=self.device
                                       or device_mod.DEFAULT_DEVICE,
                                       registry=self._reg)
            return self._pages

    @staticmethod
    def _nbytes(arrays) -> int:
        return int(sum(getattr(a, "nbytes", 0) for a in arrays))

    def contains_series(self, digest: str) -> bool:
        """Probe that counts neither a hit nor a miss (the control
        thread's check before it fetches a payload)."""
        with self._lock:
            return digest in self._series

    def _get(self, lru: ByteLRU, level: str, digest: str):
        with self._lock:
            value = lru.get(digest)
            if value is None:
                self.misses[level] += 1
            else:
                self.hits[level] += 1
        (self._c_misses if value is None else self._c_hits)[level].inc()
        return value

    def _publish_bytes(self) -> None:
        self._g_bytes.set(self._series.bytes + self._device.bytes)

    def get_series(self, digest: str):
        return self._get(self._series, "host", digest)

    def put_series(self, digest: str, series) -> None:
        with self._lock:
            self._series.put(digest, series)
            self._publish_bytes()

    def get_device(self, digest: str):
        return self._get(self._device, "device", digest)

    def put_device(self, digest: str, block: torch.Tensor,
                   nbytes: int) -> None:
        """Cache a ``(5, T)`` device block, charged ``nbytes``."""
        with self._lock:
            self._device.put(digest, block, nbytes)
            self._publish_bytes()

    def stats(self) -> dict:
        with self._lock:
            return {"host_panels": len(self._series),
                    "host_bytes": self._series.bytes,
                    "device_panels": len(self._device),
                    "device_bytes": self._device.bytes,
                    "max_bytes": self.max_bytes,
                    "hits": dict(self.hits), "misses": dict(self.misses),
                    "page_pool": (None if self._pages is None
                                  else self._pages.stats())}

    def top_digests(self, k: int = 8) -> list[dict]:
        """The ``k`` resident panels with the most bytes over the host and
        device levels, as 12-hex digest prefixes and byte sizes: the fleet
        telemetry frame's sketch of the cache (never the full key list)."""
        sizes: dict[str, int] = {}
        with self._lock:
            for key, nb in self._series.sizes() + self._device.sizes():
                sizes[key] = sizes.get(key, 0) + int(nb)
        top = sorted(sizes.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        return [{"d": str(d)[:12], "b": nb} for d, nb in top]


class _FusedSpec(NamedTuple):
    """One fused-kernel routing row (the reference's ``_FusedSpec``)."""

    axes: frozenset            # the grid axes the fused sweep takes
    window_axes: tuple         # axes holding bar counts (must be integral)
    run: Callable              # (fields, grid, **kw) -> Metrics
    fields: tuple = ("close",)  # OHLCV columns the kernel consumes
    max_window: float = math.inf  # the generic path's channel view bound


def _fused_spec(strategy: str) -> _FusedSpec:
    """The routing row of ``strategy``, from its row of the fused registry
    (``fused._PAGED_FAMILIES``) alone."""
    fam = fused._PAGED_FAMILIES[strategy]
    return _FusedSpec(
        frozenset(fam.axes), fam.window_axes,
        lambda f, g, **kw: fam.call([f[x] for x in fam.fields], g, **kw),
        fam.fields, fam.max_window)


# Strategy -> fused route, modelled on the reference's
# ``JaxSweepBackend._FUSED_STRATEGIES``. ``run`` gets the stacked fields by
# name and the flat grid.
_FUSED_STRATEGIES = {s: _fused_spec(s) for s in fused._PAGED_FAMILIES}
_PAIRS = "pairs"


class _TimeshardSpec(NamedTuple):
    """One time-sharded (long-context) routing row (the reference's
    ``_TimeshardSpec``): the positional parameter order of the sharded
    backtest, its name in :mod:`..parallel.timeshard`, and whether its
    windows must fit one block (the EMA families carry O(1) state and have
    no such bound). It takes the OHLCV columns of the family's fused row
    (``_FUSED_STRATEGIES``), in their order."""

    params: tuple
    fn_name: str
    halo_bound: bool = True


_TIMESHARD_STRATEGIES = {
    "sma_crossover": _TimeshardSpec(("fast", "slow"), "sharded_sma_backtest"),
    "bollinger": _TimeshardSpec(("window", "k"), "sharded_bollinger_backtest"),
    "bollinger_touch": _TimeshardSpec(("window", "k"),
                                      "sharded_bollinger_touch_backtest"),
    "momentum": _TimeshardSpec(("lookback",), "sharded_momentum_backtest"),
    "donchian": _TimeshardSpec(("window",), "sharded_donchian_backtest"),
    "donchian_hl": _TimeshardSpec(("window",), "sharded_donchian_hl_backtest"),
    "rsi": _TimeshardSpec(("period", "band"), "sharded_rsi_backtest",
                          halo_bound=False),
    "stochastic": _TimeshardSpec(("window", "band"),
                                 "sharded_stochastic_backtest"),
    "keltner": _TimeshardSpec(("window", "k"), "sharded_keltner_backtest"),
    "macd": _TimeshardSpec(("fast", "slow", "signal"), "sharded_macd_backtest",
                           halo_bound=False),
    "trix": _TimeshardSpec(("span", "signal"), "sharded_trix_backtest",
                           halo_bound=False),
    "vwap_reversion": _TimeshardSpec(("window", "k"), "sharded_vwap_backtest"),
    "obv_trend": _TimeshardSpec(("window",), "sharded_obv_backtest"),
}

# Every combo of a time-sharded group runs its own composed backtest; the
# reference caps a group's combos so a huge grid cannot stall a batch.
_TIMESHARD_MAX_COMBOS = 128


def _timeshard_window_reason(wins, n_combos: int, t_min: int, n_dev: int, *,
                             halo_bound: bool = True,
                             what: str = "window") -> str | None:
    """The grid gates of every time-sharded route (single-asset, pairs and
    the slice worker): the combo cap, integral windows >= 1, and a window
    that fits one block of the shortest history."""
    wins = np.asarray(wins, np.float64)
    if n_combos == 0 or wins.size == 0:
        return "empty grid"
    if n_combos > _TIMESHARD_MAX_COMBOS:
        return (f"{n_combos} grid combos exceed the per-group cap of "
                f"{_TIMESHARD_MAX_COMBOS}")
    if not np.allclose(wins, np.round(wins)):
        return f"non-integral {what} values"
    if wins.min() < 1:
        return f"{what} values below 1"
    if halo_bound:
        block = -(-int(t_min) // n_dev)
        if int(wins.max()) > block:
            return (f"max {what} {int(wins.max())} exceeds the {block}-bar "
                    "per-shard block; the halo exchange needs the window to "
                    "fit one neighbor block")
    return None


def timeshard_route_reason(strategy: str, axes, lengths,
                           n_dev: int) -> str | None:
    """None when a long-context single-asset group can take the
    time-sharded backtests over ``n_dev`` shards; otherwise why not. Shared
    by the backend and the slice worker."""
    fam = _TIMESHARD_STRATEGIES.get(strategy)
    if fam is None:
        return f"strategy {strategy!r} has no time-sharded backtest"
    if set(axes) != set(fam.params):
        return (f"grid axes {sorted(axes)} do not match the time-sharded "
                f"contract {sorted(fam.params)}")
    prod = sweep_mod.product_grid(**axes)
    n_combos = sweep_mod.grid_size(prod)
    spec = _FUSED_STRATEGIES[strategy]
    wins = np.concatenate([np.asarray(axes[a], np.float64)
                           for a in spec.window_axes])
    reason = _timeshard_window_reason(
        wins, n_combos, min(lengths), n_dev, halo_bound=fam.halo_bound,
        what=f"window ({'/'.join(spec.window_axes)})")
    if reason is not None:
        return reason
    if strategy == "sma_crossover":
        if (np.round(prod["fast"].numpy()) >= np.round(
                prod["slow"].numpy())).any():
            return "grid contains fast >= slow combos"
    if float(wins.max()) > spec.max_window:
        return (f"max window {int(wins.max())} exceeds the channel view "
                f"bound {spec.max_window}")
    return None


def timeshard_combos(strategy: str, axes) -> tuple:
    """The per-combo parameter tuples of a time-sharded sweep in the DBXM
    (product_grid) column order: ints for the window axes, floats
    otherwise."""
    fam = _TIMESHARD_STRATEGIES[strategy]
    prod = {k: v.numpy() for k, v in sweep_mod.product_grid(**axes).items()}
    ints = set(_FUSED_STRATEGIES[strategy].window_axes)
    return tuple(tuple(int(round(float(prod[p][i]))) if p in ints
                       else float(prod[p][i]) for p in fam.params)
                 for i in range(sweep_mod.grid_size(prod)))


def platform_of(device) -> str:
    """The schedule registry's platform of a backend on ``device``:
    ``torch-cuda-sm<major><minor>`` of the card, or ``torch-<type>``. Never
    a JAX backend's name (``cpu``, ``gpu``, ``tpu``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        return f"torch-cuda-sm{major}{minor}"
    return f"torch-{dev.type}"


def _synchronize(devices) -> None:
    """Wait for the work queued on each CUDA device of ``devices``."""
    for dev in {torch.device(d) for d in devices}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def default_mesh(device) -> sharding.Mesh | None:
    """The backend's mesh when none is given: every local GPU where there
    are two or more and the backend runs on CUDA, else None."""
    if (torch.device(device).type == "cuda" and torch.cuda.is_available()
            and torch.cuda.device_count() > 1):
        return sharding.make_mesh()
    return None




class Completion:
    """One finished job: id + packed result block + compute seconds.

    ``trace_id`` echoes the job's dispatcher-minted trace
    (``JobSpec.trace_id``); empty for jobs enqueued without one."""

    __slots__ = ("job_id", "metrics", "elapsed_s", "trace_id")

    def __init__(self, job_id: str, metrics: bytes, elapsed_s: float,
                 trace_id: str = ""):
        self.job_id = job_id
        self.metrics = metrics
        self.elapsed_s = elapsed_s
        self.trace_id = trace_id


@runtime_checkable
class ComputeBackend(Protocol):
    """What a worker needs of a backend (the reference's protocol);
    :class:`TorchSweepBackend` satisfies it. A backend may also expose the
    two phases ``submit(jobs)`` and ``collect(handle)``, which the
    executor pipelines when both exist, and ``prefetch(jobs)``, which the
    worker calls for queued batches."""

    def process(self, jobs: Iterable) -> list[Completion]:
        """Run a job batch to completion."""
        ...

    @property
    def chips(self) -> int:
        """Device count to advertise to the dispatcher."""
        ...


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
    if (job.ohlcv2 or job.panel_digest2) and job.strategy != _PAIRS:
        return (f"a second leg (ohlcv2) on strategy {job.strategy!r}; only "
                "pairs jobs take one")
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


def _topk_reduce(m: Metrics, metric: str, k: int):
    """Top-k on the metrics' device: ``(N, P)`` Metrics -> ``((N, k)
    indices, Metrics of (N, k) rows)`` (the reference's ``_topk_reduce``).

    Rows rank by ``metric`` in its own direction (``metric_sign``), NaN
    last, in the order of the reference's ``lax.top_k``: floats by total
    order, so +0 ranks ahead of -0 (a flat combo scores -0 under a
    lower-is-better metric), and among equal scores the lower index first.
    ``torch.sort`` and ``torch.topk`` on the floats order neither. So each
    score becomes its order-preserving int32 key (its bits, the low 31
    flipped where the sign bit is set), widened to int64 with the index
    below it, ``key * 2**32 + (P - 1 - j)``: the keys of a row are then
    distinct, and ``torch.topk`` of them is exact.
    """
    score = getattr(m, metric) * metric_sign(metric)
    score = torch.where(torch.isnan(score), torch.full_like(score, -math.inf),
                        score).contiguous()
    bits = score.view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    P = score.shape[-1]
    below = torch.arange(P - 1, -1, -1, dtype=torch.int64, device=key.device)
    _, idx = torch.topk(key.to(torch.int64) * (1 << 32) + below, k, dim=-1)
    return idx, Metrics(*(torch.take_along_dim(f, idx, dim=-1) for f in m))


def _copy_to_host(tensors: dict):
    """Start one device-to-host copy of each of ``tensors`` (the
    reference's ``copy_to_host_async``): into pinned host tensors with
    ``non_blocking=True`` on the current stream, then one recorded CUDA
    event that :meth:`TorchSweepBackend.collect` waits on before it reads
    them (a non-blocking copy into pageable memory would be synchronous,
    and a read before the event fires reads stale bytes). Returns
    ``(host tensors, event)``; on the CPU the tensors themselves and no
    event."""
    if next(iter(tensors.values())).device.type != "cuda":
        return dict(tensors), None
    host = {}
    for name, t in tensors.items():
        host[name] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host[name].copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(t.device))
    return host, ready


class _Pending(NamedTuple):
    """One group between :meth:`~TorchSweepBackend.submit` and
    :meth:`~TorchSweepBackend.collect`."""

    jobs: list        # the group's jobs; the first ``n_real`` have results
    n_real: int
    t0: float         # when the group's submit began
    host: dict        # "planes" (9, n, P or k), and "idx"/"returns"
    ready: object     # the CUDA event after the copies, or None
    kind: str = "metrics"    # "metrics" (DBXM), "topk" (DBXS), "returns"
    metric: str = ""         # the rank metric of "topk" and "returns"
    lengths: tuple = ()      # "returns": each job's real bar count
    h2d_hit: bool = False    # every panel's device block came from the cache


class _ScenarioJob(NamedTuple):
    """A scenario spec of a carrier's batch, completed under its own id;
    ``grid`` is the carrier's, which every spec sweeps."""

    id: str
    trace_id: str
    grid: object = None
    parent_span_id: str = ""


def _empty(group, t0: float) -> _Pending:
    """A validated-bad group: every job completes with an empty block."""
    return _Pending(list(group), 0, t0, {}, None)


class TorchSweepBackend:
    """Two-phase sweep backend on one device (``"cuda"`` unless the caller
    asks for ``"cpu"``), or over a :class:`~..parallel.sharding.Mesh`
    (``mesh``; results gathered on its first device, which is then the
    backend's ``device``). Where no mesh is given, a host with two or more
    GPUs gets a mesh of all of them (:func:`default_mesh`), one card none.

    ``panel_cache`` holds decoded panels, their device blocks and the page
    pool by digest; ``carry_store`` the streaming appends' carry
    checkpoints (``DBX_CARRY_CACHE_MB``); ``payload_fetcher`` (``digest ->
    bytes``, set by the worker while it runs) recovers a digest-only panel
    the cache no longer holds. ``use_paged`` (``DBX_PAGED=1``, read here;
    off by default) sends fused groups of jobs with digests through the
    page pool. Counts,
    plain attributes that :meth:`stats` returns: ``decodes``, the DBX1
    decodes of the submit path; ``appends``, the append jobs served by
    outcome (``carry_hit``: a stored checkpoint served or advanced,
    ``full_reprice``: rebuilt over the whole panel) and ``advances``, the
    checkpoints advanced; ``pad_bars``, the pad bars of the ragged stacks
    of the fused and generic sweeps (``dense``) and of the pages the pool
    uploaded (``paged``);
    ``paged_fallbacks``, the fused groups of jobs with digests served from
    the dense stacks, by why (``rejected`` by the pool, paging
    ``disabled``);
    ``scenarios``, the scenario specs served by route (``fused``,
    ``materialized``). ``schedule_registry`` holds the tuned schedules
    (``DBX_SCHEDULE_DIR``; the worker gossips it), ``platform`` their
    platform on this backend's device.

    The same events count into the process's registry under the
    reference's names (the backend's counts are its own, the registry's
    the process's): ``dbx_compute_decode_seconds`` and
    ``_decode_bytes_total``, ``dbx_compute_collect_seconds`` and
    ``dbx_compute_d2h_bytes_total``, ``dbx_backtests_total`` and the gauge
    ``dbx_compute_backtests_per_sec``, ``dbx_pad_bars_total{path}``,
    ``dbx_worker_append_total{outcome}``, ``dbx_scenario_route_total
    {mode}``, ``dbx_fused_substrate_total`` and ``_info``, and
    ``dbx_kernel_submit_seconds{kernel=route:strategy,phase}``. A group's
    submit is also the span ``worker.compile`` or ``worker.execute``
    (``kernel``, ``jobs``, ``bars``, ``combos``) on each job's trace; the
    decode, the payload fetch, an append and the device-to-host wait are
    the spans ``worker.decode``, ``worker.payload_fetch``,
    ``worker.append`` and ``worker.d2h``. The spans and histograms read
    the host clock around calls that are made anyway: none adds a wait
    for the card. ``phase="compile"`` marks the first group of a
    ``route:strategy`` a backend serves (on the card the group whose call
    builds or loads the kernel library, for the process's first backend;
    there is no jit to trace a new shape), on the routes where the
    reference splits compile from execute.
    """

    # A uniform walk-forward group whose grid has at least this many combos
    # runs its train sweep on the fused kernel (walk_forward_fused); a
    # smaller one takes the generic walk_forward. The reference's value,
    # kept so that a mixed fleet routes a group the same way on either
    # worker.
    _WF_FUSED_MIN_COMBOS = 512
    # A group with fewer tickers than the mesh has shards and a history
    # longer than this takes the time-sharded route. The reference's value
    # (its fused kernels' VMEM bar cap, which the Hopper kernels do not
    # have), kept so that a mixed fleet routes a group the same way.
    _LONG_CONTEXT_BARS = 8192

    def __init__(self, *, device: str | torch.device | None = None,
                 panel_cache: PanelCache | None = None,
                 carry_store: CarryStore | None = None,
                 mesh: sharding.Mesh | None = None,
                 param_chunk: int | None = None,
                 use_fused: bool | None = None,
                 use_mesh: bool | None = None):
        if use_mesh is False and mesh is not None:
            raise ValueError("use_mesh=False with a mesh given")
        if device is None:
            device = (mesh.devices[0] if mesh is not None
                      else device_mod.DEFAULT_DEVICE)
        self.device = device_mod.resolve(device)
        self.param_chunk = param_chunk
        self.use_fused = use_fused is not False
        if mesh is None and use_mesh is not False:
            mesh = default_mesh(self.device)
        self.mesh = mesh
        if self.mesh is not None and self.device != self.mesh.devices[0]:
            raise ValueError(f"device {self.device} is not the mesh's first "
                             f"device {self.mesh.devices[0]}")
        self.panel_cache = (PanelCache() if panel_cache is None
                            else panel_cache)
        self.carry_store = (CarryStore(device=self.device)
                            if carry_store is None else carry_store)
        if self.panel_cache.device is None:
            self.panel_cache.device = self.device
        self.payload_fetcher: Callable[[str], bytes] | None = None
        # The paged route is meshless, as the reference's (its page pool
        # lives on one device).
        self.use_paged = (self.use_fused and fused.paged_enabled()
                          and self.mesh is None)
        self.decodes = 0
        self.appends = {"carry_hit": 0, "full_reprice": 0}
        self.advances = 0
        self.pad_bars = {"dense": 0, "paged": 0}
        self.paged_fallbacks = {"rejected": 0, "disabled": 0}
        if not self.use_paged:
            log.info("paged route off (DBX_PAGED=1 turns it on): fused "
                     "groups use the dense stacks")
        self.scenarios = {"fused": 0, "materialized": 0}
        reg = self._obs = obs.get_registry()
        self._h_decode = reg.histogram(
            "dbx_compute_decode_seconds",
            help="OHLCV wire decode wall per job group")
        self._c_decode_bytes = reg.counter(
            "dbx_compute_decode_bytes_total",
            help="OHLCV payload bytes decoded")
        self._h_collect = reg.histogram(
            "dbx_compute_collect_seconds",
            help="device drain + d2h wait per pending group")
        self._c_d2h_bytes = reg.counter(
            "dbx_compute_d2h_bytes_total",
            help="result bytes copied device->host")
        self._c_backtests = reg.counter(
            "dbx_backtests_total", help="(ticker x param) combos computed")
        self._bt_rate = obs.StepTimer(reg.gauge(
            "dbx_compute_backtests_per_sec",
            help="combos/s since backend start"))
        self._kern_h: dict = {}    # (strategy, route, cold) -> Histogram
        self._seen_cold: set = set()
        _pad_help = ("panel pad bars materialized for batching, by "
                     "execution path (dense = stacks padded to the group "
                     "max; paged = in-page pad of uploaded tail pages)")
        self._c_pad_bars = {
            "dense": reg.counter("dbx_pad_bars_total", help=_pad_help,
                                 path="dense"),
            "paged": reg.counter("dbx_pad_bars_total", help=_pad_help,
                                 path="paged")}
        # The reference's epilogue and table knobs select no other code
        # here: their labels read "default", as dbx_tuned_substrate_info's
        # do.
        reg.gauge("dbx_fused_substrate_info",
                  help="constant 1; labels carry the live fused-kernel "
                       "substrate defaults (epilogue/table/lanes)",
                  epilogue="default", lanes_cap=str(fused.resolve_lanes_cap()),
                  **{f"table_{fam}": "default"
                     for fam in ("sma", "boll", "mom", "don", "obv")}).set(1)
        self._substrate_counters: dict = {}
        self._c_append = {
            outcome: reg.counter(
                "dbx_worker_append_total",
                help="streaming append jobs served, by outcome "
                     "(carry_hit=O(ΔT) advance, full_reprice=checkpoint "
                     "miss fallback)", outcome=outcome)
            for outcome in ("carry_hit", "full_reprice")}
        self._c_scenario_route = {
            mode: reg.counter(
                "dbx_scenario_route_total",
                help="scenario jobs served, by route (fused=in-trace "
                     "regeneration, materialized=concrete panel)",
                mode=mode)
            for mode in ("materialized", "fused")}
        self.schedule_registry = tune_mod.ScheduleRegistry.open_default(
            registry=self._obs)
        self._autotuner = tune_mod.Autotuner(self.schedule_registry,
                                             registry=self._obs)
        self.platform = platform_of(self.device)
        # First-contact memo: a (family, bucket) whose tune found no winner
        # is not measured again on every group.
        self._tuned_attempted: set = set()
        self._tuned_info_seen: set = set()
        # The page size binds when the page pool is made: a restored
        # registry's page_bars winners of this platform apply process-wide
        # (the most common value, ties to the smallest).
        pb_counts: dict = {}
        for e in self.schedule_registry.entries():
            if e["platform"] != self.platform:
                continue
            v = e["substrates"].get("page_bars")
            if v:
                pb_counts[v] = pb_counts.get(v, 0) + 1
        if pb_counts:
            # (length, string) orders digit strings by their value.
            pb_pick = min(pb_counts,
                          key=lambda v: (-pb_counts[v], len(v), v))
            fused.set_tuned_defaults({"page_bars": pb_pick})

    @property
    def chips(self) -> int:
        """Device count to advertise to the dispatcher: the mesh's distinct
        devices (1 without a mesh). A mesh that lists one card four times
        (a test and smoke construct) advertises 1, so the worker takes no
        leases it cannot run in parallel."""
        return 1 if self.mesh is None else self.mesh.distinct

    @property
    def accepts_scenario_batch(self) -> bool:
        """The capability the worker declares on each poll: scenario spec
        batches are served on the fused route. Read per poll, so
        ``DBX_SCENARIO_FUSED=0`` stops new batches at once (a batch already
        leased goes to the materialized rung). False with ``use_fused``
        off."""
        return self.use_fused and fused.scenario_fused_enabled()

    def stats(self) -> dict:
        """The caches' levels and the backend's counts."""
        return {"panel_cache": self.panel_cache.stats(),
                "carry": self.carry_store.stats(),
                "appends": dict(self.appends), "advances": self.advances,
                "decodes": self.decodes, "pad_bars": dict(self.pad_bars),
                "paged_fallbacks": dict(self.paged_fallbacks),
                "scenarios": dict(self.scenarios)}

    def telemetry(self) -> dict:
        """Capability flags and cache residency for the worker's fleet
        telemetry frame (``obs.fleet``): the reference's keys, with
        ``backend`` "torch"."""
        return {
            "caps": {"backend": "torch", "chips": self.chips,
                     "platform": self.platform, "fused": self.use_fused,
                     "mesh": self.mesh is not None,
                     "paged": bool(self.use_paged)},
            "caches": {
                "panel": self.panel_cache.stats(),
                "panel_topk": self.panel_cache.top_digests(),
                "carry": self.carry_store.stats(),
                "schedule_entries": len(self.schedule_registry.entries()),
            },
        }

    def _count_pad(self, path: str, bars: int) -> None:
        self.pad_bars[path] += bars
        self._c_pad_bars[path].inc(bars)

    def _count_scenarios(self, mode: str, n: int) -> None:
        self.scenarios[mode] += n
        self._c_scenario_route[mode].inc(n)

    def _observe_submit(self, strategy: str, route: str, t0: float, *,
                        cold: bool = False, group=None, bars=None,
                        combos=None) -> None:
        """A group's submit wall (group start to its launches, decode
        included) into ``dbx_kernel_submit_seconds{kernel=route:strategy,
        phase}``. Where ``cold`` (the routes the reference splits), the
        backend's first group of this ``route:strategy`` is
        ``phase="compile"``, the rest ``"execute"``. With ``group``, the
        same interval is the span ``worker.compile`` or ``worker.execute``
        on each job's trace, ``bars`` and ``combos`` with it (the cost
        model's shape)."""
        dt = time.perf_counter() - t0
        if cold:
            cold = (route, strategy) not in self._seen_cold
            self._seen_cold.add((route, strategy))
        hk = (strategy, route, cold)
        h = self._kern_h.get(hk)
        if h is None:
            h = self._kern_h[hk] = self._obs.histogram(
                "dbx_kernel_submit_seconds",
                help="per-group submit wall (decode + H2D + launch) by "
                     "route:strategy",
                kernel=f"{route}:{strategy}",
                phase="compile" if cold else "execute")
        h.observe(dt)
        if group is not None:
            pairs = obs.job_trace_pairs(group)
            if pairs:
                shape = {}
                if bars is not None:
                    shape["bars"] = int(bars)
                if combos is not None:
                    shape["combos"] = int(combos)
                obs.emit_span("worker.compile" if cold else "worker.execute",
                              time.time() - dt, dt, pairs=pairs,
                              kernel=f"{route}:{strategy}",
                              jobs=len(group), **shape)

    def _observe_substrates(self, strategy: str) -> None:
        """Count a fused group into ``dbx_fused_substrate_total{kernel,
        epilogue,table}`` (both "default": one design a family)."""
        c = self._substrate_counters.get(strategy)
        if c is None:
            c = self._substrate_counters[strategy] = self._obs.counter(
                "dbx_fused_substrate_total",
                help="fused job groups served, by kernel and "
                     "epilogue/table substrate",
                kernel=strategy, epilogue="default", table="default")
        c.inc()

    def process(self, jobs) -> list[Completion]:
        """Run a job batch to completion: ``collect(submit(jobs))``."""
        return self.collect(self.submit(jobs))

    def submit(self, jobs) -> list[_Pending]:
        """Launch a batch and start its result copies; returns the handle
        :meth:`collect` takes.

        Streaming append jobs are peeled off first and served one at a time
        (:meth:`_submit_append_job`), then scenario spec batches, one
        carrier at a time (:meth:`_submit_scenario_group`). A job that
        ``_unsupported`` refuses is logged and left without a completion (it
        stays leased until the dispatcher re-queues it); the rest are
        grouped as the reference's ``submit`` groups them: by strategy,
        grid, length bucket of each leg (:meth:`_length_bucket`), cost,
        periods per year, walk-forward window, top-k request and
        best-returns flag.
        """
        jobs = list(jobs)
        pending = [self._submit_append_job(j) for j in jobs
                   if j.append_parent_digest]
        jobs = [j for j in jobs if not j.append_parent_digest]
        for j in jobs:
            if j.scenario_batch:
                pending.extend(self._submit_scenario_group(j))
        jobs = [j for j in jobs if not j.scenario_batch]
        # A scenario job the dispatcher materialized arrives as a plain job
        # that names its spec.
        n_mat = sum(1 for j in jobs if j.scenario.base_digest)
        if n_mat:
            self._count_scenarios("materialized", n_mat)
        groups: dict[tuple, list] = {}
        for job in jobs:
            what = _unsupported(job)
            if what is not None:
                log.warning("job %s refused: %s is not ported to the "
                            "PyTorch backend yet (see ROADMAP.md, Queue 1); "
                            "it stays leased", job.id, what)
                continue
            axes = wire.grid_from_proto(job.grid)
            key = (job.strategy,
                   tuple(sorted((k, v.tobytes()) for k, v in axes.items())),
                   self._length_bucket(job, axes),
                   (len(job.ohlcv2) or job.panel_bytes_len2).bit_length(),
                   job.cost, job.periods_per_year,
                   job.wf_train, job.wf_test, job.wf_metric,
                   job.top_k, job.rank_metric, job.best_returns)
            groups.setdefault(key, []).append(job)
        for group in groups.values():
            t0 = time.perf_counter()
            job0 = group[0]
            if not self._topk_request_ok(group):
                pending.append(_empty(group, t0))
            elif job0.best_returns and (job0.strategy == _PAIRS
                                        or job0.wf_train > 0):
                log.error("jobs %s: best_returns is not supported for %s "
                          "jobs; completing empty", [j.id for j in group],
                          "pairs" if job0.strategy == _PAIRS
                          else "walk-forward")
                pending.append(_empty(group, t0))
            elif job0.strategy == _PAIRS:
                pending.append(self._submit_pairs_group(group, t0))
                self._observe_submit(
                    _PAIRS, "pairs_wf" if job0.wf_train > 0 else "pairs",
                    t0, group=group)
            elif job0.wf_train > 0:
                pending.append(self._submit_walkforward_group(
                    group, self._decode_group(group), t0))
                self._observe_submit(job0.strategy, "walkforward", t0,
                                     group=group)
            elif job0.best_returns:
                pending.append(self._submit_best_returns_group(
                    group, self._decode_group(group), t0))
                self._observe_submit(job0.strategy, "best_returns", t0,
                                     group=group)
            else:
                pending.extend(self._submit_group(
                    group, self._decode_group(group), t0))
        return pending

    def _length_bucket(self, job, axes) -> int:
        """The leg-1 length bucket of the grouping key: the power-of-two
        bucket of the payload's length (the stamped ``panel_bytes_len`` for
        a digest-only leg), or 0 for a job the paged route serves, whose
        mixed lengths one group takes (one launch a page-count bin)."""
        if self._paged_servable(job, axes):
            return 0
        return (len(job.ohlcv) or job.panel_bytes_len).bit_length()

    def _paged_servable(self, job, axes) -> bool:
        """The paged route's eligibility, which grouping and
        :meth:`prefetch` share: paging on, a digest, a plain fused job (no
        walk-forward, best-returns, pairs or scenario batch) whose grid the
        kernel takes."""
        return (self.use_paged and bool(job.panel_digest)
                and job.wf_train == 0 and not job.best_returns
                and not job.scenario_batch
                and fused.paged_supported(job.strategy)
                and _fused_demotion_reason(_FUSED_STRATEGIES[job.strategy],
                                           axes) is None)

    def collect(self, pending: list[_Pending]) -> list[Completion]:
        """Wait for each group's result copy and pack one block per job;
        a job past a group's ``n_real`` (validated-bad) completes empty."""
        out: list[Completion] = []
        for p in pending:
            host = {}
            if p.host:
                t_wait = time.perf_counter()
                # The wait for the group's copies: the d2h stage of each
                # job's timeline. cache_hit says the submit's panel upload
                # came from the device cache.
                with obs.trace_context(obs.job_trace_pairs(p.jobs)), \
                        obs.span("worker.d2h", jobs=len(p.jobs),
                                 cache_hit=p.h2d_hit):
                    if p.ready is not None:
                        p.ready.synchronize()
                    host = {name: t.numpy() for name, t in p.host.items()}
                # Combos count the real jobs' grids, as the dispatcher's
                # rate does (a top-k group ships k rows of its full grid).
                planes = host["planes"]
                combos = sum(wire.grid_n_combos(job.grid) for job in
                             p.jobs[:min(planes.shape[1], p.n_real)])
                self._h_collect.observe(time.perf_counter() - t_wait)
                self._c_d2h_bytes.inc(planes.nbytes)
                self._c_backtests.inc(combos)
                self._bt_rate.add(combos)
            if p.kind == "metrics" and p.n_real:
                blobs = wire.metrics_blocks(host["planes"])
            else:
                blobs = [self._block(p, host, i) for i in range(p.n_real)]
            per_job = (time.perf_counter() - p.t0) / max(len(p.jobs), 1)
            for i, job in enumerate(p.jobs):
                out.append(Completion(job.id,
                                      blobs[i] if i < p.n_real else b"",
                                      per_job, trace_id=job.trace_id))
        return out

    @staticmethod
    def _block(p: _Pending, host: dict, i: int) -> bytes:
        """Job ``i``'s DBXS or DBXP block."""
        row = Metrics(*host["planes"][:, i])
        if p.kind == "topk":
            return wire.topk_to_bytes(host["idx"][i], row, p.metric)
        # Trimmed to the job's real history: its padded bars earn exactly
        # zero but belong to the group.
        return wire.best_returns_to_bytes(int(host["idx"][i]), row,
                                          host["returns"][i, :p.lengths[i]],
                                          p.metric)

    def prefetch(self, jobs) -> int:
        """Decode a batch's inline payloads into the host cache ahead of
        the compute thread (the worker's prefetch thread calls this while
        earlier batches run). Best-effort: the submit path resolves through
        the same cache, so a skipped or failed prefetch costs only the
        overlap. A zero-budget cache skips the decode it could not keep.
        The panels decoded here of jobs the paged route serves then have
        their missing pages uploaded to the pool, a group a strategy (a
        rejection is fine: submit falls back as it would without it).
        Returns the number of panels decoded."""
        cache = self.panel_cache
        if cache.max_bytes <= 0:
            return 0
        warmed = 0
        seen: set = set()
        paged: dict[str, tuple[list, list]] = {}
        for job in jobs:
            if job.append_parent_digest:
                # The append route resolves its own panel (a splice for a
                # delta-only job).
                continue
            for digest, raw in ((job.panel_digest, job.ohlcv),
                                (job.panel_digest2, job.ohlcv2)):
                if (not digest or not raw or digest in seen
                        or cache.contains_series(digest)):
                    continue
                seen.add(digest)
                try:
                    s = data_mod.from_wire_bytes(raw)
                except ValueError:
                    log.exception("prefetch decode failed for digest %s; "
                                  "the compute thread will decode (and "
                                  "fail) inline", digest[:16])
                    continue
                cache.put_series(digest, s)
                warmed += 1
                if (digest == job.panel_digest and self._paged_servable(
                        job, wire.grid_from_proto(job.grid))):
                    digests, series = paged.setdefault(job.strategy,
                                                       ([], []))
                    digests.append(digest)
                    series.append(s)
        for strategy, (digests, series) in paged.items():
            cache.pages.prepare(digests, series, fused.paged_fields(strategy))
        return warmed

    def _resolve_series(self, job, *, leg2: bool = False):
        """One leg's decoded panel: host cache, then inline bytes, then
        ``payload_fetcher``. Returns ``(series, cache_hit)``. A digest-only
        leg that none of them can serve raises ``ValueError``: the worker
        logs it and leaves the lease, and the dispatcher's re-dispatch
        ships the full bytes."""
        digest = job.panel_digest2 if leg2 else job.panel_digest
        raw = job.ohlcv2 if leg2 else job.ohlcv
        if digest:
            s = self.panel_cache.get_series(digest)
            if s is not None:
                return s, True
        if not raw and digest and self.payload_fetcher is not None:
            # The recovery RPC is its own span, so that obs.timeline
            # charges its wall to transport, not to the decode around it.
            t0_wall, t0 = time.time(), time.perf_counter()
            raw = self.payload_fetcher(digest)
            obs.emit_span("worker.payload_fetch", t0_wall,
                          time.perf_counter() - t0,
                          pairs=obs.job_trace_pairs([job]), digest=digest,
                          ok=bool(raw))
        if not raw:
            raise ValueError(
                f"job {job.id}: digest-only payload "
                f"{digest[:16] if digest else '?'} is in no cache and not "
                "fetchable; leaving the lease to requeue it")
        s = data_mod.from_wire_bytes(raw)
        self.decodes += 1
        if digest:
            self.panel_cache.put_series(digest, s)
        return s, False

    def _resolve_append_series(self, job):
        """The extended panel of an append job: the host cache by its
        digest, then a splice of the cached base panel and
        ``JobSpec.append_delta`` (delta-only dispatch: no full panel on the
        wire), then inline bytes or ``payload_fetcher``
        (:meth:`_resolve_series`). Returns ``(series, cache_hit)``."""
        digest = job.panel_digest
        if (digest and not job.ohlcv and job.append_delta
                and not self.panel_cache.contains_series(digest)):
            base = self.panel_cache.get_series(job.append_parent_digest)
            if base is not None and base.n_bars == int(job.append_base_len):
                delta = data_mod.from_wire_bytes(job.append_delta)
                s = data_mod.OHLCV(*(
                    np.concatenate([np.asarray(b), np.asarray(d)])
                    for b, d in zip(base, delta)))
                self.panel_cache.put_series(digest, s)
                return s, True
        return self._resolve_series(job)

    def _submit_append_job(self, job) -> _Pending:
        """One streaming append job (the reference's
        ``_submit_append_job``). A checkpoint stored under the job's digest
        at the panel's length is a retried delivery: it is served, not
        advanced again. Otherwise the parent's checkpoint at
        ``append_base_len`` bars advances by the appended bars and is then
        dropped (the reference keeps it: a stream here holds one
        checkpoint, its tip, so a batch of N streams needs room for N
        carries, not 2N), and where there is none the extended panel is
        repriced in full by the scan form. The new checkpoint is stored
        under the job's digest, so the next append of the chain hits.
        Pairs (the append carries one panel), an unknown family and a grid
        the family cannot price complete empty with a logged error: a
        malformed spec would never heal by re-queueing. The whole window is
        the span ``worker.append`` with its ``carry_hit`` flag."""
        t0, t0_wall = time.perf_counter(), time.time()
        if (not recurrent.supports_strategy(job.strategy)
                or job.strategy == _PAIRS):
            log.error("append job %s: strategy %r is not streamable over "
                      "AppendBars; completing with empty metrics", job.id,
                      job.strategy)
            return _empty([job], t0)
        axes = wire.grid_from_proto(job.grid)
        grid = {k: v.numpy()
                for k, v in sweep_mod.product_grid(**axes).items()}
        cost = float(job.cost)
        ppy = int(job.periods_per_year or 252)
        skey = recurrent.stream_key(job.strategy, grid, cost, ppy)
        series, _ = self._resolve_append_series(job)
        fields = {f: device_mod.upload(np.asarray(getattr(series, f),
                                        np.float32)[None, :], self.device)
                  for f in recurrent.stream_fields(job.strategy)}
        base_len = int(job.append_base_len)
        store = self.carry_store
        hit = retried = False
        try:
            carry = (store.get((job.panel_digest, skey))
                     if job.panel_digest else None)
            if carry is not None and carry.n_bars == series.n_bars:
                # A retried delivery: nothing to advance or store again.
                hit = retried = True
            else:
                carry = None
                if 0 < base_len < series.n_bars:
                    parent = (job.append_parent_digest, skey)
                    base = store.get(parent)
                    if base is not None and base.n_bars == base_len:
                        carry = recurrent.append_step(
                            base, {f: v[:, base_len:]
                                   for f, v in fields.items()})
                        self.advances += 1
                        hit = True
                        store.drop(parent)     # one checkpoint a stream
                if carry is None:
                    carry = recurrent.build_carry(
                        job.strategy, fields, grid, cost=cost,
                        periods_per_year=ppy, device=self.device)
        except (ValueError, KeyError) as e:
            log.error("append job %s: %s; completing with empty metrics",
                      job.id, e)
            return _empty([job], t0)
        if job.panel_digest and not retried:
            store.put((job.panel_digest, skey), carry)
        outcome = "carry_hit" if hit else "full_reprice"
        self.appends[outcome] += 1
        self._c_append[outcome].inc()
        # finalize gives fresh tensors and the copy goes to storage of its
        # own: the block never aliases the stored checkpoint.
        host, ready = _copy_to_host(
            {"planes": torch.stack(list(recurrent.finalize(carry)))})
        obs.emit_span("worker.append", t0_wall, time.perf_counter() - t0,
                      pairs=obs.job_trace_pairs([job]), job=job.id,
                      carry_hit=hit, bars=series.n_bars,
                      delta_bars=series.n_bars - base_len)
        # The histogram alone: an execute span over the same window would
        # tie with worker.append in obs.timeline's attribution.
        self._observe_submit(job.strategy, "append", t0)
        return _Pending([job], 1, t0, host, ready)

    def _submit_scenario_group(self, job) -> list[_Pending]:
        """One carrier job's scenario spec batch (``JobSpec.scenario_batch``,
        the reference's ``_submit_scenario_group``): the K panels generated
        on the device from the base panel and each spec's effective seed,
        in chunks, each chunk through one call of the family's wrapper
        (``fused.fused_scenario_sweep``); every spec completes under its
        own id and trace id. The batch shares the first spec's ``n_bars``,
        ``block`` and ``regimes``.

        ``DBX_SCENARIO_FUSED=0``, a family without a scenario row, a grid
        the kernel does not take, or a batch the fused route rejects as
        invalid (``ValueError``) go to the materialized rung
        (:meth:`_submit_scenario_materialized`), logged and counted.
        Nothing else is caught: a failure on the card propagates. An
        unresolvable base raises, and the lease re-queues the batch."""
        t0 = time.perf_counter()
        specs = list(job.scenario_batch)
        series, _ = self._resolve_series(job)
        axes = wire.grid_from_proto(job.grid)
        if not self.use_fused:
            why = "use_fused=False"
        elif not fused.scenario_fused_enabled():
            why = "DBX_SCENARIO_FUSED=0"
        elif not fused.scenario_supported(job.strategy):
            why = f"strategy {job.strategy!r} has no scenario row"
        else:
            why = _fused_demotion_reason(_FUSED_STRATEGIES[job.strategy],
                                         axes)
        if why is None:
            try:
                n_bars, block, regimes = synth.check_shape(
                    series.n_bars, specs[0].n_bars, specs[0].block,
                    specs[0].regimes)
                words = [synth.seed_words(int(s.seed)) for s in specs]
                m = fused.fused_scenario_sweep(
                    job.strategy, series._asdict(),
                    [w[0] for w in words], [w[1] for w in words],
                    [s.vol_scale for s in specs], [s.shock for s in specs],
                    {k: v.numpy() for k, v in
                     sweep_mod.product_grid(**axes).items()},
                    n_bars=n_bars, block=block, regimes=regimes,
                    cost=float(job.cost),
                    periods_per_year=int(job.periods_per_year or 252),
                    device=self.device)
            except ValueError as e:
                why = str(e)
        if why is not None:
            log.warning("scenario batch %s (%s, %d specs) takes the "
                        "materialized rung: %s", job.id, job.strategy,
                        len(specs), why)
            obs_flight.trigger("scenario_fused_fail", subject=job.id,
                               strategy=job.strategy, specs=len(specs),
                               error=why)
            return self._submit_scenario_materialized(job, specs, series, t0)
        self._count_scenarios("fused", len(specs))
        pseudo = self._scenario_jobs(job, specs)
        self._observe_submit(job.strategy, "scenario", t0, cold=True,
                             group=pseudo, bars=n_bars,
                             combos=len(specs) * wire.grid_n_combos(job.grid))
        return [self._finish_group(pseudo, m, t0, len(specs), job)]

    @staticmethod
    def _scenario_jobs(job, specs) -> list:
        return [_ScenarioJob(s.id, s.trace_id, job.grid, job.parent_span_id)
                for s in specs]

    def _submit_scenario_materialized(self, job, specs, series,
                                      t0: float) -> list[_Pending]:
        """The materialized rung: each spec's panel generated by the same
        chunked generator call as the fused route (so the same bits), as
        DBX1 bytes in an ordinary inline job under the spec's id, and the K
        jobs submitted as any batch is. Specs are generated a group of equal
        ``(n_bars, block, regimes)`` at a time; a group whose shape is
        invalid completes empty with a logged error (a malformed spec would
        never heal by re-queueing)."""
        self._count_scenarios("materialized", len(specs))
        shapes: dict[tuple, list] = {}
        for s in specs:
            shapes.setdefault((s.n_bars, s.block, s.regimes), []).append(s)
        pending, expanded = [], []
        for (n_bars, block, regimes), group in shapes.items():
            try:
                n_bars, block, regimes = synth.check_shape(
                    series.n_bars, n_bars, block, regimes)
            except ValueError as e:
                log.error("scenario specs %s: %s; completing with empty "
                          "metrics", [s.id for s in group], e)
                pending.append(_empty(self._scenario_jobs(job, group), t0))
                continue
            words = [synth.seed_words(int(s.seed)) for s in group]
            for r0, rows in synth.generate_rows(
                    series._asdict(), [w[0] for w in words],
                    [w[1] for w in words], [s.vol_scale for s in group],
                    [s.shock for s in group], n_bars=n_bars, block=block,
                    regimes=regimes, device=self.device):
                host = {f: rows[f].cpu().numpy() for f in synth.FIELDS}
                for i in range(host["close"].shape[0]):
                    out = pb.JobSpec()
                    out.CopyFrom(job)
                    del out.scenario_batch[:]
                    out.id = group[r0 + i].id
                    out.trace_id = group[r0 + i].trace_id
                    out.ohlcv = data_mod.to_wire_bytes(data_mod.OHLCV(
                        *(host[f][i] for f in synth.FIELDS)))
                    out.panel_digest = ""
                    out.panel_bytes_len = 0
                    expanded.append(out)
        if expanded:
            pending.extend(self.submit(expanded))
        return pending

    def _decode_group(self, group) -> list:
        """The group's leg-1 panels, each through :meth:`_resolve_series`,
        under the span ``worker.decode`` (``cache_hit`` where every panel
        came from the host cache: obs.timeline then charges the window to
        ``panel_cache_hit``)."""
        t0_wall, t0 = time.time(), time.perf_counter()
        series, hits = [], 0
        for j in group:
            s, hit = self._resolve_series(j)
            series.append(s)
            hits += hit
        self._observe_decode(group, t0_wall, t0, hits,
                             hits == len(group), len(group))
        return series

    def _observe_decode(self, group, t0_wall: float, t0: float, hits: int,
                        cache_hit: bool, n_jobs: int) -> None:
        """A group's decode into ``dbx_compute_decode_seconds``,
        ``dbx_compute_decode_bytes_total`` (both legs' inline bytes) and
        the span ``worker.decode``."""
        dur = time.perf_counter() - t0
        self._h_decode.observe(dur)
        self._c_decode_bytes.inc(sum(len(j.ohlcv) + len(j.ohlcv2)
                                     for j in group))
        obs.emit_span("worker.decode", t0_wall, dur,
                      pairs=obs.job_trace_pairs(group), jobs=n_jobs,
                      cache_hit=cache_hit, cache_hits=hits)

    def _device_fields(self, group, series, fields, lengths, *,
                       hits: list | None = None):
        """``{field: (n, T_max)}`` of a fused group; where ``hits`` is
        given, whether every block came from the device cache is appended
        to it.

        With a digest on every job, each panel is cached on the device as
        its ``(5, T)`` block, in storage of its own: a hit skips the
        host-to-device copy, a miss uploads (all of a group's misses in one
        copy) and fills the cache.
        The group is then stacked on the device, repeat-last padded to the
        group's longest panel by one gather when ragged: the same values as
        :func:`_stack_field_ragged`'s host stack. Digestless jobs keep the
        host stack, and the sweep uploads it.
        """
        t_max = max(lengths)
        uniform = len(set(lengths)) == 1
        if hits is not None:
            hits.append(False)
        if not all(j.panel_digest for j in group):
            if uniform:
                return {f: np.stack([getattr(s, f) for s in series])
                        for f in fields}
            return {f: _stack_field_ragged(series, t_max, f) for f in fields}
        cache = self.panel_cache
        blocks = [cache.get_device(j.panel_digest) for j in group]
        miss = [i for i, b in enumerate(blocks) if b is None]
        if hits is not None:
            hits[-1] = not miss
        if miss:
            # One upload for the misses, then a copy of each block into
            # storage of its own: a cached view of the upload would keep
            # the whole upload alive, past what the budget charges it.
            host = [np.stack([np.asarray(f, np.float32) for f in series[i]])
                    for i in miss]
            flat = device_mod.upload(np.concatenate(host, axis=1), self.device)
            pieces = torch.split(flat, [h.shape[1] for h in host], dim=1)
            for i, piece in zip(miss, pieces):
                blocks[i] = piece.clone()
                cache.put_device(group[i].panel_digest, blocks[i],
                                 blocks[i].nbytes)
        rows = [data_mod._FIELDS.index(f) for f in fields]
        if uniform:
            return {f: torch.stack([b[r] for b in blocks])
                    for f, r in zip(fields, rows)}
        lens = device_mod.upload(np.asarray(lengths, np.int64), self.device)
        starts = torch.cumsum(lens, 0) - lens
        bars = torch.arange(t_max, device=self.device)
        at = starts[:, None] + torch.minimum(bars[None, :], lens[:, None] - 1)
        flat = torch.cat(blocks, dim=1)                       # (5, sum T)
        return {f: flat[r][at] for f, r in zip(fields, rows)}

    @staticmethod
    def _topk_request_ok(group) -> bool:
        """Validate a group's top-k request up front: an unknown rank
        metric completes empty with a logged error, no compute."""
        job0 = group[0]
        if job0.top_k <= 0 or job0.wf_train > 0:
            return True
        metric = job0.rank_metric or "sharpe"
        if metric in Metrics._fields:
            return True
        log.error("jobs %s request top-k by unknown metric %r (known: %s); "
                  "completing with empty metrics", [j.id for j in group],
                  metric, ", ".join(Metrics._fields))
        return False

    def _finish_group(self, jobs, m: Metrics, t0: float, n_real: int,
                      job0, *, h2d_hit: bool = False) -> _Pending:
        """The shared tail of the sweep paths: the top-k selection on the
        device where the job asks for it (never for a walk-forward job's
        one row), then the result copy. ``h2d_hit`` rides to collect's
        ``worker.d2h`` span."""
        if job0.top_k <= 0 or job0.wf_train > 0:
            host, ready = _copy_to_host({"planes": torch.stack(list(m))})
            return _Pending(list(jobs), n_real, t0, host, ready,
                            h2d_hit=h2d_hit)
        metric = job0.rank_metric or "sharpe"
        k = min(int(job0.top_k), wire.grid_n_combos(job0.grid))
        idx, m = _topk_reduce(m, metric, k)
        host, ready = _copy_to_host({"planes": torch.stack(list(m)),
                                     "idx": idx})
        return _Pending(list(jobs), n_real, t0, host, ready, "topk", metric,
                        h2d_hit=h2d_hit)

    def _submit_group(self, group, series, t0: float, *,
                      allow_paged: bool = True,
                      long_context: bool = True) -> list[_Pending]:
        """A single-asset group: its fused sweep, or the generic sweep where
        the kernel does not take its grid. A fused group whose jobs all
        carry digests goes through the page pool (:meth:`_try_paged`); where
        the pool rejects it, through the dense stacks, a ragged group first
        split again by the power-of-two length bucket (the dense route's
        pad bound). On a mesh, a long-context group first takes the
        time-sharded route (:meth:`_route_timeshard`) unless
        ``long_context`` is False (its remainder, already refused). Returns
        the group's pending entries."""
        lengths = [s.n_bars for s in series]
        job0 = group[0]
        axes = wire.grid_from_proto(job0.grid)
        if long_context and self._long_context(group, lengths):
            pending, rest = self._route_timeshard(group, series, lengths,
                                                  t0, axes)
            if not rest:
                return pending
            # The remainder restarts the clock and keeps the other routes.
            return pending + self._submit_group(
                [group[i] for i in rest], [series[i] for i in rest],
                time.perf_counter(), allow_paged=allow_paged,
                long_context=False)
        grid = sweep_mod.product_grid(**axes)
        cost = float(job0.cost)
        ppy = job0.periods_per_year or 252
        spec = _FUSED_STRATEGIES[job0.strategy]
        if self.use_fused:
            demotion = _fused_demotion_reason(spec, axes)
            if demotion is None:
                g = {k: v.numpy() for k, v in grid.items()}
                return self._submit_fused(group, series, lengths, g, cost,
                                          ppy, t0, allow_paged, spec)
            log.warning("jobs %s (%s) take the generic path: %s",
                        [j.id for j in group], job0.strategy, demotion)
        if len(set(lengths)) > 1:
            self._count_pad("dense", sum(max(lengths) - t for t in lengths))
        batch, _, mask = data_mod.pad_and_stack(series)
        strategy = models_base.get_strategy(job0.strategy)
        # The reference's rule: chunks only where they divide the grid.
        P = sweep_mod.grid_size(grid)
        chunk = (self.param_chunk
                 if self.param_chunk and P % self.param_chunk == 0 else None)
        if self.mesh is not None:
            m = sharding.sharded_sweep(self.mesh, batch, strategy, grid,
                                       cost=cost, bar_mask=mask,
                                       periods_per_year=ppy,
                                       param_chunk=chunk)
        elif chunk:
            m = sweep_mod.chunked_sweep(batch, strategy, grid,
                                        param_chunk=chunk, cost=cost,
                                        bar_mask=mask, periods_per_year=ppy,
                                        device=self.device)
        else:
            m = sweep_mod.run_sweep(batch, strategy, grid, cost=cost,
                                    bar_mask=mask, periods_per_year=ppy,
                                    device=self.device)
        self._observe_submit(
            job0.strategy, "generic" + ("_mesh" if self.mesh else ""), t0,
            cold=True, group=group, bars=max(lengths),
            combos=sweep_mod.grid_size(grid))
        return [self._finish_group(group, m, t0, len(group), job0)]

    def _submit_fused(self, group, series, lengths, g, cost, ppy, t0,
                      allow_paged: bool, spec):
        """A fused group's sweep on the paged route (jobs with digests,
        paging on) or the dense stacks, under the tuned schedule of the
        route that serves it (:meth:`_tuned_schedule_for`). Returns the
        group's pending entries: one, or those of a ragged group that the
        pool rejected, split again by the power-of-two length bucket."""
        job0 = group[0]
        ragged = len(set(lengths)) > 1
        self._observe_substrates(job0.strategy)
        consult = functools.partial(self._tuned_schedule_for, job0.strategy,
                                    lengths, g)
        m = None
        digests = all(j.panel_digest for j in group)
        if digests and allow_paged and not self.use_paged:
            self.paged_fallbacks["disabled"] += 1
        elif digests and allow_paged:
            m = self._try_paged(group, series, lengths, g, cost, ppy, consult)
            if m is None:
                self.paged_fallbacks["rejected"] += 1
                buckets: dict[int, list[int]] = {}
                for i, j in enumerate(group):
                    b = (len(j.ohlcv) or j.panel_bytes_len).bit_length()
                    buckets.setdefault(b, []).append(i)
                log.warning("%d %s jobs (first %s): the page pool rejected "
                            "the group; serving it from the dense stacks in "
                            "%d length bucket(s)", len(group), job0.strategy,
                            job0.id, len(buckets))
                if ragged and len(buckets) > 1:
                    out = []
                    for _, idx in sorted(buckets.items()):
                        out.extend(self._submit_group(
                            [group[i] for i in idx],
                            [series[i] for i in idx], t0,
                            allow_paged=False))
                        t0 = time.perf_counter()
                    return out
        route = "paged"
        h2d_hit = [False]
        if m is None:
            route = "fused" + ("_mesh" if self.mesh else "")
            if ragged:
                self._count_pad("dense", sum(max(lengths) - t
                                             for t in lengths))
            fields = self._device_fields(group, series, spec.fields, lengths,
                                         hits=h2d_hit)
            run = functools.partial(
                self._dense_sweep, spec, g=g, cost=cost, ppy=ppy,
                t_real=np.asarray(lengths, np.int32) if ragged else None)
            # A measurement times the sweep on fields already on the card
            # (a digestless group's host stacks uploaded once for it).
            with fused.tuned_schedule(consult(
                    lambda: functools.partial(run, self._resident(fields)))):
                m = run(fields)
        self._observe_submit(job0.strategy, route, t0, cold=True,
                             group=group, bars=max(lengths),
                             combos=sweep_mod.grid_size(g))
        return [self._finish_group(group, m, t0, len(group), job0,
                                   h2d_hit=h2d_hit[-1])]

    def _resident(self, arrays):
        """``arrays`` (a dict or a list) with each host array uploaded to
        the backend's device; a tensor stays as it is."""
        up = (lambda a: a if isinstance(a, torch.Tensor)
              else device_mod.upload(a, self.device))
        if isinstance(arrays, dict):
            return {k: up(v) for k, v in arrays.items()}
        return [up(a) for a in arrays]

    def _dense_sweep(self, spec, fields, *, g, t_real, cost,
                     ppy) -> Metrics:
        """A fused group's sweep on its dense stacks: one wrapper call on
        the backend's device, or one a shard on the mesh."""
        if self.mesh is None:
            return spec.run(fields, g, t_real=t_real, cost=cost,
                            periods_per_year=ppy, device=self.device)
        return self._mesh_call(
            lambda blks, tr, dev: spec.run(
                dict(zip(spec.fields, blks)), g, t_real=tr, cost=cost,
                periods_per_year=ppy, device=dev),
            [fields[f] for f in spec.fields], t_real)

    def _tuned_schedule_for(self, family: str, lengths, grid: dict,
                            make_run) -> dict | None:
        """The tuned substrate schedule of a fused group's (family, shape
        bucket with its rows a card, :func:`~..tune.group_bucket`,
        platform), or None (the defaults). Under ``DBX_AUTOTUNE`` a
        first contact with no entry tunes it: ``make_run()`` gives the
        group's own sweep on the route that serves it as a call, its inputs
        on the card, measured by :meth:`_autotune_measure` (``model``: the
        prior's pick). Never raises: a broken registry or a failed tune
        serves the defaults."""
        try:
            n_bars = int(max(lengths))
            n_combos = max((int(np.asarray(v).shape[0])
                            for v in grid.values()), default=1)
            # The rows one card sweeps: the mesh splits the group's rows.
            n_rows = -(-len(lengths) // (self.mesh.size if self.mesh
                                         is not None else 1))
            bucket = tune_mod.group_bucket(n_bars, n_combos, n_rows)
            sched = self.schedule_registry.lookup(family, bucket,
                                                  self.platform)
            mode = tune_mod.autotune_mode()
            if (sched is None and mode != "off"
                    and (family, bucket) not in self._tuned_attempted):
                self._tuned_attempted.add((family, bucket))
                # page_bars joins the search under the prior only: it
                # binds when the pool is made, so the runs measured here
                # could not tell its candidates apart.
                sched = self._autotuner.tune(
                    family, bucket, self.platform, n_bars=n_bars,
                    n_combos=n_combos,
                    measure=(None if mode == "model"
                             else self._autotune_measure(make_run)),
                    paged=(mode == "model" and self.use_paged
                           and fused.paged_supported(family)),
                    n_rows=n_rows, grid=grid)
            if sched:
                self._publish_tuned_info(family, bucket, sched)
            return sched
        except Exception:
            log.exception("tuned-schedule consultation failed; serving the "
                          "default substrates")
            return None

    # Runs of a group's sweep timed together in one autotune measurement.
    _MEASURE_RUNS = 3

    def _autotune_measure(self, make_run):
        """The autotuner's harness for one group: ``measure(substrates)``
        runs the group's own sweep (``make_run()``, made once: the route
        that serves the group, its inputs on the card) under the
        candidate, once to warm, then
        ``_MEASURE_RUNS`` times back to back between two synchronizations
        of the card, and returns the mean: the host's enqueue of a run
        overlaps the card's work on the one before, so the time is the
        card's, and host jitter is spread over the runs. Not a one-ticker
        probe: a tile's width trades CTAs against the card's SMs, so the
        group's own rows set the winner."""
        devices = (self.mesh.devices if self.mesh is not None
                   else [self.device])
        runs: list = []

        def measure(substrates: dict) -> float:
            if not runs:
                runs.append(make_run())
            with fused.tuned_schedule(substrates):
                runs[0]()
                _synchronize(devices)
                t0 = time.perf_counter()
                for _ in range(self._MEASURE_RUNS):
                    runs[0]()
                _synchronize(devices)
                return (time.perf_counter() - t0) / self._MEASURE_RUNS
        return measure

    def _publish_tuned_info(self, family: str, bucket: str,
                            sched: dict) -> None:
        """``dbx_tuned_substrate_info``: constant 1, its labels the tuned
        substrates serving this (family, shape bucket) ("default" where a
        knob is left to the default; always for the reference's
        ``epilogue`` and ``table`` labels, which select no other code
        here)."""
        key = (family, bucket, tuple(sorted(sched.items())))
        if key in self._tuned_info_seen:
            return
        self._tuned_info_seen.add(key)
        self._obs.gauge(
            "dbx_tuned_substrate_info",
            help="constant 1; labels carry the tuned substrate schedule "
                 "serving this (kernel family, shape-bucket) — the "
                 "tuned-vs-default twin of dbx_fused_substrate_info",
            kernel=family, bucket=bucket,
            epilogue="default", table="default",
            lanes_cap=sched.get("lanes_cap", "default"),
            page_bars=sched.get("page_bars", "default")).set(1)

    def _mesh_call(self, runner, row_arrays, t_real=None):
        """Run ``runner(blocks, t_real_block, device) -> Metrics`` (or a
        tuple of row tensors) with the group's rows split over the mesh (the
        reference's ``_mesh_call``): the rows of ``row_arrays`` (numpy or
        tensors) padded to a multiple of the mesh by repeating the last row,
        shard ``i``'s block on ``mesh.devices[i]``, its lengths from
        ``t_real`` (numpy, or None); the outputs concatenated in shard order
        on the backend's device and cut to the real rows, so pad rows are
        computed and never reported. Each shard's launches queue on its own
        device, so shards on distinct cards run at once."""
        mesh = self.mesh
        n = int(row_arrays[0].shape[0])
        n_pad = sharding.pad_tickers(n, mesh.size)
        per = n_pad // mesh.size
        blocks = [sharding.shard_rows(mesh, a) for a in row_arrays]
        tr = (None if t_real is None else
              sharding.pad_rows(np.asarray(t_real, np.int32), n_pad))
        parts = [runner([b[i] for b in blocks],
                        None if tr is None else tr[i * per:(i + 1) * per],
                        dev)
                 for i, dev in enumerate(mesh.devices)]
        out = [sharding.gather(mesh, f)[:n] for f in zip(*parts)]
        return type(parts[0])(*out) if isinstance(parts[0], Metrics) \
            else tuple(out)

    def _long_context(self, group, lengths) -> bool:
        """The time-sharded route's trigger: a mesh of two or more shards,
        fewer tickers than shards, a history longer than
        ``_LONG_CONTEXT_BARS``."""
        return (self.mesh is not None and self.mesh.size >= 2
                and len(group) < self.mesh.size
                and max(lengths) > self._LONG_CONTEXT_BARS)

    def _route_timeshard(self, group, series, lengths, t0, axes):
        """A long-context group on the time-sharded route: the whole group
        where :func:`timeshard_route_reason` allows it; otherwise, gated
        job by job (one short job must not drag the long ones off the
        route, and a job within ``_LONG_CONTEXT_BARS`` keeps the fused
        route), the jobs it allows. Returns ``(pending, indices of the jobs
        left to the other routes)``."""
        strategy = group[0].strategy
        n_dev = self.mesh.size
        reason = timeshard_route_reason(strategy, axes, lengths, n_dev)
        if reason is None:
            ok = list(range(len(group)))
        else:
            ok = [i for i, t in enumerate(lengths)
                  if t > self._LONG_CONTEXT_BARS and timeshard_route_reason(
                      strategy, axes, [t], n_dev) is None]
        rest = [i for i in range(len(group)) if i not in set(ok)]
        if not ok:
            log.warning("jobs %s (%s) are long-context (%d bars) but not "
                        "time-shardable (%s); they take the other routes",
                        [j.id for j in group], strategy, max(lengths),
                        reason)
            return [], rest
        log.info("jobs %s (%s) routed to the time-sharded long-context path "
                 "(%d bars over %d shards)%s", [group[i].id for i in ok],
                 strategy, max(lengths[i] for i in ok), n_dev,
                 "" if not rest else f"; {[group[i].id for i in rest]} "
                 f"take the other routes ({reason})")
        pending = self._submit_timeshard_groups(
            [group[i] for i in ok], [series[i] for i in ok],
            [lengths[i] for i in ok], t0, axes)
        self._observe_submit(
            strategy, "timeshard", t0, cold=True,
            group=[group[i] for i in ok],
            bars=max(lengths[i] for i in ok),
            combos=sweep_mod.grid_size(sweep_mod.product_grid(**axes)))
        return pending, rest

    def _submit_timeshard_groups(self, group, series, lengths, t0,
                                 axes) -> list[_Pending]:
        """Long-context jobs with their bars split over the mesh (the
        reference's ``_submit_timeshard_groups``): each grid combo runs the
        family's composed blockwise backtest (:mod:`..parallel.timeshard`).
        Histories pad right with repeat-last bars to a mesh multiple and
        pass their real length, so pad bars are dead in every metric. One
        pending entry a distinct length (ragged histories cannot share one
        padded panel)."""
        job0 = group[0]
        fn = getattr(timeshard, _TIMESHARD_STRATEGIES[job0.strategy].fn_name)
        tmesh = sharding.Mesh(self.mesh.devices, timeshard.TIME_AXIS)
        n_dev = tmesh.size
        cost = float(job0.cost)
        ppy = int(job0.periods_per_year or 252)
        combos = timeshard_combos(job0.strategy, axes)
        by_len: dict[int, list[int]] = {}
        for i, t in enumerate(lengths):
            by_len.setdefault(int(t), []).append(i)
        pending = []
        for t, idx in sorted(by_len.items()):
            T_pad = -(-t // n_dev) * n_dev
            arrays = [device_mod.upload(_stack_field_ragged(
                [series[i] for i in idx], T_pad, f), tmesh.devices[0])
                for f in _FUSED_STRATEGIES[job0.strategy].fields]
            ms = [fn(tmesh, *arrays, *cmb, cost=cost, periods_per_year=ppy,
                     t_real=None if t == T_pad else t) for cmb in combos]
            m = Metrics(*(torch.stack(cols, dim=-1) for cols in zip(*ms)))
            pending.append(self._finish_group([group[i] for i in idx], m, t0,
                                              len(idx), job0))
        return pending

    def _try_paged(self, group, series, lengths, grid, cost, ppy, consult):
        """The paged route of a fused group: its pages resolved against the
        pool (only missing pages upload) and one launch a page-count bin
        (``fused.fused_paged_sweep``), under the tuned schedule
        ``consult(make_run)`` gives for this route (a measurement times the
        paged sweep on the pages just resolved). The pool's writer lock is
        held from ``prepare`` until the sweep has enqueued its gathers, so
        the prefetch thread cannot overwrite a slot in between. Returns the
        metrics, or None when the pool rejects the group."""
        pages = self.panel_cache.pages
        strategy = group[0].strategy
        with pages.lock:
            prep = pages.prepare([j.panel_digest for j in group], series,
                                 fused.paged_fields(strategy))
            if prep is None:
                return None
            pool, tables, info = prep
            self._count_pad("paged", info["pad_bars_new"])
            run = functools.partial(
                fused.fused_paged_sweep, strategy, pool, tables,
                np.asarray(lengths, np.int32), grid, cost=cost,
                periods_per_year=ppy)
            with fused.tuned_schedule(consult(lambda: run)):
                return run()

    def _submit_best_returns_group(self, group, series, t0: float) -> _Pending:
        """Best-returns jobs (``JobSpec.best_returns``, the reference's
        ``_submit_best_returns_group``): the generic sweep of the group
        (the repricing needs positions, which the fused kernels do not
        materialize), each job's best combo by ``rank_metric``
        (``sweep.best_params``: NaN last, in the metric's direction, ties
        to the first index), that combo repriced, and one copy of the index,
        the metric row and the return series. The ``(N, P)`` metrics never
        leave the device; the sweep runs in param chunks."""
        job0 = group[0]
        metric = job0.rank_metric or "sharpe"
        if metric not in Metrics._fields:
            log.error("jobs %s: unknown best_returns rank metric %r; "
                      "completing empty", [j.id for j in group], metric)
            return _empty(group, t0)
        strategy = models_base.get_strategy(job0.strategy)
        grid = sweep_mod.product_grid(**wire.grid_from_proto(job0.grid))
        cost = float(job0.cost)
        ppy = job0.periods_per_year or 252
        batch, _, mask = data_mod.pad_and_stack(series)

        def best(blks, _tr, dev):
            panel, bar_mask = data_mod.OHLCV(*blks[:5]), blks[5]
            m = sweep_mod.run_sweep(panel, strategy, grid, cost=cost,
                                    bar_mask=bar_mask, periods_per_year=ppy,
                                    device=dev)
            _, chosen, idx = sweep_mod.best_params(
                getattr(m, metric), grid, metric=metric, return_index=True)
            returns = sweep_mod.reprice(panel, strategy, chosen, cost=cost,
                                        bar_mask=bar_mask, device=dev)
            rows = torch.stack([torch.take_along_dim(f, idx[:, None], dim=1)
                                for f in m], dim=1)           # (N, 9, 1)
            return rows, idx, returns

        arrays = [*batch, mask]
        rows, idx, returns = (best(arrays, None, self.device)
                              if self.mesh is None
                              else self._mesh_call(best, arrays))
        host, ready = _copy_to_host({"planes": rows.permute(1, 0, 2),
                                     "idx": idx, "returns": returns})
        return _Pending(list(group), len(group), t0, host, ready, "returns",
                        metric, tuple(s.n_bars for s in series))

    def _submit_walkforward_group(self, group, series, t0: float) -> _Pending:
        """Walk-forward jobs (the reference's ``_submit_walkforward_group``):
        per refit window, the train-span sweep, each job's argmax by
        ``wf_metric``, and that combo realized on the next ``wf_test``
        bars; each job's result is one stitched out-of-sample metrics row.
        A uniform group whose grid has at least ``_WF_FUSED_MIN_COMBOS``
        combos and routes to a fused sweep takes the fused-train route
        (:func:`~..parallel.walkforward.walk_forward_fused`, the family's
        kernel on all windows' train spans at once); any other uniform
        group the generic ``walk_forward``, and a ragged group refits one
        job at a time, since window starts are global bar indices. An
        unknown metric completes the group empty; a job with ``wf_test <=
        0`` or shorter than one train and test window completes empty."""
        job0 = group[0]
        need = job0.wf_train + job0.wf_test
        metric = job0.wf_metric or "sharpe"
        if metric not in Metrics._fields:
            log.error("walk-forward jobs %s request unknown selection "
                      "metric %r (known: %s); completing with empty metrics",
                      [j.id for j in group], metric, ", ".join(Metrics._fields))
            return _empty(group, t0)
        good, bad = [], []
        for j, s in zip(group, series):
            if job0.wf_test <= 0 or s.n_bars < need:
                log.error(
                    "walk-forward job %s needs wf_test > 0 and >= %d bars "
                    "(train %d + test %d), has %d; completing with empty "
                    "metrics", j.id, need, job0.wf_train, job0.wf_test,
                    s.n_bars)
                bad.append(j)
            else:
                good.append((j, s))
        if not good:
            return _empty(bad, t0)
        jobs = [j for j, _ in good]
        series = [s for _, s in good]
        lengths = [s.n_bars for s in series]
        axes = wire.grid_from_proto(job0.grid)
        grid = sweep_mod.product_grid(**axes)
        strategy = models_base.get_strategy(job0.strategy)
        kw = dict(train=job0.wf_train, test=job0.wf_test, metric=metric,
                  cost=float(job0.cost),
                  periods_per_year=job0.periods_per_year or 252,
                  device=self.device)
        if len(set(lengths)) == 1:
            fields = self._device_fields(jobs, series, data_mod._FIELDS,
                                         lengths)
            spec = _FUSED_STRATEGIES[job0.strategy]
            P = sweep_mod.grid_size(grid)
            fused_train = (self.use_fused
                           and P >= self._WF_FUSED_MIN_COMBOS
                           and _fused_demotion_reason(spec, axes) is None)
            if fused_train:
                log.info("walk-forward jobs %s (%s, P=%d) using the "
                         "fused-train route", [j.id for j in jobs],
                         job0.strategy, P)
                self._observe_substrates(job0.strategy)
            g = {k: v.numpy() for k, v in grid.items()}

            def refit(blks, _tr, dev):
                panel = data_mod.OHLCV(*blks)
                kwd = dict(kw, device=dev)
                if not fused_train:
                    return walkforward.walk_forward(panel, strategy, grid,
                                                    **kwd).oos_metrics

                def train_fn(*fs):
                    return spec.run(dict(zip(spec.fields, fs)), g,
                                    cost=kw["cost"],
                                    periods_per_year=kw["periods_per_year"],
                                    device=dev)

                return walkforward.walk_forward_fused(
                    panel, strategy, grid, train_fn, fields=spec.fields,
                    **kwd).oos_metrics

            arrays = [fields[f] for f in data_mod._FIELDS]
            m = (refit(arrays, None, self.device) if self.mesh is None
                 else self._mesh_call(refit, arrays))
        else:
            rows = [walkforward.walk_forward(
                data_mod.OHLCV(*(np.asarray(f)[None] for f in s)), strategy,
                grid, **kw).oos_metrics for s in series]
            m = Metrics(*(torch.cat(f) for f in zip(*rows)))
        m = Metrics(*(f[:, None] for f in m))        # one OOS row per job
        return self._finish_group(jobs + bad, m, t0, len(jobs), job0)

    def _submit_pairs_group(self, group, t0: float) -> _Pending:
        """Two-legged jobs (the reference's ``_submit_pairs_group``): stack
        both legs, run the fused pairs sweep, with ``t_real`` for a ragged
        group; a group the kernel does not take runs the generic
        ``run_pairs_sweep``, one job at a time when ragged (it has no bar
        mask). A job without a second leg, or with legs of unequal length,
        completes with an empty block. Walk-forward jobs run the generic
        ``walk_forward_pairs`` (the reference has no fused route for them),
        one job at a time when ragged, and return one stitched row a job;
        an unknown metric or ``wf_test <= 0`` completes the group empty, a
        job shorter than one train and test window completes empty."""
        wf = group[0].wf_train > 0
        if wf:
            job0 = group[0]
            metric = job0.wf_metric or "sharpe"
            if job0.wf_test <= 0 or metric not in Metrics._fields:
                log.error(
                    "pairs walk-forward jobs %s need wf_test > 0 and a "
                    "known metric (got test=%d, metric=%r); completing "
                    "with empty metrics", [j.id for j in group],
                    job0.wf_test, metric)
                return _empty(group, t0)
        good, bad = [], []
        t0_wall, t_dec = time.time(), time.perf_counter()
        hits = 0
        for j in group:
            if not j.ohlcv2 and not j.panel_digest2:
                log.error("pairs job %s has no second leg (ohlcv2); "
                          "completing with empty metrics", j.id)
                bad.append(j)
                continue
            y, hit_y = self._resolve_series(j)
            x, hit_x = self._resolve_series(j, leg2=True)
            if y.n_bars != x.n_bars:
                log.error("pairs job %s legs differ in length (%d vs %d); "
                          "completing with empty metrics", j.id, y.n_bars,
                          x.n_bars)
                bad.append(j)
                continue
            if wf and y.n_bars < j.wf_train + j.wf_test:
                log.error(
                    "pairs walk-forward job %s needs >= %d bars (train %d + "
                    "test %d), has %d; completing with empty metrics", j.id,
                    j.wf_train + j.wf_test, j.wf_train, j.wf_test, y.n_bars)
                bad.append(j)
                continue
            hits += hit_y and hit_x
            good.append((j, y, x))
        self._observe_decode(group, t0_wall, t_dec, hits,
                             bool(good) and hits == len(good), len(group))
        if not good:
            return _empty(bad, t0)
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
        if wf:
            kw.update(train=job0.wf_train, test=job0.wf_test, metric=metric)
            if uniform and self.mesh is not None:
                m = self._mesh_call(
                    lambda blks, _tr, dev: walkforward.walk_forward_pairs(
                        blks[0], blks[1], grid,
                        **dict(kw, device=dev)).oos_metrics,
                    [y_close, x_close])
            elif uniform:
                m = walkforward.walk_forward_pairs(y_close, x_close, grid,
                                                   **kw).oos_metrics
            else:
                rows = [walkforward.walk_forward_pairs(
                    y_close[i:i + 1, :n], x_close[i:i + 1, :n], grid,
                    **kw).oos_metrics for i, n in enumerate(lens)]
                m = Metrics(*(torch.cat(f) for f in zip(*rows)))
            m = Metrics(*(f[:, None] for f in m))    # one OOS row per job
            return self._finish_group(jobs + bad, m, t0, len(jobs), job0)
        if uniform and self._long_context(jobs, [t_max]):
            lb = grid.get("lookback")
            ts_reason = ("no 'lookback' axis in grid" if lb is None
                         else _timeshard_window_reason(
                             lb.numpy(), sweep_mod.grid_size(grid), t_max,
                             self.mesh.size, what="lookback"))
            if ts_reason is None:
                log.info("jobs %s (pairs) routed to the time-sharded "
                         "long-context path (%d bars over %d shards)",
                         [j.id for j in jobs], t_max, self.mesh.size)
                return self._submit_pairs_timeshard(
                    jobs, bad, y_close, x_close, t0, grid, kw)
            log.warning("jobs %s (pairs) are long-context (%d bars) but not "
                        "time-shardable (%s); they take the other routes",
                        [j.id for j in jobs], t_max, ts_reason)
        demotion = (_pairs_demotion_reason(axes) if self.use_fused
                    else "use_fused=False")
        if demotion is None:
            self._observe_substrates(_PAIRS)
            g = {k: v.numpy() for k, v in grid.items()}

            def run(blks, tr, dev):
                return fused.fused_pairs_sweep(
                    blks[0], blks[1], g["lookback"], g["z_entry"],
                    z_exit=g.get("z_exit", 0.0), t_real=tr,
                    **dict(kw, device=dev))

            tr = None if uniform else lens

            def make_run():
                legs = self._resident([y_close, x_close])
                if self.mesh is None:
                    return lambda: run(legs, tr, self.device)
                return lambda: self._mesh_call(run, legs, tr)

            with fused.tuned_schedule(self._tuned_schedule_for(
                    _PAIRS, lens, g, make_run)):
                m = (run([y_close, x_close], tr, self.device)
                     if self.mesh is None
                     else self._mesh_call(run, [y_close, x_close], tr))
        else:
            if self.use_fused:
                log.warning("jobs %s (pairs) take the generic path: %s",
                            [j.id for j in jobs], demotion)
            if uniform and self.mesh is not None:
                m = self._mesh_call(
                    lambda blks, _tr, dev: pairs_mod.run_pairs_sweep(
                        blks[0], blks[1], grid, **dict(kw, device=dev)),
                    [y_close, x_close])
            elif uniform:
                m = pairs_mod.run_pairs_sweep(y_close, x_close, grid, **kw)
            else:
                rows = [pairs_mod.run_pairs_sweep(
                    y_close[i:i + 1, :n], x_close[i:i + 1, :n], grid, **kw)
                    for i, n in enumerate(lens)]
                m = Metrics(*(torch.cat(f, dim=0) for f in zip(*rows)))
        return self._finish_group(jobs + bad, m, t0, len(jobs), job0)

    def _submit_pairs_timeshard(self, jobs, bad, y_close, x_close, t0, grid,
                                kw) -> _Pending:
        """A uniform long-context pairs group with both legs' bars split
        over the mesh (the reference's ``_submit_pairs_timeshard``): one
        :func:`~..parallel.timeshard.sharded_pairs_backtest` a combo, the
        legs right-padded with repeat-last bars to a mesh multiple and
        their real length passed."""
        job0 = jobs[0]
        tmesh = sharding.Mesh(self.mesh.devices, timeshard.TIME_AXIS)
        t = y_close.shape[1]
        T_pad = -(-t // tmesh.size) * tmesh.size
        y, x = (device_mod.upload(np.concatenate(
            [a, np.repeat(a[:, -1:], T_pad - t, axis=1)], axis=1),
            tmesh.devices[0]) for a in (y_close, x_close))
        g = {k: v.numpy() for k, v in grid.items()}
        zx = g.get("z_exit", np.zeros_like(g["z_entry"]))
        ms = [timeshard.sharded_pairs_backtest(
            tmesh, y, x, int(round(float(lb))), float(ze), z_exit=float(z),
            cost=kw["cost"], periods_per_year=kw["periods_per_year"],
            t_real=None if t == T_pad else t)
            for lb, ze, z in zip(g["lookback"], g["z_entry"], zx)]
        m = Metrics(*(torch.stack(cols, dim=-1) for cols in zip(*ms)))
        return self._finish_group(jobs + bad, m, t0, len(jobs), job0)


class InstantBackend:
    """Completes every job at once with an empty metric block (the
    reference's ``InstantBackend``): the control plane alone, for the
    bench's ``e2e_local`` key and the dispatcher tests."""

    chips = 1

    def __init__(self):
        self.seen: list[str] = []

    def process(self, jobs) -> list[Completion]:
        empty = wire.metrics_to_bytes(
            Metrics(*(np.zeros(1, np.float32) for _ in Metrics._fields)))
        out = []
        for job in jobs:
            self.seen.append(job.id)
            out.append(Completion(job.id, empty, 0.0,
                                  trace_id=job.trace_id))
        return out


class SleepBackend:
    """A fixed delay a job and an empty block (the reference's
    ``SleepBackend``): the control plane with a compute side that takes
    time, for liveness tests."""

    chips = 1

    def __init__(self, delay_s: float = 0.05):
        self.delay_s = delay_s

    def process(self, jobs) -> list[Completion]:
        out = []
        for job in jobs:
            time.sleep(self.delay_s)
            out.append(Completion(job.id, b"", self.delay_s,
                                  trace_id=job.trace_id))
        return out
