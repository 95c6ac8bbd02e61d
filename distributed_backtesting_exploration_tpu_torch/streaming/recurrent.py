"""Scan-form checkpoints and recurrent-form append steps per strategy
family (the reference's ``streaming/recurrent.py``).

One :class:`StreamCarry` holds what it takes to advance a finished T-bar
sweep by a ΔT-bar slice without touching the first T bars again:

- **metric accumulators** (``metric``): the shared tail of every fused
  kernel, the net-return moment sums (s1, s2, downside), win and active
  counts, turnover, and the equity state (cumulative net, running peak,
  max drawdown), advanced by ``ops.fused._equity_advance`` over the last
  axis. Counts and turnover are f32 sums of small integers, so a
  (sweep at T + append of ΔT) merge is bit-exact for them; the moment sums
  differ from a cold (T+ΔT) sweep by one f32 association boundary, the
  equity path by the block boundaries.
- **signal state** (``state`` and ``metric["pos_last"]``): the band and
  latch machines' position is Markov in itself, so the last position is
  their whole state; the EMA families also carry their filter values at
  the last bar.
- **raw input tail** (``tail``): the last ``tail_bars`` bars of every
  column the family reads, enough that every windowed indicator on an
  appended bar is recomputed from real data with the generic models' own
  ops. While the tail still covers the whole history the append replays
  the models and the appended positions are the cold sweep's; once it is
  partial, windowed indicators are recomputed over the tail window, the
  same values but for f32 association (the knife-edge flip class every
  comparison here budgets).

:func:`build_carry` (scan form) and :func:`append_step` (recurrent form)
share one metric advance, :func:`_advance_metrics`: the build is one
advance over the whole panel from the zero state.

Where the reference vmaps a lane's function over tickers and params, the
port lays the work out as ``(N, P, T)`` tensors in chunks of the param
axis (``parallel.sweep.param_chunks``); lanes are independent along P, so
on the CPU the chunking changes no bit. The grid is kept on the host as
flat ``(P,)`` f32 numpy arrays (it keys the carry, :func:`stream_key`);
every array of ``tail``, ``state`` and ``metric`` is an f32 tensor on the
carry's device. Nothing here writes into a tensor it was given: an
append returns a new carry and leaves its base as it was, so a retried
job can advance the stored base again.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import io
import json
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from .. import models  # noqa: F401  (registers the strategies)
from ..models import base as models_base
from ..models import donchian as donchian_mod
from ..models import keltner as keltner_mod
from ..models import pairs as pairs_mod
from ..models import stochastic as stoch_mod
from ..models import vwap as vwap_mod
from ..ops import fused as fused_ops
from ..ops import pnl as pnl_mod
from ..ops import rolling
from ..ops.metrics import Metrics
from ..parallel import sweep as sweep_mod
from ..utils import data as data_mod

_EPS = 1e-12
# Elements of one (N, P_chunk, T) tensor of the scan form and of an append:
# 2**27 f32 = 512 MiB, 8x the generic sweep's chunk, so that the band and
# latch machines' bar loops run over few chunks; about ten such tensors
# are live at once.
_CHUNK_ELEMS = 1 << 27
# State entries shared by every lane (not an (N, P) plane): macd's anchor.
_SHARED_STATE = frozenset({"c0"})


# ---------------------------------------------------------------------------
# Carry container + codec
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StreamCarry:
    """Persistable checkpoint of a (panel, strategy, param-block) sweep
    after ``n_bars`` bars. ``tail``, ``state`` and ``metric`` hold f32
    tensors on one device; ``grid`` the flat per-combo axes on the host.
    :func:`carry_to_bytes` round-trips it losslessly."""

    strategy: str
    grid: dict                      # flat per-combo (P,) f32 numpy axes
    cost: float
    ppy: int
    n_bars: int
    tail: dict                      # field -> (N, K) raw input tail
    state: dict                     # family signal state (EMA values, ...)
    metric: dict                    # shared metric accumulators, (N, P)

    @property
    def device(self) -> torch.device:
        return self.metric["s1"].device

    @property
    def nbytes(self) -> int:
        return int(sum(_nbytes(a) for d in (self.grid, self.tail,
                                            self.state, self.metric)
                       for a in d.values()))


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


def _np32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def stream_key(strategy: str, grid, cost: float, ppy: int) -> str:
    """Content key of the carry's parameter block, the digest that with the
    panel digest addresses a checkpoint: the reference's, byte for byte
    (canonical over axis order, f32 array bytes)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(strategy.encode())
    for name in sorted(grid):
        h.update(name.encode())
        h.update(np.ascontiguousarray(_np32(grid[name])).tobytes())
    h.update(np.float32(cost).tobytes())
    h.update(str(int(ppy)).encode())
    return h.hexdigest()


def carry_to_bytes(carry: StreamCarry) -> bytes:
    """Serialize a checkpoint: npz of the arrays under ``g/``, ``t/``,
    ``s/`` and ``m/`` plus a JSON ``meta``, the reference's layout, so
    either package loads the other's bytes. Lossless."""
    arrays = {}
    for ns, d in (("g", carry.grid), ("t", carry.tail),
                  ("s", carry.state), ("m", carry.metric)):
        for k, v in d.items():
            arrays[f"{ns}/{k}"] = _np32(v)
    meta = json.dumps({"strategy": carry.strategy, "cost": carry.cost,
                       "ppy": carry.ppy, "n_bars": carry.n_bars})
    buf = io.BytesIO()
    np.savez(buf, **{"meta": np.asarray(meta)}, **arrays)
    return buf.getvalue()


def carry_from_bytes(data: bytes, device: str | torch.device =
                     device_mod.DEFAULT_DEVICE) -> StreamCarry:
    """A checkpoint from :func:`carry_to_bytes`'s bytes (or the
    reference's), its tensors on ``device``."""
    dev = device_mod.resolve(device)
    with np.load(io.BytesIO(data)) as z:
        meta = json.loads(str(z["meta"]))
        out = {"g": {}, "t": {}, "s": {}, "m": {}}
        for key in z.files:
            if key == "meta":
                continue
            ns, _, name = key.partition("/")
            a = np.array(z[key], np.float32)
            out[ns][name] = a if ns == "g" else torch.from_numpy(a).to(dev)
    return StreamCarry(strategy=meta["strategy"], grid=out["g"],
                       cost=float(meta["cost"]), ppy=int(meta["ppy"]),
                       n_bars=int(meta["n_bars"]), tail=out["t"],
                       state=out["s"], metric=out["m"])


# ---------------------------------------------------------------------------
# Shared metric accumulators (the recurrent form of the kernels' tail)
# ---------------------------------------------------------------------------

def _metric_init(n: int, p: int, dev: torch.device) -> dict:
    def z():
        return torch.zeros((n, p), dtype=torch.float32, device=dev)
    return {"s1": z(), "s2": z(), "dsum": z(), "wins": z(), "active": z(),
            "turnover": z(), "pos_last": z(), "cum": z(),
            "peak": torch.full((n, p), -math.inf, dtype=torch.float32,
                               device=dev),
            "mdd": z()}


def _advance_metrics(metric: dict, pos: torch.Tensor, ret: torch.Tensor, *,
                     cost: float, block: int) -> dict:
    """Fold an ``(N, P, D)`` position slice and its ``(N, 1|P, D)``
    returns into the accumulators (new tensors; ``metric`` is not written).
    The scan form calls it once with D = T from the zero state, the
    recurrent form with D = ΔT from the stored state."""
    pos = pos.to(torch.float32)
    ret = ret.to(torch.float32)
    prev = torch.cat([metric["pos_last"][..., None], pos[..., :-1]], dim=-1)
    dpos = (pos - prev).abs()
    net = prev * ret - torch.tensor(cost, dtype=torch.float32,
                                    device=pos.device) * dpos
    down = torch.minimum(net, torch.zeros((), dtype=net.dtype,
                                          device=net.device))
    active = prev.abs() > 0
    wins = (net > 0) & active
    cum, peak, mdd = fused_ops._equity_advance(
        net, block, metric["cum"], metric["peak"], metric["mdd"])
    return {
        "s1": metric["s1"] + net.sum(dim=-1),
        "s2": metric["s2"] + (net * net).sum(dim=-1),
        "dsum": metric["dsum"] + (down * down).sum(dim=-1),
        "wins": metric["wins"] + wins.to(torch.float32).sum(dim=-1),
        "active": metric["active"] + active.to(torch.float32).sum(dim=-1),
        "turnover": metric["turnover"] + dpos.sum(dim=-1),
        "pos_last": pos[..., -1],
        "cum": cum, "peak": peak, "mdd": mdd,
    }


def _finalize(metric: dict, n_bars: int, ppy: int) -> Metrics:
    """Accumulators -> the 9 metrics, in the reference's ``_metrics_pack``
    op order (every division an IEEE division)."""
    dev = metric["s1"].device
    one = torch.ones((), dtype=torch.float32, device=dev)
    n = torch.tensor(float(n_bars), dtype=torch.float32, device=dev)
    ppy_t = torch.tensor(float(ppy), dtype=torch.float32, device=dev)
    mean = metric["s1"] / n
    var = (metric["s2"] / n - mean * mean).clamp_min(0.0)
    std = torch.sqrt(var)
    ann = torch.sqrt(ppy_t)
    dstd = torch.sqrt(metric["dsum"] / n)
    hit = metric["wins"] / (metric["active"] + _EPS)
    years = (n / ppy_t).clamp_min(_EPS)
    eq_final = 1.0 + metric["cum"]
    final = eq_final.clamp_min(_EPS)
    return Metrics(
        sharpe=mean / (std + _EPS) * ann,
        sortino=mean / (dstd + _EPS) * ann,
        max_drawdown=metric["mdd"].clone(),
        total_return=eq_final - 1.0,
        cagr=torch.pow(final, torch.div(one, years)) - 1.0,
        volatility=std * ann,
        hit_rate=hit,
        n_trades=0.5 * metric["turnover"],
        turnover=metric["turnover"].clone(),
    )


def finalize(carry: StreamCarry) -> Metrics:
    """The checkpoint's 9 metrics over its whole history, ``(N, P)`` fresh
    tensors (none aliases the carry)."""
    return _finalize(carry.metric, carry.n_bars, carry.ppy)


# ---------------------------------------------------------------------------
# Family registry: tail sizing + partial-tail signal heads
# ---------------------------------------------------------------------------

def _mw(grid, *names) -> int:
    return int(max(int(round(float(np.max(_np32(grid[n]))))) for n in names))


class _StreamSpec(NamedTuple):
    """One streaming family: consumed columns, tail sizing, and the
    partial-tail head (None: replay the generic model over the tail
    window, valid for memoryless families whose indicators are shift- and
    scale-invariant over the window)."""

    fields: tuple
    tail_bars: Callable             # grid -> int
    head: Callable | None = None    # (win, D, sub, state, pos0) ->
                                    #   (pos_delta, ret_delta|None, state')


def _per_series(x, like: torch.Tensor) -> torch.Tensor:
    """A band or decay that broadcasts against ``like`` (``(..., D)``),
    as its ``like.shape[:-1]`` value per series."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.broadcast_to(x, like.shape)[..., 0]


def _band_advance(z, z_entry, z_exit, pos0):
    """Recurrent form of ``ops.signals.band_hysteresis``: advance the
    3-state machine over an ``(N, P, D)`` z slice from the carried
    position. Selection only, so given the same z the path is the cold
    machine's bit for bit."""
    ze, zx = _per_series(z_entry, z), _per_series(z_exit, z)
    one = torch.ones((), dtype=z.dtype, device=z.device)
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    pos = pos0
    out = torch.empty_like(z)
    for t in range(z.shape[-1]):
        zt = z[..., t]
        entered = torch.where(zt < -ze, one, torch.where(zt > ze, -one, zero))
        exit_long = (pos > 0) & (zt >= -zx)
        exit_short = (pos < 0) & (zt <= zx)
        held = torch.where(exit_long | exit_short, zero, pos)
        pos = torch.where(pos == 0, entered, held)
        out[..., t] = pos
    return out


def _latch_advance(up, down, pos0):
    """Recurrent form of ``models.donchian._latch`` (valid region only)."""
    one = torch.ones((), dtype=pos0.dtype, device=pos0.device)
    pos = pos0
    out = torch.empty(up.shape, dtype=pos0.dtype, device=pos0.device)
    for t in range(up.shape[-1]):
        pos = torch.where(up[..., t], one,
                          torch.where(down[..., t], -one, pos))
        out[..., t] = pos
    return out


def _ohlcv_rows(rows: dict):
    close = rows["close"]
    return data_mod.OHLCV(
        open=rows.get("open", close), high=rows.get("high", close),
        low=rows.get("low", close), close=close,
        volume=rows.get("volume", torch.ones_like(close)))


def _pairs_hedged_returns(y, x, beta):
    """``models.pairs.pair_net_returns``'s hedged-return op order."""
    ry = pnl_mod.simple_returns(y)
    rx = pnl_mod.simple_returns(x)
    prev_beta = torch.cat([torch.zeros_like(beta[..., :1]),
                           beta[..., :-1]], dim=-1)
    gross = 1.0 + prev_beta.abs()
    return (ry - prev_beta * rx) / gross.clamp_min(1.0)


def _positions_full(strategy: str, f3: dict, sub: dict):
    """Positions over a full-history window by the generic models,
    ``(N, P_chunk, T)`` from ``(N, 1, T)`` fields and ``(P_chunk, 1)``
    params, and their returns (the pairs' hedged returns; the single-asset
    close's simple returns). The semantics-defining path: whatever it
    computes is what the cold sweep means."""
    if strategy == "pairs":
        pos, beta = pairs_mod.pairs_positions(f3["close"], f3["close2"], sub)
        return pos, _pairs_hedged_returns(f3["close"], f3["close2"], beta)
    strat = models_base.get_strategy(strategy)
    pos = strat.positions(_ohlcv_rows(f3), sub)
    return pos, pnl_mod.simple_returns(f3["close"])


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as one IEEE division (``num / tensor`` in torch
    rounds twice: a reciprocal, then a multiply)."""
    return torch.div(torch.as_tensor(num, dtype=den.dtype,
                                     device=den.device), den)


def _extract_state(strategy: str, f3: dict, sub: dict) -> dict:
    """Exact signal state at the window's last bar, from the models' own
    filters (the EMA families; the rest carry nothing beyond the tail and
    the last position)."""
    close = f3["close"]
    if strategy == "rsi":
        diff = torch.diff(close, dim=-1, prepend=close[..., :1])
        alpha = _div(1.0, sub["period"])
        ag = rolling.ema(diff.clamp_min(0.0), alpha=alpha)[..., -1]
        al = rolling.ema((-diff).clamp_min(0.0), alpha=alpha)[..., -1]
        return {"ag": ag, "al": al}
    if strategy == "macd":
        x = close - close[..., :1]
        ef = rolling.ema_ladder(x, span=sub["fast"])
        es = rolling.ema_ladder(x, span=sub["slow"])
        esig = rolling.ema_ladder(ef - es, span=sub["signal"])
        return {"ef": ef[..., -1], "es": es[..., -1], "esig": esig[..., -1],
                "c0": close[:, 0, :1].clone()}
    if strategy == "trix":
        span = sub["span"]
        e1 = rolling.ema_ladder(close, span=span)
        e2 = rolling.ema_ladder(e1, span=span)
        e3 = rolling.ema_ladder(e2, span=span)
        prev = torch.cat([e3[..., :1], e3[..., :-1]], dim=-1)
        esig = rolling.ema_ladder(e3 / prev - 1.0, span=sub["signal"])
        return {"e1": e1[..., -1], "e2": e2[..., -1], "e3": e3[..., -1],
                "esig": esig[..., -1]}
    if strategy == "keltner":
        return {"mid": rolling.ema(close, span=sub["window"])[..., -1]}
    return {}


# -- partial-tail heads ------------------------------------------------------
# Every head runs with n_bars > tail_bars(grid) >= the longest warmup, so
# every delta bar is past warmup for every lane: no validity masks needed.
# ``win`` holds (N, 1, K + D) rows, ``sub`` (P_chunk, 1) param columns,
# ``state`` and ``pos0`` (N, P_chunk) planes.

def _bars(row: torch.Tensor, K: int):
    """The delta bars of an ``(N, 1, K + D)`` row, each ``(N, 1)``."""
    return [row[:, 0, t:t + 1] for t in range(K, row.shape[-1])]


def _head_bollinger(win, D, sub, state, pos0):
    K = win["close"].shape[-1] - D
    z = rolling.rolling_zscore(win["close"], sub["window"], fill=0.0)
    return _band_advance(z[..., K:], sub["k"], 0.0, pos0), None, state


def _head_stochastic(win, D, sub, state, pos0):
    K = win["close"].shape[-1] - D
    # The tail holds every window (``tail_bars``), so its length bounds
    # them without reading the windows off the device.
    z = stoch_mod.stochastic_k(win["high"], win["low"], win["close"],
                               sub["window"], bound=K)[..., K:] - 50.0
    return _band_advance(z, sub["band"], 0.0, pos0), None, state


def _head_vwap(win, D, sub, state, pos0):
    close = win["close"]
    K = close.shape[-1] - D
    dev = close - vwap_mod.rolling_vwap(close, win["volume"], sub["window"])
    z = rolling.rolling_zscore(dev, sub["window"], fill=0.0)[..., K:]
    return _band_advance(z, sub["k"], 0.0, pos0), None, state


def _head_keltner(win, D, sub, state, pos0):
    close = win["close"]
    K = close.shape[-1] - D
    a = _div(2.0, sub["window"] + 1.0)[:, 0]                 # (P,)
    mid, mids = state["mid"], []
    for c_t in _bars(close, K):                              # c_t (N, 1)
        mid = (1.0 - a) * mid + a * c_t
        mids.append(mid)
    mids = torch.stack(mids, dim=-1)                         # (N, P, D)
    atr = rolling.rolling_mean(
        keltner_mod.true_range(win["high"], win["low"], close),
        sub["window"], fill=math.nan)[..., K:]
    dev = close[..., K:] - mids
    z = torch.where(atr > _EPS, dev / (atr + _EPS),
                    torch.zeros((), dtype=dev.dtype, device=dev.device))
    return _band_advance(z, sub["k"], 0.0, pos0), None, {"mid": mid}


def _head_rsi(win, D, sub, state, pos0):
    close = win["close"]
    K = close.shape[-1] - D
    a = _div(1.0, sub["period"])[:, 0]                       # (P,)
    hundred = torch.full((), 100.0, dtype=close.dtype, device=close.device)
    ag, al, pc = state["ag"], state["al"], close[:, 0, K - 1:K]
    zs = []
    for c_t in _bars(close, K):
        diff = c_t - pc
        ag = (1.0 - a) * ag + a * diff.clamp_min(0.0)
        al = (1.0 - a) * al + a * (-diff).clamp_min(0.0)
        rsi = 100.0 - torch.div(hundred, 1.0 + ag / (al + _EPS))
        zs.append(rsi - 50.0)
        pc = c_t
    z = torch.stack(zs, dim=-1)
    return (_band_advance(z, sub["band"], 0.0, pos0), None,
            {"ag": ag, "al": al})


def _head_macd(win, D, sub, state, pos0):
    close = win["close"]
    K = close.shape[-1] - D
    af = _div(2.0, sub["fast"] + 1.0)[:, 0]
    as_ = _div(2.0, sub["slow"] + 1.0)[:, 0]
    ag = _div(2.0, sub["signal"] + 1.0)[:, 0]
    c0 = state["c0"]
    ef, es, esig = state["ef"], state["es"], state["esig"]
    pos = []
    for c_t in _bars(close, K):
        x = c_t - c0
        ef = (1.0 - af) * ef + af * x
        es = (1.0 - as_) * es + as_ * x
        macd = ef - es
        esig = (1.0 - ag) * esig + ag * macd
        pos.append(torch.sign(macd - esig))
    return (torch.stack(pos, dim=-1), None,
            {"ef": ef, "es": es, "esig": esig, "c0": c0})


def _head_trix(win, D, sub, state, pos0):
    close = win["close"]
    K = close.shape[-1] - D
    a = _div(2.0, sub["span"] + 1.0)[:, 0]
    ag = _div(2.0, sub["signal"] + 1.0)[:, 0]
    e1, e2, e3, esig = state["e1"], state["e2"], state["e3"], state["esig"]
    pos = []
    for c_t in _bars(close, K):
        e1 = (1.0 - a) * e1 + a * c_t
        e2 = (1.0 - a) * e2 + a * e1
        e3n = (1.0 - a) * e3 + a * e2
        trix = e3n / e3 - 1.0
        esig = (1.0 - ag) * esig + ag * trix
        e3 = e3n
        pos.append(torch.sign(trix - esig))
    return (torch.stack(pos, dim=-1), None,
            {"e1": e1, "e2": e2, "e3": e3, "esig": esig})


def _donchian_head(hi_src: str, lo_src: str):
    def head(win, D, sub, state, pos0):
        close = win["close"]
        K = close.shape[-1] - D
        w = sub["window"]
        hi = rolling.rolling_max(win[hi_src], w,
                                 max_window=donchian_mod.MAX_WINDOW,
                                 fill=math.inf, bound=K)
        lo = rolling.rolling_min(win[lo_src], w,
                                 max_window=donchian_mod.MAX_WINDOW,
                                 fill=-math.inf, bound=K)
        hi_prev = torch.cat([torch.full_like(hi[..., :1], math.inf),
                             hi[..., :-1]], dim=-1)
        lo_prev = torch.cat([torch.full_like(lo[..., :1], -math.inf),
                             lo[..., :-1]], dim=-1)
        up = (close >= hi_prev)[..., K:]
        down = (close <= lo_prev)[..., K:]
        return _latch_advance(up, down, pos0), None, state
    return head


def _head_pairs(win, D, sub, state, pos0):
    y, x = win["close"], win["close2"]
    K = y.shape[-1] - D
    beta, z, _ = pairs_mod.pair_signals(y, x, sub["lookback"])
    pos = _band_advance(z[..., K:], sub["z_entry"], sub.get("z_exit", 0.0),
                        pos0)
    return pos, _pairs_hedged_returns(y, x, beta)[..., K:], state


_STREAM_FAMILIES = {
    "sma_crossover": _StreamSpec(
        ("close",), lambda g: _mw(g, "fast", "slow") + 2),
    "momentum": _StreamSpec(("close",), lambda g: _mw(g, "lookback") + 2),
    "bollinger_touch": _StreamSpec(("close",),
                                   lambda g: _mw(g, "window") + 2),
    "obv_trend": _StreamSpec(("close", "volume"),
                             lambda g: _mw(g, "window") + 2),
    "bollinger": _StreamSpec(("close",), lambda g: _mw(g, "window") + 2,
                             _head_bollinger),
    "stochastic": _StreamSpec(("close", "high", "low"),
                              lambda g: _mw(g, "window") + 2,
                              _head_stochastic),
    "vwap_reversion": _StreamSpec(("close", "volume"),
                                  lambda g: 2 * _mw(g, "window") + 2,
                                  _head_vwap),
    "keltner": _StreamSpec(("close", "high", "low"),
                           lambda g: _mw(g, "window") + 2, _head_keltner),
    "rsi": _StreamSpec(("close",), lambda g: _mw(g, "period") + 2,
                       _head_rsi),
    "macd": _StreamSpec(
        ("close",), lambda g: _mw(g, "slow") + _mw(g, "signal") + 2,
        _head_macd),
    "trix": _StreamSpec(
        ("close",), lambda g: 3 * _mw(g, "span") + _mw(g, "signal") + 2,
        _head_trix),
    "donchian": _StreamSpec(("close",), lambda g: _mw(g, "window") + 3,
                            _donchian_head("close", "close")),
    "donchian_hl": _StreamSpec(("close", "high", "low"),
                               lambda g: _mw(g, "window") + 3,
                               _donchian_head("high", "low")),
    "pairs": _StreamSpec(("close", "close2"),
                         lambda g: 2 * _mw(g, "lookback") + 2, _head_pairs),
}


def supports_strategy(strategy: str) -> bool:
    return strategy in _STREAM_FAMILIES


def stream_fields(strategy: str) -> tuple:
    """OHLCV columns the family's signal head consumes (``close2`` = the
    pairs x leg)."""
    return _STREAM_FAMILIES[strategy].fields


def tail_bars(strategy: str, grid) -> int:
    """Raw-input bars the carry keeps: every windowed indicator (and its
    warmup chain) on an appended bar is recomputable from this many
    trailing bars."""
    return _STREAM_FAMILIES[strategy].tail_bars(grid)


# ---------------------------------------------------------------------------
# Scan form (build) + recurrent form (append)
# ---------------------------------------------------------------------------

# The reference's bound on the blocks of the host-side equity advance
# (each block is its own chain of ops): looser blocks move only f32
# association.
_HOST_MAX_BLOCKS = 32


def _block(n: int, epilogue: str | None) -> int:
    """The equity advance's block over ``n`` bars (the reference's
    ``recurrent._block``): the kernels' scan block, doubled until at most
    ``_HOST_MAX_BLOCKS`` blocks; ``"ladder"`` is one block."""
    n = max(n, 1)
    epi = fused_ops._resolve_epilogue(epilogue)
    if epi == "ladder":
        return n
    b = fused_ops._scan_block(n, epi)
    while -(-n // b) > _HOST_MAX_BLOCKS:
        b *= 2
    return b


def _fields_on(fields: dict, names: tuple, dev: torch.device) -> dict:
    return {f: device_mod.as_tensor(fields[f], torch.float32, dev)
            for f in names if f in fields}


def _chunks(grid: dict, row_elems: int, dev: torch.device):
    """``(lo, hi, sub)`` of the param chunks: ``sub`` the chunk's
    ``(P_chunk, 1)`` param columns on ``dev``."""
    for lo, sub in sweep_mod.param_chunks(grid, row_elems, dev,
                                          _CHUNK_ELEMS):
        yield lo, lo + next(iter(sub.values())).shape[0], sub


def _lane_slice(d: dict, lo: int, hi: int) -> dict:
    return {k: v if k in _SHARED_STATE else v[..., lo:hi]
            for k, v in d.items()}


def _join(parts: list) -> dict:
    """Chunks' dicts joined along the param axis into new tensors (the
    shared entries copied from the first chunk)."""
    return {k: parts[0][k].clone() if k in _SHARED_STATE
            else torch.cat([p[k] for p in parts], dim=-1)
            for k in parts[0]}


def build_carry(strategy: str, fields: dict, grid, *, cost: float = 0.0,
                periods_per_year: int = 252, epilogue: str | None = None,
                device: str | torch.device = device_mod.DEFAULT_DEVICE,
                ) -> StreamCarry:
    """Scan form: run the full ``(N, T)`` panel once and return its
    checkpoint. ``fields`` maps the consumed columns (``close`` [+
    ``high``/``low``/``volume``; ``close2`` for pairs]) to ``(N, T)``
    arrays or tensors; ``grid`` the flat per-combo axes (product order).
    Runs on ``device`` (``"cuda"`` unless the caller asks for the CPU)."""
    if strategy not in _STREAM_FAMILIES:
        raise ValueError(f"strategy {strategy!r} has no streaming family; "
                         f"known: {sorted(_STREAM_FAMILIES)}")
    spec = _STREAM_FAMILIES[strategy]
    missing = [f for f in spec.fields if f not in fields]
    if missing:
        raise ValueError(f"streaming {strategy} needs fields {missing}")
    dev = device_mod.resolve(device)
    fields = _fields_on(fields, spec.fields, dev)
    grid_np = {k: _np32(v).reshape(-1) for k, v in grid.items()}
    N, T = fields["close"].shape
    K = min(T, tail_bars(strategy, grid_np))    # raises on an empty axis
    block = _block(T, epilogue)
    f3 = {f: v[:, None, :] for f, v in fields.items()}
    metrics, states = [], []
    for _, _, sub in _chunks(grid_np, N * T, dev):
        pos, ret = _positions_full(strategy, f3, sub)
        metrics.append(_advance_metrics(
            _metric_init(N, pos.shape[1], dev), pos, ret, cost=float(cost),
            block=block))
        states.append(_extract_state(strategy, f3, sub))
        del pos, ret
    return StreamCarry(strategy=strategy, grid=grid_np, cost=float(cost),
                       ppy=int(periods_per_year), n_bars=int(T),
                       tail={f: v[..., -K:].clone() for f, v in
                             fields.items()},
                       state=_join(states), metric=_join(metrics))


def append_step(carry: StreamCarry, delta_fields: dict, *,
                epilogue: str | None = None) -> StreamCarry:
    """Recurrent form: advance a checkpoint by an ``(N, D)`` bar slice in
    O(D) work, on the carry's device. Returns a new carry; the base is not
    written, so a retried job can advance the stored base again."""
    spec = _STREAM_FAMILIES[carry.strategy]
    dev = carry.device
    delta = _fields_on(delta_fields, spec.fields, dev)
    missing = [f for f in spec.fields if f not in delta]
    if missing:
        raise ValueError(
            f"append for {carry.strategy} needs delta fields {missing}")
    D = int(delta["close"].shape[-1])
    if D < 1:
        raise ValueError("empty delta slice")
    K = int(carry.tail["close"].shape[-1])
    full_cover = carry.n_bars == K      # the tail still holds all history
    n_new = carry.n_bars + D
    K_new = min(n_new, tail_bars(carry.strategy, carry.grid))
    win = {f: torch.cat([carry.tail[f], delta[f]], dim=-1) for f in delta}
    w3 = {f: v[:, None, :] for f, v in win.items()}
    N, W = win["close"].shape
    block = _block(D, epilogue)
    metrics, states = [], []
    for lo, hi, sub in _chunks(carry.grid, N * W, dev):
        metric = _lane_slice(carry.metric, lo, hi)
        state = _lane_slice(carry.state, lo, hi)
        if full_cover or spec.head is None:
            pos_w, ret_w = _positions_full(carry.strategy, w3, sub)
            pos_d, ret_d = pos_w[..., K:], ret_w[..., K:]
            if full_cover:
                state = _extract_state(carry.strategy, w3, sub)
        else:
            pos_d, ret_d, state = spec.head(w3, D, sub, state,
                                            metric["pos_last"])
            if ret_d is None:
                ret_d = pnl_mod.simple_returns(w3["close"])[..., K:]
        metrics.append(_advance_metrics(metric, pos_d, ret_d,
                                        cost=carry.cost, block=block))
        states.append(state)
    return StreamCarry(strategy=carry.strategy, grid=carry.grid,
                       cost=carry.cost, ppy=carry.ppy, n_bars=n_new,
                       tail={f: v[..., -K_new:].clone()
                             for f, v in win.items()},
                       state=_join(states),
                       metric=_join(metrics))


# ---------------------------------------------------------------------------
# Analysis probes: kernel-hygiene's append step and dbxcert's labeled cones
# ---------------------------------------------------------------------------

_PROBE_DELTA_BARS = 4


@functools.lru_cache(maxsize=None)
def _probe_inputs(strategy: str, scale: int = 1):
    """Tiny concrete ``(carry, delta, grid, base)`` of ``strategy`` for the
    analysis probes (the reference's): one ticker, the family's tail plus
    6 bars of a seeded random walk, then a 4-bar delta, both times
    ``scale`` (the census's length test doubles them); the carry built on
    the CPU, cached per family."""
    spec = _STREAM_FAMILIES[strategy]
    axes = {"fast": [2.0], "slow": [5.0], "window": [3.0], "k": [1.0],
            "lookback": [3.0], "period": [3.0], "band": [20.0],
            "signal": [2.0], "span": [2.0], "z_entry": [1.0],
            "z_exit": [0.0]}
    strat_axes = {
        "sma_crossover": ("fast", "slow"), "momentum": ("lookback",),
        "bollinger": ("window", "k"), "bollinger_touch": ("window", "k"),
        "obv_trend": ("window",), "stochastic": ("window", "band"),
        "vwap_reversion": ("window", "k"), "keltner": ("window", "k"),
        "rsi": ("period", "band"), "macd": ("fast", "slow", "signal"),
        "trix": ("span", "signal"), "donchian": ("window",),
        "donchian_hl": ("window",), "pairs": ("lookback", "z_entry",
                                              "z_exit"),
    }[strategy]
    grid = {a: np.asarray(axes[a], np.float32) for a in strat_axes}
    rng = np.random.default_rng(7)
    T = scale * (tail_bars(strategy, grid) + 6)
    D = scale * _PROBE_DELTA_BARS

    def series():
        walk = np.cumsum(rng.standard_normal(T + D) * 0.5)
        return (100.0 + walk).astype(np.float32)[None, :]

    close = series()
    fields = {}
    for f in spec.fields:
        fields[f] = {"close": close, "high": close * 1.01,
                     "low": close * 0.99,
                     "volume": np.full_like(close, 1e4),
                     "close2": series() * 0.9}[f]
    base = {f: v[..., :T] for f, v in fields.items()}
    carry = build_carry(strategy, base, grid, device="cpu")
    delta = {f: np.asarray(v[..., T:]) for f, v in fields.items()}
    return carry, delta, grid, base


def _carry_args(carry: StreamCarry) -> list:
    return [{k: _np32(v) for k, v in d.items()}
            for d in (carry.tail, carry.state, carry.metric)]


def _probe_append(carry: StreamCarry, tail, delta, state, metric, *,
                  cost: float, epilogue: str | None) -> StreamCarry:
    """:func:`append_step` of ``carry``'s checkpoint with its arrays
    replaced by the traced ``tail``, ``state`` and ``metric``."""
    base = StreamCarry(strategy=carry.strategy, grid=carry.grid, cost=cost,
                       ppy=carry.ppy, n_bars=carry.n_bars, tail=tail,
                       state=state, metric=metric)
    return append_step(base, delta, epilogue=epilogue)


def hygiene_probe(strategy: str, *, epilogue: str | None = None):
    """``(fn, args)`` for kernel-hygiene: ``fn(*args)`` runs one recurrent
    append step (the partial-tail signal head, the metric advance, the
    finalize) of ``strategy`` over tiny concrete numpy inputs, on the
    device its caller places them on, with the equity advance blocked for
    the ``epilogue`` substrate."""
    carry, delta, _, _ = _probe_inputs(strategy)

    def fn(tail, delta_a, state, metric):
        new = _probe_append(carry, tail, delta_a, state, metric, cost=0.0,
                            epilogue=epilogue)
        m = _finalize(new.metric, new.n_bars, 252)
        return tuple(m) + tuple(
            new.tail[k] for k in sorted(new.tail)) + tuple(
            new.state[k] for k in sorted(new.state)) + tuple(
            new.metric[k] for k in sorted(new.metric))

    tail, state, metric = _carry_args(carry)
    return fn, [tail, dict(delta), state, metric]


# Carry accumulators that are f32 sums or holds of exact small integers by
# the carry contract (positions in {-1, 0, 1}, bool-cast win and active
# counts, |Δpos| turnover increments): dbxcert seeds the append form's
# inputs with this integrality hint.
_INTEGRAL_CARRY_KEYS = frozenset(
    {"wins", "active", "turnover", "pos_last"})


def certify_probe(strategy: str, *, form: str, epilogue: str | None = None,
                  scale: int = 1):
    """``(fn, args, integral_keys)`` for dbxcert (``analysis.certify``).

    ``fn(*args)`` runs one certified cone of ``strategy``: ``form``
    ``"build_carry"`` (the scan form over the full tiny panel from the
    zero state) or ``"append_step"`` (the recurrent form over a ΔT slice
    from the stored carry), on the CPU, returning a dict so that every
    output has a stable label in the contract table: ``metrics/<name>``
    the 9 public metrics, ``metric/<k>`` the accumulators, ``state/<k>``
    the family's signal state, ``tail/<k>`` the raw-input tail. The
    substrate is passed explicitly; ``integral_keys`` names the input keys
    the analyzer may assume integer-valued (the carry contract's hints).
    ``scale`` multiplies the probe's bars."""
    if form not in ("build_carry", "append_step"):
        raise ValueError(f"unknown certify form {form!r}")
    carry, delta, grid, base_fields = _probe_inputs(strategy, scale)

    def _label(m: Metrics, metric: dict, state: dict, extra: dict) -> dict:
        out = {f"metrics/{k}": getattr(m, k) for k in Metrics._fields}
        out.update({f"metric/{k}": v for k, v in metric.items()})
        out.update({f"state/{k}": v for k, v in state.items()})
        out.update(extra)
        return out

    if form == "append_step":
        def fn(tail, delta_a, state, metric):
            new = _probe_append(carry, tail, delta_a, state, metric,
                                cost=0.001, epilogue=epilogue)
            m = _finalize(new.metric, new.n_bars, 252)
            return _label(m, new.metric, new.state,
                          {f"tail/{k}": v for k, v in new.tail.items()})

        tail, state, metric = _carry_args(carry)
        return fn, [tail, dict(delta), state, metric], _INTEGRAL_CARRY_KEYS

    T = int(base_fields["close"].shape[-1])

    def fn(fields):
        c = build_carry(strategy, fields, grid, cost=0.001,
                        epilogue=epilogue, device=fields["close"].device)
        m = _finalize(c.metric, T, 252)
        return _label(m, c.metric, c.state, {})

    return fn, [dict(base_fields)], frozenset()
