"""Fused SMA-crossover sweep: K1 of the port (reference ``ops/fused.py``).

:func:`fused_sma_sweep` computes the 9 metrics of every (ticker, combo)
backtest of an SMA-crossover grid and returns them as :class:`Metrics` of
``(N, P)`` fields, like the reference's ``fused_sma_sweep``. It prepares
the inputs host-side and with plain torch ops (distinct windows, the close
cumsum, the simple returns) and hands them to :func:`fused_sma`:

- on a CUDA tensor, :func:`fused_sma_cuda` launches the hand-written kernel
  ``csrc/fused_sma.cu`` (it raises on anything it cannot launch: there is
  no fallback);
- on a CPU tensor, :func:`fused_sma_plain` computes the same function with
  plain PyTorch ops. It is also the yardstick the kernel is held against on
  the card.

Numerics: the per-lane SMA values use the reference table's exact op
sequence, so on the same cumsum the kernel and the plain version take
identical positions; the metric sums differ only by f32 association.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import device as device_mod
from . import _kernels
from .metrics import Metrics, metrics_from_reductions
from .pnl import simple_returns

_EPS = 1e-12
_N_METRICS = 9
_KERNEL_THREADS = 128      # lanes per CTA (csrc/fused_sma.cu kThreads)
_MAX_PARAM_BLOCKS = 65535  # CUDA gridDim.y limit


def _epilogue_ok(epilogue) -> bool:
    if epilogue in ("ladder", "scan"):
        return True
    if isinstance(epilogue, str) and epilogue.startswith("scan:"):
        try:
            b = int(epilogue[5:])
        except ValueError:
            return False
        return b >= 8 and b % 8 == 0
    return False


def _resolve_epilogue(epilogue: str | None) -> str:
    """The reference's epilogue rule (``_resolve_epilogue``): ``"scan"``,
    ``"scan:<B>"`` with B a positive multiple of 8, or ``"ladder"``; None
    means ``"scan"``. Any other value raises."""
    if epilogue is None:
        return "scan"
    if _epilogue_ok(epilogue):
        return epilogue
    raise ValueError(
        f"epilogue must be 'scan', 'scan:<B>' (B a positive multiple of 8) "
        f"or 'ladder', got {epilogue!r}")


def _resolve_table(table: str | None) -> str:
    """The reference's table rule: ``"inline"`` or ``"hbm"``; None means
    ``"inline"``. Any other value raises."""
    if table is None:
        return "inline"
    if table not in ("inline", "hbm"):
        raise ValueError(f"table must be 'inline' or 'hbm', got {table!r}")
    return table


def _distinct_windows(vals: np.ndarray, what: str) -> np.ndarray:
    """Validate integral bar counts and return the sorted distinct windows."""
    if not np.allclose(vals, np.round(vals)):
        raise ValueError(
            f"fused sweep {what} are bar counts and must be integral; got "
            f"non-integer values "
            f"(e.g. {vals[~np.isclose(vals, np.round(vals))][0]})")
    return np.unique(np.round(vals)).astype(np.float32)


def _grid_setup(fast, slow):
    """Per-lane integer windows and warmup of a flat (fast, slow) grid.

    Mirrors the reference's ``_grid_setup``: windows are validated as
    integral and rounded; the warmup is ``max(fast, slow)`` of the raw
    values, truncated to an integer as the reference's kernel truncates it.
    Returns ``(fast_w, slow_w, warm)``, each an ``(P,)`` int32 array.
    """
    fast = np.asarray(fast, np.float32).reshape(-1)
    slow = np.asarray(slow, np.float32).reshape(-1)
    if fast.shape != slow.shape:
        raise ValueError(
            f"fast and slow must be flat per-combo arrays of one length; got "
            f"{fast.shape} and {slow.shape}")
    windows = _distinct_windows(np.concatenate([fast, slow]), "windows")
    if windows.size and windows[0] < 1:
        raise ValueError(
            f"fused sweep windows must be at least 1 bar; got {windows[0]:g}")
    fast_w = np.round(fast).astype(np.int32)
    slow_w = np.round(slow).astype(np.int32)
    warm = np.maximum(fast, slow).astype(np.int32)
    return fast_w, slow_w, warm


def _check_t_real(t_real, N: int, T: int) -> np.ndarray:
    if t_real is None:
        return np.full((N,), T, np.int32)
    tr = np.asarray(t_real).reshape(-1)
    if tr.shape != (N,):
        raise ValueError(f"t_real must hold one length per ticker ({N}); "
                         f"got shape {np.asarray(t_real).shape}")
    if tr.size and (tr.min() < 1 or tr.max() > T):
        raise ValueError(f"t_real values must lie in [1, {T}]; got "
                         f"[{tr.min()}, {tr.max()}]")
    return tr.astype(np.int32)


def fused_sma_plain(cs, r, t_real, fast, slow, warm, *, cost: float,
                    ppy: int) -> torch.Tensor:
    """Plain PyTorch version of K1: the kernel's algorithm as tensor ops.

    ``cs`` and ``r`` are the ``(N, T)`` close cumsum and simple returns;
    ``t_real`` the ``(N,)`` real lengths; ``fast``/``slow``/``warm`` the
    ``(P,)`` integer windows and warmups. Returns the ``(9, N, P)`` metric
    planes in :class:`Metrics` field order.

    One step per bar over all ``(N, P)`` lanes, carrying the kernel's
    running sums in the kernel's order. A vectorized ``cumsum`` over time
    would associate the equity sum differently, and where a combo's
    additive equity ends near zero, CAGR (``final ** (1 / years)``)
    magnifies that last-bit difference past any f32 tolerance; the same
    order keeps the kernel and this version in step there too.
    """
    N, T = cs.shape
    P = fast.shape[0]
    dev = cs.device
    t = torch.arange(T, device=dev)
    # Distinct-window SMA table with the reference's op sequence:
    # (cs[t] - cs[t-w]) / float(w), cs[t-w] = 0 for t < w, 0 for t < w-1.
    windows, inv = torch.unique(torch.cat([fast, slow]).long(),
                                return_inverse=True)
    fi, si = inv[:P], inv[P:]
    lag_idx = t[None, :] - windows[:, None]                     # (W, T)
    lag = torch.gather(cs[:, None, :].expand(N, windows.shape[0], T), -1,
                       lag_idx.clamp_min(0).expand(N, -1, -1))
    lag = torch.where(lag_idx >= 0, lag, torch.zeros_like(lag))
    table = (cs[:, None, :] - lag) / windows.to(cs.dtype)[:, None]
    table = torch.where(t[None, :] >= windows[:, None] - 1, table,
                        torch.zeros_like(table))
    table = table.permute(2, 0, 1).contiguous()                 # (T, N, W)

    zero = torch.zeros((N, P), dtype=torch.float32, device=dev)
    prev, s1, s2, dsq, cum = zero, zero, zero, zero, zero
    mdd, wins, active, turn = zero, zero, zero, zero
    peak = torch.full((N, P), -math.inf, dtype=torch.float32, device=dev)
    t_on = (warm.long() - 1)[None, :]                           # (1, P)
    tr = t_real.long()[:, None]                                 # (N, 1)
    for step in range(T):
        row = table[step]
        d = row[:, fi] - row[:, si]
        pos = torch.where(step >= t_on, torch.sign(d), zero)
        # Bars at or past a ticker's real length change nothing: zero net,
        # no turnover, the last position held.
        ok = step < tr
        dp = torch.where(ok, (pos - prev).abs(), zero)
        net = torch.where(ok, prev * r[:, step:step + 1] - cost * dp, zero)
        s1 = s1 + net
        s2 = s2 + net * net
        down = net.clamp_max(0.0)
        dsq = dsq + down * down
        cum = cum + net
        eq = 1.0 + cum
        peak = torch.maximum(peak, eq)
        mdd = torch.maximum(mdd, (peak - eq) / peak.clamp_min(_EPS))
        act = (prev != 0) & ok
        active = active + act
        wins = wins + (act & (net > 0))
        turn = turn + dp
        prev = torch.where(ok, pos, prev)
    m = metrics_from_reductions(
        s1=s1, s2=s2, downside_sq_sum=dsq, mdd=mdd, eq_final=1.0 + cum,
        wins_sum=wins, active_sum=active, turnover=turn,
        n=t_real.to(torch.float32)[:, None], periods_per_year=ppy)
    return torch.stack(list(m), 0)


def fused_sma_cuda(cs, r, t_real, fast, slow, warm, *, cost: float,
                   ppy: int) -> torch.Tensor:
    """Launch K1 (``csrc/fused_sma.cu``) on PyTorch's current stream.

    Same inputs and output as :func:`fused_sma_plain`, all on one CUDA
    device. Raises on a wrong device, dtype, shape or layout, and when the
    launch reports an error.
    """
    N, T = cs.shape
    P = fast.shape[0]
    dev = cs.device
    if dev.type != "cuda":
        raise ValueError(f"fused_sma_cuda needs CUDA tensors; got {dev}")
    for name, x, dtype, shape in (
            ("cs", cs, torch.float32, (N, T)),
            ("r", r, torch.float32, (N, T)),
            ("t_real", t_real, torch.int32, (N,)),
            ("fast", fast, torch.int32, (P,)),
            ("slow", slow, torch.int32, (P,)),
            ("warm", warm, torch.int32, (P,))):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, cs on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if -(-P // _KERNEL_THREADS) > _MAX_PARAM_BLOCKS:
        raise ValueError(f"{P} combos exceed the kernel's grid limit of "
                         f"{_MAX_PARAM_BLOCKS * _KERNEL_THREADS}")
    out = torch.empty((_N_METRICS, N, P), dtype=torch.float32, device=dev)
    if N == 0 or P == 0:
        return out
    lib = _kernels.fused_sma_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dbx_fused_sma(
            cs.data_ptr(), r.data_ptr(), t_real.data_ptr(), fast.data_ptr(),
            slow.data_ptr(), warm.data_ptr(), out.data_ptr(), N, T, P,
            float(cost), int(ppy), stream)
    if err != 0:
        raise RuntimeError(f"fused_sma kernel launch failed: CUDA error {err}")
    _kernels.LAUNCHES["fused_sma"] += 1
    return out


def fused_sma(cs, r, t_real, fast, slow, warm, *, cost: float,
              ppy: int) -> torch.Tensor:
    """K1 on the inputs' device: the kernel on CUDA, the plain version on
    the CPU."""
    if cs.device.type == "cpu":
        return fused_sma_plain(cs, r, t_real, fast, slow, warm, cost=cost,
                               ppy=ppy)
    return fused_sma_cuda(cs, r, t_real, fast, slow, warm, cost=cost, ppy=ppy)


def fused_sma_sweep(close, fast, slow, *, t_real=None, cost: float = 0.0,
                    periods_per_year: int = 252,
                    table: str | None = None,
                    epilogue: str | None = None,
                    carry_out: bool = False,
                    device: str | torch.device = device_mod.DEFAULT_DEVICE,
                    ) -> Metrics:
    """Fused SMA-crossover sweep: ``(N, T)`` closes x ``(P,)`` param lanes.

    ``fast``/``slow`` are the *flat* per-combo window arrays (use
    :func:`~..parallel.sweep.product_grid`); windows are bar counts and
    must be integral. ``t_real`` gives each ticker's real length in a
    ragged batch whose closes are padded by repeating the last bar. Returns
    :class:`Metrics` with ``(N, P)`` fields on ``device`` (``"cuda"``
    unless the caller asks for the CPU).

    ``table`` (``"inline"``/``"hbm"``) and ``epilogue`` (``"scan"``,
    ``"scan:<B>"``, ``"ladder"``) are validated by the reference's rules,
    and an invalid value raises; on Hopper one kernel design serves every
    value (no table, one sequential pass per lane), so a valid value
    changes nothing. ``carry_out=True`` (the streaming checkpoint) is not
    ported yet and raises ``NotImplementedError``.
    """
    if carry_out:
        raise NotImplementedError(
            "carry_out=True (the streaming checkpoint) is not ported yet; "
            "see the streaming slice in ROADMAP.md, Queue 1")
    _resolve_table(table)
    _resolve_epilogue(epilogue)
    dev = device_mod.resolve(device)
    close = device_mod.as_tensor(close, torch.float32, dev)
    if close.ndim != 2:
        raise ValueError(f"close must be (N, T); got {tuple(close.shape)}")
    N, T = close.shape
    fast_w, slow_w, warm = _grid_setup(fast, slow)
    tr = _check_t_real(t_real, N, T)
    tr_t, fast_t, slow_t, warm_t = (torch.from_numpy(a).to(dev)
                                    for a in (tr, fast_w, slow_w, warm))
    planes = fused_sma(
        torch.cumsum(close, dim=1).contiguous(),
        simple_returns(close).contiguous(),
        tr_t, fast_t, slow_t, warm_t,
        cost=float(cost), ppy=int(periods_per_year))
    return Metrics(*planes)
