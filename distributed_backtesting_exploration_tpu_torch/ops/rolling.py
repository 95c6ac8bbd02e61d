"""Rolling-window indicators (PyTorch).

The part of the reference's ``ops/rolling.py`` the ported families need:
cumulative-sum sums, means, variances and z-scores, the rolling OLS of the
pairs trade, on-balance volume, windowed extrema, and the exponential
moving average (as the reference's shift-doubling ladder).
Time is the last axis. A rolling sum over window ``w`` is ``cs[t] - cs[t-w]`` on the
inclusive prefix sum, where the shifted read is a clipped gather so that
``w`` may be a tensor of windows that broadcasts against the series (the
port's stand-in for the reference's ``vmap`` over traced windows).
Warmup bars ``t < w - 1`` are filled with ``fill``.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def _as_window(window, like: Tensor) -> Tensor:
    return torch.as_tensor(window, dtype=like.dtype, device=like.device)


def _shifted(cs: Tensor, w, *, fill: float = 0.0) -> Tensor:
    """``cs[..., t - w]`` along the last axis, ``fill`` where ``t < w``.

    ``w`` is a scalar or a tensor that broadcasts against ``cs`` with the
    time axis dropped (e.g. ``(P, 1)`` windows against ``(N, 1, T)``
    series). As in the reference, the gather index is ``t - w`` clipped to
    ``[0, T-1]`` and then truncated to an integer, so a non-integral window
    reads the same bar the reference reads.
    """
    T = cs.shape[-1]
    w = _as_window(w, cs)
    idx = torch.arange(T, device=cs.device, dtype=cs.dtype) - w
    gather_idx = idx.clamp(0, T - 1).to(torch.int64)
    shape = torch.broadcast_shapes(cs.shape, gather_idx.shape)
    taken = torch.gather(cs.expand(shape), -1, gather_idx.expand(shape))
    return torch.where(idx >= 0, taken, torch.full_like(taken, fill))


def valid_mask(T: int, window, device=None) -> Tensor:
    """Boolean mask, True where a ``window``-bar indicator is defined.

    Shaped ``(T,)`` for a scalar window, ``window.shape + (T,)`` for a
    tensor of windows; broadcasts against any ``(..., T)`` indicator.
    """
    w = torch.as_tensor(window, dtype=torch.float32, device=device)
    return torch.arange(T, device=w.device) >= w - 1


def prefix_sum(x: Tensor, dim: int = -1) -> Tensor:
    """Inclusive prefix sums of ``x`` along ``dim``, accumulated in f64 and
    rounded once a bar to ``x``'s dtype. On the CPU this is torch's cumsum
    of f32 bit for bit (it accumulates in f64 too). On CUDA torch's f32
    scan associates by the tensor's row count and length, so a row's sums
    would depend on the rows stacked with it; sums of f32 prices are exact
    in f64 whatever the order, so these round to the same bits on any
    device and shape."""
    return torch.cumsum(x.double(), dim=dim).to(x.dtype)


def rolling_sum(x: Tensor, window, *, fill: float = math.nan) -> Tensor:
    """Rolling sum over the trailing ``window`` bars (inclusive), same length.

    ``out[..., t] = sum(x[..., t-window+1 : t+1])``; warmup -> ``fill``.
    The difference of two :func:`prefix_sum` bars, so the generic models'
    sums round as the fused preps' do.
    """
    cs = prefix_sum(x)
    return _mask_warmup(cs - _shifted(cs, window), window, fill)


def rolling_mean(x: Tensor, window, *, fill: float = math.nan) -> Tensor:
    """Rolling mean (SMA) over the trailing ``window`` bars."""
    return rolling_sum(x, window, fill=fill) / _as_window(window, x)


def _mask_warmup(out: Tensor, window, fill: float) -> Tensor:
    valid = valid_mask(out.shape[-1], _as_window(window, out))
    return torch.where(valid, out, torch.full_like(out, fill))


def mean_f64(x: Tensor, dim: int = -1) -> Tensor:
    """The mean of ``x`` along ``dim`` (kept), its sum taken in f64, divided
    by the length and rounded once to ``x``'s dtype: the centering of the
    generic models and the fused preps. A sum of f32 prices is exact in f64
    whatever the order, so the mean has the same bits on any device and
    shape."""
    total = x.double().sum(dim=dim, keepdim=True)
    return (total / x.shape[dim]).to(x.dtype)


def _centered(x: Tensor) -> Tensor:
    # Constant per-series shift: preserves variances, kills the float32
    # cancellation between E[x^2] and E[x]^2 for price-level inputs.
    return x - mean_f64(x)


def rolling_var(x: Tensor, window, *, ddof: int = 0,
                fill: float = math.nan) -> Tensor:
    """Rolling population (ddof=0) or sample (ddof=1) variance, from
    series-centered second moments (the reference's op order)."""
    xc = _centered(x)
    w = _as_window(window, x)
    s1 = rolling_sum(xc, window)
    s2 = rolling_sum(xc * xc, window)
    var = ((s2 - s1 * s1 / w) / (w - ddof)).clamp_min(0.0)
    return _mask_warmup(var, window, fill)


def rolling_std(x: Tensor, window, *, ddof: int = 0,
                fill: float = math.nan) -> Tensor:
    """Rolling standard deviation."""
    return torch.sqrt(rolling_var(x, window, ddof=ddof, fill=fill))


def rolling_zscore(x: Tensor, window, *, ddof: int = 0, eps: float = 1e-12,
                   fill: float = math.nan) -> Tensor:
    """``(x - rolling_mean) / (rolling_std + eps)``: the Bollinger entry
    signal."""
    m = rolling_mean(x, window)
    sd = rolling_std(x, window, ddof=ddof)
    return _mask_warmup((x - m) / (sd + eps), window, fill)


def rolling_ols(y: Tensor, x: Tensor, window, *, eps: float = 1e-12,
                fill: float = math.nan) -> tuple[Tensor, Tensor]:
    """Rolling least squares of ``y`` on ``x`` with an intercept, from
    windowed moments of the series-centered legs (the reference's op
    order; each leg centered by :func:`mean_f64`, so the same bits on any
    device and shape, and the time-sharded pairs backtest's blockwise f64
    means give the same): ``beta = cov / (var + eps)`` with ``cov = sxy - sx*sy/w`` and
    ``var = max(sxx - sx*sx/w, 0)``, ``alpha = (sy/w + my) - beta*(sx/w +
    mx)``. Returns ``(alpha, beta)``, each broadcast of ``y``, ``x`` and the
    window; warmup bars ``t < w - 1`` hold ``fill``."""
    w = _as_window(window, y)
    mx = mean_f64(x)
    my = mean_f64(y)
    xc, yc = x - mx, y - my
    sx = rolling_sum(xc, window)
    sy = rolling_sum(yc, window)
    sxx = rolling_sum(xc * xc, window)
    sxy = rolling_sum(xc * yc, window)
    cov = sxy - sx * sy / w
    var = (sxx - sx * sx / w).clamp_min(0.0)
    beta = cov / (var + eps)
    alpha = (sy / w + my) - beta * (sx / w + mx)
    return _mask_warmup(alpha, window, fill), _mask_warmup(beta, window, fill)


def obv_series(close: Tensor, volume: Tensor) -> Tensor:
    """Normalized on-balance volume, ``(..., T)``, ``obv[0] = 0``:
    ``cumsum(sign(close[t] - close[t-1]) * v)`` with ``v`` the volume over
    the first bar's (a first bar of 0 divides by 1). One definition for the
    generic model and the fused prep, as in the reference."""
    v0 = volume[..., :1]
    v = volume / torch.where(v0 == 0.0, torch.ones_like(v0), v0)
    step = torch.sign(torch.diff(close, dim=-1, prepend=close[..., :1])) * v
    return prefix_sum(step)


def _decay(x: Tensor, span, alpha) -> Tensor:
    """The EMA decay as a tensor of ``x``'s dtype: ``alpha``, or
    ``2 / (span + 1)`` as one IEEE division, as the reference computes it
    (``2.0 / span_tensor`` in torch would round twice: a reciprocal, then
    a multiply)."""
    if (span is None) == (alpha is None):
        raise ValueError("pass exactly one of span= or alpha=")
    if alpha is not None:
        return _as_window(alpha, x)
    return torch.div(_as_window(2.0, x), _as_window(span, x) + 1.0)


def ema_ladder(x: Tensor, *, span=None, alpha=None) -> Tensor:
    """Exponential moving average along the last axis as the reference's
    Hillis-Steele shift-doubling ladder (``rolling.ema_ladder``), op for op.

    ``y[t] = (1-a) * y[t-1] + a * x[t]``, ``y[0] = x[0]``, with
    ``a = 2/(span+1)`` when ``span`` is given. The recurrence is carried as
    ``(A, B)`` pairs: ``A = 1-a`` (0 at bar 0), ``B = a*x`` (``x`` at bar
    0); each of the ~log2(T) passes shifts the pairs down by ``step`` bars,
    filling with the identity ``(1, 0)``, and folds them in as
    ``A, B = Ae*A, A*Be + B``, the multiply and the add two separate ops.

    ``span``/``alpha`` are scalars or tensors that broadcast against ``x``
    with a time axis of 1 (e.g. ``(W, 1)`` decays against ``(N, 1, T)``
    series give ``(N, W, T)``): the port's stand-in for the reference's
    ``vmap`` over traced decays. ``A`` depends on the decay only, so it is
    kept at the decay's shape; each element takes the same values as in the
    reference's full-shape ``A``.
    """
    alpha = _decay(x, span, alpha)
    T = x.shape[-1]
    t0 = torch.arange(T, device=x.device) == 0
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    A = torch.where(t0, zero, 1.0 - alpha)          # y[0] = x[0] exactly
    B = torch.where(t0, x, x * alpha)
    step = 1
    while step < T:
        Ae = torch.cat([torch.ones_like(A[..., :step]), A[..., :-step]], -1)
        Be = torch.cat([torch.zeros_like(B[..., :step]), B[..., :-step]], -1)
        A, B = Ae * A, A * Be + B
        step *= 2
    return B


def ema(x: Tensor, *, span=None, alpha=None) -> Tensor:
    """Exponential moving average, ``y[t] = (1-a) * y[t-1] + a * x[t]``,
    ``y[0] = x[0]``, ``a = 2/(span+1)`` when ``span`` is given.

    The reference evaluates this with ``lax.associative_scan``, which torch
    does not have. The port evaluates the same recurrence with
    :func:`ema_ladder`, so it rounds in the ladder's order (the reference's
    ``ema_ladder``, and the fused prep's ``_ema_rows``), not in the
    associative scan's: against the reference's ``ema`` it may differ in
    the last bits. ``span``/``alpha`` broadcast as in :func:`ema_ladder`.
    """
    return ema_ladder(x, span=span, alpha=alpha)


def _rolling_extremum(x: Tensor, window, max_window, fill: float,
                      mode: str, bound: int | None = None) -> Tensor:
    T = x.shape[-1]
    w = _as_window(window, x)
    top = math.ceil(float(w.max())) if bound is None else int(bound)
    reach = top if max_window is None else min(int(max_window), top)
    neutral = -math.inf if mode == "max" else math.inf
    pick = torch.maximum if mode == "max" else torch.minimum
    # Offset o reads x[t - o] for every lane whose window covers it
    # (o < window, t - o >= 0); other lanes see the neutral value.
    out = torch.where(0 < w, x, neutral)
    for o in range(1, min(reach, T)):
        shifted = torch.cat(
            [torch.full_like(x[..., :o], neutral), x[..., :T - o]], dim=-1)
        out = pick(out, torch.where(o < w, shifted, neutral))
    if max_window is not None:
        # As the reference's traced-window kernel: a window beyond the view
        # bound poisons its output instead of truncating the lookback.
        out = torch.where(w <= max_window, out, torch.full_like(out, math.nan))
    return _mask_warmup(out, window, fill)


def rolling_max(x: Tensor, window, *, max_window: int | None = None,
                fill: float = math.nan, bound: int | None = None) -> Tensor:
    """Rolling max over the trailing ``window`` bars (inclusive).

    ``window`` may be a tensor of windows that broadcasts against ``x``
    (e.g. ``(P, 1)`` against ``(N, 1, T)``). With ``max_window`` set, a
    window beyond it yields NaN, as the reference's traced-window kernel
    (``rolling_extrema_traced``) does. Max of exact values is exact in any
    order, so this equals the reference's doubling and masked-view forms.
    ``bound``, a host-side bound of the windows, spares reading the largest
    window off the device (a sync); any bound at or above it gives the same
    values.
    """
    return _rolling_extremum(x, window, max_window, fill, "max", bound)


def rolling_min(x: Tensor, window, *, max_window: int | None = None,
                fill: float = math.nan, bound: int | None = None) -> Tensor:
    """Rolling min over the trailing ``window`` bars; see
    :func:`rolling_max`."""
    return _rolling_extremum(x, window, max_window, fill, "min", bound)
