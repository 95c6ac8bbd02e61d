"""Block-bootstrap, regime-switching OHLCV generator (reference
``scenarios/synth.py``).

The generator resamples a real base panel's per-bar geometry (close
return, open gap, upper and lower wick, volume) in contiguous blocks,
modulates volatility through a Markov chain over ``regimes`` levels and
injects rare gap-open shocks. Bars rebuild multiplicatively, so ``high >=
max(open, close) >= min(open, close) >= low > 0`` holds by construction.

A scenario is a pure function of ``(base panel digest, params)``: the
effective seed is :func:`scenario_seed` and block ``b`` of a scenario draws
from ``fold_in(key, b)`` alone (:mod:`.threefry`, JAX's threefry bit for
bit). So the draws (block starts, regime path, shock hits) equal the
reference's exactly. The floats do not: ``log``, ``exp`` and the sums
round differently in XLA and torch, so a panel agrees with the reference's
to about 1e-6 relative, not bit for bit.

:func:`generate_rows` builds K scenarios of one base at once, vectorized
over ``(K, blocks, block)``, in chunks of at most :func:`chunk_rows` rows.
Every sum runs in a fixed order that does not depend on K or the chunk:
a block's running sum bar by bar, the level carried block by block; the
regime chain is exact integer work (the state at a bar is the candidate of
the latest switch at or before it). Both the fused scenario sweep
(``ops.fused.fused_scenario_sweep``) and the backend's materialized rung
iterate the same chunks of the same call, so the two see the same panel
bits.

The pure-Python parts (:class:`ScenarioParams`, :func:`scenario_seed`,
:func:`seed_words`, :func:`seed_to_int64`, :func:`max_bars`) are copies of
the reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Iterator

import numpy as np
import torch

from .. import device as device_mod
from ..utils import data as data_mod
from . import threefry

_DEFAULT_MAX_BARS = 1 << 20

# Markov regime persistence: P(stay in the current vol regime per bar).
_REGIME_PERSIST = 0.96
# The switch test ``u < 1 - persist`` compares f32 draws with the f32
# rounding of the float64 constant, as the reference's traced compare does.
_SWITCH_BELOW = float(np.float32(1.0 - _REGIME_PERSIST))

# Device bytes a chunk of generated rows may take, and the (row, bar) f32
# tensors the generator holds live at its peak.
_CHUNK_BYTES = 1 << 28
_ROW_TENSORS = 32

FIELDS = data_mod._FIELDS


def max_bars() -> int:
    """Safety cap on generated panel length (``DBX_SCENARIO_MAX_BARS``),
    read lazily."""
    return int(os.environ.get("DBX_SCENARIO_MAX_BARS", _DEFAULT_MAX_BARS))


@dataclasses.dataclass(frozen=True)
class ScenarioParams:
    """Generator parameters: the ``params`` half of a scenario spec.

    ``seed`` is a user sequence number (scenario i of a diversity sweep),
    folded into the effective seed together with the base digest and
    every other field."""

    n_bars: int = 0          # output length; 0 = the base panel's length
    block: int = 16          # bootstrap block length in bars
    regimes: int = 2         # K Markov vol regimes; <= 1 disables switching
    vol_scale: float = 2.0   # top-regime vol multiplier (span 1/s .. s)
    shock: float = 0.0       # per-bar probability of a gap-open shock
    seed: int = 0            # scenario sequence number

    def canonical(self) -> str:
        """Canonical encoding: the string hashed into the effective seed."""
        d = dataclasses.asdict(self)
        return json.dumps({k: d[k] for k in sorted(d)},
                          separators=(",", ":"), sort_keys=True)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "ScenarioParams":
        """Build from a dict; unknown keys (the record's ``base``) are
        ignored."""
        fields = {f.name for f in dataclasses.fields(ScenarioParams)}
        return ScenarioParams(**{k: v for k, v in d.items() if k in fields})


def scenario_seed(base_digest: str, params: ScenarioParams) -> int:
    """64-bit effective seed: blake2b of ``base_digest | canonical
    params``."""
    h = hashlib.blake2b(
        f"{base_digest}|{params.canonical()}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little")


def seed_words(seed: int) -> tuple[int, int]:
    """The ``(lo, hi)`` int31 words of a 64-bit effective seed: the pair
    folded into the PRNG key, ``fold_in(PRNGKey(lo), hi)``."""
    return seed & 0x7FFFFFFF, (seed >> 31) & 0x7FFFFFFF


def seed_to_int64(seed: int) -> int:
    """Two's-complement wrap of an unsigned 64-bit effective seed into the
    signed int64 range ``ScenarioSpec.seed`` carries; :func:`seed_words`
    gives the same words for both."""
    return seed - (1 << 64) if seed >= (1 << 63) else seed


def check_shape(t_base: int, n_bars: int, block: int,
                regimes: int) -> tuple[int, int, int]:
    """The reference's validation of one generator call: a base of at
    least 2 bars, ``1 <= n_bars <= max_bars()`` (0 means the base's
    length), block and regimes at least 1. Returns ``(n_bars, block,
    regimes)``; raises ``ValueError``."""
    if t_base < 2:
        raise ValueError(f"scenario base needs >= 2 bars (got {t_base})")
    n_bars = int(n_bars) or t_base
    cap = max_bars()
    if not 1 <= n_bars <= cap:
        raise ValueError(f"scenario n_bars {n_bars} outside [1, {cap}] "
                         "(DBX_SCENARIO_MAX_BARS)")
    return n_bars, max(int(block), 1), max(int(regimes), 1)


def chunk_rows(n_bars: int, block: int) -> int:
    """Rows a chunk of :func:`generate_rows` holds: as many as fit
    ``_CHUNK_BYTES`` at ``_ROW_TENSORS`` f32 values a padded bar."""
    padded = -(-n_bars // block) * block
    return max(1, _CHUNK_BYTES // (padded * 4 * _ROW_TENSORS))


def block_keys(seed_lo, seed_hi, n_blocks: int, device) -> torch.Tensor:
    """``(K, n_blocks, 2)`` keys: block ``b`` of scenario ``k`` draws from
    ``fold_in(fold_in(PRNGKey(lo_k), hi_k), b)``."""
    key = threefry.fold_in(threefry.prng_key(seed_lo, device),
                           torch.as_tensor(seed_hi, device=device))
    b = torch.arange(n_blocks, dtype=torch.int64, device=device)
    return threefry.fold_in(key[:, None, :], b[None, :])


def draws(keys: torch.Tensor, t_base: int, block: int,
          regimes: int, shock: torch.Tensor) -> dict[str, torch.Tensor]:
    """The draws of blocks keyed ``keys`` (``(K, n_blocks, 2)``), as the
    reference draws them: each block key splits into (start, switch, pick,
    shock, magnitude) keys, and randint's start and pick each split theirs
    in two. The hashes of one step run as one batch: the seven keys the bits
    come from are stacked, and a block's counters hashed under all of them
    at once (the start takes the first counter alone).

    Returns ``start`` (``(K, n_blocks)`` block start bars) and, each
    ``(K, n_blocks, block)``, ``path`` (the regime state a bar, -1 where
    ``regimes`` <= 1), ``hit`` (shock hits) and ``mag`` (the shock's
    N(0, 1) draw)."""
    k = threefry.split(keys, 5)                        # (K, nb, 5, 2)
    kk = threefry.split(k[..., [0, 2], :], 2)          # (K, nb, 2, 2, 2)
    stacked = torch.cat([kk.flatten(-3, -2), k[..., [1, 3, 4], :]], dim=-2)
    bits = threefry.random_bits(stacked, (block,))     # (K, nb, 7, block)
    start = threefry.randint_from_bits(bits[..., 0, 0], bits[..., 1, 0], 0,
                                       max(t_base - block + 1, 1))
    out = {"start": start}
    if regimes > 1:
        u = threefry.uniform_from_bits(bits[..., 4, :])
        cand = threefry.randint_from_bits(bits[..., 2, :], bits[..., 3, :],
                                          0, regimes)
        K = u.shape[0]
        switch = (u < _SWITCH_BELOW).reshape(K, -1)
        at = torch.arange(switch.shape[1], device=u.device)
        last = torch.where(switch, at, -1).cummax(dim=1).values
        path = torch.where(last >= 0,
                           cand.reshape(K, -1).gather(1, last.clamp_min(0)),
                           0)
        out["path"] = path.reshape(u.shape)
    else:
        out["path"] = torch.full(start.shape + (block,), -1,
                                 dtype=torch.int64, device=keys.device)
    out["hit"] = (threefry.uniform_from_bits(bits[..., 5, :])
                  < shock[:, None, None])
    out["mag"] = threefry.normal_from_bits(bits[..., 6, :])
    return out


def _geometry(base: dict[str, torch.Tensor]):
    """The base's per-bar geometry: close return, open gap, upper and lower
    wick (logs), and sigma of the returns (ddof 0, in f64 rounded once)."""
    o, h, l, c = (base[f] for f in ("open", "high", "low", "close"))
    c_prev = c[:-1]
    ret = torch.log(c[1:] / c_prev)
    gap = torch.log(o[1:] / c_prev)
    hi = torch.log(h[1:] / torch.maximum(o[1:], c[1:])).abs()
    lo = torch.log(torch.minimum(o[1:], c[1:]) / l[1:]).abs()
    sigma = ret.double().std(correction=0).float()
    return ret, gap, hi, lo, sigma


def _linspace(regimes: int) -> np.ndarray:
    """``jnp.linspace(-1, 1, regimes)`` in f32, its formula step for
    step."""
    if regimes == 1:
        return np.float32([-1.0])
    div = regimes - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    out = np.float32(-1.0) * (np.float32(1.0) - step) + np.float32(1.0) * step
    return np.concatenate([out, np.float32([1.0])]).astype(np.float32)


def _rows(base, geo, keys, vol_scale, shock, *, n_bars, block, regimes):
    """One chunk: ``(K, n_bars)`` f32 fields of the scenarios keyed
    ``keys``."""
    ret, gap, hi, lo, sigma = geo
    t_base = ret.shape[0]
    dv = keys.device
    d = draws(keys, t_base, block, regimes, shock)
    K, nb = keys.shape[:2]
    idx = torch.minimum(d["start"][..., None]
                        + torch.arange(block, device=dv), torch.tensor(
                            t_base - 1, device=dv))          # (K, nb, block)
    if regimes > 1:
        lin = torch.from_numpy(_linspace(regimes)).to(dv)
        vs = torch.maximum(vol_scale, torch.tensor(1.0 + 1e-6, device=dv))
        mult = torch.exp(lin[None, :] * torch.log(vs)[:, None])   # (K, R)
        scale = mult.gather(1, d["path"].reshape(K, -1)).reshape(idx.shape)
    else:
        scale = torch.ones(idx.shape, dtype=torch.float32, device=dv)
    mag = d["mag"] * 5.0 * sigma
    jump = torch.where(d["hit"], mag, torch.zeros((), device=dv))
    b_ret = ret[idx] * scale + jump
    b_gap = gap[idx] * scale + jump
    # A block's running sum bar by bar (its cumsum), then the level of the
    # blocks before it added, carried block by block.
    part = b_ret.clone()
    for i in range(1, block):
        part[..., i] = part[..., i - 1] + b_ret[..., i]
    level = torch.empty((K, nb), dtype=torch.float32, device=dv)
    run = torch.zeros((K,), dtype=torch.float32, device=dv)
    for b in range(nb):
        level[:, b] = run
        run = run + part[:, b, -1]
    cum = level[..., None] + part
    prev_cum = torch.cat([level[..., None], cum[..., :-1]], dim=-1)
    c0 = base["close"][0]
    close_b = c0 * torch.exp(cum)
    open_b = (c0 * torch.exp(prev_cum)) * torch.exp(b_gap)
    body_hi = torch.maximum(open_b, close_b)
    body_lo = torch.minimum(open_b, close_b)
    high_b = body_hi * torch.exp(hi[idx] * scale)
    low_b = body_lo * torch.exp(-lo[idx] * scale)
    vol_b = base["volume"][1:][idx]
    return {f: x.reshape(K, -1)[:, :n_bars]
            for f, x in zip(FIELDS, (open_b, high_b, low_b, close_b, vol_b))}


def generate_rows(base, seed_lo, seed_hi, vol_scale, shock, *, n_bars: int,
                  block: int, regimes: int,
                  device: str | torch.device = device_mod.DEFAULT_DEVICE,
                  ) -> Iterator[tuple[int, dict[str, torch.Tensor]]]:
    """K scenarios of one base, a chunk at a time.

    ``base`` maps the five OHLCV names to ``(T,)`` arrays or tensors;
    ``seed_lo``, ``seed_hi`` (:func:`seed_words` of each effective seed),
    ``vol_scale`` and ``shock`` are ``(K,)`` arrays or tensors; ``n_bars``,
    ``block`` and ``regimes`` as
    :func:`check_shape` returns them. Yields ``(first row, {field: (k, n_bars)
    f32 tensor})`` for chunks of at most :func:`chunk_rows` rows, on
    ``device``."""
    dev = device_mod.resolve(device)
    b = {f: device_mod.as_tensor(base[f], torch.float32, dev)
         for f in FIELDS}
    geo = _geometry(b)
    lo = device_mod.as_tensor(seed_lo, torch.int64, dev)
    hi = device_mod.as_tensor(seed_hi, torch.int64, dev)
    vs = device_mod.as_tensor(vol_scale, torch.float32, dev)
    sh = device_mod.as_tensor(shock, torch.float32, dev)
    if lo.ndim != 1 or not lo.shape == hi.shape == vs.shape == sh.shape:
        raise ValueError("seed_lo, seed_hi, vol_scale and shock must be "
                         "matching (K,) arrays")
    n_blocks = -(-n_bars // block)
    step = chunk_rows(n_bars, block)
    for r0 in range(0, lo.shape[0], step):
        sl = slice(r0, r0 + step)
        keys = block_keys(lo[sl], hi[sl], n_blocks, dev)
        yield r0, _rows(b, geo, keys, vs[sl], sh[sl], n_bars=n_bars,
                        block=block, regimes=regimes)


def generate(base: data_mod.OHLCV, params: ScenarioParams, seed: int, *,
             device: str | torch.device = device_mod.DEFAULT_DEVICE,
             ) -> data_mod.OHLCV:
    """One synthetic single-ticker panel (numpy ``(n_bars,)`` fields) from
    ``base`` (fields ``(T,)``) under ``params`` and the 64-bit effective
    ``seed``, generated on ``device``."""
    if np.asarray(base.close).ndim != 1:
        raise ValueError("generate takes a single ticker, fields "
                         "shaped (T,)")
    n_bars, block, regimes = check_shape(base.n_bars, params.n_bars,
                                         params.block, params.regimes)
    lo, hi = seed_words(seed)
    ((_, rows),) = generate_rows(
        base._asdict(), [lo], [hi], [params.vol_scale], [params.shock],
        n_bars=n_bars, block=block, regimes=regimes, device=device)
    return data_mod.OHLCV(*(rows[f][0].cpu().numpy() for f in FIELDS))


def certify_probe():
    """``(fn, args, integral_keys)`` for dbxcert: the generation digest
    cone on tiny pinned shapes (the reference's). The scenario digest
    scheme is sound only if this program is run-to-run deterministic for a
    fixed (seed, params): the certifier asserts that no nondet-class op
    reaches these outputs (float association is fine: the program always
    evaluates in its own fixed order). Runs on the CPU."""
    base = data_mod.synthetic_ohlcv(1, 48, seed=3)

    def fn(open_, high, low, close, volume, lo, hi):
        b = {"open": open_, "high": high, "low": low, "close": close,
             "volume": volume}
        dev = close.device
        keys = block_keys(lo, hi, 4, dev)
        rows = _rows(b, _geometry(b), keys,
                     torch.tensor([2.0], dtype=torch.float32, device=dev),
                     torch.tensor([0.1], dtype=torch.float32, device=dev),
                     n_bars=16, block=4, regimes=2)
        return {f: rows[f][0] for f in FIELDS}

    args = [np.asarray(getattr(base, f)[0], np.float32) for f in FIELDS]
    args += [np.asarray([7], np.int64), np.asarray([11], np.int64)]
    return fn, args, frozenset()


def scenario_panel_bytes(base_bytes: bytes, params: ScenarioParams, *,
                         device: str | torch.device =
                         device_mod.DEFAULT_DEVICE) -> bytes:
    """DBX1 wire bytes of the scenario panel for ``(base_bytes, params)``,
    deterministic on one device."""
    base_digest = hashlib.blake2b(base_bytes, digest_size=16).hexdigest()
    base = data_mod.from_wire_bytes(base_bytes)
    series = generate(base, params, scenario_seed(base_digest, params),
                      device=device)
    return data_mod.to_wire_bytes(series)
