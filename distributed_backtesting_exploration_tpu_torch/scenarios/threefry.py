"""Threefry2x32 counter-based random bits as torch ops.

The reference's scenario generator draws its randomness from JAX's default
PRNG (``threefry2x32`` with ``jax_threefry_partitionable`` on, jax 0.9.0).
A panel's content digest is a pure function of its spec only if every
worker draws the same bits, so this module repeats JAX's key derivation
and samplers bit for bit:

- a key is two uint32 words, held here as an int64 tensor of shape
  ``(..., 2)``; every word is an int64 masked to 32 bits (torch has no
  uint32 arithmetic), rotations written out;
- :func:`prng_key` is ``jax.random.PRNGKey`` of an int32 seed (high word
  0), :func:`fold_in` and :func:`split` hash the counter ``(0, data)`` and
  ``(0, i)`` under the key, and :func:`random_bits` hashes each element's
  flat index as the ``(hi, lo)`` counter words and xors the two outputs;
- :func:`uniform`, :func:`randint` and :func:`normal` map bits to values as
  ``jax.random``'s ``_uniform``, ``_randint`` and ``_normal_real`` do.
  ``normal`` goes through XLA's f32 ``erf_inv`` polynomial, whose
  ``log1p`` is XLA's own: it agrees with JAX to about an ulp, not bit
  for bit.

Keys may carry leading batch dimensions: a sampler given keys of shape
``(*B, 2)`` returns values of shape ``(*B, *shape)``, element ``b`` drawn
under key ``b``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def hash2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under the
    key words ``(k0, k1)``; int64 tensors of uint32 values, broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for int32 seeds: the words ``(0, seed
    mod 2**32)``; ``seed`` an int or an integer tensor of any shape."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & _M32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed on the counter ``(0, data)``;
    ``data`` broadcasts against the key's batch shape."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    a, b = hash2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(*B, 2)`` keys to ``(*B, num, 2)``, key ``i``
    the hash of the counter ``(0, i)``."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = hash2x32(key[..., 0, None], key[..., 1, None],
                    torch.zeros_like(i), i)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32 random bits (int64 holding uint32) of ``shape`` under each key:
    element ``n`` (flat, row-major) hashes the counter ``(n >> 32, n mod
    2**32)`` and xors the two words."""
    n = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=key.device).reshape(shape)
    at = (*key.shape[:-1], *([1] * len(shape)))
    k0 = key[..., 0].reshape(at)
    k1 = key[..., 1].reshape(at)
    a, b = hash2x32(k0, k1, n >> 32, n & _M32)
    return a ^ b


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """f32 values of 32 random bits as ``jax.random.uniform`` maps them:
    the top 23 bits as the mantissa of a float in [1, 2), minus 1, then
    ``max(minval, u * (maxval - minval) + minval)``, the bounds rounded to
    f32 first."""
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.maximum(lo, (one - 1.0) * (hi - lo) + lo)


def uniform(key: torch.Tensor, shape: tuple, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32."""
    return uniform_from_bits(random_bits(key, shape), minval, maxval)


def randint_from_bits(higher: torch.Tensor, lower: torch.Tensor,
                      minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint``'s int32 values in ``[minval, maxval)`` from
    its two words of bits (drawn under ``split(key)``'s two keys): combined
    modulo the span with the multiplier ``(2**16 mod span)**2 mod span``,
    all in uint32 arithmetic (wrapping mod 2**32 as JAX's does). Returns
    int64."""
    if not (-2**31 <= minval and maxval <= 2**31 - 1):
        raise ValueError("randint bounds must lie in int32")
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (((2**16 % span) ** 2) & _M32) % span
    off = ((((higher % span) * mult) & _M32) + lower % span) & _M32
    return minval + off % span


def randint(key: torch.Tensor, shape: tuple, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` of int32 values (as int64)."""
    k = split(key, 2)
    return randint_from_bits(random_bits(k[..., 0, :], shape),
                             random_bits(k[..., 1, :], shape), minval, maxval)


# XLA's f32 erf_inv (the polynomial of M. Giles, "Approximating the erfinv
# function"): coefficients for w = -log1p(-x*x) < 5 and >= 5.
_ERFINV_SMALL = np.float32([
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941])
_ERFINV_LARGE = np.float32([
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682])


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``, step for step (±1 map to ±inf)."""
    w = -torch.log1p(-(x * x))
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for cs, cl in zip(_ERFINV_SMALL, _ERFINV_LARGE):
        c = torch.where(small, torch.tensor(float(cs), device=x.device),
                        torch.tensor(float(cl), device=x.device))
        p = c if p is None else c + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal``'s f32 values of 32 random bits: ``sqrt(2) *
    erf_inv(u)``, ``u`` uniform on [nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return np.float32(np.sqrt(2)).item() * erf_inv(
        uniform_from_bits(bits, lo, 1.0))


def normal(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.normal`` in f32."""
    return normal_from_bits(random_bits(key, shape))
