"""Threefry-2x32 counter-based PRNG, bit-exact with ``jax.random``.

The port's counterpart of ``jax.random`` as jax 0.9 runs it (the
threefry2x32 implementation with ``jax_threefry_partitionable=True``):
the same key in gives the same bits out, so masks, quantizer rounding
uniforms and fixed-k index sets of the port equal the JAX package's
draw for draw.

Keys are int64 tensors of shape ``(..., 2)`` holding two uint32 words
(kept in int64 and masked to 32 bits, since torch's uint32 lacks
shifts and adds on every device). A leading batch of keys draws in one
call: ``uniform(keys, shape)`` with ``keys`` of shape ``(n, 2)`` returns
``(n, *shape)``, exactly what ``jax.vmap(lambda k: uniform(k, shape))``
returns -- the per-node draws of the reference executor are one call.

What the partitionable threefry computes (``jax/_src/prng.py``):

* ``bits(key, shape)``: the counter of flat element i is the 64-bit
  integer i split into (hi, lo) words; threefry2x32(key, hi, lo) gives
  (b1, b2) and the 32-bit draw is ``b1 ^ b2``;
* ``split(key, num)``: threefry2x32(key, 0, j) for j < num, both words
  kept as the j-th new key (fold-like);
* ``fold_in(key, data)``: threefry2x32(key, 0, data), both words kept;
* ``uniform``: the top 23 bits as an f32 mantissa in [1, 2), minus 1.

``normal`` follows jax's inverse-erf construction with XLA's own erfinv
polynomial; its last bits depend on ``log1p``, so it is the one draw
here that is not bit-exact (within a few ulp).
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

__all__ = ["PRNGKey", "key_data", "threefry2x32", "fold_in", "split",
           "bits", "uniform", "normal", "erfinv_xla", "bernoulli",
           "fixedk_indices", "top_k_indices"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

IntLike = Union[int, torch.Tensor]


def PRNGKey(seed: int, *, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the (2,) key [seed >> 32, seed & M].

    Without jax's x64 mode the seed is an int32, so the high word is 0
    and a negative seed keeps its two's-complement low word.
    """
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit int32 (jax's default)")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def key_data(key) -> torch.Tensor:
    """A key (or batch of keys) as an int64 tensor, checked."""
    k = torch.as_tensor(key)
    if k.dtype != torch.int64:
        k = k.to(torch.int64) & _M32
    if k.shape[-1:] != (2,):
        raise ValueError(f"keys have a trailing axis of 2, got {tuple(k.shape)}")
    return k


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 block function (20 rounds), elementwise over
    broadcast uint32 words held in int64 tensors."""
    k3 = k1 ^ k2 ^ _KS_PARITY
    ks = (k1, k2, k3)
    a = (x1 + k1) & _M32
    b = (x2 + k2) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def _words(key: torch.Tensor, extra_dims: int):
    """(k1, k2) of a batch of keys, broadcastable over ``extra_dims``
    trailing draw dimensions."""
    k1, k2 = key[..., 0], key[..., 1]
    shape = tuple(k1.shape) + (1,) * extra_dims
    return k1.reshape(shape), k2.reshape(shape)


def fold_in(key, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in``: threefry2x32(key, 0, data). ``data`` (an
    int or an integer tensor) broadcasts against the batch of keys."""
    key = key_data(key)
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    k1, k2 = key[..., 0], key[..., 1]
    a, b = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (fold-like): (..., num, 2) new keys."""
    key = key_data(key)
    j = torch.arange(num, dtype=torch.int64, device=key.device)
    k1, k2 = _words(key, 1)
    a, b = threefry2x32(k1, k2, torch.zeros_like(j), j)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def bits(key, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32), shape
    ``(*key_batch, *shape)``."""
    key = key_data(key)
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    i = torch.arange(size, dtype=torch.int64, device=key.device)
    k1, k2 = _words(key, 1)
    a, b = threefry2x32(k1, k2, i >> 32, i & _M32)
    return (a ^ b).reshape(tuple(key.shape[:-1]) + shape)


def _unit_floats(key, shape) -> torch.Tensor:
    """f32 in [0, 1): 23 random mantissa bits over exponent 0, minus 1."""
    mant = (bits(key, shape) >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    """f32 a * b + c rounded once, as XLA's CPU backend contracts it: the
    f32 product is exact in f64, so only the final f64 -> f32 rounding
    remains (a double rounding that can differ from a true fma only when
    the f64 sum lands exactly on an f32 tie)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def uniform(key, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: floats * (max - min) + min (one
    fused multiply-add under jit), clamped below at min."""
    f = _unit_floats(key, shape)
    if minval == 0.0 and maxval == 1.0:
        return f      # * 1 + 0 and max(0, .) are exact no-ops
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, _fma_f32(f, hi - lo, lo))


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))

# XLA's f32 inverse error function (Giles' single-precision polynomial,
# the one chlo.erf_inv lowers to), split at w = -log1p(-x^2) = 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """f32 erfinv computed as XLA computes it (its polynomial, Horner
    steps as fused multiply-adds). ``torch.erfinv`` is a different
    approximation; this one differs from XLA's only where ``log1p``
    rounds differently in the last bit (a few ulp; the tests bound it)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(
            lt, torch.tensor(_ERFINV_LT5[i], dtype=torch.float32,
                             device=x.device),
            torch.tensor(_ERFINV_GE5[i], dtype=torch.float32,
                         device=x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma_f32(p, w, coef(i))
    out = p * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       out)


def normal(key, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.normal`` in f32: sqrt(2) * erfinv(u), u uniform on
    (nextafter(-1, 0), 1). The uniforms are bit-exact; the inverse erf is
    XLA's polynomial, within a few ulp (the tests state the gap)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return erfinv_xla(u) * _SQRT2_F32


def bernoulli(key, p, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode 'low'): uniform < p in f32. ``p``
    is a float or an f32 tensor broadcasting against the draw."""
    u = uniform(key, shape)
    return u < torch.as_tensor(p, dtype=torch.float32, device=u.device)


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, in
    ``lax.top_k``'s order: descending value, ties by ascending index
    (a stable descending sort; ``torch.topk`` does not promise that)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[..., :k]


def fixedk_indices(key, d: int, k: int) -> torch.Tensor:
    """``sparsifier.fixedk_indices``: the top-k of d uniforms (int64)."""
    return top_k_indices(uniform(key, (d,)), k)
