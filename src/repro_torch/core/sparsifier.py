"""The Bernoulli sparsifier S(.) of Definition 2 plus the fixed-k variant.

Port of ``repro.core.sparsifier``. For x in R^d and p in (0, 1],
[S(x)]_i = x_i / p with probability p and 0 otherwise (unbiased). The
fixed-k variant keeps exactly k = ceil(p d) coordinates chosen by the
top-k of d uniforms, so both endpoints can regenerate the index set from
a shared key.

Every function takes an optional leading batch: a key of shape (n, 2)
draws n independent masks / index sets in one call, one per row of x.

Division by a constant p: the JAX package runs these functions inside
``jax.jit``, where XLA rewrites ``x / p`` with a constant p into
``x * (1 / p)`` (the reciprocal rounded to f32). The port computes that
same product, so the sparsified values agree bit for bit with the
compiled reference. A per-node p (a tensor) stays a true division, as
it does in XLA.
"""
from __future__ import annotations

import decimal
import functools
import math
from fractions import Fraction

import numpy as np
import torch

from repro_torch import prng

__all__ = ["bernoulli_mask", "bernoulli_sparsify", "sparsifier_variance",
           "fixedk_indices", "fixedk_pack", "fixedk_unpack",
           "fixedk_sparsify", "num_kept", "block_view", "block_sparsify",
           "f32_reciprocal"]


def f32_reciprocal(p: float) -> float:
    """1/p as XLA folds it into a constant: f32(1) / f32(p), in f32."""
    return float(np.float32(1.0) / np.float32(p))


def bernoulli_mask(key, shape, p) -> torch.Tensor:
    """Boolean keep-mask with i.i.d. keep-probability p (``key`` (2,) or
    a batch (*batch, 2): the mask is (*batch, *shape))."""
    return prng.bernoulli(prng.key_data(key), p, tuple(shape))


def bernoulli_sparsify(key, x: torch.Tensor, p) -> torch.Tensor:
    """S(x): keep each coordinate w.p. p, scale kept by 1/p.

    ``key`` is (2,) or (*batch, 2) with ``x`` of shape (*batch, ...);
    ``p`` is a python float or an f32 tensor broadcasting against x (a
    per-node budget).
    """
    if isinstance(p, (int, float)):
        if not 0.0 < p <= 1.0:
            raise ValueError(f"p must be in (0, 1], got {p}")
        if p == 1.0:
            return x
    key = prng.key_data(key)
    shape = tuple(x.shape[key.dim() - 1:])
    mask = prng.bernoulli(key, p, shape)
    if isinstance(p, (int, float)):
        kept = x * f32_reciprocal(p)
    else:
        kept = x / p
    return torch.where(mask, kept, torch.zeros_like(x))


def sparsifier_variance(x: torch.Tensor, p: float) -> torch.Tensor:
    """Lemma 1: Var(S(x)) = (1/p - 1) ||x||_2^2 (summed over coords)."""
    return (1.0 / p - 1.0) * torch.sum(torch.square(x))


def fixedk_indices(key, d: int, k: int) -> torch.Tensor:
    """k distinct uniform indices into [0, d), regenerable from ``key``:
    the arg-top-k of d uniforms, in ``lax.top_k``'s tie order."""
    return prng.fixedk_indices(key, d, k)


@functools.lru_cache(maxsize=None)
def num_kept(d: int, p: float) -> int:
    """k = ceil(p * d), at least 1, at most d, in exact arithmetic
    (``repr(p)`` is the decimal the caller wrote)."""
    p_exact = Fraction(decimal.Decimal(repr(p)))
    return min(d, max(1, math.ceil(p_exact * d)))


def fixedk_pack(x_flat: torch.Tensor, idx: torch.Tensor, d: int
                ) -> torch.Tensor:
    """The selected coordinates pre-scaled by d/k (the exact inclusion
    probability is k/d): shape (k,)."""
    k = idx.shape[0]
    return torch.index_select(x_flat, 0, idx) * (d / k)


def fixedk_unpack(values: torch.Tensor, idx: torch.Tensor, d: int
                  ) -> torch.Tensor:
    """The packed values scattered back into a dense (d,) S(x)."""
    out = torch.zeros((d,), dtype=values.dtype, device=values.device)
    out[idx] = values
    return out


def fixedk_sparsify(key, x_flat: torch.Tensor, p: float) -> torch.Tensor:
    """Dense-output fixed-k sparsifier of a flat vector."""
    d = x_flat.shape[0]
    k = num_kept(d, p)
    idx = fixedk_indices(key, d, k)
    return fixedk_unpack(fixedk_pack(x_flat, idx, d), idx, d)


def block_view(x_flat: torch.Tensor, block: int) -> torch.Tensor:
    """Pad the last axis to a block multiple and view it as
    (..., n_blocks, block)."""
    d = x_flat.shape[-1]
    pad = (-d) % block
    if pad:
        x_flat = torch.nn.functional.pad(x_flat, (0, pad))
    return x_flat.reshape(tuple(x_flat.shape[:-1]) + (-1, block))


def block_sparsify(key, x_flat: torch.Tensor, p: float, block: int
                   ) -> torch.Tensor:
    """Dense-output block-granular fixed-k sparsifier: whole blocks of
    ``block`` consecutive coordinates kept or dropped together, kept
    blocks scaled by n_blocks / k_blocks."""
    d = x_flat.shape[0]
    xb = block_view(x_flat, block)
    nb = xb.shape[0]
    kb = num_kept(nb, p)
    idx = fixedk_indices(key, nb, kb)
    out = torch.zeros_like(xb)
    out[idx] = torch.index_select(xb, 0, idx) * (nb / kb)
    return out.reshape(-1)[:d]
