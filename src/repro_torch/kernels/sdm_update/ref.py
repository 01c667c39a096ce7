"""Plain version of the fused SDM-DSGD update (Algorithm 1's elementwise
core), in torch.

Port of ``repro.kernels.sdm_update.ref.sdm_update_ref``. Over (rows,
1024) planes, with three 32-bit random bit streams:

    s      = s_prev + nb_sum
    g_hat  = clip(g, +-clip_c) + sigma * sqrt(-2 log u1) cos(2 pi u2)
    y      = (1-theta)*x + theta*(w_self*x + s - gamma*g_hat)
    d      = y - x
    sd     = [u_mask < p] * d * f32(1/p)
    x_new  = x + sd

with u = max((bits >> 8) * 2^-24, 2^-24), the top 24 bits as a uniform
in (0, 1]. Each operation is its own rounded f32 tensor op, in the order
the JAX expression writes them: the CUDA kernel
(``kernels/csrc/sdm_update.cu``) rounds the same operations in the same
order. The sparsifier scale is the multiplication by the f32 rounding of
1/p (taken in double), as the Pallas kernel writes it; the JAX oracle
divides by p, which XLA turns into the same multiplication under jit.

The bit streams may be int32 (the kernel's 4-byte storage: words >= 2^31
read negative) or int64 holding u32 values (``prng.bits``): the shift is
masked to the low 24 bits, so both give the unsigned word's top 24 bits.
torch's uint32 has no right shift on the CPU, so the streams are never
uint32 here.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["LANE", "DEFAULT_BLOCK_ROWS", "uniform01", "sdm_update_ref",
           "inv_p_f32"]

LANE = 1024
DEFAULT_BLOCK_ROWS = 256

_TWO_PI = 2.0 * math.pi
_INV24 = 1.0 / (1 << 24)


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """Top-24-bit uniform in (0, 1] of 32-bit words (never 0: log-safe)."""
    if bits.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"bit streams must be int32 or int64 holding u32 "
                         f"words, got {bits.dtype}")
    top = torch.bitwise_and(torch.bitwise_right_shift(bits, 8), 0xFFFFFF)
    u = top.to(torch.float32) * _INV24
    return torch.clamp_min(u, _INV24)


def inv_p_f32(p: float) -> float:
    """The f32 rounding of 1/p, the reciprocal taken in double (the
    Pallas kernel's ``d * (1.0 / p)`` with a weakly typed constant)."""
    return float(torch.tensor(1.0 / p, dtype=torch.float32))


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def sdm_update_ref(x: torch.Tensor, s: torch.Tensor, nb_sum: torch.Tensor,
                   g: torch.Tensor, mask_bits: torch.Tensor,
                   n1_bits: torch.Tensor, n2_bits: torch.Tensor, *,
                   p: float, theta: float, gamma: float, sigma: float,
                   clip_c: Optional[float], self_w: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (x_new, s_new, sd), each shaped like ``x`` (f32)."""
    s = s + nb_sum
    if clip_c is not None:
        g = torch.clamp(g, -clip_c, clip_c)
    if sigma > 0.0:
        u1 = uniform01(n1_bits)
        u2 = uniform01(n2_bits)
        gauss = torch.sqrt(torch.log(u1) * -2.0) * torch.cos(u2 * _TWO_PI)
        g = g + gauss * sigma
    y = x * (1.0 - theta) + (x * self_w + s - g * gamma) * theta
    d = y - x
    keep = torch.lt(uniform01(mask_bits), _f32(p, x))
    sd = torch.where(keep, d * inv_p_f32(p), _f32(0.0, x))
    return x + sd, s, sd
