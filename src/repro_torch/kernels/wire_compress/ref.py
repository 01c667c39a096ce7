"""Plain PyTorch versions of the fused wire-compressor kernels.

Port of ``repro.kernels.wire_compress.ref``. ``qsgd_quantize_pack_ref``
repeats the CUDA kernel's arithmetic op for op (``|x| * inv``, floor,
stochastic carry, clamp, sign, offset-encode, sub-byte pack);
``fixedk_gather_pack_ref`` is the fixed-k sender pack (a row gather and
one f32 multiply). The CPU tests hold them against the JAX kernels and
``chip_smoke.py`` holds the CUDA kernels against them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["pack_factor", "levels", "qsgd_quantize_pack_ref",
           "qsgd_decode_ref", "norm_from_tail", "fixedk_gather_pack_ref",
           "f32_scale"]


def pack_factor(bits: int) -> int:
    """Levels per u8 wire byte: 8/bits for sub-byte widths, else 1."""
    return 8 // bits if bits in (2, 4) else 1


def levels(bits: int) -> int:
    """QSGD magnitude levels s = 2^(bits-1) - 1."""
    return 2 ** (bits - 1) - 1


def qsgd_quantize_pack_ref(xf: torch.Tensor, u: torch.Tensor,
                           inv: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Quantize + offset-encode + sub-byte pack, per node.

    ``inv`` holds the pre-computed ``s / max(norm, 1e-30)`` of each node
    (shape = the batch shape, () for one node); ``xf`` and ``u`` are
    (*inv.shape, ...) f32. Returns (*inv.shape, n_bytes) u8: each node's
    offset-encoded levels (q + s, in [0, 2s]) in row-major order, k =
    8/bits per byte (element j of a group in bits [j*bits, (j+1)*bits)),
    a ragged last byte filled with encoded value 0, as the JAX oracle
    pads.
    """
    s = levels(bits)
    batch = tuple(inv.shape)
    ratio = torch.abs(xf) * inv.reshape(batch + (1,) * (xf.dim() - len(batch)))
    level = torch.floor(ratio)
    level = level + (u < (ratio - level)).to(level.dtype)
    q = (torch.sign(xf) * torch.clamp(level, max=float(s))).to(torch.int32)
    off = (q + s).reshape(batch + (-1,))
    k = pack_factor(bits)
    if k == 1:
        return off.to(torch.uint8)
    pad = (-off.shape[-1]) % k
    if pad:
        off = torch.nn.functional.pad(off, (0, pad))
    groups = off.reshape(batch + (-1, k))
    byte = torch.zeros(groups.shape[:-1], dtype=torch.int32,
                       device=xf.device)
    for j in range(k):
        byte = byte | (groups[..., j] << (j * bits))
    return byte.to(torch.uint8)


def norm_from_tail(buf: torch.Tensor) -> torch.Tensor:
    """The f32 norm(s) in the last 4 (little-endian) bytes of each
    payload row: (*batch, n) u8 -> (*batch,) f32."""
    tail = buf[..., -4:].reshape(-1, 4).clone(
        memory_format=torch.contiguous_format)
    return tail.view(torch.float32).reshape(tuple(buf.shape[:-1]))


def qsgd_decode_ref(buf: torch.Tensor, shape, *, bits: int) -> torch.Tensor:
    """Decode one node's fused payload (packed bytes + 4 little-endian
    norm bytes) back to f32 of ``shape``."""
    s = levels(bits)
    d = math.prod(shape)
    k = pack_factor(bits)
    norm = norm_from_tail(buf)
    data = buf[:-4].to(torch.int32)
    if k == 1:
        flat = data[:d] - s
    else:
        mask = (1 << bits) - 1
        parts = [(data >> (j * bits)) & mask for j in range(k)]
        flat = torch.stack(parts, dim=1).reshape(-1)[:d] - s
    # a true division, as the (eager) JAX oracle computes it
    scale = torch.div(norm, torch.tensor(float(s), device=buf.device))
    return scale * flat.reshape(shape).to(torch.float32)


def f32_scale(scale: float) -> torch.Tensor:
    """The f32 rounding of a Python scale, as JAX multiplies by a weakly
    typed constant (a 0-d CPU tensor: it broadcasts onto any device)."""
    return torch.tensor(float(np.float32(scale)), dtype=torch.float32)


def fixedk_gather_pack_ref(db: torch.Tensor, idx: torch.Tensor, *,
                           scale: float) -> torch.Tensor:
    """The sender-side fixed-k pack: rows ``idx`` of each node's block
    view times f32(scale). db (*batch, nb, block), idx (*batch, kb) ->
    (*batch, kb, block)."""
    rows = torch.gather(db, -2, idx.long().unsqueeze(-1).expand(
        tuple(idx.shape) + (db.shape[-1],)))
    return rows * f32_scale(scale)
