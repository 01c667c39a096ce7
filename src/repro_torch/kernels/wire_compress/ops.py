"""Entry point of the fused QSGD quantize-and-pack kernel.

Port of ``repro.kernels.wire_compress.ops.qsgd_pack``. The caller draws
the stochastic-rounding uniforms at the canonical plane shape and passes
each node's raw l2 norm; this wrapper derives ``inv = s / max(norm,
1e-30)`` exactly as the unfused compressor does (a true f32 division)
and then:

* for CUDA tensors launches the hand-written Hopper kernel
  ``kernels/csrc/wire_compress.cu`` (which replaces the TPU kernel
  ``qsgd_pack_pallas``) once over the whole node stack, or raises -- it
  never falls back;
* for CPU tensors runs the plain version ``qsgd_quantize_pack_ref``.

``qsgd_pack.launches`` counts kernel launches (the plain version never
adds to it). Any contiguous f32 length is taken: the kernel packs in
row-major order and fills a ragged last byte itself, so the JAX
wrapper's branch that sends odd shapes to the oracle has no counterpart.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import levels, pack_factor, qsgd_quantize_pack_ref

__all__ = ["qsgd_pack", "qsgd_inv"]

_BITS = (2, 4, 8)


def qsgd_inv(norm: torch.Tensor, bits: int) -> torch.Tensor:
    """s / max(norm, 1e-30) in f32 -- the unfused compressor's scale."""
    norm = norm.to(torch.float32)
    s = torch.tensor(float(levels(bits)), device=norm.device)
    return torch.div(s, torch.maximum(
        norm, torch.tensor(1e-30, dtype=torch.float32, device=norm.device)))


def qsgd_pack(xf: torch.Tensor, u: torch.Tensor, norm: torch.Tensor, *,
              bits: int) -> torch.Tensor:
    """Per-node f32 values + uniforms + l2 norms -> packed u8 bytes.

    ``norm`` has the batch shape (() for one node, (n,) for a node
    stack); ``xf`` and ``u`` are (*norm.shape, ...) f32. Returns
    (*norm.shape, ceil(d / k)) u8 with d the per-node element count and
    k = 8/bits (1 for bits 8).
    """
    if bits not in _BITS:
        raise ValueError(f"qsgd_pack: bits must be one of {_BITS}, got {bits}")
    if tuple(u.shape) != tuple(xf.shape):
        raise ValueError(f"uniforms {tuple(u.shape)} do not match values "
                         f"{tuple(xf.shape)}")
    if tuple(xf.shape[:norm.dim()]) != tuple(norm.shape):
        raise ValueError(f"norm {tuple(norm.shape)} is not the leading "
                         f"(batch) shape of {tuple(xf.shape)}")
    inv = qsgd_inv(norm, bits)
    if xf.device.type == "cpu":
        return qsgd_quantize_pack_ref(xf.to(torch.float32), u, inv,
                                      bits=bits)
    if xf.device.type != "cuda":
        raise ValueError(f"qsgd_pack: unsupported device {xf.device}")
    return _qsgd_pack_cuda(xf, u, inv, bits=bits)


qsgd_pack.launches = 0


def _kernel_fn():
    from repro_torch.kernels._build import load_library

    fn = load_library("wire_compress").qsgd_pack
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, ll, ll, ll, i, p]
        fn.restype = ctypes.c_int
    return fn


def _qsgd_pack_cuda(xf, u, inv, *, bits) -> torch.Tensor:
    if xf.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"qsgd_pack: values and uniforms must be float32, "
                         f"got {xf.dtype} and {u.dtype}")
    if any(t.device != xf.device for t in (u, inv)):
        raise ValueError("qsgd_pack: all inputs must be on one device")
    if not (xf.is_contiguous() and u.is_contiguous()):
        raise ValueError("qsgd_pack: values and uniforms must be contiguous")
    batch = tuple(inv.shape)
    n = inv.numel()
    d = xf.numel() // n if n else 0
    nbytes = -(-d // pack_factor(bits))
    out = torch.empty(batch + (nbytes,), dtype=torch.uint8, device=xf.device)
    if out.numel() == 0:
        return out
    inv = inv.contiguous()
    fn = _kernel_fn()
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        rc = fn(xf.data_ptr(), u.data_ptr(), inv.data_ptr(), out.data_ptr(),
                n, d, nbytes, bits, stream)
    if rc != 0:
        raise RuntimeError(f"qsgd_pack kernel launch failed: CUDA error {rc}")
    qsgd_pack.launches += 1
    return out
