"""Entry points of the wire-compressor kernels.

``fixedk_gather_pack`` (port of ``repro.kernels.wire_compress.ops.
fixedk_gather_pack``) is the sender-side pack of the ``fixedk_packed``
exchange: rows ``idx`` of each node's (nb, block) plane view times the
f32 rounding of the static scale nb/kb, bit-exact with ``jnp.take(db,
idx, 0) * scale``. For CUDA tensors it launches the hand-written kernel
in ``kernels/csrc/wire_compress.cu`` (which replaces the TPU kernel
``fixedk_gather_pack_pallas``) once over the whole node block, or
raises; for CPU tensors it runs ``fixedk_gather_pack_ref``.
``fixedk_gather_pack.launches`` counts kernel launches.

On ``meta`` tensors (the dry-run) both wrappers add the kernel's
``kernels/cost.py`` count to the open ``cost.KernelTally`` and return
empty meta outputs of the kernel's shape and dtype; any other device
raises.

The CUDA body of each kernel is the custom op ``repro_torch::qsgd_pack``
/ ``repro_torch::fixedk_gather_pack`` (with a fake impl, which also
serves ``meta``): a trace of the step (``make_fx``, the static auditor)
records each launch as one node with its inputs, and a wrapper's
``.launches`` moves only where the CUDA body runs.

``qsgd_pack`` (port of ``repro.kernels.wire_compress.ops.qsgd_pack``)
is the fused QSGD quantize-and-pack. The caller draws
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

from repro_torch.core.tagging import define_op
from repro_torch.kernels import cost

from .ref import (f32_scale, fixedk_gather_pack_ref, levels, pack_factor,
                  qsgd_quantize_pack_ref)

__all__ = ["qsgd_pack", "qsgd_inv", "fixedk_gather_pack"]

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
    if xf.device.type not in ("cpu", "meta", "cuda"):
        raise ValueError(f"qsgd_pack: unsupported device {xf.device}")
    inv = qsgd_inv(norm, bits)
    if xf.device.type == "cpu":
        return qsgd_quantize_pack_ref(xf.to(torch.float32), u, inv,
                                      bits=bits)
    if xf.device.type == "meta":
        n = inv.numel()
        d = xf.numel() // n if n else 0
        cost.charge("qsgd_pack", cost.qsgd_pack(n, d, bits))
    return torch.ops.repro_torch.qsgd_pack(xf, u, inv, bits)


qsgd_pack.launches = 0


def _qsgd_pack_op(xf: torch.Tensor, u: torch.Tensor, inv: torch.Tensor,
                  bits: int) -> torch.Tensor:
    return _qsgd_pack_cuda(xf, u, inv, bits=bits)


def _qsgd_pack_fake(xf, u, inv, bits):
    n = inv.numel()
    d = xf.numel() // n if n else 0
    return xf.new_empty(tuple(inv.shape) + (-(-d // pack_factor(bits)),),
                        dtype=torch.uint8)


def _kernel_fn(name: str = "qsgd_pack"):
    from repro_torch.kernels._build import load_library

    fn = getattr(load_library("wire_compress"), name)
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = {
            "qsgd_pack": [p, p, p, p, ll, ll, ll, i, p],
            "fixedk_gather_pack": [p, p, p, ll, ll, ll, ll, ctypes.c_float,
                                   p],
        }[name]
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


def fixedk_gather_pack(db: torch.Tensor, idx: torch.Tensor, *,
                       scale: float) -> torch.Tensor:
    """Rows ``idx`` of each node's block view, times f32(scale).

    ``db`` (*batch, nb, block) f32, ``idx`` (*batch, kb) int32 with
    entries in [0, nb) (``fixedk_indices`` draws them; on the card an
    index out of range gives a NaN row, never a read out of bounds);
    returns (*batch, kb, block) f32.
    """
    if db.dim() < 2 or tuple(idx.shape[:-1]) != tuple(db.shape[:-2]):
        raise ValueError(f"indices {tuple(idx.shape)} do not batch the "
                         f"block view {tuple(db.shape)}")
    if db.device.type == "cpu":
        return fixedk_gather_pack_ref(db, idx, scale=scale)
    if db.device.type == "meta":
        kb, block = idx.shape[-1], db.shape[-1]
        cost.charge("fixedk_gather_pack", cost.fixedk_gather_pack(
            idx.numel() // kb if kb else 0, kb, block))
    elif db.device.type != "cuda":
        raise ValueError(f"fixedk_gather_pack: unsupported device "
                         f"{db.device}")
    return torch.ops.repro_torch.fixedk_gather_pack(db, idx, float(scale))


fixedk_gather_pack.launches = 0


def _fixedk_gather_pack_op(db: torch.Tensor, idx: torch.Tensor,
                           scale: float) -> torch.Tensor:
    return _fixedk_gather_pack_cuda(db, idx, scale=scale)


def _fixedk_gather_pack_fake(db, idx, scale):
    return db.new_empty(tuple(idx.shape) + (db.shape[-1],),
                        dtype=torch.float32)


define_op("qsgd_pack", _qsgd_pack_op, _qsgd_pack_fake, device_types="cuda")
define_op("fixedk_gather_pack", _fixedk_gather_pack_op,
          _fixedk_gather_pack_fake, device_types="cuda")


def _fixedk_gather_pack_cuda(db, idx, *, scale: float) -> torch.Tensor:
    if db.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(f"fixedk_gather_pack: takes float32 values and "
                         f"int32 indices, got {db.dtype} and {idx.dtype}")
    if idx.device != db.device:
        raise ValueError("fixedk_gather_pack: values and indices must be on "
                         "one device")
    if not (db.is_contiguous() and idx.is_contiguous()):
        raise ValueError("fixedk_gather_pack: inputs must be contiguous")
    nb, block = db.shape[-2], db.shape[-1]
    kb = idx.shape[-1]
    n = idx.numel() // kb if kb else 0
    out = torch.empty(tuple(idx.shape) + (block,), dtype=torch.float32,
                      device=db.device)
    if out.numel() == 0:
        return out
    fn = _kernel_fn("fixedk_gather_pack")
    with torch.cuda.device(db.device):
        stream = torch.cuda.current_stream(db.device).cuda_stream
        rc = fn(db.data_ptr(), idx.data_ptr(), out.data_ptr(), n, nb, block,
                kb, float(f32_scale(scale)), stream)
    if rc != 0:
        raise RuntimeError(f"fixedk_gather_pack kernel launch failed: CUDA "
                           f"error {rc}")
    fixedk_gather_pack.launches += 1
    return out
