"""Entry point of prefill (flash) attention.

``flash_attention`` (port of ``repro.kernels.flash_attn.ops.
flash_attention``) takes the model's (b, sq, h, dh) queries and
(b, skv, kv_heads, dh) keys and values (GQA: query head h reads KV head
h // group, nothing repeated in memory):

* for CUDA tensors it launches the hand-written Hopper kernel
  ``kernels/csrc/flash_attn.cu`` (which replaces the TPU kernel
  ``flash_attention_pallas``), or raises -- it never falls back;
* for CPU tensors it runs the plain version ``ref.flash_attention_ref``;
* for ``meta`` tensors (the dry-run) it returns an empty meta output and
  adds the kernel's ``kernels/cost.py`` count to the open
  ``cost.KernelTally``; any other device raises.

``flash_attention.launches`` counts kernel launches. The JAX wrapper's
``use_kernel`` / ``interpret`` switches, its head_dim padding to the
TPU's 128 lanes and the ``scale_fix`` that padding needs have no
counterpart: the kernel takes head_dim 32, 64, 128 or 256 as it is, with
scale 1/sqrt(dh). ``block_q`` keeps the JAX kernel's precondition
``sq % block_q == 0``; the CUDA kernel tiles queries and keys on its
own (bf16 on the tensor cores: 64 query rows, 64 keys or 32 at dh 256;
f32 on the FP32 pipes: 64 x 64) and masks ragged edges, so ``block_k``
only has to be positive.
A query row that can see no key (skv = 0, or a window that ends before
the keys start) has no defined output and is refused.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import cost

from .ref import flash_attention_ref

__all__ = ["flash_attention", "HEAD_DIMS"]

HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, *, window, block_q, block_k) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (b, sq, h, dh), k/v (b, skv, "
                         f"kv_heads, dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must be on one device")
    if block_q < 1 or block_k < 1 or sq % block_q:
        raise ValueError(f"flash_attention: sq {sq} must be a multiple of "
                         f"block_q {block_q} (block_k {block_k} > 0)")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    skv = k.shape[1]
    # row q sees keys [max(0, q - window + 1), skv) (capped at q if causal)
    if skv == 0 or (window is not None and sq - 1 - window >= skv - 1):
        raise ValueError(f"flash_attention: some query row sees no key "
                         f"(sq {sq}, skv {skv}, window {window})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q: (b, sq, h, dh); k/v: (b, skv, kv_heads, dh) -> (b, sq, h, dh)
    in q's dtype."""
    _check(q, k, v, window=window, block_q=block_q, block_k=block_k)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type == "meta":
        b, sq, h, dh = q.shape
        cost.charge("flash_attn", cost.flash_attn(
            b, sq, k.shape[1], h, k.shape[2], dh, causal=causal,
            window=window, elt_bytes=q.element_size()))
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _flash_cuda(q, k, v, causal=causal, window=window,
                       softcap=softcap)


flash_attention.launches = 0


def _kernel_fn():
    from repro_torch.kernels._build import load_library

    fn = load_library("flash_attn").flash_attn_fwd
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, f, f, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _flash_cuda(q, k, v, *, causal, window, softcap) -> torch.Tensor:
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dh}; the kernel takes "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes q {q.dtype}, k {k.dtype}, "
                         f"v {v.dtype}; the kernel takes one of "
                         f"{list(_DTYPES)} for all three")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, sq, skv, h, kvh, dh, 1.0 / math.sqrt(dh),
                0.0 if softcap is None else float(softcap), int(causal),
                0 if window is None else int(window), _DTYPES[q.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out
