"""Plain version of prefill (flash) attention: dense scores, in torch.

``attention_ref`` is the port of ``repro.kernels.flash_attn.ref.
attention_ref`` over the heads-flattened (bh, s, dh) layout: f32 scores
q.k / sqrt(dh), the optional softcap ``c * tanh(scores / c)``, causal and
sliding-window masks at -1e30, softmax, and the probabilities times v in
f32, cast back to q's dtype. ``flash_attention_ref`` takes the model's
(b, s, h, dh) / (b, s, kv_heads, dh) layout: query head h reads KV head
h // (h / kv_heads), as ``jnp.repeat(k, group, axis=2)`` lays them out.

The CPU tests and the card's comparisons use these; the CUDA kernel
(``kernels/csrc/flash_attn.cu``) never falls back to them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["NEG_INF", "attention_ref", "flash_attention_ref"]

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """q: (bh, sq, dh); k/v: (bh, skv, dh) -> (bh, sq, dh) in q's dtype."""
    _, sq, dh = q.shape
    skv = k.shape[1]
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) \
        / math.sqrt(dh)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    scores = torch.where(mask[None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs, v.float()).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """q: (b, sq, h, dh); k/v: (b, skv, kv_heads, dh) -> (b, sq, h, dh)."""
    b, sq, h, dh = q.shape
    group = h // k.shape[2]
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=2)
        v = torch.repeat_interleave(v, group, dim=2)

    def to_bh(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, t.shape[1], dh)

    out = attention_ref(to_bh(q), to_bh(k), to_bh(v), causal=causal,
                        window=window, softcap=softcap)
    return out.reshape(b, h, sq, dh).permute(0, 2, 1, 3)
