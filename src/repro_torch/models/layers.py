"""Parameter specs and core transformer layers (norms, RoPE, attention, MLP).

Port of ``repro.models.layers``: plain functions over dicts of tensors,
in the JAX package's layouts (fused ``(d_model, heads*head_dim)``
projections, ``(b, s, heads, head_dim)`` activations), so parameters
carry over by renaming only. The single-chip port drops the logical
sharding annotations.

JAX's caches are immutable and rebuilt with ``.at[].set``; here a cache
or page pool is written IN PLACE (the JAX engine donates those buffers
for the same effect).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

__all__ = ["ParamSpec", "rms_norm", "rope", "attention_specs",
           "attention_apply", "attention_decode_paged", "mlp_specs",
           "mlp_apply", "KVCache", "softcap"]

NEG_INF = -1e30


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    init: str = "normal"      # normal | zeros | ones | half
    scale: float = 1.0        # stddev multiplier for normal init


# --------------------------------------------------------------------------
# Elementary ops
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             plus_one: bool = False) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (x32 * w).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 soft capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding on the first ``fraction`` of the head dim.

    x: (b, s, heads, head_dim); positions: (b, s) int. Angles in f32.
    """
    head_dim = x.shape[-1]
    rot = int(head_dim * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(float(theta), exps)
    angles = positions[..., None].float() * freqs          # (b, s, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor  # (b, max_seq, kv_heads, head_dim)
    v: torch.Tensor


def attention_specs(cfg: ModelConfig,
                    cross: bool = False) -> Dict[str, ParamSpec]:
    """A self-attention block's parameters; a cross-attention block
    (``cross``) carries no QKV biases, even under ``cfg.qkv_bias``."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    specs = {
        "wq": ParamSpec((d, h * hd)),
        "wk": ParamSpec((d, kv * hd)),
        "wv": ParamSpec((d, kv * hd)),
        "wo": ParamSpec((h * hd, d)),
        "norm": ParamSpec((d,), "zeros" if cfg.post_block_norm else "ones"),
    }
    if cfg.qkv_bias and not cross:
        specs["bq"] = ParamSpec((h * hd,), "zeros")
        specs["bk"] = ParamSpec((kv * hd,), "zeros")
        specs["bv"] = ParamSpec((kv * hd,), "zeros")
    if cfg.post_block_norm:
        specs["post_norm"] = ParamSpec((d,), "zeros")
    return specs


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          q_positions: torch.Tensor, kv_positions: torch.Tensor,
          causal: bool, window: Optional[int],
          softcap_val: Optional[float],
          kv_valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped-query scaled dot-product attention, written out (the JAX
    package leaves it to XLA, outside any kernel).

    q: (b, sq, h, hd); k/v: (b, skv, kv, hd); positions are absolute
    token indices for masking.
    """
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    group = h // kvh
    q = q.reshape(b, sq, kvh, group, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k) / math.sqrt(hd)
    scores = softcap(scores.float(), softcap_val)

    mask = torch.ones((b, sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_positions[:, None, :] <= q_positions[:, :, None]
    if window is not None:
        mask &= kv_positions[:, None, :] > q_positions[:, :, None] - window
    if kv_valid_len is not None:
        mask &= kv_positions[:, None, :] < kv_valid_len[:, None, None]
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, hd)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_positions: torch.Tensor, chunk: int,
                  **kw) -> torch.Tensor:
    """Query-chunked attention: the (sq, skv) score matrix never
    materializes whole."""
    sq = q.shape[1]
    assert sq % chunk == 0, (sq, chunk)
    outs = [_sdpa(q[:, i:i + chunk], k, v,
                  q_positions=q_positions[:, i:i + chunk], **kw)
            for i in range(0, sq, chunk)]
    return torch.cat(outs, dim=1)


def _attend(q, k, v, *, chunk_q: Optional[int] = None, **kw) -> torch.Tensor:
    sq = q.shape[1]
    if chunk_q is not None and sq > chunk_q and sq % chunk_q == 0:
        return _sdpa_chunked(q, k, v, chunk=chunk_q, **kw)
    return _sdpa(q, k, v, **kw)


def _project_qkv(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                 x: torch.Tensor, *, positions: torch.Tensor,
                 kv_source: Optional[torch.Tensor] = None,
                 use_rope: bool = True):
    """Shared pre-attention stage: norm, fused projections, head split,
    RoPE. Returns (residual, q, k, v) with q: (b, s, h, hd) and
    k/v: (b, skv, kv, hd). Cross-attention (``kv_source``): k/v come
    from the raw ``kv_source`` (not the normed x) and neither q nor k is
    rotated; ``use_rope=False`` also skips RoPE (the encoder)."""
    residual = x
    h = rms_norm(x, params["norm"], cfg.norm_eps,
                 plus_one=cfg.post_block_norm)
    kv_in = kv_source if kv_source is not None else h
    hd = cfg.resolved_head_dim
    q = h @ params["wq"]
    k = kv_in @ params["wk"]
    v = kv_in @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(*q.shape[:2], -1, hd)
    k = k.reshape(*k.shape[:2], -1, hd)
    v = v.reshape(*v.shape[:2], -1, hd)
    if use_rope and kv_source is None and cfg.pos_embedding == "rope":
        q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return residual, q, k, v


def _project_out(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                 out: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """Shared post-attention stage: head merge, output projection,
    optional post-block norm, residual add."""
    out = out.reshape(*out.shape[:2], -1) @ params["wo"]
    if cfg.post_block_norm:
        out = rms_norm(out, params["post_norm"], cfg.norm_eps, plus_one=True)
    return residual + out


def attention_apply(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                    x: torch.Tensor, *,
                    positions: torch.Tensor,
                    layer_kind: str = "attn",
                    cache: Optional[KVCache] = None,
                    cache_offset: Optional[int] = None,
                    cache_offsets: Optional[torch.Tensor] = None,
                    kv_source: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    use_rope: bool = True,
                    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Self- or cross-attention with an optional dense KV cache.

    No cache: full-sequence attention, causal unless ``causal=False``
    (the encoder, which also passes ``use_rope=False``). With ``cache`` +
    ``cache_offset`` (prefill / equal-length decode) this call's k/v are
    written at ``cache_offset``; with ``cache_offsets`` (b,) (ragged
    decode, sq=1) row i writes at its own offset and attends only its
    own ``offsets[i]+1`` valid positions. The cache is written in place
    and returned. Cross-attention (``kv_source``: encoder or image
    states (b, skv, d)): every query sees every key, nothing is cached,
    and no cache comes back.
    """
    residual, q, k, v = _project_qkv(params, cfg, x, positions=positions,
                                     kv_source=kv_source, use_rope=use_rope)
    if kv_source is not None:
        skv = k.shape[1]
        kv_pos = torch.arange(skv, device=x.device).expand(x.shape[0], skv)
        out = _attend(q, k, v, chunk_q=cfg.attn_chunk_q,
                      q_positions=positions, kv_positions=kv_pos,
                      causal=False, window=None,
                      softcap_val=cfg.attn_softcap, kv_valid_len=None)
        return _project_out(params, cfg, out, residual), None
    window = cfg.sliding_window if layer_kind == "attn_local" else None
    kw = dict(chunk_q=cfg.attn_chunk_q, q_positions=positions, causal=True,
              window=window, softcap_val=cfg.attn_softcap)
    if cache is None:
        kw["causal"] = causal
        out = _attend(q, k, v, kv_positions=positions, kv_valid_len=None,
                      **kw)
        return _project_out(params, cfg, out, residual), None

    b, max_seq = cache.k.shape[0], cache.k.shape[1]
    if cache_offsets is not None:
        rows = torch.arange(b, device=x.device)
        cache.k[rows, cache_offsets] = k[:, 0].to(cache.k.dtype)
        cache.v[rows, cache_offsets] = v[:, 0].to(cache.v.dtype)
        valid = cache_offsets + 1
    else:
        s = x.shape[1]
        cache.k[:, cache_offset:cache_offset + s] = k.to(cache.k.dtype)
        cache.v[:, cache_offset:cache_offset + s] = v.to(cache.v.dtype)
        valid = torch.full((b,), cache_offset + s, device=x.device)
    kv_pos = torch.arange(max_seq, device=x.device).expand(b, max_seq)
    out = _attend(q, cache.k, cache.v, kv_positions=kv_pos,
                  kv_valid_len=valid, **kw)
    return _project_out(params, cfg, out, residual), cache


def attention_decode_paged(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                           x: torch.Tensor, *,
                           pages: Tuple[torch.Tensor, torch.Tensor],
                           block_table: torch.Tensor,
                           offsets: torch.Tensor,
                           write_enabled: torch.Tensor,
                           layer_kind: str = "attn",
                           ) -> torch.Tensor:
    """Single-token self-attention over a PAGED KV cache.

    x: (b, 1, d). ``pages`` is this layer's (k_pages, v_pages), each
    (n_pages+1, page_size, kv_heads, head_dim), written IN PLACE;
    ``block_table`` (b, n_blocks) int32 maps row b's logical block j to
    a physical page; ``offsets`` (b,) int32 is each row's next write
    position; ``write_enabled`` (b,) bool routes finished / empty rows'
    writes to the trash page 0 (see ``repro_torch.serving.kv_cache``).
    Attention goes through ``kernels.flash_attn.decode.paged_attention``:
    the CUDA kernel for CUDA tensors, its plain version on the CPU.
    """
    from repro_torch.kernels.flash_attn.decode import paged_attention

    b = x.shape[0]
    residual, q, k, v = _project_qkv(params, cfg, x,
                                     positions=offsets[:, None])
    k_pages, v_pages = pages
    page = k_pages.shape[1]
    rows = torch.arange(b, device=x.device)
    blk = torch.clamp(offsets // page, 0, block_table.shape[1] - 1)
    zero = torch.zeros_like(offsets)
    page_id = torch.where(write_enabled, block_table[rows, blk], zero)
    in_page = torch.where(write_enabled, offsets % page, zero)
    k_pages[page_id, in_page] = k[:, 0].to(k_pages.dtype)
    v_pages[page_id, in_page] = v[:, 0].to(v_pages.dtype)

    # a row that did not write must not read its (absent) current token
    seq_lens = offsets + write_enabled.to(offsets.dtype)
    window = cfg.sliding_window if layer_kind == "attn_local" else None
    out = paged_attention(q[:, 0], k_pages, v_pages, block_table, seq_lens,
                          window=window, softcap=cfg.attn_softcap)
    return _project_out(params, cfg, out[:, None], residual)


# --------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / plain)
# --------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    specs = {
        "w_up": ParamSpec((d, f)),
        "w_down": ParamSpec((f, d)),
        "norm": ParamSpec((d,), "zeros" if cfg.post_block_norm else "ones"),
    }
    if cfg.glu:
        specs["w_gate"] = ParamSpec((d, f))
    if cfg.post_block_norm:
        specs["post_norm"] = ParamSpec((d,), "zeros")
    return specs


def _activation(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act == "gelu":
        # jax.nn.gelu(approximate=True) is the tanh form
        return F.gelu(x, approximate="tanh")
    raise ValueError(act)


def mlp_apply(params: Dict[str, torch.Tensor], cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    residual = x
    h = rms_norm(x, params["norm"], cfg.norm_eps, plus_one=cfg.post_block_norm)
    up = h @ params["w_up"]
    if cfg.glu:
        up = _activation(h @ params["w_gate"], cfg.act) * up
    else:
        up = _activation(up, cfg.act)
    out = up @ params["w_down"]
    if cfg.post_block_norm:
        out = rms_norm(out, params["post_norm"], cfg.norm_eps, plus_one=True)
    return residual + out
