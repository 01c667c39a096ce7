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

__all__ = ["ParamSpec", "axes_of", "shapes_of", "rms_norm", "rope",
           "attention_specs", "attention_apply", "attention_decode_paged",
           "mlp_specs", "mlp_apply", "KVCache", "softcap"]

NEG_INF = -1e30


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names (sharding.py)
    init: str = "normal"      # normal | zeros | ones | half
    scale: float = 1.0        # stddev multiplier for normal init


def _spec_map(fn, specs):
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: _spec_map(fn, v) for k, v in specs.items()}


def axes_of(specs) -> Dict:
    """The logical-axes tree of a (nested dict) spec tree."""
    return _spec_map(lambda s: s.axes, specs)


def shapes_of(specs) -> Dict:
    """The shapes tree of a (nested dict) spec tree."""
    return _spec_map(lambda s: s.shape, specs)


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


def promote(*xs: torch.Tensor):
    """The operands of a product in their common dtype, as ``jnp``
    promotes them (an f32 context against bf16 weights gives f32; a
    torch matmul refuses mixed dtypes)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x if x.dtype == dt else x.to(dt) for x in xs)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the operands' promoted dtype."""
    if x.dtype != w.dtype:
        x, w = promote(x, w)
    return x @ w


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
        "wq": ParamSpec((d, h * hd), ("embed", "heads_flat")),
        "wk": ParamSpec((d, kv * hd), ("embed", "kv_flat")),
        "wv": ParamSpec((d, kv * hd), ("embed", "kv_flat")),
        "wo": ParamSpec((h * hd, d), ("heads_flat", "embed")),
        "norm": ParamSpec((d,), ("embed",),
                          "zeros" if cfg.post_block_norm else "ones"),
    }
    if cfg.qkv_bias and not cross:
        specs["bq"] = ParamSpec((h * hd,), ("heads_flat",), "zeros")
        specs["bk"] = ParamSpec((kv * hd,), ("kv_flat",), "zeros")
        specs["bv"] = ParamSpec((kv * hd,), ("kv_flat",), "zeros")
    if cfg.post_block_norm:
        specs["post_norm"] = ParamSpec((d,), ("embed",), "zeros")
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
    if q.dtype != k.dtype:
        q, k = promote(q, k)
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
    q = matmul(h, params["wq"])
    k = matmul(kv_in, params["wk"])
    v = matmul(kv_in, params["wv"])
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
    out = matmul(out.reshape(*out.shape[:2], -1), params["wo"])
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
                    model_axis=None,
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

    ``model_axis`` (``core/model_axis``) with ``params`` in the
    model-axis layout (``convert.shard_params``): the tensor-parallel
    self-attention of a training forward (no cache); a block whose
    ``wq`` the divisibility fallback left whole runs as without it.
    """
    if model_axis is not None and _split(params["wq"], 2):
        if cache is not None or kv_source is not None or not causal \
                or not use_rope:
            raise NotImplementedError(
                "tensor-parallel attention runs the causal self-attention "
                "of a training forward only; caches (prefill / decode), "
                "cross-attention and the encoder are not ported (ROADMAP "
                "Queue 1, item 5)")
        return _attention_tp(params, cfg, x, positions=positions,
                             layer_kind=layer_kind, axis=model_axis), None
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
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
        "norm": ParamSpec((d,), ("embed",),
                          "zeros" if cfg.post_block_norm else "ones"),
    }
    if cfg.glu:
        specs["w_gate"] = ParamSpec((d, f), ("embed", "mlp"))
    if cfg.post_block_norm:
        specs["post_norm"] = ParamSpec((d,), ("embed",), "zeros")
    return specs


def _activation(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act == "gelu":
        # jax.nn.gelu(approximate=True) is the tanh form
        return F.gelu(x, approximate="tanh")
    raise ValueError(act)


def mlp_apply(params: Dict[str, torch.Tensor], cfg: ModelConfig,
              x: torch.Tensor, model_axis=None) -> torch.Tensor:
    """The feed-forward sub-block. With ``model_axis`` and ``params`` in
    the model-axis layout: ``w_up`` / ``w_gate`` split by columns,
    ``w_down`` by rows, then the all-reduce (Megatron's MLP)."""
    tp = model_axis is not None and _split(params["w_up"], 2)
    mm = _bmm if tp else matmul
    residual = x
    h = rms_norm(x, params["norm"], cfg.norm_eps, plus_one=cfg.post_block_norm)
    if tp:
        h = model_axis.copy_in(h)
    up = mm(h, params["w_up"])
    if cfg.glu:
        up = _activation(mm(h, params["w_gate"]), cfg.act) * up
    else:
        up = _activation(up, cfg.act)
    out = mm(up, params["w_down"])
    if tp:
        out = model_axis.all_reduce(out)
    if cfg.post_block_norm:
        out = rms_norm(out, params["post_norm"], cfg.norm_eps, plus_one=True)
    return residual + out


# --------------------------------------------------------------------------
# Tensor parallelism over the model axis (training forward)
# --------------------------------------------------------------------------
#
# ``params`` come in the model-axis layout (``convert.shard_params``): a
# leaf JAX's rules split over ``model`` is (M,) + its shard, each shard
# the contiguous block of the split dimension that ``NamedSharding``
# gives that device; a leaf the divisibility fallback replicates stays
# whole. Sharded activations are (M, ...) stacks, replicated ones are
# held once (``core/model_axis``). Every product of a split weight is a
# batched matmul over the shards, each shard with its own block.

def _split(w: torch.Tensor, ndim: int) -> bool:
    """Whether a leaf of ``ndim`` dimensions (per layer) is in the
    model-axis layout (a leading shard dimension)."""
    return w.dim() == ndim + 1


def _bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each shard's product: x (M, ..., k) @ w (M, k, n) -> (M, ..., n)."""
    if x.dtype != w.dtype:
        x, w = promote(x, w)
    m = x.shape[0]
    out = torch.bmm(x.reshape(m, -1, x.shape[-1]), w)
    return out.reshape(tuple(x.shape[:-1]) + (w.shape[-1],))


def _kv_of_own_heads(t: torch.Tensor, cfg: ModelConfig,
                     m: int) -> torch.Tensor:
    """(M, b, s, kv heads x hd), every shard holding every KV head ->
    (M, b, s, hq x hd): shard i's copy of the KV head of each of its
    ``hq = n_heads / M`` query heads (GQA group 1 from here on)."""
    hd = cfg.resolved_head_dim
    hq = cfg.n_heads // m
    group = cfg.n_heads // cfg.n_kv_heads
    idx = (torch.arange(m * hq, device=t.device) // group).reshape(m, hq)
    t = t.reshape(tuple(t.shape[:3]) + (cfg.n_kv_heads, hd))
    idx = idx[:, None, None, :, None].expand(
        tuple(t.shape[:3]) + (hq, hd))
    return torch.gather(t, 3, idx).reshape(tuple(t.shape[:3]) + (hq * hd,))


def _attention_tp(params, cfg: ModelConfig, x: torch.Tensor, *,
                  positions: torch.Tensor, layer_kind: str, axis):
    """Megatron's attention: the input copied into the shards, each
    shard's query heads from its block of ``wq`` (heads split whole,
    GQA groups kept), its output through its rows of ``wo``, the partial
    sums all-reduced before ``post_norm`` and the residual add. K / V:
    from the shard's own block of ``wk`` / ``wv`` where it holds exactly
    its query heads' KV heads (``n_kv_heads % M == 0``); otherwise every
    shard gathers the whole K / V (split ``wk``: all-gathered from the
    blocks; ``wk`` left whole: computed once, copied in) and takes its
    query heads' KV heads."""
    m, hd = axis.size, cfg.resolved_head_dim
    if cfg.n_heads % m:
        raise NotImplementedError(
            f"{cfg.n_heads} query heads do not split whole over a model "
            f"axis of {m} (JAX's GSPMD splits inside a head): not ported "
            "(ROADMAP Queue 1, item 5)")
    residual = x
    h = rms_norm(x, params["norm"], cfg.norm_eps,
                 plus_one=cfg.post_block_norm)
    hs = axis.copy_in(h)
    q = _bmm(hs, params["wq"])
    if "bq" in params:
        q = q + params["bq"][:, None, None]
    wk, wv = params["wk"], params["wv"]
    if _split(wk, 2):
        k, v = _bmm(hs, wk), _bmm(hs, wv)
        if "bk" in params:
            k = k + params["bk"][:, None, None]
            v = v + params["bv"][:, None, None]
        if cfg.n_kv_heads % m:
            k = _kv_of_own_heads(axis.all_gather(k), cfg, m)
            v = _kv_of_own_heads(axis.all_gather(v), cfg, m)
    else:
        k, v = matmul(h, wk), matmul(h, wv)
        if "bk" in params:
            k, v = k + params["bk"], v + params["bv"]
        k = _kv_of_own_heads(axis.copy_in(k), cfg, m)
        v = _kv_of_own_heads(axis.copy_in(v), cfg, m)
    b, s = x.shape[:2]
    q, k, v = (t.reshape(m * b, s, -1, hd) for t in (q, k, v))
    pos = positions.repeat(m, 1)                     # the shards fold into b
    if cfg.pos_embedding == "rope":
        q = rope(q, pos, cfg.rope_theta, cfg.rope_fraction)
        k = rope(k, pos, cfg.rope_theta, cfg.rope_fraction)
    window = cfg.sliding_window if layer_kind == "attn_local" else None
    out = _attend(q, k, v, chunk_q=cfg.attn_chunk_q, q_positions=pos,
                  kv_positions=pos, causal=True, window=window,
                  softcap_val=cfg.attn_softcap, kv_valid_len=None)
    out = axis.all_reduce(_bmm(out.reshape(m, b, s, -1), params["wo"]))
    if cfg.post_block_norm:
        out = rms_norm(out, params["post_norm"], cfg.norm_eps, plus_one=True)
    return residual + out
