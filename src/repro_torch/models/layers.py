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
                    cache_nodes: int = 1,
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
    causal self-attention, without a cache (a training forward) or with
    one at ``cache_offset`` (the serving steps), the cache in its
    model-axis layout (``convert.shard_cache``): split by KV heads, by
    positions (``cache_nodes`` node blocks a shard under
    ``shard_cache_seq``) or whole. A block whose ``wq`` the divisibility
    fallback left whole runs as without the axis (with a whole cache).
    """
    if model_axis is not None and (_split(params["wq"], 2)
                                   or (cache is not None
                                       and cache.k.dim() == 5)):
        if kv_source is not None or not causal or not use_rope:
            raise NotImplementedError(
                "tensor-parallel attention runs causal self-attention "
                "only; cross-attention and the encoder are not ported "
                "(ROADMAP Queue 1, item 5)")
        if cache is None:
            return _attention_tp(params, cfg, x, positions=positions,
                                 layer_kind=layer_kind, axis=model_axis), None
        if cache_offsets is not None:
            raise NotImplementedError(
                "ragged offsets over a model axis are not ported (ROADMAP "
                "Queue 1, item 5): the serving steps share the scalar "
                "offset")
        if not _split(params["wq"], 2):
            raise NotImplementedError(
                "a model-axis cache beside a whole wq is not ported "
                "(ROADMAP Queue 1, item 5)")
        return _attention_tp_cached(
            params, cfg, x, positions=positions, layer_kind=layer_kind,
            cache=cache, offset=int(cache_offset), axis=model_axis,
            nodes=cache_nodes), cache
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
                     axis) -> torch.Tensor:
    """(L, b, s, kv heads x hd), every shard holding every KV head ->
    (L, b, s, hq x hd): each local shard's copy of the KV head of each of
    its ``hq = n_heads / M`` query heads (GQA group 1 from here on)."""
    hd = cfg.resolved_head_dim
    hq = cfg.n_heads // axis.size
    group = cfg.n_heads // cfg.n_kv_heads
    ids = axis.shard_ids(t.device)
    idx = (ids[:, None] * hq + torch.arange(hq, device=t.device)) // group
    t = t.reshape(tuple(t.shape[:3]) + (cfg.n_kv_heads, hd))
    idx = idx[:, None, None, :, None].expand(
        tuple(t.shape[:3]) + (hq, hd))
    return torch.gather(t, 3, idx).reshape(tuple(t.shape[:3]) + (hq * hd,))


def _tp_project(params, cfg: ModelConfig, x: torch.Tensor, axis):
    """The shards' shared pre-attention stage: the norm, *f*, each
    shard's query heads from its block of ``wq``, (L, b, s, hq hd); K / V
    from each shard's block of ``wk`` / ``wv``, (L, b, s, c), where they
    are split (``kv`` "own": the block is exactly its query heads' KV
    heads, ``n_kv_heads % M == 0``; "gather": columns that cut a head),
    or once from the replicated norm, (b, s, kvh hd), where the
    divisibility fallback left them whole ("whole"). Returns (residual,
    q, k, v, kv)."""
    m = axis.size
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
        kv = "gather" if cfg.n_kv_heads % m else "own"
    else:
        k, v = matmul(h, wk), matmul(h, wv)
        if "bk" in params:
            k, v = k + params["bk"], v + params["bv"]
        kv = "whole"
    return residual, q, k, v, kv


def _tp_out(params, cfg: ModelConfig, out: torch.Tensor,
            residual: torch.Tensor, axis) -> torch.Tensor:
    """Each shard's heads (L, b, s, hq hd) through its rows of ``wo``,
    the all-reduce, ``post_norm`` and the residual add."""
    out = axis.all_reduce(_bmm(out, params["wo"]))
    if cfg.post_block_norm:
        out = rms_norm(out, params["post_norm"], cfg.norm_eps, plus_one=True)
    return residual + out


def _rope_heads(t: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor) -> torch.Tensor:
    """(rows, s, heads x hd) -> (rows, s, heads, hd), rotated."""
    t = t.reshape(tuple(t.shape[:2]) + (-1, cfg.resolved_head_dim))
    if cfg.pos_embedding == "rope":
        t = rope(t, positions, cfg.rope_theta, cfg.rope_fraction)
    return t


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
    n = axis.local
    residual, q, k, v, kv = _tp_project(params, cfg, x, axis)
    if kv == "gather":
        k = _kv_of_own_heads(axis.all_gather(k), cfg, axis)
        v = _kv_of_own_heads(axis.all_gather(v), cfg, axis)
    elif kv == "whole":
        k = _kv_of_own_heads(axis.copy_in(k), cfg, axis)
        v = _kv_of_own_heads(axis.copy_in(v), cfg, axis)
    b, s = x.shape[:2]
    pos = positions.repeat(n, 1)                     # the shards fold into b
    q, k = (_rope_heads(t.reshape(n * b, s, -1), cfg, pos) for t in (q, k))
    v = v.reshape(q.shape[:2] + (-1, cfg.resolved_head_dim))
    window = cfg.sliding_window if layer_kind == "attn_local" else None
    out = _attend(q, k, v, chunk_q=cfg.attn_chunk_q, q_positions=pos,
                  kv_positions=pos, causal=True, window=window,
                  softcap_val=cfg.attn_softcap, kv_valid_len=None)
    return _tp_out(params, cfg, out.reshape(n, b, s, -1), residual, axis)


# ---- with a dense cache (the serving steps) --------------------------------

def _whole_kv(t: torch.Tensor, kv: str, axis) -> torch.Tensor:
    """The new positions' K or V of every KV head, (b, s, kvh hd), from
    ``_tp_project``'s: the shards' blocks all-gathered (one copy of the
    replicated result), or the whole product as it is."""
    return t if kv == "whole" else axis.all_gather(t)[0]


def _attention_tp_cached(params, cfg: ModelConfig, x: torch.Tensor, *,
                         positions: torch.Tensor, layer_kind: str,
                         cache: KVCache, offset: int, axis,
                         nodes: int = 1) -> torch.Tensor:
    """Tensor-parallel attention of the serving steps over a dense cache
    in its model-axis layout: this call's s positions are written at
    ``offset`` and each query attends the cache's valid prefix, as the
    plain path does.

    A cache split by KV heads, (L, b, max_len, kvh / M, hd): each shard
    writes and attends its own KV heads with its own query heads. A
    whole cache, (b, max_len, kvh, hd), held once: the whole K / V
    (all-gathered where ``wk`` is split) are written once and each shard
    reads its query heads' KV heads from it. A cache split by positions,
    (L, b, l, kvh, hd): ``_attention_seq_split``."""
    window = cfg.sliding_window if layer_kind == "attn_local" else None
    residual, q, k, v, kv = _tp_project(params, cfg, x, axis)
    if cache.k.dim() == 5 and cache.k.shape[3] == cfg.n_kv_heads:
        out = _attention_seq_split(cfg, q, k, v, kv, positions=positions,
                                   cache=cache, offset=offset, axis=axis,
                                   nodes=nodes, window=window)
        return _tp_out(params, cfg, out, residual, axis)
    n, hd = axis.local, cfg.resolved_head_dim
    b, s = x.shape[:2]
    pos = positions.repeat(n, 1)
    if cache.k.dim() == 5:                            # split by KV heads
        if kv != "own":
            raise NotImplementedError(
                "a cache split by KV heads needs wk split by whole heads "
                "(ROADMAP Queue 1, item 5)")
        new_k = _rope_heads(k.reshape(n * b, s, -1), cfg, pos)
        cache.k[:, :, offset:offset + s] = new_k.reshape(
            (n, b, s) + tuple(cache.k.shape[3:])).to(cache.k.dtype)
        cache.v[:, :, offset:offset + s] = v.reshape(
            (n, b, s) + tuple(cache.v.shape[3:])).to(cache.v.dtype)
        ck, cv = (c.reshape((n * b,) + tuple(c.shape[2:]))
                  for c in (cache.k, cache.v))
    else:                                             # whole, held once
        cache.k[:, offset:offset + s] = _rope_heads(
            _whole_kv(k, kv, axis), cfg, positions).to(cache.k.dtype)
        cache.v[:, offset:offset + s] = _whole_kv(v, kv, axis).reshape(
            (b, s) + tuple(cache.v.shape[2:])).to(cache.v.dtype)
        length = cache.k.shape[1]
        ck, cv = (_kv_of_own_heads(
            c.reshape(b, length, -1).unsqueeze(0).expand(
                n, b, length, cfg.n_kv_heads * hd), cfg, axis).reshape(
            n * b, length, -1, hd) for c in (cache.k, cache.v))
    q = _rope_heads(q.reshape(n * b, s, -1), cfg, pos)
    length = ck.shape[1]
    kv_pos = torch.arange(length, device=x.device).expand(n * b, length)
    valid = torch.full((n * b,), offset + s, device=x.device)
    out = _attend(q, ck, cv, chunk_q=cfg.attn_chunk_q, q_positions=pos,
                  kv_positions=kv_pos, causal=True, window=window,
                  softcap_val=cfg.attn_softcap, kv_valid_len=valid)
    return _tp_out(params, cfg, out.reshape(n, b, s, -1), residual, axis)


def seq_split_positions(axis, local_len: int, nodes: int,
                        device) -> torch.Tensor:
    """The absolute positions, (L, local_len), of each local shard's
    entries of a cache split by positions: shard i holds, in node order,
    blocks d M + i of max_len / (nodes M) positions each, d over the
    node blocks it holds (all ``nodes`` in a stack; node 0's alone on a
    one-shard axis)."""
    held = nodes if axis.local == axis.size else 1
    blk = local_len // held
    ids = axis.shard_ids(device)
    j = torch.arange(local_len, device=device)
    return ((j // blk) * axis.size + ids[:, None]) * blk + j % blk


def _write_seq_split(c: torch.Tensor, t: torch.Tensor, offset: int, axis,
                     nodes: int) -> None:
    """Write this call's positions [offset, offset + s) of ``t``, (b, s,
    kvh, hd), into the local shards that hold them, (L, b, l, kvh, hd):
    host arithmetic on the Python int offset, one slice a block."""
    s = t.shape[1]
    held = nodes if axis.local == axis.size else 1
    blk = c.shape[2] // held
    p = offset
    while p < offset + s:
        g, r = divmod(p, blk)
        d, i = divmod(g, axis.size)
        end = min(offset + s, (g + 1) * blk)
        if i in axis.held and d < held:
            j = d * blk + r
            c[axis.held.index(i), :, j:j + end - p] = \
                t[:, p - offset:end - offset].to(c.dtype)
        p = end


def _attention_seq_split(cfg: ModelConfig, q, k, v, kv: str, *,
                         positions: torch.Tensor, cache: KVCache,
                         offset: int, axis, nodes: int,
                         window: Optional[int]) -> torch.Tensor:
    """Attention over a cache split by positions (flash decoding). The
    query heads are all-gathered, so every shard holds all of them; the
    new positions' K / V go into the shard that holds them; each shard
    takes its partial softmax over its own positions for every head: the
    max m, the sum l of exp(score - m) and the sum o of exp(score - m) v
    (the probabilities rounded to V's dtype before the product, as the
    plain path rounds its normalised ones). The partials merge by an
    ``all_max`` of m and one ``all_reduce`` of l and o rescaled by
    exp(m - max), packed together. A shard whose positions are all
    masked (beyond the offset, outside the window) has m = ``NEG_INF``
    and weight 0. Under ``shard_cache_seq`` the two collectives span
    ("data", "model"), all N M partials: each is one collective and is
    counted once, on the model axis (a stack merges its N node blocks
    inside its own partial). Returns each shard's heads of the merged
    output, (L, b, s, hq hd), in V's dtype."""
    hd = cfg.resolved_head_dim
    b, s = positions.shape
    kvh = cfg.n_kv_heads
    qf = _rope_heads(axis.all_gather(q)[0], cfg, positions)   # (b, s, h, hd)
    kf = _rope_heads(_whole_kv(k, kv, axis), cfg, positions)
    vf = _whole_kv(v, kv, axis).reshape(b, s, kvh, hd)
    _write_seq_split(cache.k, kf, offset, axis, nodes)
    _write_seq_split(cache.v, vf, offset, axis, nodes)
    ck, cv = cache.k, cache.v                         # (L, b, l, kvh, hd)
    kv_pos = seq_split_positions(axis, ck.shape[2], nodes, ck.device)
    q5 = qf.reshape(b, s, kvh, -1, hd)
    if q5.dtype != ck.dtype:
        q5, ck = promote(q5, ck)
    scores = torch.einsum("bqkgd,lbskd->lbkgqs", q5, ck) / math.sqrt(hd)
    scores = softcap(scores.float(), cfg.attn_softcap)
    kp = kv_pos[:, None, None, :]                     # (L, 1, 1, l)
    qp = positions[None, :, :, None]                  # (1, b, s, 1)
    mask = (kp <= qp) & (kp < offset + s)
    if window is not None:
        mask &= kp > qp - window
    scores = torch.where(mask[:, :, None, None], scores, NEG_INF)
    top = scores.amax(-1, keepdim=True)               # (L, b, kvh, g, s, 1)
    p = torch.exp(scores - top)
    total = p.sum(-1, keepdim=True)
    o = torch.einsum("lbkgqs,lbskd->lbkgqd", p.to(cv.dtype), cv).float()
    w = torch.exp(top - axis.all_max(top))
    merged = axis.all_reduce(torch.cat([o * w, total * w], dim=-1))
    out = (merged[..., :hd] / merged[..., hd:]).to(cv.dtype)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, axis.size, -1)
    return out.index_select(2, axis.shard_ids(out.device)).movedim(2, 0)
