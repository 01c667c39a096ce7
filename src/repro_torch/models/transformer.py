"""Model composition: embeddings + layer periods + heads.

Port of ``repro.models.transformer`` for the attention + MLP layer slots
(dense decoder LMs such as gemma2). The parameter tree keeps the JAX
layout -- ``embed``, ``final_norm``, ``blocks/<slot>/{attn,mlp}/...``
with every block leaf stacked over a leading ``n_periods`` axis -- so a
JAX checkpoint carries over by renaming only (``repro_torch.convert``).
A Python loop over periods replaces ``lax.scan``.

Not yet ported (they raise ``NotImplementedError``): MoE, mamba and
rwkv slots, cross-attention, encoders and learned position embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (KVCache, ParamSpec, attention_apply,
                                       attention_decode_paged,
                                       attention_specs, mlp_apply, mlp_specs,
                                       rms_norm, softcap)

__all__ = ["model_specs", "param_shapes", "flat_specs", "init_params",
           "init_cache", "prefill", "decode_step", "decode_step_paged",
           "Cache", "period_params"]

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# Parameter specs
# --------------------------------------------------------------------------

def _check_supported(cfg: ModelConfig) -> None:
    for spec in cfg.period:
        if spec.mixer not in ("attn", "attn_local"):
            raise NotImplementedError(
                f"{cfg.name}: {spec.mixer!r} layers are not yet ported")
        if spec.ffn != "mlp":
            raise NotImplementedError(
                f"{cfg.name}: {spec.ffn!r} feed-forward is not yet ported")
        if spec.cross_attn:
            raise NotImplementedError(
                f"{cfg.name}: cross-attention is not yet ported")
    if cfg.has_encoder:
        raise NotImplementedError(f"{cfg.name}: encoders are not yet ported")
    if cfg.pos_embedding == "learned":
        raise NotImplementedError(
            f"{cfg.name}: learned position embeddings are not yet ported")


def _stack(specs: Dict[str, ParamSpec], n: int) -> Dict[str, ParamSpec]:
    return {k: ParamSpec((n,) + s.shape, s.init, s.scale)
            for k, s in specs.items()}


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _check_supported(cfg)
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.padded_vocab, d)),
        "final_norm": ParamSpec((d,), "ones"),
        "blocks": {
            str(i): {"attn": _stack(attention_specs(cfg), cfg.n_periods),
                     "mlp": _stack(mlp_specs(cfg), cfg.n_periods)}
            for i in range(len(cfg.period))
        },
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, cfg.padded_vocab))
    return specs


def flat_specs(cfg: ModelConfig) -> List[Tuple[str, ParamSpec]]:
    """('/'-joined key, spec) pairs in the JAX package's flatten order
    (dict keys sorted at every level) -- the keys its checkpoints use."""
    out: List[Tuple[str, ParamSpec]] = []

    def walk(prefix: str, node) -> None:
        if isinstance(node, ParamSpec):
            out.append((prefix, node))
            return
        for k in sorted(node):
            walk(f"{prefix}/{k}" if prefix else k, node[k])

    walk("", model_specs(cfg))
    return out


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    return {k: s.shape for k, s in flat_specs(cfg)}


def unflatten(flat: Dict[str, torch.Tensor]) -> Params:
    """{'a/b/c': t} -> {'a': {'b': {'c': t}}}."""
    tree: Params = {}
    for key, val in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def init_params(cfg: ModelConfig, *, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device="cuda") -> Params:
    """The JAX ``init_tree`` rule: normal leaves have std
    ``scale / sqrt(shape[-2])`` (``shape[-1]`` for 1-D), the others are
    zeros or ones. Drawn from a ``torch.Generator`` seeded with ``seed``
    on the target device, so the values differ from JAX's for the same
    seed (tests carry JAX's tree over with ``convert.params_from_jax``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = {}
    for key, s in flat_specs(cfg):
        if s.init == "zeros":
            flat[key] = torch.zeros(s.shape, dtype=dtype, device=dev)
        elif s.init == "ones":
            flat[key] = torch.ones(s.shape, dtype=dtype, device=dev)
        else:
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = s.scale / max(fan_in, 1) ** 0.5
            w = torch.randn(s.shape, generator=gen, device=dev)
            flat[key] = (w.mul_(std)).to(dtype)
    return unflatten(flat)


def period_params(params: Params, slot: str, i: int) -> Dict[str, Any]:
    """Period ``i``'s parameters of layer slot ``slot`` (views)."""
    return {name: {k: v[i] for k, v in sub.items()}
            for name, sub in params["blocks"][slot].items()}


# --------------------------------------------------------------------------
# Caches
# --------------------------------------------------------------------------

class Cache(NamedTuple):
    """Per-slot dense KV caches, each stacked over the period axis:
    k/v (n_periods, batch, max_len, kv_heads, head_dim)."""
    slots: Dict[str, KVCache]
    offset: int  # number of tokens already in the cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype, device) -> Cache:
    _check_supported(cfg)
    shape = (cfg.n_periods, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dev = torch.device(device)
    return Cache(
        slots={str(i): KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                               torch.zeros(shape, dtype=dtype, device=dev))
               for i in range(len(cfg.period))},
        offset=0)


def _layer_cache(cache: Cache, slot: str, i: int) -> KVCache:
    kv = cache.slots[slot]
    return KVCache(kv.k[i], kv.v[i])


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------

def _embed_tokens(params: Params, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.scale_embeddings:
        # the scale rounded to x's dtype first, as in JAX (a fill, so no
        # host-to-device copy on the decode path)
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    return x


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return softcap(x @ head, cfg.logit_softcap)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Cache, *, last_index: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Process a prompt, filling ``cache`` in place. Returns (last-token
    logits (b, V), cache).

    ``cache`` must come from init_cache with max_len >= prompt + new.
    ``last_index`` (b,) selects each row's OWN last real token for the
    returned logits (right-padded unequal-length prompts; causal masking
    keeps their hidden states exact).
    """
    b, s = tokens.shape
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.arange(s, device=x.device).expand(b, s)
    for i in range(cfg.n_periods):
        for si, spec in enumerate(cfg.period):
            sp = period_params(params, str(si), i)
            x, _ = attention_apply(sp["attn"], cfg, x, positions=positions,
                                   layer_kind=spec.mixer,
                                   cache=_layer_cache(cache, str(si), i),
                                   cache_offset=0)
            x = mlp_apply(sp["mlp"], cfg, x)
    if last_index is None:
        x_last = x[:, -1:, :]
    else:
        x_last = x[torch.arange(b, device=x.device), last_index.long()][:, None]
    logits = _logits(params, cfg, x_last)
    return logits[:, 0, :], cache._replace(offset=s)


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Cache, *, offsets: torch.Tensor
                ) -> Tuple[torch.Tensor, Cache]:
    """One greedy-decode step over a dense cache. token: (b,) -> (logits
    (b, V), cache). Ragged: with ``offsets`` (b,) each row writes at its
    own position, takes its own RoPE phase and attends only its own
    valid prefix. Attention is the plain ``_sdpa`` (no kernel)."""
    x = _embed_tokens(params, cfg, token[:, None])
    positions = offsets[:, None]
    for i in range(cfg.n_periods):
        for si, spec in enumerate(cfg.period):
            sp = period_params(params, str(si), i)
            x, _ = attention_apply(sp["attn"], cfg, x, positions=positions,
                                   layer_kind=spec.mixer,
                                   cache=_layer_cache(cache, str(si), i),
                                   cache_offsets=offsets)
            x = mlp_apply(sp["mlp"], cfg, x)
    logits = _logits(params, cfg, x)
    return logits[:, 0, :], cache._replace(offset=cache.offset + 1)


def decode_step_paged(params: Params, cfg: ModelConfig, token: torch.Tensor,
                      pages: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                      block_tables: torch.Tensor, offsets: torch.Tensor,
                      write_enabled: torch.Tensor) -> torch.Tensor:
    """One decode step over a PAGED KV cache (continuous-batching engine).

    ``pages``: {period-slot -> (k_pages, v_pages)}, each (n_periods,
    n_pages+1, page_size, kv_heads, head_dim) -- one shared physical
    page pool per layer slot, written IN PLACE. ``block_tables`` (b,
    n_blocks) and ``offsets`` (b,) int32 are per request slot;
    ``write_enabled`` (b,) bool sends finished / empty rows' writes to
    the trash page. Returns logits (b, V). Every attention layer calls
    ``paged_attention`` once: the kernel on CUDA.
    """
    x = _embed_tokens(params, cfg, token[:, None])
    for i in range(cfg.n_periods):
        for si, spec in enumerate(cfg.period):
            sp = period_params(params, str(si), i)
            kp, vp = pages[str(si)]
            x = attention_decode_paged(
                sp["attn"], cfg, x, pages=(kp[i], vp[i]),
                block_table=block_tables, offsets=offsets,
                write_enabled=write_enabled, layer_kind=spec.mixer)
            x = mlp_apply(sp["mlp"], cfg, x)
    return _logits(params, cfg, x)[:, 0, :]
