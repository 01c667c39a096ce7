"""Model composition: embeddings + layer periods + heads.

Port of ``repro.models.transformer``: attention, mamba and rwkv mixers
with MLP, MoE and rwkv channel-mix feed-forwards (the dense, MoE, hybrid
and ssm families), cross-attention sub-blocks, learned position
embeddings and an encoder stack (the audio and vlm families). The
parameter tree keeps the JAX layout -- ``embed``, ``final_norm``,
``blocks/<slot>/{attn,mamba,time_mix}/...``, ``blocks/<slot>/cross/...``
and ``{mlp,moe,channel_mix}/...`` with every block leaf stacked over a
leading ``n_periods`` axis, ``pos_embed`` and ``encoder/{layers/{attn,
mlp}/..., final_norm}`` with the encoder's leaves stacked over its
layers -- so a JAX checkpoint carries over by renaming only
(``repro_torch.convert``). A Python loop over periods replaces
``lax.scan``; ``cfg.remat`` recomputes each period (not the encoder) in
the backward pass (``torch.utils.checkpoint``, the counterpart of
``jax.checkpoint``: the same numbers, less memory).

Context (whisper's 1500 frame embeddings, the VLM's image-patch
embeddings; the modality frontends are stubs, as in the JAX package):
``forward`` and ``prefill`` take it raw and encode it themselves
(``encode_context``: whisper's non-causal encoder without positions,
the identity for the VLM); ``decode_step`` and ``decode_step_paged``
take it pre-encoded. Its dtype must be the weights'.

Caches: attention slots keep a dense ``KVCache`` written in place;
mamba / rwkv slots keep a ``MambaState`` / ``RWKVState`` stacked over
the periods, which prefill and the dense decode step return anew and the
paged decode step (``rec=``) writes in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (KVCache, ParamSpec, _bmm, _split,
                                       attention_apply,
                                       attention_decode_paged,
                                       attention_specs, axes_of, matmul,
                                       mlp_apply, mlp_specs, rms_norm,
                                       softcap)

__all__ = ["model_specs", "param_shapes", "param_axes", "cache_logical_axes",
           "check_tensor_parallel", "flat_specs", "init_params",
           "forward", "lm_loss", "init_cache", "prefill", "decode_step",
           "decode_step_paged", "encode_context", "stub_context", "Cache",
           "period_params"]

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# Parameter specs
# --------------------------------------------------------------------------

ATTN = ("attn", "attn_local")


def _slot_specs(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if spec.mixer in ATTN:
        out["attn"] = attention_specs(cfg)
    elif spec.mixer == "mamba":
        out["mamba"] = mamba_mod.mamba_specs(cfg)
    elif spec.mixer == "rwkv":
        out["time_mix"] = rwkv_mod.rwkv_time_mix_specs(cfg)
    else:
        raise ValueError(spec.mixer)
    if spec.cross_attn:
        out["cross"] = attention_specs(cfg, cross=True)
    if spec.ffn == "mlp":
        out["mlp"] = mlp_specs(cfg)
    elif spec.ffn == "moe":
        out["moe"] = moe_mod.moe_specs(cfg)
    elif spec.ffn == "rwkv_ffn":
        out["channel_mix"] = rwkv_mod.rwkv_channel_mix_specs(cfg)
    elif spec.ffn is not None:
        raise ValueError(spec.ffn)
    return out


def _stack(specs: Dict[str, ParamSpec], n: int) -> Dict[str, ParamSpec]:
    return {k: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init,
                         s.scale)
            for k, s in specs.items()}


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.padded_vocab, d), ("vocab", "embed")),
        "final_norm": ParamSpec((d,), ("embed",), "ones"),
        "blocks": {
            str(i): {name: _stack(sub, cfg.n_periods)
                     for name, sub in _slot_specs(cfg, spec).items()}
            for i, spec in enumerate(cfg.period)
        },
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, cfg.padded_vocab),
                                     ("embed", "vocab"))
    if cfg.pos_embedding == "learned":
        specs["pos_embed"] = ParamSpec((cfg.max_position_embeddings, d),
                                       (None, "embed"),
                                       scale=0.02)
    if cfg.has_encoder:
        specs["encoder"] = {
            "layers": {"attn": _stack(attention_specs(cfg),
                                      cfg.n_encoder_layers),
                       "mlp": _stack(mlp_specs(cfg), cfg.n_encoder_layers)},
            "final_norm": ParamSpec((d,), ("embed",), "ones"),
        }
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


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Each parameter's logical axes, as a tree of the parameters' own
    (nested dict) structure (``repro.models.transformer.param_axes``)."""
    return axes_of(model_specs(cfg))


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
    zeros, ones or halves (0.5). Drawn from a ``torch.Generator`` seeded
    with ``seed`` on the target device, so the values differ from JAX's
    for the same seed (tests carry JAX's tree over with
    ``convert.params_from_jax``). A stacked leaf (``blocks/...``,
    ``encoder/layers/...``) is drawn in f32 one period (encoder layer) at
    a time and cast before the next draw, so no leaf's whole f32 draw is
    ever held (qwen3-moe-30b-a3b's ``w_up``: 38.7 GB at 48 layers).
    On ``meta`` (the dry-run) it draws nothing: every leaf is an empty
    meta tensor of its shape and dtype."""
    dev = resolve_device(device, allow_meta=True)
    if dev.type == "meta":
        return unflatten({key: torch.empty(s.shape, dtype=dtype, device=dev)
                          for key, s in flat_specs(cfg)})
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = {}
    for key, s in flat_specs(cfg):
        if s.init == "zeros":
            flat[key] = torch.zeros(s.shape, dtype=dtype, device=dev)
        elif s.init == "ones":
            flat[key] = torch.ones(s.shape, dtype=dtype, device=dev)
        elif s.init == "half":
            flat[key] = torch.full(s.shape, 0.5, dtype=dtype, device=dev)
        else:
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = s.scale / max(fan_in, 1) ** 0.5
            w = torch.empty(s.shape, dtype=dtype, device=dev)
            stacked = key.startswith(("blocks/", "encoder/layers/"))
            for part in (w if stacked else w[None]):
                part.copy_(torch.randn(part.shape, generator=gen,
                                       device=dev).mul_(std))
            flat[key] = w
    return unflatten(flat)


def period_params(params: Params, slot: str, i: int) -> Dict[str, Any]:
    """Period ``i``'s parameters of layer slot ``slot`` (views)."""
    return {name: {k: v[i] for k, v in sub.items()}
            for name, sub in params["blocks"][slot].items()}


# --------------------------------------------------------------------------
# Caches
# --------------------------------------------------------------------------

class Cache(NamedTuple):
    """Per-slot caches, each stacked over the period axis: an attention
    slot's dense ``KVCache`` k/v (n_periods, batch, max_len, kv_heads,
    head_dim), a mamba / rwkv slot's ``MambaState`` / ``RWKVState`` with a
    leading n_periods axis."""
    slots: Dict[str, Any]
    offset: int  # number of tokens already in the cache


def _slot_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int,
                dtype: torch.dtype, dev: torch.device):
    n = cfg.n_periods
    if spec.mixer in ATTN:
        shape = (n, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros(shape, dtype=dtype, device=dev))
    init = (mamba_mod.init_mamba_state if spec.mixer == "mamba"
            else rwkv_mod.init_rwkv_state)
    st = init(cfg, batch, dtype, dev)
    return type(st)(*(a.new_zeros((n,) + tuple(a.shape)) for a in st))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype, device) -> Cache:
    dev = torch.device(device)
    return Cache(
        slots={str(i): _slot_cache(cfg, s, batch, max_len, dtype, dev)
               for i, s in enumerate(cfg.period)},
        offset=0)


def _at(st, i: int):
    """Period ``i`` of a slot's stacked cache or state (views)."""
    return type(st)(*(a[i] for a in st))


def cache_logical_axes(cfg: ModelConfig) -> Cache:
    """The logical axes of ``init_cache``'s leaves, in its structure."""
    def slot_axes(spec: LayerSpec):
        if spec.mixer in ATTN:
            a = ("layers", "batch", "cache_seq", "kv_heads", None)
            return KVCache(k=a, v=a)
        if spec.mixer == "mamba":
            return mamba_mod.MambaState(
                conv=("layers", "batch", None, "mlp"),
                ssm=("layers", "batch", "mlp", None))
        if spec.mixer == "rwkv":
            return rwkv_mod.RWKVState(
                att_shift=("layers", "batch", "embed"),
                ffn_shift=("layers", "batch", "embed"),
                wkv=("layers", "batch", "heads", None, None))
        raise ValueError(spec.mixer)

    return Cache(slots={str(i): slot_axes(s)
                        for i, s in enumerate(cfg.period)}, offset=())


def _with_states(cache: Cache, states: Dict[str, List[Any]],
                 offset: int) -> Cache:
    """``cache`` with the recurrent slots' per-period states stacked in."""
    slots = dict(cache.slots)
    for slot, per_period in states.items():
        slots[slot] = type(per_period[0])(
            *(torch.stack(f) for f in zip(*per_period)))
    return Cache(slots=slots, offset=offset)


# --------------------------------------------------------------------------
# Layer slots
# --------------------------------------------------------------------------

def _ffn_full(cfg: ModelConfig, spec: LayerSpec, sp, x: torch.Tensor,
              state, model_axis=None):
    """A slot's feed-forward over a full sequence: (x, MoE aux or None,
    the slot's recurrent state)."""
    if spec.ffn == "mlp":
        return mlp_apply(sp["mlp"], cfg, x, model_axis), None, state
    if spec.ffn == "moe":
        x, aux = moe_mod.moe_apply(sp["moe"], cfg, x)
        return x, aux, state
    if spec.ffn == "rwkv_ffn":
        x, state = rwkv_mod.rwkv_channel_mix(sp["channel_mix"], cfg, x, state)
    return x, None, state


def _cross(cfg: ModelConfig, spec: LayerSpec, sp, x: torch.Tensor,
           positions: torch.Tensor, ctx: Optional[torch.Tensor]
           ) -> torch.Tensor:
    """A slot's cross-attention sub-block over the encoded context
    ``ctx`` (after the mixer, before the feed-forward); skipped without
    one, as in JAX."""
    if spec.cross_attn and ctx is not None:
        x, _ = attention_apply(sp["cross"], cfg, x, positions=positions,
                               kv_source=ctx)
    return x


def _slot_full(cfg: ModelConfig, spec: LayerSpec, sp, x: torch.Tensor,
               positions: torch.Tensor, cache=None,
               ctx: Optional[torch.Tensor] = None, model_axis=None,
               cache_nodes: int = 1):
    """One layer slot over a full sequence. ``cache``: an attention
    slot's ``KVCache`` to fill from position 0 (prefill), or an rwkv
    slot's initial state (zeros when None); ``ctx``: the encoded context
    of a cross-attention slot; ``model_axis``: a dense slot's tensor-
    parallel forward (the cache then in its model-axis layout). Returns
    (x, MoE aux or None, the recurrent slot's final state or None)."""
    state = None
    if spec.mixer in ATTN:
        if cache is None:
            x, _ = attention_apply(sp["attn"], cfg, x, positions=positions,
                                   layer_kind=spec.mixer,
                                   model_axis=model_axis)
        else:
            x, _ = attention_apply(sp["attn"], cfg, x, positions=positions,
                                   layer_kind=spec.mixer, cache=cache,
                                   cache_offset=0, model_axis=model_axis,
                                   cache_nodes=cache_nodes)
    elif spec.mixer == "mamba":
        x, state = mamba_mod.mamba_apply(sp["mamba"], cfg, x,
                                         return_state=True)
    else:
        if cache is None:
            cache = rwkv_mod.init_rwkv_state(cfg, x.shape[0], x.dtype,
                                             x.device)
        x, state = rwkv_mod.rwkv_time_mix(sp["time_mix"], cfg, x, cache)
    x = _cross(cfg, spec, sp, x, positions, ctx)
    return _ffn_full(cfg, spec, sp, x, state, model_axis)


def _slot_step(cfg: ModelConfig, spec: LayerSpec, sp, x: torch.Tensor,
               state, positions: torch.Tensor, ctx: Optional[torch.Tensor]):
    """A recurrent slot (mamba / rwkv mixer, its cross-attention, then
    its feed-forward) for one token. Returns (x, the slot's new
    state)."""
    if spec.mixer == "mamba":
        x, state = mamba_mod.mamba_decode_step(sp["mamba"], cfg, x, state)
    else:
        x, state = rwkv_mod.rwkv_time_mix_step(sp["time_mix"], cfg, x, state)
    x = _cross(cfg, spec, sp, x, positions, ctx)
    return _ffn_step(cfg, spec, sp, x, state)


def _ffn_step(cfg: ModelConfig, spec: LayerSpec, sp, x: torch.Tensor,
              state, model_axis=None):
    """A slot's feed-forward for one token: (x, the slot's state)."""
    if spec.ffn == "mlp":
        return mlp_apply(sp["mlp"], cfg, x, model_axis), state
    if spec.ffn == "moe":
        return moe_mod.moe_apply(sp["moe"], cfg, x)[0], state
    if spec.ffn == "rwkv_ffn":
        return rwkv_mod.rwkv_channel_mix_step(sp["channel_mix"], cfg, x,
                                              state)
    return x, state


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------

def _embed_tokens(params: Params, cfg: ModelConfig,
                  tokens: torch.Tensor, model_axis=None) -> torch.Tensor:
    if model_axis is not None and _split(params["embed"], 2):
        x = _embed_vocab_split(params["embed"], tokens, model_axis)
    else:
        x = params["embed"][tokens.long()]
    if cfg.scale_embeddings:
        # the scale rounded to x's dtype first, as in JAX (a fill, so no
        # host-to-device copy on the decode path)
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    return x


def _embed_vocab_split(embed: torch.Tensor, tokens: torch.Tensor,
                       axis) -> torch.Tensor:
    """The vocab-split embedding (L, V/M, d): each shard looks up the
    tokens its block of rows holds (zeros for the others), then the
    all-reduce sums the one owner's row with zeros (exact)."""
    n, rows = embed.shape[:2]
    lead = (n,) + (1,) * tokens.dim()
    local = tokens.long()[None] - (axis.shard_ids(tokens.device)
                                   * rows).reshape(lead)
    own = (local >= 0) & (local < rows)
    shard = torch.arange(n, device=tokens.device).reshape(lead)
    x = embed[shard, local.clamp(0, rows - 1)]
    x = torch.where(own[..., None], x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    return axis.all_reduce(x)


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor,
            model_axis=None) -> torch.Tensor:
    """The (softcapped) logits; with ``model_axis`` and a vocab-split
    head, each shard's block of the vocab: (L, ..., V/M)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if model_axis is not None and _split(head, 2):
        head = head.transpose(-1, -2) if cfg.tie_embeddings else head
        return softcap(_bmm(model_axis.copy_in(x), head), cfg.logit_softcap)
    head = head.T if cfg.tie_embeddings else head
    return softcap(matmul(x, head), cfg.logit_softcap)


def stub_context(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                 device) -> Optional[torch.Tensor]:
    """The launchers' context for the audio / vlm families, whose
    frontends are stubs (as in the JAX package): (batch, encoder_seq or
    n_image_tokens, d_model) filled with 0.01. None for a text model."""
    if cfg.family not in ("audio", "vlm"):
        return None
    n = cfg.encoder_seq if cfg.family == "audio" else cfg.n_image_tokens
    return torch.full((batch, n, cfg.d_model), 0.01, dtype=dtype,
                      device=device)


def encode_context(params: Params, cfg: ModelConfig,
                   context: Optional[torch.Tensor]
                   ) -> Optional[torch.Tensor]:
    """Public: encode a context once for serving (see ``decode_step``)."""
    return _encode_context(params, cfg, context)


def _encode_context(params: Params, cfg: ModelConfig,
                    context: Optional[torch.Tensor]
                    ) -> Optional[torch.Tensor]:
    """Whisper: the encoder stack (non-causal attention without
    positions, then the MLP, each layer; then ``encoder/final_norm``)
    over the stub frame embeddings (b, s, d). VLM: the stub patch
    embeddings pass straight through."""
    if context is None or not cfg.has_encoder:
        return context
    enc = params["encoder"]
    b, s, _ = context.shape
    positions = torch.arange(s, device=context.device).expand(b, s)
    x = context
    for i in range(cfg.n_encoder_layers):
        layer = {name: {k: v[i] for k, v in sub.items()}
                 for name, sub in enc["layers"].items()}
        x, _ = attention_apply(layer["attn"], cfg, x, positions=positions,
                               causal=False, use_rope=False)
        x = mlp_apply(layer["mlp"], cfg, x)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _embed_prompt(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  model_axis=None):
    """Token embeddings of a (b, s) prompt plus, with learned positions,
    ``pos_embed[:s]``; and the positions (b, s)."""
    b, s = tokens.shape
    x = _embed_tokens(params, cfg, tokens, model_axis)
    if cfg.pos_embedding == "learned":
        x = x + params["pos_embed"][:s][None]
    return x, torch.arange(s, device=x.device).expand(b, s)


def _period(params: Params, cfg: ModelConfig, i: int, x: torch.Tensor,
            positions: torch.Tensor, ctx: Optional[torch.Tensor] = None,
            model_axis=None):
    """Period ``i`` of the layer stack over a full sequence (no cache).
    Returns (x, the period's summed MoE aux or None without MoE)."""
    aux = None
    for si, spec in enumerate(cfg.period):
        sp = period_params(params, str(si), i)
        x, a, _ = _slot_full(cfg, spec, sp, x, positions, ctx=ctx,
                             model_axis=model_axis)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def check_tensor_parallel(cfg: ModelConfig) -> None:
    """Raises unless ``cfg`` is a dense decoder (attention + MLP slots):
    the only family whose forward runs over a model axis."""
    bad = [s for s in cfg.period
           if s.mixer not in ATTN or s.ffn != "mlp" or s.cross_attn]
    if bad or cfg.has_encoder or cfg.pos_embedding == "learned":
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism over a model axis runs the "
            "dense decoder family only; the MoE experts, the mamba / rwkv "
            "mixers, cross-attention and the encoder are not ported "
            "(ROADMAP Queue 1, item 5)")


def _tp_axis(cfg: ModelConfig, model_axis):
    """``model_axis``, or None for none or a single shard; the families
    other than the dense decoder raise under M > 1."""
    if model_axis is None or model_axis.size == 1:
        return None
    check_tensor_parallel(cfg)
    return model_axis


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            context: Optional[torch.Tensor] = None, model_axis=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward. tokens (b, s) -> (logits (b, s, V), aux loss):
    the MoE slots' load-balance losses summed over slots and periods (0
    without MoE). ``context``: the raw (b, s_ctx, d) context, encoded
    here.

    ``model_axis`` (``core/model_axis``, M > 1 shards) runs the dense
    decoder tensor-parallel over ``params`` in the model-axis layout
    (``convert.shard_params``); the logits then come vocab-split, (M, b,
    s, V/M), for ``lm_loss(..., model_axis=)``. Other families raise."""
    model_axis = _tp_axis(cfg, model_axis)
    x, positions = _embed_prompt(params, cfg, tokens, model_axis)
    ctx = _encode_context(params, cfg, context)
    auxs = []
    for i in range(cfg.n_periods):
        if cfg.remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            x, aux = checkpoint(_period, params, cfg, i, x, positions, ctx,
                                model_axis, use_reentrant=False)
        else:
            x, aux = _period(params, cfg, i, x, positions, ctx, model_axis)
        if aux is not None:
            auxs.append(aux)
    total = (torch.sum(torch.stack(auxs)) if auxs
             else torch.zeros((), device=x.device))
    return _logits(params, cfg, x, model_axis), total


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int,
            aux=0.0, aux_weight: float = 0.01, *,
            model_axis=None) -> torch.Tensor:
    """Next-token cross entropy in f32; the padded vocab tail is masked
    out (logits there set to -1e30). Vocab-split logits (M, b, s, V/M)
    from a tensor-parallel ``forward`` take ``model_axis``."""
    if model_axis is not None and logits.dim() == labels.dim() + 2:
        return _lm_loss_vocab_split(logits, labels, vocab_size, model_axis) \
            + aux_weight * aux
    v = logits.shape[-1]
    pad = torch.arange(v, device=logits.device) >= vocab_size
    logits = torch.where(pad, torch.full((), -1e30, device=logits.device),
                         logits.float())
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold) + aux_weight * aux


def _lm_loss_vocab_split(logits: torch.Tensor, labels: torch.Tensor,
                         vocab_size: int, axis) -> torch.Tensor:
    """The mean cross entropy of vocab-split logits: logsumexp from the
    model-axis max and the all-reduced sum of exponentials, the label's
    logit from the shard whose block holds it (all-reduced with the
    others' zeros)."""
    n, cols = logits.shape[0], logits.shape[-1]
    lead = (n,) + (1,) * (logits.dim() - 2)
    start = axis.shard_ids(logits.device).reshape(lead) * cols
    col = start[..., None] + torch.arange(cols, device=logits.device)
    logits = torch.where(col >= vocab_size,
                         torch.full((), -1e30, device=logits.device),
                         logits.float())
    top = axis.all_max(logits.amax(-1))
    total = axis.all_reduce(torch.exp(logits - top[..., None]).sum(-1))
    logz = torch.log(total) + top
    local = labels.long()[None] - start
    own = (local >= 0) & (local < cols)
    gold = torch.gather(logits, -1, local.clamp(0, cols - 1)[..., None])
    gold = axis.all_reduce(torch.where(own, gold[..., 0],
                                       torch.zeros((), device=gold.device)))
    return torch.mean(logz - gold)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Cache, *, context: Optional[torch.Tensor] = None,
            last_index: Optional[torch.Tensor] = None, model_axis=None,
            cache_nodes: int = 1) -> Tuple[torch.Tensor, Cache]:
    """Process a prompt. Attention slots fill ``cache`` in place; the
    recurrent slots' final states come back in the returned cache.
    Returns (last-token logits (b, V), cache).

    ``cache`` must come from init_cache with max_len >= prompt + new.
    ``context``: the raw context, encoded here (as ``forward``).
    ``last_index`` (b,) selects each row's OWN last real token for the
    returned logits (right-padded unequal-length prompts; causal masking
    keeps their hidden states exact -- recurrent models need equal
    lengths, their state would consume the padding).

    ``model_axis`` (M > 1 shards; the dense family): ``params`` and
    ``cache`` in their model-axis layouts (``convert.shard_params``,
    ``convert.shard_cache``); the logits come back vocab-split, (M, b,
    V/M), as ``forward``'s do. ``cache_nodes``: the node blocks of a
    cache split by positions over ("data", "model") (``shard_cache_seq``).
    """
    b, s = tokens.shape
    model_axis = _tp_axis(cfg, model_axis)
    x, positions = _embed_prompt(params, cfg, tokens, model_axis)
    ctx = _encode_context(params, cfg, context)
    states: Dict[str, List[Any]] = {}
    for i in range(cfg.n_periods):
        for si, spec in enumerate(cfg.period):
            key = str(si)
            sp = period_params(params, key, i)
            x, _, st = _slot_full(cfg, spec, sp, x, positions,
                                  cache=_at(cache.slots[key], i), ctx=ctx,
                                  model_axis=model_axis,
                                  cache_nodes=cache_nodes)
            if st is not None:
                states.setdefault(key, []).append(st)
    if last_index is None:
        x_last = x[:, -1:, :]
    else:
        x_last = x[torch.arange(b, device=x.device), last_index.long()][:, None]
    logits = _logits(params, cfg, x_last, model_axis)
    return logits[..., 0, :], _with_states(cache, states, s)


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Cache, *, context: Optional[torch.Tensor] = None,
                offsets: Optional[torch.Tensor] = None, model_axis=None,
                cache_nodes: int = 1) -> Tuple[torch.Tensor, Cache]:
    """One greedy-decode step over a dense cache. token: (b,) -> (logits
    (b, V), cache). Ragged: with ``offsets`` (b,) each row writes at its
    own position, takes its own RoPE phase (or learned position) and
    attends only its own valid prefix; without it every row shares the
    scalar ``cache.offset``. ``context`` must be PRE-ENCODED
    (``encode_context``). Attention is the plain ``_sdpa`` (no kernel);
    the recurrent slots' new states come back in the returned cache.
    ``model_axis`` / ``cache_nodes``: as ``prefill``'s (the cache split by
    positions is the flash-decoding layout); ragged ``offsets`` raise
    under it."""
    b = token.shape[0]
    model_axis = _tp_axis(cfg, model_axis)
    x = _embed_tokens(params, cfg, token[:, None], model_axis)
    if offsets is not None:
        positions = offsets[:, None]
    else:
        positions = torch.full((b, 1), cache.offset, device=x.device)
    if cfg.pos_embedding == "learned":
        if offsets is not None:
            x = x + params["pos_embed"][offsets.long()][:, None]
        else:
            x = x + params["pos_embed"][cache.offset:cache.offset + 1][None]
    states: Dict[str, List[Any]] = {}
    for i in range(cfg.n_periods):
        for si, spec in enumerate(cfg.period):
            key = str(si)
            sp = period_params(params, key, i)
            if spec.mixer in ATTN:
                x, _ = attention_apply(sp["attn"], cfg, x,
                                       positions=positions,
                                       layer_kind=spec.mixer,
                                       cache=_at(cache.slots[key], i),
                                       cache_offset=cache.offset,
                                       cache_offsets=offsets,
                                       model_axis=model_axis,
                                       cache_nodes=cache_nodes)
                x = _cross(cfg, spec, sp, x, positions, context)
                x, _ = _ffn_step(cfg, spec, sp, x, None, model_axis)
            else:
                x, st = _slot_step(cfg, spec, sp, x,
                                   _at(cache.slots[key], i), positions,
                                   context)
                states.setdefault(key, []).append(st)
    logits = _logits(params, cfg, x, model_axis)
    return logits[..., 0, :], _with_states(cache, states, cache.offset + 1)


def decode_step_paged(params: Params, cfg: ModelConfig, token: torch.Tensor,
                      pages: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                      block_tables: torch.Tensor, offsets: torch.Tensor,
                      write_enabled: torch.Tensor, *,
                      rec: Optional[Dict[str, Any]] = None,
                      context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step over a PAGED KV cache (continuous-batching engine).

    ``pages``: {period-slot -> (k_pages, v_pages)}, each (n_periods,
    n_pages+1, page_size, kv_heads, head_dim) -- one shared physical
    page pool per attention slot, written IN PLACE. ``rec``:
    {period-slot -> recurrent state stacked over the periods} for the
    mamba / rwkv slots (dense per-row state: paging applies to KV only),
    advanced IN PLACE for every row, emitting or not, as in the JAX
    engine. ``block_tables`` (b, n_blocks) and ``offsets`` (b,) int32 are
    per request slot; ``write_enabled`` (b,) bool sends finished / empty
    rows' KV writes to the trash page. ``context``: PRE-ENCODED, one row
    per slot (cross-attention keys / values are recomputed from it every
    step; nothing is cached). Returns logits (b, V). Every attention
    layer calls ``paged_attention`` once: the kernel on CUDA.
    """
    x = _embed_tokens(params, cfg, token[:, None])
    # the cross sub-blocks' query positions (a decoder-only step makes none)
    positions = None if context is None else offsets[:, None]
    if cfg.pos_embedding == "learned":
        x = x + params["pos_embed"][offsets.long()][:, None]
    for i in range(cfg.n_periods):
        for si, spec in enumerate(cfg.period):
            key = str(si)
            sp = period_params(params, key, i)
            if spec.mixer in ATTN:
                kp, vp = pages[key]
                x = attention_decode_paged(
                    sp["attn"], cfg, x, pages=(kp[i], vp[i]),
                    block_table=block_tables, offsets=offsets,
                    write_enabled=write_enabled, layer_kind=spec.mixer)
                x = _cross(cfg, spec, sp, x, positions, context)
                x, _ = _ffn_step(cfg, spec, sp, x, None)
            else:
                x, st = _slot_step(cfg, spec, sp, x, _at(rec[key], i),
                                   positions, context)
                for dst, src in zip(rec[key], st):
                    dst[i].copy_(src)
    return _logits(params, cfg, x)[:, 0, :]
