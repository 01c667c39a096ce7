"""Mixture-of-Experts layer: top-k router + capacity-based gather dispatch.

Port of ``repro.models.moe``. Expert weights are stacked on a leading
``experts`` axis: ``w_up`` / ``w_gate`` (e, d, f), ``w_down`` (e, f, d).

Capacity: ``int(top_k * tokens * capacity_factor / n_experts)`` clamped
to ``[top_k, tokens]``, counted over every row the call receives (in a
decode step, every engine slot, empty or finished ones too), so which
tokens drop is the JAX package's. Tokens beyond an expert's capacity are
dropped (their combine weight is 0). Aux: the Switch-style load-balance
loss.

JAX writes the (expert, position) slots with ``.at[].set(mode="drop")``;
here the slot tables carry one spare column (index ``cap``) that takes
every dropped write and is sliced off. The combine is ``index_add``: on
CUDA it adds a token's k contributions with atomics, in an order that
varies from run to run.

Over a model axis (``model_axis``, ``params`` in the model-axis layout of
``convert.shard_params``) the experts split as ``INNER_RULES`` splits
them: by ``experts`` where M divides ``n_experts`` (shard i holds experts
[i e/M, (i+1) e/M)), else by ``mlp`` inside every expert (the
divisibility fallback: ``w_up`` / ``w_gate`` by columns, ``w_down`` by
rows). The router, the top-k, the slotting and the capacity run once on
the replicated input; each shard takes the rows and the gates of its
experts' slots through *f* (``copy_in``), runs its experts, and adds its
partial combine, which *g* (``all_reduce``) sums.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamSpec, _activation, _split,
                                       rms_norm)

__all__ = ["moe_specs", "moe_apply", "capacity"]


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, fe, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    specs = {
        "router": ParamSpec((d, e), ("embed", None)),
        "w_up": ParamSpec((e, d, fe), ("experts", "embed", "mlp")),
        "w_down": ParamSpec((e, fe, d), ("experts", "mlp", "embed")),
        "norm": ParamSpec((d,), ("embed",),
                          "zeros" if cfg.post_block_norm else "ones"),
    }
    if cfg.glu:
        specs["w_gate"] = ParamSpec((e, d, fe), ("experts", "embed", "mlp"))
    if cfg.post_block_norm:
        specs["post_norm"] = ParamSpec((d,), ("embed",), "zeros")
    return specs


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(cfg.top_k * n_tokens * cfg.capacity_factor / cfg.n_experts)
    return max(cfg.top_k, min(c, n_tokens))


def moe_apply(params: Dict[str, torch.Tensor], cfg: ModelConfig,
              x: torch.Tensor, model_axis=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_load_balance_loss). x: (b, s, d). With
    ``model_axis`` and the expert weights in the model-axis layout, the
    experts run over the shards (module docstring); x, the output and
    aux stay replicated. Leaves the divisibility fallback left whole run
    as without the axis."""
    b, s, d = x.shape
    residual = x
    h = rms_norm(x, params["norm"], cfg.norm_eps, plus_one=cfg.post_block_norm)

    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t)
    xt = h.reshape(t, d)
    dev = x.device

    # --- routing, in f32 whatever the weights' dtype ---------------------
    probs = torch.softmax(xt.float() @ params["router"].float(), dim=-1)
    # lax.top_k breaks ties towards the lower index: a stable sort does too
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[:, :k], expert_ids[:, :k]
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # Switch-style aux loss: e * sum_e fraction_tokens_e * mean_prob_e.
    onehot = F.one_hot(expert_ids[:, 0], e).float()
    aux = e * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))

    # --- slotting: position of each (token, k) within its expert ----------
    flat_expert = expert_ids.reshape(-1)                     # (t*k,)
    tk = flat_expert.shape[0]
    order = torch.argsort(flat_expert, stable=True)          # groups experts,
    sorted_e = flat_expert[order]                           # keeps token order
    group_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    seg_pos = torch.arange(tk, device=dev) - group_start
    pos = torch.empty_like(seg_pos)
    pos[order] = seg_pos
    token_of = torch.arange(t, device=dev).repeat_interleave(k)
    write_pos = torch.where(pos < cap, pos, cap)  # column cap: dropped

    # slot -> token map; dropped slots point at a padding row (index t)
    slot_token = torch.full((e, cap + 1), t, dtype=torch.long, device=dev)
    slot_token[flat_expert, write_pos] = token_of
    slot_token = slot_token[:, :cap]
    slot_gate = torch.zeros((e, cap + 1), dtype=torch.float32, device=dev)
    slot_gate = slot_gate.index_put((flat_expert, write_pos),
                                    gate_vals.reshape(-1))[:, :cap]

    axis = model_axis if model_axis is not None and _split(
        params["w_up"], 3) else None
    out = _experts(params, cfg, xt, slot_token, slot_gate, axis)
    out = out.reshape(b, s, d)
    if cfg.post_block_norm:
        out = rms_norm(out, params["post_norm"], cfg.norm_eps, plus_one=True)
    return residual + out, aux


def _experts(params: Dict[str, torch.Tensor], cfg: ModelConfig,
             xt: torch.Tensor, slot_token: torch.Tensor,
             slot_gate: torch.Tensor, axis=None) -> torch.Tensor:
    """The expert compute, in the parameters' dtype, and the combine: xt
    (t, d) and the slot tables (e, cap) replicated. Without ``axis`` the
    weights are (e, d, f) / (e, f, d) and run as one stack of L = 1
    shards; with it ``w_up`` / ``w_gate`` are (L, e', d, f'), ``w_down``
    (L, e', f', d), e' = e / M experts a shard (split by experts) or e'
    = e with f' = f / M (the fallback), rows and gates enter through *f*
    and the partial combines leave through *g*. Returns the combine (t,
    d), replicated."""
    t, d = xt.shape
    cap = slot_token.shape[1]
    dev = xt.device
    if axis is None:
        n, el = 1, cfg.n_experts
        xs, gates = xt[None], slot_gate[None]
    else:
        n, el = params["w_up"].shape[:2]
        xs = axis.copy_in(xt)                                # (L, t, d)
        gates = axis.copy_in(slot_gate)                      # (L, e, cap)
    xs = torch.cat([xs, xs.new_zeros((n, 1, d))], dim=1)     # pad row t
    if el != cfg.n_experts:                      # each shard its experts
        rows = axis.shard_ids(dev)[:, None] * el + torch.arange(el,
                                                               device=dev)
        tok = slot_token[rows]                               # (L, e', cap)
        gates = torch.gather(gates, 1, rows[..., None].expand(n, el, cap))
    else:                                   # every expert, f / M of it
        tok = slot_token.expand(n, el, cap)
    xe = xs[torch.arange(n, device=dev)[:, None, None], tok]
    xe = xe.reshape(n * el, cap, d)                          # one bmm

    def w(name):
        v = params[name]
        return v.reshape((n * el,) + tuple(v.shape[-2:]))

    up = torch.bmm(xe, w("w_up"))
    if cfg.glu:
        up = _activation(torch.bmm(xe, w("w_gate")), cfg.act) * up
    else:
        up = _activation(up, cfg.act)
    ye = torch.bmm(up, w("w_down")).reshape(n, el, cap, d)
    ye = ye * gates[..., None].to(ye.dtype)
    # each shard's partial combine, side by side in one index_add
    idx = tok + (torch.arange(n, device=dev) * (t + 1))[:, None, None]
    part = ye.new_zeros((n * (t + 1), d)).index_add(0, idx.reshape(-1),
                                                   ye.reshape(-1, d))
    part = part.reshape(n, t + 1, d)[:, :t]
    return part[0] if axis is None else axis.all_reduce(part)
