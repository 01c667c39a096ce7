"""RWKV-6 "Finch" block: attention-free time-mix with data-dependent decay.

Port of ``repro.models.rwkv``. Per head (head size N): state S in
R^{N x N} evolves as

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (diag(u) k_t^T v_t + S_{t-1})

with data-dependent decay w_t = exp(-exp(wproj(x_t))). The full-sequence
time-mix runs the recurrence in order over the sequence (JAX's
``lax.scan``) with an f32 state; the outer products k_t^T v_t and their
bonus-weighted copies are formed for every step up front (elementwise,
so the same numbers), leaving four launches a step. Decode carries
(shift, state) with O(1) work a token.

As in the JAX package: token shift is a plain lerp with learned mix
vectors, and the output gate is SiLU. A decode step is the full-sequence
mix at s = 1 (the same operations).

Over a model axis (``model_axis``, ``params`` in the model-axis layout of
``convert.shard_params``) the mixers split as ``INNER_RULES`` splits
them. Time mix: shard i holds heads [i h/M, (i+1) h/M), the columns of
``w_r``, ``w_k``, ``w_v``, ``w_decay`` (``heads_flat``) and ``w_g``
(``mlp``: with h n = d its block covers the same heads, so ``o * g`` is
local), the rows of ``decay_bias`` / ``bonus_u`` (``heads``) and of
``w_out`` (``mlp``), whose partial products end in *g*; the norm and
the ``mix_*`` vectors are replicated. The normed input enters the shards
through *f* and each shard forms the token shift and the lerps from it
alike; the WKV loop runs over the shard's heads with a state of (L, b,
h/M, N, N). Where M does not divide the heads but splits their h N
columns (the split inside a head; ``decay_bias`` / ``bonus_u`` then stay
whole, as JAX's rules leave ``heads``): output column j of head H needs
the whole head's r, k, w and u but only column j of v, and its state
only S[H, :, j]. So each shard all-gathers r, k and the decay's
projection, takes the head of each of its own columns (``_column_heads``)
and runs the loop over its columns with its own v, a state of (L, b,
h N/M, N) (``S[H, :, j]`` of column (H, j)); the all-gathers' backward,
a reduce-scatter, sums the gradients of the shards that share a head.
``w_g`` and ``w_out`` split as before. Channel mix: ``w_k`` split by
columns and ``w_v`` by rows (partials all-reduced), ``w_r`` (``embed``,
``mlp``) by columns, its product all-gathered before ``r * kv``, as
GSPMD reshards it; a weight the divisibility fallback leaves whole
multiplies one copy of the replicated lerp. The token-shift states stay
whole.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec, _bmm, _split, rms_norm

__all__ = ["RWKVState", "rwkv_time_mix_specs", "rwkv_channel_mix_specs",
           "rwkv_time_mix", "rwkv_channel_mix", "init_rwkv_state"]


class RWKVState(NamedTuple):
    att_shift: torch.Tensor  # (b, d) last token's x at the time-mix input
    ffn_shift: torch.Tensor  # (b, d) last token's x at the channel-mix input
    wkv: torch.Tensor        # (b, heads, N, N) f32 recurrent state


def rwkv_time_mix_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    n = cfg.rwkv_head_size
    h = cfg.rwkv_n_heads
    return {
        "norm": ParamSpec((d,), ("embed",), "ones"),
        "mix_r": ParamSpec((d,), ("embed",), "half"),
        "mix_k": ParamSpec((d,), ("embed",), "half"),
        "mix_v": ParamSpec((d,), ("embed",), "half"),
        "mix_w": ParamSpec((d,), ("embed",), "half"),
        "mix_g": ParamSpec((d,), ("embed",), "half"),
        "w_r": ParamSpec((d, h * n), ("embed", "heads_flat")),
        "w_k": ParamSpec((d, h * n), ("embed", "heads_flat")),
        "w_v": ParamSpec((d, h * n), ("embed", "heads_flat")),
        "w_g": ParamSpec((d, d), ("embed", "mlp")),
        "w_decay": ParamSpec((d, h * n), ("embed", "heads_flat"),
                             scale=0.1),
        "decay_bias": ParamSpec((h, n), ("heads", None), "zeros"),
        "bonus_u": ParamSpec((h, n), ("heads", None), "zeros"),
        "w_out": ParamSpec((d, d), ("mlp", "embed")),
    }


def rwkv_channel_mix_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm": ParamSpec((d,), ("embed",), "ones"),
        "mix_k": ParamSpec((d,), ("embed",), "half"),
        "mix_r": ParamSpec((d,), ("embed",), "half"),
        "w_k": ParamSpec((d, f), ("embed", "mlp")),
        "w_v": ParamSpec((f, d), ("mlp", "embed")),
        "w_r": ParamSpec((d, d), ("embed", "mlp")),
    }


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                    device, model_axis=None) -> RWKVState:
    """Zeros; over ``model_axis`` the WKV state split by heads, (L, b,
    h/M, N, N), or, where M cuts the heads, by columns, (L, b, h N/M,
    N)."""
    d, h, n = cfg.d_model, cfg.rwkv_n_heads, cfg.rwkv_head_size
    wkv = (batch, h, n, n)
    if model_axis is not None:
        m = model_axis.size
        wkv = (model_axis.local, batch) + (
            (h // m, n, n) if h % m == 0 else (h * n // m, n))
    return RWKVState(
        att_shift=torch.zeros((batch, d), dtype=dtype, device=device),
        ffn_shift=torch.zeros((batch, d), dtype=dtype, device=device),
        wkv=torch.zeros(wkv, dtype=torch.float32, device=device))


def _column_heads(cfg: ModelConfig, axis, device):
    """The head of each of a local shard's h N / M columns, (L, c), where
    M cuts the heads; None where it divides them."""
    h, n, m = cfg.rwkv_n_heads, cfg.rwkv_head_size, axis.size
    if h % m == 0:
        return None
    c = h * n // m
    ids = axis.shard_ids(device)
    return (ids[:, None] * c + torch.arange(c, device=device)) // n


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: the x_{t-1} sequence (prev fills t=0). x: (..., s, d),
    prev (..., d)."""
    return torch.cat([prev[..., None, :], x[..., :-1, :]], dim=-2)


def _lerp(mix, a, b):
    return a + (b - a) * mix


def _tp(axis, w: torch.Tensor):
    """``axis`` where ``w`` (a 2-D weight a layer) is split over it."""
    return axis if axis is not None and _split(w, 2) else None


def _stacked_input(h: torch.Tensor, prev: torch.Tensor, axis):
    """(h, x_{t-1}) as the shards see them: the replicated normed input
    through *f* and the token shift formed on every shard alike."""
    if axis is None:
        return h, _shift(h, prev)
    hs = axis.copy_in(h)
    return hs, _shift(hs, prev.expand((hs.shape[0],) + tuple(prev.shape)))


def _time_mix_projections(params, cfg: ModelConfig, x, x_prev, axis=None,
                          cols=None):
    """(r, k, v, g, w): r, k, v, w (..., s, heads, N) over the shard's
    heads, g (..., s, d) (the shard's block over ``axis``). With
    ``cols`` (``_column_heads``): r, k, w (L, b, s, c, N) of the head of
    each of the shard's c columns (all-gathered), v and g (L, b, s, c)
    its own columns."""
    n = cfg.rwkv_head_size
    mm = torch.matmul if axis is None else _bmm
    lead = tuple(x.shape[:-1])
    xr = _lerp(params["mix_r"], x, x_prev)
    xk = _lerp(params["mix_k"], x, x_prev)
    xv = _lerp(params["mix_v"], x, x_prev)
    xw = _lerp(params["mix_w"], x, x_prev)
    xg = _lerp(params["mix_g"], x, x_prev)
    g = F.silu(mm(xg, params["w_g"]))
    bias = params["decay_bias"]
    if cols is not None:

        def heads(t):          # each column's whole head, from the gather
            full = axis.all_gather(t).reshape(lead + (-1, n))
            idx = cols[:, None, None, :, None].expand(
                lead + (cols.shape[1], n))
            return torch.gather(full, -2, idx)

        r, k = heads(mm(xr, params["w_r"])), heads(mm(xk, params["w_k"]))
        v = mm(xv, params["w_v"])
        wlog = heads(mm(xw, params["w_decay"])) + bias[cols][:, None, None]
    else:
        r = mm(xr, params["w_r"]).reshape(lead + (-1, n))
        k = mm(xk, params["w_k"]).reshape(lead + (-1, n))
        v = mm(xv, params["w_v"]).reshape(lead + (-1, n))
        if axis is not None:
            bias = bias[:, None, None]
        wlog = mm(xw, params["w_decay"]).reshape(lead + (-1, n)) + bias
    # Finch data-dependent decay in (0, 1): exp(-exp(.)) of a projection.
    w = torch.exp(-torch.exp(wlog.float()))
    return r, k, v, g, w


def _outer(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """k^T v per head, in the inputs' dtype, then f32 (JAX's einsum
    ``bhk,bhv->bhkv`` then ``.astype(f32)``)."""
    return (k[..., :, None] * v[..., None, :]).float()


def _readout(r: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """o = r M per head: (..., h, k) x (..., h, k, v) -> (..., h, v)."""
    return torch.matmul(r[..., None, :], m)[..., 0, :]


def rwkv_time_mix(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                  x: torch.Tensor, state: RWKVState, model_axis=None
                  ) -> Tuple[torch.Tensor, RWKVState]:
    """Full-sequence time-mix. x: (b, s, d). Over ``model_axis`` (module
    docstring) x and the output stay replicated and ``state.wkv`` is
    split by heads, (L, b, h/M, N, N), or by columns where M cuts the
    heads, (L, b, h N/M, N)."""
    s = x.shape[1]
    axis = _tp(model_axis, params["w_r"])
    cols = None if axis is None else _column_heads(cfg, axis, x.device)
    residual = x
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    hx, x_prev = _stacked_input(h, state.att_shift, axis)
    r, k, v, g, w = _time_mix_projections(params, cfg, hx, x_prev, axis,
                                          cols)
    u = params["bonus_u"].float()
    if cols is not None:
        return _time_mix_columns(params, x, h, state, r, k, v, g, w,
                                 u[cols], axis)
    if axis is not None:
        u = u[:, None, None]                     # (L, 1, 1, h/M, N)

    kv = _outer(k, v)                            # (..., s, h, N, N)
    ukv = u[..., None] * kv
    r32 = r.float()
    w32 = w.float()[..., None]
    S = state.wkv
    outs = []
    for t in range(s):
        outs.append(_readout(r32[..., t, :, :], S + ukv[..., t, :, :, :]))
        S = w32[..., t, :, :, :] * S + kv[..., t, :, :, :]
    o = torch.stack(outs, dim=-3).flatten(-2).to(x.dtype) * g
    if axis is None:
        out = o @ params["w_out"]
    else:
        out = axis.all_reduce(_bmm(o, params["w_out"]))
    new_state = state._replace(att_shift=h[:, -1, :], wkv=S)
    return residual + out, new_state


def _time_mix_columns(params, x, h, state, r, k, v, g, w, u, axis):
    """The WKV loop over each shard's columns where M cuts the heads: r,
    k, w (L, b, s, c, N) of each column's head, v, g (L, b, s, c), u (L,
    c, N); the state (L, b, c, N), S[H, :, j] of column (H, j). Column
    (H, j) reads out o = sum_i r_i (u_i k_i v_j + S[i]) and carries S =
    w S + k v_j: the terms the whole head's loop forms for it."""
    kv = (k * v[..., None]).float()              # k^T v's column j, f32
    ukv = u[:, None, None] * kv
    r32 = r.float()
    S = state.wkv
    outs = []
    for t in range(x.shape[1]):
        outs.append((r32[:, :, t] * (S + ukv[:, :, t])).sum(-1))
        S = w[:, :, t] * S + kv[:, :, t]
    o = torch.stack(outs, dim=2).to(x.dtype) * g
    out = axis.all_reduce(_bmm(o, params["w_out"]))
    return x + out, state._replace(att_shift=h[:, -1, :], wkv=S)


def rwkv_channel_mix(params, cfg: ModelConfig, x: torch.Tensor,
                     state: RWKVState, model_axis=None
                     ) -> Tuple[torch.Tensor, RWKVState]:
    """The channel mix over a full sequence, x: (b, s, d); over
    ``model_axis`` as the module docstring says."""
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    tk = _tp(model_axis, params["w_k"])
    tr = _tp(model_axis, params["w_r"])
    axis = tk or tr
    hx, x_prev = _stacked_input(h, state.ffn_shift, axis)
    xk = _lerp(params["mix_k"], hx, x_prev)
    xr = _lerp(params["mix_r"], hx, x_prev)
    if axis is not None and tk is None:
        xk = xk[0]
    if axis is not None and tr is None:
        xr = xr[0]
    if tk is None:
        kv = torch.square(F.relu(xk @ params["w_k"])) @ params["w_v"]
    else:
        kv = tk.all_reduce(_bmm(torch.square(F.relu(_bmm(xk, params["w_k"]))),
                                params["w_v"]))
    if tr is None:
        r = xr @ params["w_r"]
    else:
        r = tr.all_gather(_bmm(xr, params["w_r"]))[0]
    return x + torch.sigmoid(r) * kv, state._replace(ffn_shift=h[:, -1, :])

