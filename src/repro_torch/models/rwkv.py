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
vectors, and the output gate is SiLU.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec, rms_norm

__all__ = ["RWKVState", "rwkv_time_mix_specs", "rwkv_channel_mix_specs",
           "rwkv_time_mix", "rwkv_channel_mix", "init_rwkv_state",
           "rwkv_time_mix_step", "rwkv_channel_mix_step"]


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
                    device) -> RWKVState:
    d, h, n = cfg.d_model, cfg.rwkv_n_heads, cfg.rwkv_head_size
    return RWKVState(
        att_shift=torch.zeros((batch, d), dtype=dtype, device=device),
        ffn_shift=torch.zeros((batch, d), dtype=dtype, device=device),
        wkv=torch.zeros((batch, h, n, n), dtype=torch.float32, device=device))


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: the x_{t-1} sequence (prev fills t=0). x: (b, s, d)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _lerp(mix, a, b):
    return a + (b - a) * mix


def _time_mix_projections(params, cfg: ModelConfig, x, x_prev):
    b, s, _ = x.shape
    h, n = cfg.rwkv_n_heads, cfg.rwkv_head_size
    xr = _lerp(params["mix_r"], x, x_prev)
    xk = _lerp(params["mix_k"], x, x_prev)
    xv = _lerp(params["mix_v"], x, x_prev)
    xw = _lerp(params["mix_w"], x, x_prev)
    xg = _lerp(params["mix_g"], x, x_prev)
    r = (xr @ params["w_r"]).reshape(b, s, h, n)
    k = (xk @ params["w_k"]).reshape(b, s, h, n)
    v = (xv @ params["w_v"]).reshape(b, s, h, n)
    g = F.silu(xg @ params["w_g"])
    # Finch data-dependent decay in (0, 1): exp(-exp(.)) of a projection.
    wlog = (xw @ params["w_decay"]).reshape(b, s, h, n) + params["decay_bias"]
    w = torch.exp(-torch.exp(wlog.float()))
    return r, k, v, g, w


def _outer(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """k^T v per head, in the inputs' dtype, then f32 (JAX's einsum
    ``bhk,bhv->bhkv`` then ``.astype(f32)``)."""
    return (k[..., :, None] * v[..., None, :]).float()


def _readout(r: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """o = r M per head: (b, h, k) x (b, h, k, v) -> (b, h, v)."""
    return torch.matmul(r[..., None, :], m)[..., 0, :]


def rwkv_time_mix(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                  x: torch.Tensor, state: RWKVState
                  ) -> Tuple[torch.Tensor, RWKVState]:
    """Full-sequence time-mix. x: (b, s, d)."""
    b, s, d = x.shape
    residual = x
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    x_prev = _shift(h, state.att_shift)
    r, k, v, g, w = _time_mix_projections(params, cfg, h, x_prev)
    u = params["bonus_u"].float()

    kv = _outer(k, v)                                   # (b, s, h, N, N)
    ukv = u[:, :, None] * kv
    r32 = r.float()
    w32 = w.float()[..., None]
    S = state.wkv
    outs = []
    for t in range(s):
        outs.append(_readout(r32[:, t], S + ukv[:, t]))
        S = w32[:, t] * S + kv[:, t]
    o = torch.stack(outs, dim=1).reshape(b, s, d).to(x.dtype)
    o = o * g
    out = o @ params["w_out"]
    new_state = state._replace(att_shift=h[:, -1, :], wkv=S)
    return residual + out, new_state


def rwkv_time_mix_step(params, cfg: ModelConfig, x: torch.Tensor,
                       state: RWKVState) -> Tuple[torch.Tensor, RWKVState]:
    """One-token decode step; O(1) state update. x: (b, 1, d)."""
    residual = x
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    x_prev = state.att_shift[:, None, :]
    r, k, v, g, w = _time_mix_projections(params, cfg, h, x_prev)
    u = params["bonus_u"].float()
    r1, k1, v1, w1 = (a[:, 0] for a in (r, k, v, w))
    kv = _outer(k1, v1)
    o = _readout(r1.float(), state.wkv + u[:, :, None] * kv)
    S = w1.float()[..., None] * state.wkv + kv
    o = o.reshape(x.shape[0], 1, -1).to(x.dtype) * g
    out = o @ params["w_out"]
    new_state = state._replace(att_shift=h[:, 0, :], wkv=S)
    return residual + out, new_state


def _channel_mix(params, h: torch.Tensor, x_prev: torch.Tensor):
    xk = _lerp(params["mix_k"], h, x_prev)
    xr = _lerp(params["mix_r"], h, x_prev)
    k = torch.square(F.relu(xk @ params["w_k"]))
    kv = k @ params["w_v"]
    return torch.sigmoid(xr @ params["w_r"]) * kv


def rwkv_channel_mix(params, cfg: ModelConfig, x: torch.Tensor,
                     state: RWKVState) -> Tuple[torch.Tensor, RWKVState]:
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    out = _channel_mix(params, h, _shift(h, state.ffn_shift))
    return x + out, state._replace(ffn_shift=h[:, -1, :])


def rwkv_channel_mix_step(params, cfg: ModelConfig, x: torch.Tensor,
                          state: RWKVState) -> Tuple[torch.Tensor, RWKVState]:
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    out = _channel_mix(params, h, state.ffn_shift[:, None, :])
    return x + out, state._replace(ffn_shift=h[:, 0, :])
