"""Mamba (S6) block as used by Jamba -- selective state-space mixer.

Port of ``repro.models.mamba``. Prefill computes the recurrence
h_t = A_t * h_{t-1} + B_t x_t as a parallel prefix over the sequence:
``_associative_scan`` is JAX's own odd/even recursion
(``jax.lax.associative_scan``), so the products are formed in the same
order, and a prompt of s tokens costs O(log s) launches a layer, not s.
Decode is a single O(1) recurrence step carrying (conv_state, ssm_state).

Shapes follow Jamba: d_inner = 2*d_model, d_state = 16, d_conv = 4,
dt_rank = d_model/16. ``A = -exp(a_log)``, the ssm state and the
readout are f32 whatever the weights' dtype.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec, rms_norm

__all__ = ["MambaState", "mamba_specs", "mamba_apply", "mamba_decode_step",
           "init_mamba_state"]


class MambaState(NamedTuple):
    conv: torch.Tensor  # (b, d_conv - 1, d_inner) last inputs of the conv
    ssm: torch.Tensor   # (b, d_inner, d_state) f32


def mamba_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, di = cfg.d_model, cfg.mamba_d_inner
    ds, dc, dtr = cfg.mamba_d_state, cfg.mamba_d_conv, cfg.mamba_dt_rank
    return {
        "norm": ParamSpec((d,), ("embed",), "ones"),
        "w_in": ParamSpec((d, 2 * di), ("embed", "mlp")),  # x and z
        "conv_w": ParamSpec((dc, di), (None, "mlp")),
        "conv_b": ParamSpec((di,), ("mlp",), "zeros"),
        "w_x_dbc": ParamSpec((di, dtr + 2 * ds), ("mlp", None)),
        "w_dt": ParamSpec((dtr, di), (None, "mlp")),
        "dt_bias": ParamSpec((di,), ("mlp",), "zeros"),
        "a_log": ParamSpec((di, ds), ("mlp", None), "ones"),  # -exp(A)
        "d_skip": ParamSpec((di,), ("mlp",), "ones"),
        "w_out": ParamSpec((di, d), ("mlp", "embed")),
    }


def init_mamba_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> MambaState:
    return MambaState(
        conv=torch.zeros((batch, cfg.mamba_d_conv - 1, cfg.mamba_d_inner),
                         dtype=dtype, device=device),
        ssm=torch.zeros((batch, cfg.mamba_d_inner, cfg.mamba_d_state),
                        dtype=torch.float32, device=device))


def _ssm_params(params, cfg: ModelConfig, u: torch.Tensor):
    """Input-dependent (dt, B, C) and continuous A. u: (b, s, di)."""
    ds, dtr = cfg.mamba_d_state, cfg.mamba_dt_rank
    dbc = u @ params["w_x_dbc"]
    dt_in, B, C = torch.split(dbc, [dtr, ds, ds], dim=-1)
    dt = F.softplus(dt_in @ params["w_dt"] + params["dt_bias"])
    A = -torch.exp(params["a_log"].float())                   # (di, ds)
    return dt, B, C, A


def _discretize(dt, A, B, u, scan_dtype=torch.float32):
    """ZOH-ish discretization: Abar = exp(dt A), Bbar x = dt * B * x,
    stored in ``scan_dtype`` (the (b, s, d_inner, d_state) scan elements
    are the layer's largest activation)."""
    dA = torch.exp(dt.float()[..., None] * A).to(scan_dtype)
    dBx = (dt[..., None] * B[:, :, None, :] * u[..., None]).to(scan_dtype)
    return dA, dBx


def _combine(a_l, b_l, a_r, b_r):
    return a_r * a_l, a_r * b_l + b_r


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along dim 1 (len(even) - len(odd) is
    0 or 1)."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n) + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along dim 1, by JAX's
    recursion: combine adjacent pairs, scan the half-length sequence (the
    odd results), then form the even results from the odd ones."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def mamba_apply(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                x: torch.Tensor, return_state: bool = False):
    """Full-sequence mixer. x: (b, s, d) -> (b, s, d) [, final MambaState].

    The returned conv state is ``u_raw[:, s - (d_conv - 1):]`` as the JAX
    package writes it: a prompt shorter than d_conv - 1 tokens starts the
    slice at a negative index and leaves fewer than d_conv - 1 rows.
    """
    b, s, d = x.shape
    dc = cfg.mamba_d_conv
    residual = x
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    u_raw, z = torch.chunk(h @ params["w_in"], 2, dim=-1)

    # causal depthwise conv over seq (kernel dc)
    u_pad = F.pad(u_raw, (0, 0, dc - 1, 0))
    conv = sum(u_pad[:, i:i + s, :] * params["conv_w"][i] for i in range(dc))
    u = F.silu(conv + params["conv_b"])

    dt, B, C, A = _ssm_params(params, cfg, u)
    dA, dBx = _discretize(dt, A, B, u, getattr(torch, cfg.mamba_scan_dtype))
    _, hs = _associative_scan(dA, dBx)
    y = torch.einsum("bsin,bsn->bsi", hs.float(), C.float())
    y = y.to(u.dtype) + params["d_skip"] * u
    y = y * F.silu(z)
    out = residual + y @ params["w_out"]
    if not return_state:
        return out
    state = MambaState(conv=u_raw[:, s - (dc - 1):, :], ssm=hs[:, -1].float())
    return out, state


def mamba_decode_step(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                      x: torch.Tensor, state: MambaState
                      ) -> Tuple[torch.Tensor, MambaState]:
    """One-token step. x: (b, 1, d); O(1) in sequence length. Raises
    ``ValueError`` on a conv state of other than d_conv - 1 rows (the JAX
    package's einsum refuses it too)."""
    residual = x
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    u, z = torch.chunk(h @ params["w_in"], 2, dim=-1)         # (b, 1, di)

    conv_hist = torch.cat([state.conv, u], dim=1)               # (b, dc, di)
    if conv_hist.shape[1] != cfg.mamba_d_conv:
        raise ValueError(
            f"mamba conv state has {state.conv.shape[1]} rows, the step "
            f"needs d_conv - 1 = {cfg.mamba_d_conv - 1} (a prompt shorter "
            f"than that leaves a short state)")
    conv = torch.einsum("bci,ci->bi", conv_hist, params["conv_w"])[:, None, :]
    u = F.silu(conv + params["conv_b"])

    dt, B, C, A = _ssm_params(params, cfg, u)
    dA, dBx = _discretize(dt, A, B, u)                        # (b, 1, di, ds)
    ssm = dA[:, 0] * state.ssm + dBx[:, 0]                      # (b, di, ds)
    y = torch.einsum("bin,bn->bi", ssm, C[:, 0].float())[:, None, :]
    y = y.to(u.dtype) + params["d_skip"] * u
    y = y * F.silu(z)
    out = y @ params["w_out"]
    return residual + out, MambaState(conv=conv_hist[:, 1:], ssm=ssm)
