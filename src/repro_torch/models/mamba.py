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

Over a model axis (``model_axis``, ``params`` in the model-axis layout of
``convert.shard_params``) the channels (``mlp``) split as ``INNER_RULES``
splits them: shard i holds channels [i di/M, (i+1) di/M) of ``conv_w``,
``conv_b``, ``w_dt``, ``dt_bias``, ``a_log``, ``d_skip`` and the rows of
``w_x_dbc`` and ``w_out``, and the scan and its state for those channels.
``w_in`` keeps JAX's layout, its columns ``[u | z]`` cut in M contiguous
blocks, so a shard's block is not its own channels' u and z: each shard
multiplies its block (after *f*), the blocks are all-gathered, and each
shard takes its channels of u and z from them (GSPMD's reshard after
the product; where M splits the 2 di columns but not di, the gathered
product goes on replicated). ``w_x_dbc``'s partial products are
all-reduced into the replicated (dt_in, B, C), which enter the shards
again through *f*; ``w_out``'s partials end in *g*.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec, _bmm, _split, rms_norm

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


def _ssm_params(params, cfg: ModelConfig, u: torch.Tensor, axis=None):
    """Input-dependent (dt, B, C) and continuous A. u: (b, s, di); over
    ``axis``, u (L, b, s, di/M) and (dt, B, C) (L, b, s, .), A (L, 1, 1,
    di/M, ds), broadcast against the stack."""
    ds, dtr = cfg.mamba_d_state, cfg.mamba_dt_rank
    mm = _bmm if axis is not None else torch.matmul
    dbc = mm(u, params["w_x_dbc"])
    if axis is not None:
        dbc = axis.copy_in(axis.all_reduce(dbc))
    dt_in, B, C = torch.split(dbc, [dtr, ds, ds], dim=-1)
    dt = F.softplus(mm(dt_in, params["w_dt"])
                    + _lead(params["dt_bias"], axis, 4))
    A = -torch.exp(_lead(params["a_log"], axis, 5).float())
    return dt, B, C, A


def _discretize(dt, A, B, u, scan_dtype=torch.float32):
    """ZOH-ish discretization: Abar = exp(dt A), Bbar x = dt * B * x,
    stored in ``scan_dtype`` (the (b, s, d_inner, d_state) scan elements
    are the layer's largest activation)."""
    dA = torch.exp(dt.float()[..., None] * A).to(scan_dtype)
    dBx = (dt[..., None] * B[..., None, :] * u[..., None]).to(scan_dtype)
    return dA, dBx


def _channels(params, cfg: ModelConfig, x: torch.Tensor, model_axis):
    """The norm and ``w_in``: (axis, residual, u_raw, z), each (b, s,
    di). Where ``model_axis`` splits the channels, ``axis`` is it and u_raw
    and z are (L, b, s, di/M), each shard's own channels, taken from the
    all-gathered blocks of the product; where it splits ``w_in``'s 2 di
    columns but not di (the divisibility fallback), the gathered product
    is replicated and ``axis`` None, as without a model axis."""
    residual = x
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    if model_axis is None or not _split(params["w_in"], 2):
        u_raw, z = torch.chunk(h @ params["w_in"], 2, dim=-1)
        return None, residual, u_raw, z
    xz = model_axis.all_gather(_bmm(model_axis.copy_in(h), params["w_in"]))
    if not _split(params["conv_w"], 2):
        u_raw, z = torch.chunk(xz[0], 2, dim=-1)
        return None, residual, u_raw, z
    n, c = xz.shape[0], cfg.mamba_d_inner // model_axis.size
    dev = x.device
    cols = model_axis.shard_ids(dev)[:, None] * c + torch.arange(c,
                                                                device=dev)
    cols = cols.reshape((n,) + (1,) * (xz.dim() - 2) + (c,)).expand(
        tuple(xz.shape[:-1]) + (c,))
    return (model_axis, residual, torch.gather(xz, -1, cols),
            torch.gather(xz, -1, cols + cfg.mamba_d_inner))


def _lead(v: torch.Tensor, axis, rank: int) -> torch.Tensor:
    """A per-channel leaf of a shard, (L, ...), broadcast against a
    (L, b, s, ...) stack of ``rank`` dimensions (as is without ``axis``)."""
    if axis is None:
        return v
    return v.reshape((v.shape[0],) + (1,) * (rank - v.dim())
                     + tuple(v.shape[1:]))


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
                x: torch.Tensor, return_state: bool = False,
                model_axis=None):
    """Full-sequence mixer. x: (b, s, d) -> (b, s, d) [, final MambaState].

    The returned conv state is ``u_raw[:, s - (d_conv - 1):]`` as the JAX
    package writes it: a prompt shorter than d_conv - 1 tokens starts the
    slice at a negative index and leaves fewer than d_conv - 1 rows.
    Over ``model_axis`` (module docstring) x and the output stay
    replicated and the state comes back split by channel, (L, b, ...,
    di/M) each field.
    """
    b, s, d = x.shape
    dc = cfg.mamba_d_conv
    axis, residual, u_raw, z = _channels(params, cfg, x, model_axis)
    lead = u_raw.shape[:-2]                   # (b,) or (L, b)

    # causal depthwise conv over seq (kernel dc)
    u_pad = F.pad(u_raw, (0, 0, dc - 1, 0))
    conv = sum(u_pad[..., i:i + s, :]
               * _lead(params["conv_w"][..., i, :], axis, 4)
               for i in range(dc))
    u = F.silu(conv + _lead(params["conv_b"], axis, 4))

    dt, B, C, A = _ssm_params(params, cfg, u, axis)
    dA, dBx = _discretize(dt, A, B, u, getattr(torch, cfg.mamba_scan_dtype))
    flat = (-1, s) + tuple(dA.shape[-2:])     # the stack's rows as batch
    _, hs = _associative_scan(dA.reshape(flat), dBx.reshape(flat))
    y = torch.einsum("bsin,bsn->bsi", hs.float(),
                     C.reshape((-1, s, C.shape[-1])).float())
    y = y.reshape(u.shape).to(u.dtype) + _lead(params["d_skip"], axis, 4) * u
    y = y * F.silu(z)
    if axis is None:
        out = residual + y @ params["w_out"]
    else:
        out = residual + axis.all_reduce(_bmm(y, params["w_out"]))
    if not return_state:
        return out
    state = MambaState(conv=u_raw[..., s - (dc - 1):, :],
                       ssm=hs[:, -1].float().reshape(
                           tuple(lead) + tuple(hs.shape[-2:])))
    return out, state


def mamba_decode_step(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                      x: torch.Tensor, state: MambaState, model_axis=None
                      ) -> Tuple[torch.Tensor, MambaState]:
    """One-token step. x: (b, 1, d); O(1) in sequence length. Raises
    ``ValueError`` on a conv state of other than d_conv - 1 rows (the JAX
    package's einsum refuses it too). Over ``model_axis`` the state is
    split by channel, as ``mamba_apply`` returns it."""
    axis, residual, u, z = _channels(params, cfg, x, model_axis)

    conv_hist = torch.cat([state.conv, u], dim=-2)          # (.., b, dc, di)
    if conv_hist.shape[-2] != cfg.mamba_d_conv:
        raise ValueError(
            f"mamba conv state has {state.conv.shape[-2]} rows, the step "
            f"needs d_conv - 1 = {cfg.mamba_d_conv - 1} (a prompt shorter "
            f"than that leaves a short state)")
    if axis is None:
        conv = torch.einsum("bci,ci->bi", conv_hist, params["conv_w"])
    else:
        conv = torch.einsum("lbci,lci->lbi", conv_hist, params["conv_w"])
    u = F.silu(conv[..., None, :] + _lead(params["conv_b"], axis, 4))

    dt, B, C, A = _ssm_params(params, cfg, u, axis)
    dA, dBx = _discretize(dt, A, B, u)                   # (.., b, 1, di, ds)
    ssm = dA[..., 0, :, :] * state.ssm + dBx[..., 0, :, :]  # (.., b, di, ds)
    y = torch.einsum("bin,bn->bi" if axis is None else "lbin,lbn->lbi",
                     ssm, C[..., 0, :].float())[..., None, :]
    y = y.to(u.dtype) + _lead(params["d_skip"], axis, 4) * u
    y = y * F.silu(z)
    if axis is None:
        out = y @ params["w_out"]
    else:
        out = axis.all_reduce(_bmm(y, params["w_out"]))
    return residual + out, MambaState(conv=conv_hist[..., 1:, :], ssm=ssm)
