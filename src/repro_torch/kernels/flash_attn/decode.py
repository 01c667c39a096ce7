"""Paged flash decode: block-table-aware single-token attention.

Port of ``repro.kernels.flash_attn.decode``. The serving engine's paged
KV cache stores keys/values in fixed-size pages
(``repro_torch.serving.kv_cache``); a per-row block table maps logical
block j of request row b to a physical page id. ``paged_attention``
reads the cache THROUGH the table:

* for CUDA tensors it launches the hand-written Hopper kernel
  ``kernels/csrc/paged_decode.cu`` (which replaces the TPU kernel
  ``paged_flash_decode_pallas``), or raises -- it never falls back;
* for CPU tensors it runs the plain version ``paged_attention_ref``;
* for ``meta`` tensors (the dry-run) it returns an empty meta output and
  adds the kernel's ``kernels/cost.py`` count to the open
  ``cost.KernelTally``; any other device raises.

``paged_attention.launches`` counts calls that launched the kernel (the
plain version never adds to it), so a run can show that decode went
through the kernel. The kernel splits each row's pages across blocks
(split-K); ``split_plan`` makes that choice on the host from the shapes
alone, so a decode step never reads ``seq_lens`` back. The JAX
wrapper's ``use_kernel`` / ``interpret`` switches and its head_dim
padding to the TPU's 128 lanes have no counterpart here: the CUDA
kernel takes any head_dim that is a multiple of 32 up to 256.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import cost

__all__ = ["paged_attention", "paged_attention_ref", "split_plan",
           "SplitPlan"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# two blocks for each of the H100's 132 SMs
MIN_BLOCKS = 2 * 132


class SplitPlan(NamedTuple):
    pages_per_split: int      # P
    n_splits: int             # S = ceil(n_blocks / P)
    scratch_shape: Optional[Tuple[int, int, int, int]]  # f32, None if S 1


def split_plan(b: int, kvh: int, group: int, dh: int,
               n_blocks: int) -> SplitPlan:
    """How the decode kernel splits each row's ``n_blocks`` pages across
    blocks: S = 1 (one launch, no scratch) when the rows alone give b *
    kvh >= ``MIN_BLOCKS`` blocks; else splits of P pages, P the largest
    power of two that still gives b * kvh * S >= ``MIN_BLOCKS`` (or one
    page a split, if the table is shorter). A power of two keeps a
    split's tokens a whole number of the block's steps (8 warps x 4
    tokens at the serving shape: 2 pages of 16). The partials go to f32
    scratch (b, kvh * group, S, dh + 2) that a second kernel merges. A
    pure function of the shapes: it reads no device value, so the decode
    step needs no sync."""
    if min(b, kvh, group, dh, n_blocks) < 1:
        raise ValueError(f"split_plan: sizes must be positive, got b {b}, "
                         f"kvh {kvh}, group {group}, dh {dh}, n_blocks "
                         f"{n_blocks}")
    if b * kvh >= MIN_BLOCKS:
        pages = n_blocks
    else:
        want = -(-MIN_BLOCKS // (b * kvh))      # splits per row
        pages = 1
        while 2 * pages <= n_blocks and -(-n_blocks // (2 * pages)) >= want:
            pages *= 2
    n_splits = -(-n_blocks // pages)
    scratch = (b, kvh * group, n_splits, dh + 2) if n_splits > 1 else None
    return SplitPlan(pages, n_splits, scratch)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_table: torch.Tensor,
                        seq_lens: torch.Tensor, *,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Plain version: gather pages through the table, masked softmax.

    q: (b, h, dh) -> (b, h, dh) in q's dtype. Computes in f32, as the
    kernel does, and materializes the (b, n_blocks*page) contiguous view.
    Rows with seq_len 0 give zeros.
    """
    b, h, dh = q.shape
    _, page, kvh, _ = k_pages.shape
    group = h // kvh
    tbl = block_table.long()
    k = k_pages[tbl].float()             # (b, nb, page, kvh, dh)
    v = v_pages[tbl].float()
    nb = k.shape[1]
    k = k.reshape(b, nb * page, kvh, dh)
    v = v.reshape(b, nb * page, kvh, dh)
    qg = q.float().reshape(b, kvh, group, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k) / math.sqrt(dh)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(nb * page, device=q.device)
    lens = seq_lens.long()
    mask = pos[None, :] < lens[:, None]
    if window is not None:
        mask &= pos[None, :] > (lens[:, None] - 1) - window
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v)
    # empty rows (seq_len 0): the fully masked softmax is uniform; zero
    # them so a dead slot contributes nothing, as in the kernel.
    out = torch.where((lens > 0)[:, None, None, None], out, 0.0)
    return out.reshape(b, h, dh).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    seq_lens: torch.Tensor, *,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """GQA-aware decode attention. q: (b, h, dh), one token per row;
    k/v_pages: (n_pages+1, page, kv_heads, dh); block_table (b, n_blocks)
    int32; seq_lens (b,) int32, valid tokens per row (incl. the current
    one). CPU tensors: the plain version. CUDA tensors: the kernel."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_table,
                                   seq_lens, window=window, softcap=softcap)
    if q.device.type == "meta":
        # the lengths have no values on meta: every row counts its whole
        # table, the most the call could read
        b, h, dh = q.shape
        n_blocks, (_, page, kvh, _) = block_table.shape[1], k_pages.shape
        cost.charge("paged_decode", cost.paged_decode(
            [n_blocks * page] * b, window=window, kvh=kvh, group=h // kvh,
            dh=dh, page=page, n_blocks=n_blocks,
            elt_bytes=q.element_size()))
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _paged_decode_cuda(q, k_pages, v_pages, block_table, seq_lens,
                              window=window, softcap=softcap)


paged_attention.launches = 0


def _kernel_fn():
    from repro_torch.kernels._build import load_library

    fn = load_library("paged_decode").paged_decode
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, f, i,
                       i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _paged_decode_cuda(q, k_pages, v_pages, block_table, seq_lens, *,
                       window, softcap, plan: Optional[SplitPlan] = None
                       ) -> torch.Tensor:
    """The kernel; ``plan`` overrides ``split_plan`` (for timing other
    splits of the same call)."""
    b, h, dh = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v pages must share a 4-D shape, got "
                         f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    _, page, kvh, pdh = k_pages.shape
    if pdh != dh or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not fit pages "
                         f"{tuple(k_pages.shape)}")
    if dh % 32 or not 32 <= dh <= 256:
        raise ValueError(f"head_dim {dh}: the kernel takes multiples of 32 "
                         f"up to 256")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k_pages.dtype}, "
                         f"v {v_pages.dtype}: the kernel takes one of "
                         f"{list(_DTYPES)} for all three")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("block_table and seq_lens must be int32")
    if block_table.dim() != 2 or block_table.shape[0] != b \
            or tuple(seq_lens.shape) != (b,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / seq_lens "
                         f"{tuple(seq_lens.shape)} do not match batch {b}")
    tensors = (q, k_pages, v_pages, block_table, seq_lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all inputs must be on one device")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("k/v pages must be contiguous")
    q = q.contiguous()
    block_table = block_table.contiguous()
    seq_lens = seq_lens.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("q and the page pools must be 16-byte aligned")

    n_blocks = block_table.shape[1]
    if plan is None:
        plan = split_plan(b, kvh, h // kvh, dh, n_blocks)
    out = torch.empty_like(q)
    scratch = None if plan.scratch_shape is None else torch.empty(
        plan.scratch_shape, dtype=torch.float32, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                b, kvh, h // kvh, dh, page, n_blocks,
                0 if window is None else int(window),
                0.0 if softcap is None else float(softcap),
                1.0 / math.sqrt(dh), plan.pages_per_split, plan.n_splits,
                _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{rc}")
    paged_attention.launches += 1
    return out
