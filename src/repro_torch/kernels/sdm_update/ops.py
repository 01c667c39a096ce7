"""Entry points of the fused SDM-DSGD update.

``sdm_update_planes`` (the counterpart of ``repro.kernels.sdm_update.
sdm_update.sdm_update_pallas``) runs the update over (rows, 1024) f32
planes with three 32-bit bit streams:

* for CUDA tensors it launches the hand-written Hopper kernel
  ``kernels/csrc/sdm_update.cu`` (which replaces the TPU kernel
  ``sdm_update_pallas``), or raises -- it never falls back;
* for CPU tensors it runs the plain version ``ref.sdm_update_ref``;
* for ``meta`` tensors (the dry-run) it returns empty meta outputs and
  adds the kernel's ``kernels/cost.py`` count to the open
  ``cost.KernelTally``; any other device raises.

``sdm_update_planes.launches`` counts kernel launches. On the card the
bit streams are int32 (u32 words in 4-byte storage, read as unsigned by
the kernel); the CPU also takes ``prng.bits``' int64 words.

``sdm_update`` (port of ``repro.kernels.sdm_update.ops.sdm_update``) is
the tree wrapper: it packs four trees into the kernel's plane layout
(``ParamPlane.for_tree(lane=1024, row_multiple=block_rows)``), draws the
three streams from ``key`` with the port's threefry at the canonical
LANE-padded row count (not the tile-padded one, so the draws do not
depend on ``block_rows``; they equal ``jax.random.bits`` under the same
key), runs ``sdm_update_planes`` and unpacks. The JAX wrapper's
``use_kernel`` / ``interpret`` switches have no counterpart: the
tensors' device picks the kernel or the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Any, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.core.plane import ParamPlane
from repro_torch.kernels import cost

from .ref import DEFAULT_BLOCK_ROWS, LANE, inv_p_f32, sdm_update_ref

__all__ = ["sdm_update", "sdm_update_planes", "u32_words"]

PyTree = Any


def u32_words(bits: torch.Tensor) -> torch.Tensor:
    """int64 u32 words (``prng.bits``) as int32 storage of the same bits."""
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
        torch.int32)


def _check(x, s, nb, g, mb, n1, n2, block_rows: int) -> None:
    if x.dim() != 2 or x.shape[1] != LANE:
        raise ValueError(f"sdm_update: planes must be (rows, {LANE}), got "
                         f"{tuple(x.shape)}")
    if block_rows < 1 or x.shape[0] % block_rows:
        raise ValueError(f"sdm_update: rows {x.shape[0]} must be a multiple "
                         f"of block_rows {block_rows}")
    for t in (s, nb, g, mb, n1, n2):
        if tuple(t.shape) != tuple(x.shape):
            raise ValueError(f"sdm_update: operand {tuple(t.shape)} does not "
                             f"match {tuple(x.shape)}")
        if t.device != x.device:
            raise ValueError("sdm_update: all operands must be on one device")


def sdm_update_planes(x: torch.Tensor, s: torch.Tensor, nb_sum: torch.Tensor,
                      g: torch.Tensor, mask_bits: torch.Tensor,
                      n1_bits: torch.Tensor, n2_bits: torch.Tensor, *,
                      p: float, theta: float, gamma: float, sigma: float,
                      clip_c: Optional[float], self_w: float,
                      block_rows: int = DEFAULT_BLOCK_ROWS
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x_new, s_new, sd) of (rows, 1024) planes, rows % block_rows == 0."""
    _check(x, s, nb_sum, g, mask_bits, n1_bits, n2_bits, block_rows)
    kw = dict(p=p, theta=theta, gamma=gamma, sigma=sigma, clip_c=clip_c,
              self_w=self_w)
    if x.device.type == "cpu":
        return sdm_update_ref(x, s, nb_sum, g, mask_bits, n1_bits, n2_bits,
                              **kw)
    if x.device.type == "meta":
        cost.charge("sdm_update", cost.sdm_update(x.numel()))
        return tuple(torch.empty_like(x) for _ in range(3))
    if x.device.type != "cuda":
        raise ValueError(f"sdm_update: unsupported device {x.device}")
    return _sdm_update_cuda(x, s, nb_sum, g, mask_bits, n1_bits, n2_bits,
                            **kw)


sdm_update_planes.launches = 0


def _kernel_fn():
    from repro_torch.kernels._build import load_library

    fn = load_library("sdm_update").sdm_update
    if fn.argtypes is None:
        ptr, f32 = ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [ptr] * 10 + [ctypes.c_longlong] + [f32] * 6 + \
            [f32, ctypes.c_int, f32, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
    return fn


def _sdm_update_cuda(x, s, nb, g, mb, n1, n2, *, p, theta, gamma, sigma,
                     clip_c, self_w):
    floats, words = (x, s, nb, g), (mb, n1, n2)
    if any(t.dtype != torch.float32 for t in floats):
        raise ValueError("sdm_update: x, s, nb_sum and g must be float32")
    if any(t.dtype != torch.int32 for t in words):
        raise ValueError("sdm_update: the bit streams must be int32 storage "
                         "of u32 words on the card (see u32_words)")
    if not all(t.is_contiguous() for t in floats + words):
        raise ValueError("sdm_update: operands must be contiguous")
    if not (0.0 < p <= 1.0):
        raise ValueError(f"sdm_update: p must be in (0, 1], got {p}")
    xo, so, sd = (torch.empty_like(x) for _ in range(3))
    n = x.numel()
    if n == 0:
        return xo, so, sd
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in floats + words + (xo, so, sd)), n,
                p, inv_p_f32(p), 1.0 - theta, theta, gamma, sigma,
                0.0 if clip_c is None else clip_c, int(clip_c is not None),
                self_w, int(sigma > 0.0), stream)
    if rc != 0:
        raise RuntimeError(f"sdm_update kernel launch failed: CUDA error {rc}")
    sdm_update_planes.launches += 1
    return xo, so, sd


def sdm_update(x_tree: PyTree, s_tree: PyTree, nb_tree: PyTree,
               g_tree: PyTree, key, *, p: float, theta: float, gamma: float,
               sigma: float, clip_c: Optional[float], self_w: float,
               block_rows: int = DEFAULT_BLOCK_ROWS
               ) -> Tuple[PyTree, PyTree, PyTree]:
    """Returns (x_new, s_new, sd) trees; ``key`` drives the mask and the
    noise bits (split in three: mask, n1, n2)."""
    spec = ParamPlane.for_tree(x_tree, lane=LANE, row_multiple=block_rows,
                               buckets=None)
    (x,), (s,), (nb,), (g,) = (spec.pack(t) for t in
                               (x_tree, s_tree, nb_tree, g_tree))
    kb, k1, k2 = prng.split(prng.key_data(key).to(x.device), 3)
    # the canonical LANE-padded row count, not x's tile-padded one: the
    # threefry draw depends on its size, and the mask must not change
    # with block_rows
    n_rows = -(-spec.total_size // LANE)

    def bits(k):
        b = u32_words(prng.bits(k, (n_rows, LANE)))
        return torch.nn.functional.pad(b, (0, 0, 0, x.shape[0] - n_rows))

    x2, s2, sd = sdm_update_planes(
        x, s, nb, g, bits(kb), bits(k1), bits(k2), p=p, theta=theta,
        gamma=gamma, sigma=sigma, clip_c=clip_c, self_w=self_w,
        block_rows=block_rows)
    return spec.unpack((x2,)), spec.unpack((s2,)), spec.unpack((sd,))
