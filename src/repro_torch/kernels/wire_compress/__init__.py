"""Fused wire compressor kernels (CUDA) and their plain versions:
QSGD quantize + pack (``qsgd_pack``) and the fixed-k sender pack
(``fixedk_gather_pack``)."""
from .ops import fixedk_gather_pack, qsgd_inv, qsgd_pack
from .ref import (f32_scale, fixedk_gather_pack_ref, levels, norm_from_tail,
                  pack_factor, qsgd_decode_ref, qsgd_quantize_pack_ref)

__all__ = ["qsgd_pack", "qsgd_inv", "qsgd_quantize_pack_ref",
           "qsgd_decode_ref", "pack_factor", "levels", "norm_from_tail",
           "fixedk_gather_pack", "fixedk_gather_pack_ref", "f32_scale"]
