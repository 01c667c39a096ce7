"""Fused wire compressor: QSGD quantize + pack (CUDA kernel + plain version).

The fixed-k gather+pack kernel of the JAX package
(``fixedk_gather_pack_pallas``) runs only on the distributed executor's
transport and is not ported yet.
"""
from .ops import qsgd_inv, qsgd_pack
from .ref import (levels, norm_from_tail, pack_factor, qsgd_decode_ref,
                  qsgd_quantize_pack_ref)

__all__ = ["qsgd_pack", "qsgd_inv", "qsgd_quantize_pack_ref",
           "qsgd_decode_ref", "pack_factor", "levels", "norm_from_tail"]
