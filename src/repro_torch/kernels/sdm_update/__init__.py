"""Fused SDM-DSGD update: the CUDA kernel's wrapper (``sdm_update_planes``),
the tree wrapper (``sdm_update``) and the plain version."""
from .ops import sdm_update, sdm_update_planes, u32_words
from .ref import (DEFAULT_BLOCK_ROWS, LANE, inv_p_f32, sdm_update_ref,
                  uniform01)

__all__ = ["sdm_update", "sdm_update_planes", "sdm_update_ref", "uniform01",
           "u32_words", "inv_p_f32", "LANE", "DEFAULT_BLOCK_ROWS"]
