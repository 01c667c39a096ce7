"""Flat-key .npz checkpoints, numpy only.

The same file format as ``repro.checkpoint.npz``: one ``np.savez``
archive per step, named ``step_<8 digits>.npz``, whose keys are the
'/'-joined tree paths of the saved state. The port works on the flat
``{key: ndarray}`` dict directly, so no treedef is needed to read or
write one.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Dict, Optional

import numpy as np

__all__ = ["save_checkpoint", "load_flat", "latest_step", "as_float_array"]

_STEP_RE = re.compile(r"step_(\d+)\.npz$")


def save_checkpoint(directory: str, step: int,
                    flat: Dict[str, np.ndarray]) -> str:
    """Write ``flat`` as ``directory/step_<step>.npz`` (atomic rename)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in flat.items()})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint's raw flat {'/'-joined key -> np.ndarray} dict.
    Opaque (void) dtypes are returned as they are; ``as_float_array``
    reads the bfloat16 ones."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := _STEP_RE.search(f))]
    return max(steps) if steps else None


def as_float_array(arr: np.ndarray) -> np.ndarray:
    """``arr`` with 2-byte opaque leaves read as bfloat16.

    ``np.load`` returns the JAX package's bfloat16 leaves as raw 2-byte
    void data (and an in-memory bfloat16 array has a void-kind dtype
    too). bfloat16 is the top half of a float32, so shifting the 16 bits
    into the high half of a uint32 gives the exact float32 value -- no
    ``ml_dtypes`` needed."""
    if arr.dtype.kind != "V":
        return arr
    if arr.dtype.itemsize != 2:
        raise ValueError(f"cannot reinterpret opaque dtype {arr.dtype}")
    bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.uint32)
    return (bits << 16).view(np.float32)
