"""Flat-key .npz checkpoints.

The same file format as ``repro.checkpoint.npz``: one ``np.savez``
archive per step, named ``step_<8 digits>.npz``, whose keys are the
'/'-joined tree paths of the saved state (``tree_keys``: dict keys,
NamedTuple field names and sequence indices, as the JAX package's
``_path_str`` writes them). bfloat16 leaves are stored as 2-byte opaque
data, as ``np.savez`` stores the JAX package's. ``save_checkpoint``
takes any tree (a flat ``{key: array}`` dict is one whose keys are its
paths); ``restore_checkpoint`` rebuilds a tree from an exemplar.

``restore_checkpoint`` reads a tensor leaf stored uncompressed in the
exemplar's own dtype (``np.savez``'s archives; a bfloat16 leaf as 2-byte
opaque data) straight from the file's bytes into the restored tensor,
on the card through two pinned staging chunks whose copies overlap the
next read. That path checks the archive's layout but not the members'
CRC-32; any other leaf goes through ``np.load`` and a cast.
"""
from __future__ import annotations

import os
import re
import struct
import tempfile
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch._device import resolve_device

__all__ = ["save_checkpoint", "restore_checkpoint", "tree_keys", "load_flat",
           "latest_step", "as_float_array"]

_STEP_RE = re.compile(r"step_(\d+)\.npz$")
_CHUNK = 1 << 26        # bytes a staging read on the way to the card


def _to_numpy(v) -> np.ndarray:
    """A leaf as numpy; a bfloat16 tensor as 2-byte opaque data."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view("V2")
        return v.numpy()
    return np.asarray(v)


def tree_keys(tree: Any) -> List[str]:
    """The '/'-joined flat keys of ``tree``, in flatten order (the keys
    ``save_checkpoint`` writes)."""
    return list(tree_mod.flatten_with_paths(tree))


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Write ``tree`` as ``directory/step_<step>.npz`` (atomic rename)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:08d}.npz")
    flat = {k: _to_numpy(v)
            for k, v in tree_mod.flatten_with_paths(tree).items()}
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _restore_leaf(key: str, arr: np.ndarray, leaf, device):
    """``arr`` as the exemplar ``leaf``: cast to its dtype, a tensor on
    ``device`` (or the leaf's own device), a host scalar as its type."""
    if isinstance(leaf, torch.Tensor):
        if arr.dtype.kind == "V":
            if leaf.element_size() != arr.dtype.itemsize:
                raise ValueError(
                    f"checkpoint leaf {key!r} has opaque dtype {arr.dtype} "
                    f"({arr.dtype.itemsize} B) but the exemplar expects "
                    f"{leaf.dtype} ({leaf.element_size()} B)")
            arr = as_float_array(arr) if leaf.dtype == torch.bfloat16 \
                else arr.view(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=leaf.device if device is None else device,
            dtype=leaf.dtype)
    if hasattr(leaf, "dtype"):
        want = np.dtype(leaf.dtype)
        if arr.dtype.kind == "V":
            if want.itemsize != arr.dtype.itemsize:
                raise ValueError(
                    f"checkpoint leaf {key!r} has opaque dtype {arr.dtype} "
                    f"({arr.dtype.itemsize} B) but the exemplar expects "
                    f"{want} ({want.itemsize} B)")
            arr = arr.view(want)
        return arr.astype(want)
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(arr)      # a host scalar (a state's step)
    return arr


def _stored_arrays(path: str) -> Dict[str, tuple]:
    """{key: (dtype, shape, byte offset)} of the C-order arrays an npz
    stores uncompressed (the others are left out)."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED or \
                    not info.filename.endswith(".npy"):
                continue
            f.seek(info.header_offset)
            local = f.read(30)
            if local[:4] != b"PK\x03\x04":
                raise ValueError(f"{path}: bad local header for "
                                 f"{info.filename!r}")
            name_len, extra_len = struct.unpack("<HH", local[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            shape, fortran, dtype = (
                np.lib.format.read_array_header_1_0(f) if version == (1, 0)
                else np.lib.format.read_array_header_2_0(f))
            if not fortran and not dtype.hasobject:
                out[info.filename[:-4]] = (dtype, shape, f.tell())
    return out


def _readinto(f, view: memoryview) -> None:
    while len(view):
        got = f.readinto(view)
        if not got:
            raise EOFError("checkpoint file ends inside an array")
        view = view[got:]


def _read_raw(f, offset: int, out: torch.Tensor) -> torch.Tensor:
    """``out``'s bytes read from ``f`` at ``offset``: straight into a host
    tensor; for the card through two pinned chunks, each copied on while
    the other is read."""
    dst = out.view(-1).view(torch.uint8)
    f.seek(offset)
    if not dst.numel():
        return out
    if not out.is_cuda:
        _readinto(f, memoryview(dst.numpy()))
        return out
    size = min(_CHUNK, dst.numel())
    bufs = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)]
    copied = [None, None]
    for i, at in enumerate(range(0, dst.numel(), size)):
        n = min(size, dst.numel() - at)
        if copied[i % 2] is not None:
            copied[i % 2].synchronize()
        buf = bufs[i % 2]
        _readinto(f, memoryview(buf.numpy())[:n])
        dst[at:at + n].copy_(buf[:n], non_blocking=True)
        copied[i % 2] = torch.cuda.Event()
        copied[i % 2].record()
    torch.cuda.current_stream(out.device).synchronize()
    return out


def _raw_readable(dtype: np.dtype, leaf) -> bool:
    """Whether an array of ``dtype`` holds ``leaf``'s dtype bit for bit:
    the same native numpy dtype, or opaque data of its width (bfloat16
    as ``np.savez`` writes it)."""
    if not isinstance(leaf, torch.Tensor) or \
            dtype.itemsize != leaf.element_size():
        return False
    if dtype.kind == "V":
        return True
    if leaf.dtype == torch.bfloat16:
        return False
    return dtype == torch.empty(0, dtype=leaf.dtype).numpy().dtype


def restore_checkpoint(directory: str, exemplar: Any,
                       step: Optional[int] = None, *, device=None) -> Any:
    """The checkpoint of ``step`` (default: the latest) as a tree shaped
    like ``exemplar``: each leaf cast to the exemplar leaf's dtype
    (2-byte opaque leaves read as bfloat16 first), tensors placed on
    ``device`` or, by default, on the exemplar leaf's device. A key the
    file lacks raises ``KeyError``; an opaque leaf whose width differs
    from the exemplar's raises ``ValueError``, as in the JAX package."""
    if device is not None:
        device = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}.npz")
    leaves, treedef = tree_mod.flatten(exemplar)
    stored = _stored_arrays(path)
    out = []
    with np.load(path) as data, open(path, "rb", buffering=0) as raw:
        for key, leaf in zip(tree_keys(exemplar), leaves):
            if key not in data.files:
                raise KeyError(f"{key!r} is not a leaf of {path}")
            dtype, shape, offset = stored.get(key, (None, None, None))
            if dtype is not None and _raw_readable(dtype, leaf):
                dev = leaf.device if device is None else device
                out.append(_read_raw(raw, offset, torch.empty(
                    shape, dtype=leaf.dtype, device=dev)))
            else:
                out.append(_restore_leaf(key, data[key], leaf, device))
    return tree_mod.unflatten(treedef, out)


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
