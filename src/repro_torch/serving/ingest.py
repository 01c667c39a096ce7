"""Checkpoint ingest: trainer npz -> one consensus serving model.

Port of ``repro.serving.ingest``. The decentralized trainer checkpoints
the whole algorithm state with the n node replicas stacked on a leading
``(n, ...)`` axis under the ``x`` field. Ingest:

1. locates the params subtree inside the flat checkpoint (the shortest
   key prefix -- ``x`` for every trainer state, ``''`` for a raw params
   checkpoint -- under which EVERY model parameter path exists),
2. de-biases push-sum mass if the state carries per-node weights
   (``z_i = x_i / w_i``),
3. consensus-averages the replicas into one model (in float64), and
4. reports the max cross-node disagreement -- how far the fleet was from
   consensus when the snapshot was taken.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import as_float_array, latest_step, load_flat
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Params, flat_specs, unflatten

__all__ = ["IngestReport", "consensus_from_flat", "ingest_checkpoint"]


@dataclasses.dataclass
class IngestReport:
    path: str
    prefix: str              # key prefix the params were found under
    n_nodes: int             # replicas averaged (1 = raw params ckpt)
    debiased: bool           # push-sum x/w de-bias applied
    max_disagreement: float  # max_i,leaf |z_i - mean| across the fleet
    rms_disagreement: float
    worst_leaf: str          # param path attaining max_disagreement

    def __str__(self) -> str:
        return (f"ingested {self.path} [prefix={self.prefix!r} "
                f"n_nodes={self.n_nodes} debias={self.debiased}] "
                f"disagreement max={self.max_disagreement:.3e} "
                f"(rms={self.rms_disagreement:.3e}, at {self.worst_leaf})")


def _find_prefix(flat: Dict[str, np.ndarray], param_keys) -> str:
    """Shortest prefix P such that P/k exists for every param key k
    ('' means the checkpoint IS a raw params tree)."""
    k0 = param_keys[0]
    cands = set()
    if k0 in flat:
        cands.add("")
    for key in flat:
        if key.endswith("/" + k0):
            cands.add(key[: -len(k0) - 1])

    def full(p, k):
        return k if p == "" else f"{p}/{k}"

    cands = [p for p in cands if all(full(p, k) in flat for k in param_keys)]
    if not cands:
        raise KeyError(
            f"checkpoint holds none of the model's parameters (looked for "
            f"{k0!r} under any prefix; checkpoint keys start "
            f"{sorted(flat)[:4]})")
    # 'x' (trainer state) and '' (raw params) are the expected layouts;
    # both sort first by length. 's'/'xhat' replicas lose the tie-break.
    cands.sort(key=lambda p: (len(p), p != "x", p))
    return cands[0]


def consensus_from_flat(flat: Dict[str, np.ndarray], cfg: ModelConfig, *,
                        dtype: torch.dtype = torch.float32, device="cuda",
                        path: str = "<flat>") -> Tuple[Params, IngestReport]:
    """Average the stacked node replicas in a flat checkpoint dict into
    one serving parameter tree. Returns (params, IngestReport)."""
    dev = resolve_device(device)
    specs = flat_specs(cfg)
    param_keys = [k for k, _ in specs]
    prefix = _find_prefix(flat, param_keys)

    def full(k):
        return k if prefix == "" else f"{prefix}/{k}"

    first = as_float_array(flat[full(param_keys[0])])
    want0 = specs[0][1].shape
    if tuple(first.shape) == want0:
        n = 1
    elif first.ndim == len(want0) + 1 and tuple(first.shape[1:]) == want0:
        n = first.shape[0]
    else:
        raise ValueError(
            f"param {param_keys[0]!r} has shape {first.shape}, expected "
            f"{want0} or (n,)+{want0} -- wrong --arch for this checkpoint?")

    w = None
    if n > 1 and prefix == "x" and "w" in flat:
        wr = np.asarray(as_float_array(flat["w"]), np.float64).reshape(-1)
        if wr.shape == (n,):     # push-sum: the model estimate is x/w
            w = wr

    out, max_d, sq_sum, sq_n, worst = {}, 0.0, 0.0, 0, "-"
    for key, spec in specs:
        want = spec.shape
        arr = np.asarray(as_float_array(flat[full(key)]), np.float64)
        if n == 1:
            mean = arr if tuple(arr.shape) == tuple(want) else arr[0]
        else:
            if arr.shape[0] != n:
                raise ValueError(f"param {key!r}: replica axis "
                                 f"{arr.shape[0]} != {n}")
            z = arr / w.reshape((n,) + (1,) * (arr.ndim - 1)) \
                if w is not None else arr
            mean = z.mean(axis=0)
            d = np.abs(z - mean)
            dm = float(d.max())
            if dm > max_d:
                max_d, worst = dm, key
            sq_sum += float((d * d).sum())
            sq_n += d.size
        if tuple(mean.shape) != tuple(want):
            raise ValueError(f"param {key!r}: shape {mean.shape} != {want}")
        out[key] = torch.as_tensor(mean).to(dtype).to(dev)
    report = IngestReport(
        path=path, prefix=prefix, n_nodes=n, debiased=w is not None,
        max_disagreement=max_d,
        rms_disagreement=(sq_sum / sq_n) ** 0.5 if sq_n else 0.0,
        worst_leaf=worst)
    return unflatten(out), report


def ingest_checkpoint(path: str, cfg: ModelConfig, *,
                      step: Optional[int] = None,
                      dtype: torch.dtype = torch.float32, device="cuda"
                      ) -> Tuple[Params, IngestReport]:
    """Load a trainer checkpoint (file, or directory of step_*.npz) and
    consensus-average it into a single serving model."""
    if os.path.isdir(path):
        s = step if step is not None else latest_step(path)
        if s is None:
            raise FileNotFoundError(f"no checkpoints in {path}")
        path = os.path.join(path, f"step_{s:08d}.npz")
    return consensus_from_flat(load_flat(path), cfg, dtype=dtype,
                               device=device, path=path)
