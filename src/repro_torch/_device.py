"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device, *, allow_meta: bool = False) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is available (the port never falls back to the CPU on
    its own -- pass ``device="cpu"`` to run there). ``meta`` (shapes, no
    data) is taken only with ``allow_meta=True``: the dry-run's opt-in
    (``launch/dryrun``), through ``init_params`` and ``StackTransport``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type == "meta" and allow_meta:
        return dev
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
