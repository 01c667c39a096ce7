"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "host_to_device"]


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


def host_to_device(array, device: torch.device) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) on ``device``. On CUDA the
    copy goes through pinned memory and does not wait for the stream: a
    copy from pageable memory (``torch.as_tensor(array, device=cuda)``)
    synchronizes the host with the stream after it. On the CPU the
    result may share ``array``'s memory, as ``torch.as_tensor``'s does."""
    t = torch.as_tensor(array)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
