"""Optimizers over pytrees of tensors (port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (OptState, Optimizer, adamw,
                                          cosine_schedule, global_norm_clip,
                                          momentum, sgd)

__all__ = ["OptState", "Optimizer", "sgd", "momentum", "adamw",
           "cosine_schedule", "global_norm_clip"]
