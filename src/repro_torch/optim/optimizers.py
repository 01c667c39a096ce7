"""A minimal optimizer library over pytrees of tensors.

Port of ``repro.optim.optimizers``: SGD is the paper's optimizer
(SDM-DSGD is an SGD-family method); momentum and AdamW serve the
non-private examples. Each is an ``Optimizer`` with the JAX package's
functional protocol, ``init(params) -> OptState`` and
``update(grads, state, params) -> (new params, new state)``, over any
tree ``repro_torch.tree`` walks. Nothing is updated in place.

Not ``torch.optim``: its update differs. AdamW here steps in f32 and
casts the result back to each parameter's dtype, as the JAX version
does. The step counter is a 0-d int32 tensor on the parameters' device,
and a schedule (``cosine_schedule``) is a function of it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as tree_mod

__all__ = ["OptState", "Optimizer", "sgd", "momentum", "adamw",
           "cosine_schedule", "global_norm_clip"]

PyTree = Any


class OptState(NamedTuple):
    step: torch.Tensor
    mu: Optional[PyTree] = None
    nu: Optional[PyTree] = None


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], OptState]
    update: Callable[[PyTree, OptState, PyTree], Tuple[PyTree, OptState]]


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _step0(params: PyTree) -> torch.Tensor:
    leaves = tree_mod.leaves(params)
    dev = leaves[0].device if leaves else "cpu"
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd(lr) -> Optimizer:
    """p <- p - lr g (``lr`` a float or a schedule of the step)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return OptState(step=_step0(params))

    def update(grads, state, params):
        step_lr = lr_fn(state.step)
        new = tree_mod.tree_map(lambda p, g: p - step_lr * g.to(p.dtype),
                                params, grads)
        return new, OptState(step=state.step + 1)

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9) -> Optimizer:
    """Heavy ball: mu <- beta mu + g, p <- p - lr mu."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return OptState(step=_step0(params),
                        mu=tree_mod.tree_map(torch.zeros_like, params))

    def update(grads, state, params):
        mu = tree_mod.tree_map(lambda m, g: beta * m + g.to(m.dtype),
                               state.mu, grads)
        step_lr = lr_fn(state.step)
        new = tree_mod.tree_map(lambda p, m: p - step_lr * m, params, mu)
        return new, OptState(step=state.step + 1, mu=mu)

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with f32 moments; the step is taken in f32 and cast back to
    each parameter's dtype."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def zeros(t):
            return tree_mod.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), t)
        return OptState(step=_step0(params), mu=zeros(params),
                        nu=zeros(params))

    def update(grads, state, params):
        t = state.step + 1
        mu = tree_mod.tree_map(
            lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
            state.mu, grads)
        nu = tree_mod.tree_map(
            lambda n, g: b2 * n + (1 - b2) * torch.square(
                g.to(torch.float32)), state.nu, grads)
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(b1, tf)
        bc2 = 1 - torch.pow(b2, tf)
        step_lr = lr_fn(state.step)

        def upd(p, m, n):
            mhat = m / bc1
            nhat = n / bc2
            delta = mhat / (torch.sqrt(nhat) + eps) \
                + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - step_lr * delta).to(p.dtype)

        return (tree_mod.tree_map(upd, params, mu, nu),
                OptState(t, mu, nu))

    return Optimizer(init, update)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor`` x peak at ``total``: an f32 0-d tensor a step."""
    def fn(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * s / max(warmup, 1)
        progress = torch.clamp((s - warmup) / max(total - warmup, 1),
                               0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * progress)))
        return torch.where(s < warmup, warm, cos)

    return fn


def global_norm_clip(grads: PyTree, max_norm: float
                     ) -> Tuple[PyTree, torch.Tensor]:
    """``grads`` scaled so their global l2 norm is at most ``max_norm``,
    and that norm (f32) before the scaling."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_mod.leaves(grads)))
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return (tree_mod.tree_map(lambda g: g * scale.to(g.dtype), grads),
            norm)
