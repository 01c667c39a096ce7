"""Identity tags and event markers the static auditor keys on.

Port of ``repro.core.tagging``. The privacy argument (paper Theorem 1)
is about the computation a step performs: what crosses the wire must be
a clipped, Gaussian-masked, sparsified differential.
``repro_torch.analysis`` proves that over an fx graph of the step
(``make_fx``), and a graph has no notion of "this add was the DP mask";
these ops give it one. Each is a ``torch.library`` custom op in the
``repro_torch`` namespace (a fake impl for tracing, an identity
gradient) whose node survives into the graph with its inputs:

* ``sanitize(tree)`` -- ``sdm_dsgd.masked_grad``, after clip -> +
  sigma * normal, only when sigma > 0. Clears data taint.
* ``wire_payload(x)`` -- ``gossip`` on every buffer it sends: the one
  vetted transport layer. A send whose operand is not the direct output
  of this tag bypassed it.
* ``declared_release(x)`` -- a deliberate release of a data-derived
  aggregate (the training-loss ``pmean``), listed by the auditor.
* ``clip_bound(tree, bound=C)`` -- ``clipping.clip_tree``: the clamp
  constant C, which the sensitivity pass seeds its bound at and checks
  against the config.
* ``pending_buffer(x)`` -- the overlapped exchange's fresh neighbour
  sums (``overlap``), which must be consumed one step later.

JAX gets three more facts from its primitives that the port marks
itself: ``collective`` (every ``ppermute`` / ``ppermute_start`` /
``ppermute_done`` / ``pmean`` of ``core/transport.py``, with its
permutation), the PRNG events (``prng_fold_in``, ``prng_split`` and
``prng_draw``, which also compute the key or the draw in one node, so a
threefry call is one node and not dozens of int64 ops) and
``loop_iteration`` (the unrolled loop's step boundaries, where JAX has
a ``scan``).

Every function here returns its input untouched unless ``recording()``
is on, and only the auditor's trace turns it on (``record()``): the
eager step runs no extra op. While recording, each tag returns a copy of
its input (a custom op may not alias it), so the values are the same.
"""
from __future__ import annotations

import contextlib
import os
import sys
from typing import Any, List, Optional, Sequence

import torch

from repro_torch import tree as tree_mod

__all__ = ["SANITIZE", "WIRE", "RELEASE", "CLIP", "PENDING", "COLLECTIVE",
           "ITERATION", "FOLD_IN", "SPLIT", "DRAW", "recording", "record",
           "iteration", "sanitize", "wire_payload", "declared_release",
           "clip_bound", "pending_buffer", "collective", "prng_fold_in",
           "prng_split", "prng_draw", "define_op"]

NAMESPACE = "repro_torch"
SANITIZE = "privacy_sanitize"
WIRE = "wire_payload"
RELEASE = "declared_release"
CLIP = "clip_bound"
PENDING = "pending_buffer"
COLLECTIVE = "collective"
ITERATION = "loop_iteration"
FOLD_IN = "prng_fold_in"
SPLIT = "prng_split"
DRAW = "prng_draw"

_STATE = {"on": False, "step": -1}


def recording() -> bool:
    """Whether the tags and markers are being recorded."""
    return _STATE["on"]


@contextlib.contextmanager
def record(on: bool = True):
    """Turn recording on (or off) inside the block."""
    old = _STATE["on"]
    _STATE["on"] = on
    try:
        yield
    finally:
        _STATE["on"] = old


@contextlib.contextmanager
def iteration(index: int):
    """Step ``index`` of an unrolled training loop: while recording, a
    ``loop_iteration`` node opens the step and another (index -1) closes
    it, so every node of the graph belongs to one step or to none."""
    if not recording():
        yield
        return
    torch.ops.repro_torch.loop_iteration(int(index))
    old, _STATE["step"] = _STATE["step"], int(index)
    try:
        yield
    finally:
        _STATE["step"] = old
        torch.ops.repro_torch.loop_iteration(-1)


_SKIP = tuple(os.path.join(os.path.dirname(os.path.dirname(__file__)), f)
              for f in ("core/tagging.py", "prng.py", "core/transport.py",
                        "tree.py"))


def _site() -> str:
    """'file:line' of the innermost caller outside this module, the PRNG,
    the transport, the tree helpers and torch: where a tag was placed."""
    frame = sys._getframe(1)
    torch_dir = os.path.dirname(torch.__file__)
    while frame is not None:
        fname = frame.f_code.co_filename
        if not (fname.startswith(_SKIP) or fname.startswith(torch_dir)
                or fname.startswith("<")
                or os.path.basename(fname) in ("contextlib.py",
                                               "functools.py")):
            parts = fname.replace(os.sep, "/").split("/")
            for root in ("repro_torch", "tests"):
                if root in parts:
                    fname = "/".join(parts[parts.index(root):])
                    break
            return f"{fname}:{frame.f_lineno}"
        frame = frame.f_back
    return "?"


# --------------------------------------------------------------------------
# The custom ops.
# --------------------------------------------------------------------------

def define_op(name: str, impl, fake, *, device_types=None,
              identity_grad: bool = False):
    """Register ``impl`` as ``repro_torch::name`` (``device_types``: the
    devices it serves, all if None) with its fake impl."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", mutates_args=(),
                                 device_types=device_types)(impl)
    op.register_fake(fake)
    if identity_grad:
        op.register_autograd(
            lambda ctx, grad: (grad,) + (None,) * ctx.n_extra,
            setup_context=lambda ctx, inputs, output: setattr(
                ctx, "n_extra", len(inputs) - 1))


def _sanitize(x: torch.Tensor, label: str, site: str, leaf: int,
              node_dims: int) -> torch.Tensor:
    return x.clone()


def _wire(x: torch.Tensor, label: str, site: str) -> torch.Tensor:
    return x.clone()


def _release(x: torch.Tensor, label: str, site: str) -> torch.Tensor:
    return x.clone()


def _clip(x: torch.Tensor, bound: float, site: str, leaf: int
          ) -> torch.Tensor:
    return x.clone()


def _pending(x: torch.Tensor, label: str, site: str, step: int
             ) -> torch.Tensor:
    return x.clone()


def _collective(x: torch.Tensor, kind: str, perm: List[int], uid: int,
                site: str) -> torch.Tensor:
    return x.clone()


def _iteration(index: int) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64)


def _iteration_fake(index):
    return torch.empty((), dtype=torch.int64)


def _fold_in(key: torch.Tensor, data: Optional[torch.Tensor],
             data_int: Optional[int], site: str) -> torch.Tensor:
    from repro_torch import prng

    with record(False):
        return prng.fold_in(key, data if data is not None else data_int)


def _fold_in_fake(key, data, data_int, site):
    batch = tuple(key.shape[:-1])
    if data is not None:
        batch = tuple(torch.broadcast_shapes(batch, tuple(data.shape)))
    return key.new_empty(batch + (2,))


def _split(key: torch.Tensor, num: int, site: str) -> torch.Tensor:
    from repro_torch import prng

    with record(False):
        return prng.split(key, num)


def _split_fake(key, num, site):
    return key.new_empty(tuple(key.shape[:-1]) + (num, 2))


def _draw(key: torch.Tensor, shape: List[int], dist: str, minval: float,
          maxval: float, dtype: torch.dtype, site: str) -> torch.Tensor:
    from repro_torch import prng

    with record(False):
        if dist == "bits":
            return prng.bits(key, shape)
        if dist == "uniform":
            return prng.uniform(key, shape, minval, maxval)
        return prng.normal(key, shape, dtype=dtype)


def _draw_fake(key, shape, dist, minval, maxval, dtype, site):
    out = tuple(key.shape[:-1]) + tuple(shape)
    return key.new_empty(out, dtype=torch.int64 if dist == "bits" else dtype)


def _like(x, *args):
    return torch.empty_like(x)


define_op(SANITIZE, _sanitize, _like, identity_grad=True)
define_op(WIRE, _wire, _like, identity_grad=True)
define_op(RELEASE, _release, _like, identity_grad=True)
define_op(CLIP, _clip, _like, identity_grad=True)
define_op(PENDING, _pending, _like, identity_grad=True)
define_op(COLLECTIVE, _collective, _like, identity_grad=True)
define_op(ITERATION, _iteration, _iteration_fake)
define_op(FOLD_IN, _fold_in, _fold_in_fake)
define_op(SPLIT, _split, _split_fake)
define_op(DRAW, _draw, _draw_fake)


# --------------------------------------------------------------------------
# The tags.
# --------------------------------------------------------------------------

def sanitize(tree: Any, *, label: str = "gaussian_mask",
             node_dims: int = 0) -> Any:
    """Mark every leaf of ``tree`` as DP-sanitized. ``node_dims`` leading
    dims index nodes (a node block's noise is drawn per node), so one
    node's sensitivity is over the remaining dims."""
    if not recording():
        return tree
    site = _site()
    leaves, struct = tree_mod.flatten(tree)
    return tree_mod.unflatten(struct, [
        torch.ops.repro_torch.privacy_sanitize(v, label, site, i,
                                               int(node_dims))
        for i, v in enumerate(leaves)])


def wire_payload(x: torch.Tensor, *, label: str = "gossip") -> torch.Tensor:
    """Mark ``x`` as a vetted wire buffer."""
    if not recording():
        return x
    return torch.ops.repro_torch.wire_payload(x, label, _site())


def declared_release(tree: Any, *, label: str = "metric") -> Any:
    """Mark ``tree`` as a deliberate data-derived release."""
    if not recording():
        return tree
    site = _site()
    return tree_mod.tree_map(
        lambda v: torch.ops.repro_torch.declared_release(v, label, site),
        tree)


def clip_bound(tree: Any, *, bound: float) -> Any:
    """Declare every leaf coordinate-clamped to [-bound, bound]."""
    if not recording():
        return tree
    site = _site()
    leaves, struct = tree_mod.flatten(tree)
    return tree_mod.unflatten(struct, [
        torch.ops.repro_torch.clip_bound(v, float(bound), site, i)
        for i, v in enumerate(leaves)])


def pending_buffer(tree: Any, *, label: str = "overlap") -> Any:
    """Mark the overlap's fresh neighbour sums. The tag carries the loop
    step that made them (``step``; -1 outside ``iteration``). A
    ``transport.Pending`` leaf is tagged lazily: its node lands where
    the executor waits on it (the next step, or ``settle``), after the
    exchange's ``ppermute_done``, so a start never waited on leaves no
    done and no tag."""
    if not recording():
        return tree
    from repro_torch.core.transport import Pending

    site, step = _site(), _STATE["step"]

    def tag(v):
        return torch.ops.repro_torch.pending_buffer(v, label, site, step)

    def one(v):
        if isinstance(v, Pending):
            return Pending(lambda: tag(v.wait()))
        return tag(v)

    return tree_mod.tree_map(one, tree)


def collective(x: torch.Tensor, kind: str, perm: Sequence = (), *,
               uid: int = 0) -> torch.Tensor:
    """Mark a collective's operand (``kind``: ppermute, ppermute_start,
    ppermute_done, pmean); ``perm`` its (src, dst) pairs, ``uid`` pairs a
    start with its done."""
    if not recording():
        return x
    flat = [int(v) for pair in perm for v in pair]
    return torch.ops.repro_torch.collective(x, kind, flat, int(uid), _site())


def prng_fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``prng.fold_in`` as one recorded node."""
    if isinstance(data, torch.Tensor):
        return torch.ops.repro_torch.prng_fold_in(key, data, None, _site())
    return torch.ops.repro_torch.prng_fold_in(key, None, int(data), _site())


def prng_split(key: torch.Tensor, num: int) -> torch.Tensor:
    """``prng.split`` as one recorded node (consumes ``key``)."""
    return torch.ops.repro_torch.prng_split(key, int(num), _site())


def prng_draw(key: torch.Tensor, shape, dist: str, minval: float = 0.0,
              maxval: float = 1.0, dtype: torch.dtype = torch.float32
              ) -> torch.Tensor:
    """A draw (``dist``: bits, uniform, normal) as one recorded node
    (consumes ``key``)."""
    return torch.ops.repro_torch.prng_draw(
        key, [int(s) for s in shape], dist, float(minval), float(maxval),
        dtype, _site())
