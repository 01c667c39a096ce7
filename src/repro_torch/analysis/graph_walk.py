"""Shared abstract interpretation over an fx graph of the port's step.

Port of ``repro.analysis.jaxpr_walk``. The JAX package walks a jaxpr and
recurses through its call, scan and branch boundaries; the port traces
its distributed step with ``make_fx`` (``trace``), functionalized, so the
graph is straight-line SSA: no views, no mutation, the training loop
unrolled and Python's control flow already taken. ``GraphInterpreter``
runs one forward pass over the nodes, one abstract value per node.
Subclasses define the lattice (``bottom`` / ``join``) and the transfer
rules (``transfer``, keyed by op name: ``aten.add``, ``repro_torch.
collective``, ...); an op without a rule gets ``default`` (the join of
its inputs), and a pass that must be conservative about unknown ops says
so in its own default.

The walker also keeps what several passes need:

* ``iteration[node]``: the unrolled loop step a node belongs to (the
  ``loop_iteration`` markers, ``core/tagging.iteration``), -1 outside;
* ``consts[node]``: the concrete value of every node that is a function
  of the graph's constants only (lifted tensors and factories, folded
  while the value stays small), and ``literal(arg)``, a Python number or
  such a constant holding one element: what JAX calls a literal.

View ops come out of functionalization as ``*_copy`` ops; ``op_of``
drops the suffix (``aten.view_copy`` is ``aten.view``).
"""
from __future__ import annotations

import contextlib
import operator
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.core import tagging

__all__ = ["GraphInterpreter", "trace", "op_of", "tensor_args",
           "node_shape", "node_dtype", "SHAPE_ONLY", "tag_args"]

# view ops whose functionalized form is ``<name>_copy``
_VIEWS = frozenset({
    "view", "reshape", "slice", "select", "expand", "permute", "transpose",
    "t", "unsqueeze", "squeeze", "alias", "detach", "unbind", "split",
    "split_with_sizes", "as_strided", "diagonal", "unfold", "narrow",
    "lift_fresh", "_unsafe_view", "view_as_real", "view_as_complex",
    "_reshape_alias", "unsafe_split", "chunk", "_neg_view", "_conj",
    "indices", "values", "expand_as", "view_as"})

#: ops whose output depends on their inputs' shapes only, never on values
SHAPE_ONLY = frozenset({
    "aten.zeros_like", "aten.ones_like", "aten.empty_like", "aten.full_like",
    "aten.new_zeros", "aten.new_ones", "aten.new_empty", "aten.new_full",
    "aten.empty_strided", "aten.zeros", "aten.ones", "aten.full",
    "aten.empty", "aten.arange", "aten.scalar_tensor", "aten.sym_size",
    "aten.new_empty_strided", "aten.eye", "aten.linspace"})

# factories whose contents are undefined: never a constant
_UNDEFINED = frozenset({"aten.empty", "aten.empty_like", "aten.new_empty",
                        "aten.empty_strided", "aten.new_empty_strided"})

_FOLD_MAX = 1 << 16        # largest constant the walker evaluates


def op_of(node) -> str:
    """'aten.add', 'repro_torch.collective', 'getitem', or the node's
    op kind ('placeholder', 'get_attr', 'output')."""
    if node.op != "call_function":
        return node.op
    target = node.target
    if target is operator.getitem:
        return "getitem"
    schema = getattr(target, "_schema", None)
    if schema is None:
        return getattr(target, "__name__", str(target))
    ns, _, name = schema.name.partition("::")
    if ns == "aten" and name.endswith("_copy") and name[:-5] in _VIEWS:
        name = name[:-5]
    return f"{ns}.{name}"


def _flat(args) -> List[Any]:
    out: List[Any] = []
    for a in args:
        if isinstance(a, (list, tuple)):
            out.extend(_flat(a))
        else:
            out.append(a)
    return out


def tensor_args(node) -> List[Any]:
    """The fx nodes among a node's args and kwargs, in order."""
    flat = _flat(list(node.args) + list(node.kwargs.values()))
    return [a for a in flat if isinstance(a, torch.fx.Node)]


def _val(node):
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else None


def node_shape(node) -> Optional[tuple]:
    v = _val(node)
    return tuple(v.shape) if isinstance(v, torch.Tensor) else None


def node_dtype(node) -> Optional[torch.dtype]:
    v = _val(node)
    return v.dtype if isinstance(v, torch.Tensor) else None


def tag_args(node) -> Dict[str, Any]:
    """A ``repro_torch`` op's arguments by name (its schema's)."""
    schema = node.target._schema
    out = {}
    for i, arg in enumerate(schema.arguments):
        if i < len(node.args):
            out[arg.name] = node.args[i]
        elif arg.name in node.kwargs:
            out[arg.name] = node.kwargs[arg.name]
    return out


@contextlib.contextmanager
def _fake_meta_mode():
    """One FakeTensorMode for every node's metadata: without it
    ``make_fx`` in real mode builds a new mode (with a stack trace) for
    each node, which dominates the trace time."""
    from torch._guards import TracingContext, tracing
    from torch._subclasses.fake_tensor import FakeTensorMode

    with tracing(TracingContext(FakeTensorMode(allow_fallback_kernels=True))):
        yield


def trace(fn: Callable, *args) -> torch.fx.GraphModule:
    """``fn(*args)`` run once for real with the tags recording, traced
    (``make_fx``, functionalized) into a straight-line graph."""
    from torch.func import functionalize

    with tagging.record(), _fake_meta_mode():
        return make_fx(functionalize(fn, remove="mutations_and_views"),
                       tracing_mode="real")(*args)


class GraphInterpreter:
    """Forward abstract interpreter base; subclass and override."""

    # ---- lattice ---------------------------------------------------------
    def bottom(self):
        raise NotImplementedError

    def join(self, a, b):
        raise NotImplementedError

    # ---- transfer --------------------------------------------------------
    def transfer(self, node, name: str, ins: List) -> "Any | None":
        """Out value (a list for a multi-output op) or None for
        ``default``. ``ins`` are the values of ``tensor_args(node)``
        (for ``aten.copy`` only its source)."""
        return None

    def default(self, node, name: str, ins: List):
        out = self.bottom()
        for v in ins:
            out = self.join(out, v)
        return out

    # ---- helpers ---------------------------------------------------------
    def literal(self, arg) -> Optional[float]:
        """A Python number, or a constant holding one element."""
        if isinstance(arg, (int, float)):
            return float(arg)
        if isinstance(arg, torch.fx.Node):
            c = self.consts.get(arg)
            if isinstance(c, torch.Tensor) and c.numel() == 1 \
                    and not c.is_complex():
                return float(c.reshape(()).item())
        return None

    def value(self, arg):
        """The abstract value of an argument (bottom for a non-node)."""
        if isinstance(arg, torch.fx.Node):
            return self.env.get(arg, self.bottom())
        return self.bottom()

    # ---- the walk --------------------------------------------------------
    def run(self, gm: torch.fx.GraphModule, in_vals: Sequence) -> List:
        """Walk ``gm``; ``in_vals`` are the placeholders' values (missing
        ones are bottom). Returns the output values."""
        self.gm = gm
        self.env: Dict[Any, Any] = {}
        self.consts: Dict[Any, Any] = {}
        self.iteration: Dict[Any, int] = {}
        step, n_ph, outs = -1, 0, []
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                self.env[node] = in_vals[n_ph] if n_ph < len(in_vals) \
                    else self.bottom()
                n_ph += 1
                continue
            if node.op == "get_attr":
                self.consts[node] = getattr(gm, node.target)
                self.env[node] = self.bottom()
                continue
            if node.op == "output":
                outs = [self.value(a) for a in _flat(node.args)]
                continue
            name = op_of(node)
            if name == "repro_torch." + tagging.ITERATION:
                step = int(node.args[0])
                self.env[node] = self.bottom()
                continue
            self.iteration[node] = step
            self.env[node] = self._eval(node, name)
            self._fold(node, name)
        self.outputs = outs
        return outs

    def _eval(self, node, name: str):
        if name == "getitem":
            src, idx = node.args
            v = self.value(src)
            return v[idx] if isinstance(v, list) else v
        if name in SHAPE_ONLY:
            return self._fit(node, self.bottom())
        if name == "aten.copy":
            ins = [self.value(node.args[1])]
        else:
            ins = [self.value(a) for a in tensor_args(node)]
        out = self.transfer(node, name, ins)
        if out is None:
            out = self.default(node, name, ins)
        return self._fit(node, out)

    def _fit(self, node, out):
        """A multi-output op's value as a list (one value per output)."""
        v = _val(node)
        if isinstance(v, (list, tuple)) and not isinstance(out, list):
            return [out] * len(v)
        return out

    def _fold(self, node, name: str) -> None:
        """Evaluate a node whose inputs are all constants (aten ops only,
        small outputs)."""
        if name == "getitem":
            c = self.consts.get(node.args[0])
            if isinstance(c, (list, tuple)):
                self.consts[node] = c[node.args[1]]
            return
        if not name.startswith("aten.") or name in _UNDEFINED:
            return
        ins = tensor_args(node)
        if any(a not in self.consts for a in ins):
            return
        v = _val(node)
        outs = v if isinstance(v, (list, tuple)) else [v]
        if not all(isinstance(o, torch.Tensor) and o.numel() <= _FOLD_MAX
                   for o in outs):
            return

        def sub(a):
            if isinstance(a, torch.fx.Node):
                return self.consts[a]
            if isinstance(a, (list, tuple)):
                return type(a)(sub(x) for x in a)
            return a

        try:
            with tagging.record(False):
                self.consts[node] = node.target(
                    *[sub(a) for a in node.args],
                    **{k: sub(a) for k, a in node.kwargs.items()})
        except Exception:      # a fold is an optimisation: skip on failure
            pass
