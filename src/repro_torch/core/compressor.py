"""Pluggable compressor layer: what goes on the wire.

Port of ``repro.core.compressor``. Each registered family defines

    compress(key, x, node=...) -> Payload     # what a node transmits
    decompress(payload)        -> x_hat       # what a receiver rebuilds
    wire_elements / wire_bits  -> int         # exact cost accounting

Families: ``bernoulli`` (Definition 2, dense masked payload), ``fixedk``
/ ``block:B`` (exactly k = ceil(p * n_blocks) blocks, pad-to-max-k under
a per-node p), ``rows`` (fixed-k over trailing-dim rows), ``qsgd:b``
(per-tensor l2 norm + b-bit stochastic levels; 2- and 4-bit levels
packed 8/b per byte) and ``qsgdf:b`` (the same levels through the fused
quantize-and-pack kernel, norm bytes appended: one u8 buffer).

Batched use: the JAX reference vmaps compress over the node stack; here
a key of shape (n, 2) with x of shape (n, ...) compresses the n nodes in
one call (``node`` is then an (n,) index tensor when p is per-node).
The payload records that batch and ``decompress`` returns (n, ...).

Arithmetic follows the JAX package as ``jax.jit`` compiles it, so the
roundtrips agree bit for bit given the same inputs: a division by a
constant becomes a multiply by its f32 reciprocal (XLA's rewrite), a
constant divided by a tensor stays a true division.

The accounting (``wire_elements``, ``wire_bits``, the ``*_exact``
variants, ``node_mean_exact`` and the ``tree_wire_*_exact`` helpers) is
integer and ``Fraction`` arithmetic copied unchanged, so the port's
counts equal the JAX package's exactly. The sensitivity-transfer
declarations only the JAX package's static analyzer reads are not
ported.
"""
from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import prng, tree as tree_mod
from repro_torch.core import sparsifier

__all__ = ["Payload", "Compressor", "BernoulliCompressor", "FixedKCompressor",
           "RowsCompressor", "QSGDCompressor", "FusedQSGDCompressor", "make",
           "names", "register", "index_bits", "node_mean_exact",
           "tree_wire_elements_exact", "tree_wire_elements",
           "tree_wire_bits_exact", "tree_wire_bits"]


def index_bits(d: int) -> int:
    """Bits to address one of d coordinates: ceil(log2 d) (0 for d <= 1)."""
    return max(0, math.ceil(math.log2(d))) if d > 1 else 0


@dataclasses.dataclass
class Payload:
    """The wire format of one node (or of a stack of ``batch`` nodes).

    ``values`` is the packed/masked/quantized data, ``indices`` the
    explicit coordinate side-channel (None when dense), ``scale`` an
    optional per-node scalar (the QSGD norm). ``shape`` is the per-node
    tensor shape; ``batch`` the leading node dims of every field."""

    values: Any
    indices: Any = None
    scale: Any = None
    shape: Tuple[int, ...] = ()
    meta: Tuple = ()
    batch: Tuple[int, ...] = ()


def _as_p_tuple_or_float(p):
    if isinstance(p, (list, tuple)):
        p = tuple(float(v) for v in p)
        if not p:
            raise ValueError("per-node p must be non-empty")
        if any(not (0.0 < v <= 1.0) for v in p):
            raise ValueError("every per-node p must be in (0, 1]")
        return p
    if not (0.0 < float(p) <= 1.0):
        raise ValueError(f"p must be in (0, 1], got {p}")
    return float(p)


def _split_shape(key, x: torch.Tensor):
    """(key tensor, batch dims, per-node shape) of a compress call."""
    key = prng.key_data(key)
    lead = key.dim() - 1
    if tuple(x.shape[:lead]) != tuple(key.shape[:-1]):
        raise ValueError(f"keys {tuple(key.shape)} do not batch values "
                         f"{tuple(x.shape)}")
    return key, tuple(x.shape[:lead]), tuple(x.shape[lead:])


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-node (batch-shaped) tensor broadcastable over ``ndim``
    trailing dims."""
    return v.reshape(tuple(v.shape) + (1,) * ndim)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base: a transmit-probability-parameterized compressor. ``p`` may
    be a per-node tuple; ``compress(..., node=i)`` resolves node i's
    budget (``i`` an int or an index tensor)."""

    p: "float | Tuple[float, ...]" = 0.2

    def __post_init__(self) -> None:
        object.__setattr__(self, "p", _as_p_tuple_or_float(self.p))

    @property
    def p_max(self) -> float:
        return max(self.p) if isinstance(self.p, tuple) else self.p

    @property
    def p_min(self) -> float:
        return min(self.p) if isinstance(self.p, tuple) else self.p

    def p_of(self, node, device="cpu"):
        """Transmit probability of ``node``: the scalar, or an f32 gather
        of the per-node tuple."""
        if isinstance(self.p, tuple):
            if node is None:
                raise ValueError(
                    f"{self.name}: per-node p needs an explicit node=")
            table = torch.tensor(self.p, dtype=torch.float32, device=device)
            return table[torch.as_tensor(node, device=device)]
        return self.p

    @property
    def release_probability(self):
        """Per-coordinate release probability for the RDP accountant."""
        return self.p

    name: str = dataclasses.field(default="", init=False, repr=False)

    def compress(self, key, x: torch.Tensor, *, node=None) -> Payload:
        raise NotImplementedError

    def decompress(self, payload: Payload) -> torch.Tensor:
        raise NotImplementedError

    def wire_elements(self, shape: Tuple[int, ...], node: int | None = None
                      ) -> int:
        raise NotImplementedError

    def wire_bits(self, shape: Tuple[int, ...], *, value_bits: int = 32,
                  index_sync: bool = False, node: int | None = None) -> int:
        raise NotImplementedError

    def _p_static(self, node: int | None) -> float:
        if isinstance(self.p, tuple):
            return self.p[node] if node is not None else self.p_max
        return self.p

    def wire_elements_exact(self, shape, node=None) -> "Fraction | float":
        return float(self.wire_elements(shape, node=node))

    def wire_bits_exact(self, shape, *, value_bits=32, index_sync=False,
                        node=None) -> "Fraction | float":
        return float(self.wire_bits(shape, value_bits=value_bits,
                                    index_sync=index_sync, node=node))

    def coord_sensitivity_transfer(self, beta: float,
                                   shape: Tuple[int, ...]) -> float:
        """Worst-case coordinate bound after a compress -> decompress
        roundtrip of a tensor whose coordinates are bounded by ``beta``
        (the static auditor's certificate records it). A family that
        declares none is unbounded."""
        del shape
        return math.inf if beta > 0.0 else 0.0



# ==========================================================================
# Bernoulli (the paper's Definition-2 sparsifier; dense payload).
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class BernoulliCompressor(Compressor):
    """S(x): keep each coordinate w.p. p, scale kept by 1/p."""

    name: str = dataclasses.field(default="bernoulli", init=False, repr=False)

    def compress(self, key, x, *, node=None) -> Payload:
        key, batch, shape = _split_shape(key, x)
        if isinstance(self.p, tuple):
            p = _bcast(self.p_of(node, x.device), len(shape))
        else:
            p = self.p
        vals = sparsifier.bernoulli_sparsify(key, x, p)
        return Payload(values=vals, shape=shape, meta=("bernoulli",),
                       batch=batch)

    def decompress(self, payload: Payload) -> torch.Tensor:
        return payload.values

    def wire_elements_exact(self, shape, node=None) -> Fraction:
        return Fraction(repr(self._p_static(node))) * math.prod(shape)

    def wire_elements(self, shape, node=None) -> int:
        return int(round(self.wire_elements_exact(shape, node)))

    def wire_bits_exact(self, shape, *, value_bits=32, index_sync=False,
                        node=None) -> Fraction:
        d = int(math.prod(shape))
        per = value_bits + (0 if index_sync else index_bits(d))
        return self.wire_elements_exact(shape, node) * per

    def wire_bits(self, shape, *, value_bits=32, index_sync=False,
                  node=None) -> int:
        return int(round(self.wire_bits_exact(
            shape, value_bits=value_bits, index_sync=index_sync, node=node)))

    def coord_sensitivity_transfer(self, beta, shape):
        # kept coordinates are rescaled by 1/p; the sparsest node's
        # budget is the worst case under per-node p
        del shape
        return beta / self.p_min


# ==========================================================================
# Fixed-k packing (element blocks); the pad-to-max-k payload format.
# ==========================================================================

def _gather_rows(xb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """xb (*batch, nb, block), idx (*batch, k) -> (*batch, k, block)."""
    return torch.gather(xb, -2, idx.unsqueeze(-1).expand(
        tuple(idx.shape) + (xb.shape[-1],)))


def _scatter_rows(nb: int, idx: torch.Tensor, vals: torch.Tensor
                  ) -> torch.Tensor:
    """Zeros (*batch, nb, block) with ``vals`` added at rows ``idx``."""
    out = torch.zeros(tuple(vals.shape[:-2]) + (nb, vals.shape[-1]),
                      dtype=vals.dtype, device=vals.device)
    return out.scatter_add(-2, idx.unsqueeze(-1).expand(vals.shape), vals)


@dataclasses.dataclass(frozen=True)
class FixedKCompressor(Compressor):
    """Exactly k = ceil(p * n_blocks) blocks, packed (values, indices);
    under a per-node p every node draws k_max indices and zeroes rows
    beyond its own k_i (one static payload shape)."""

    block: int = 1
    name: str = dataclasses.field(default="fixedk", init=False, repr=False)

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.block < 1:
            raise ValueError("block must be >= 1")

    def _k_table(self, nb: int):
        if isinstance(self.p, tuple):
            return tuple(sparsifier.num_kept(nb, pi) for pi in self.p)
        return None

    def k_max(self, nb: int) -> int:
        kt = self._k_table(nb)
        return max(kt) if kt else sparsifier.num_kept(nb, self.p)

    def compress(self, key, x, *, node=None) -> Payload:
        key, batch, shape = _split_shape(key, x)
        xb = sparsifier.block_view(x.reshape(batch + (-1,)), self.block)
        nb = xb.shape[-2]
        kt = self._k_table(nb)
        kmax = self.k_max(nb)
        idx = sparsifier.fixedk_indices(key, nb, kmax)
        vals = _gather_rows(xb, idx)
        if kt is None:
            vals = vals * (nb / kmax)
        else:
            if node is None:
                raise ValueError("per-node p needs node=")
            kb = torch.tensor(kt, dtype=torch.int32, device=x.device)[
                torch.as_tensor(node, device=x.device)]
            keep = torch.arange(kmax, device=x.device) < kb.unsqueeze(-1)
            scale = torch.div(torch.tensor(float(nb), device=x.device),
                              kb.to(torch.float32))
            vals = vals * _bcast(scale, 2) * keep.unsqueeze(-1).to(vals.dtype)
        return Payload(values=vals.to(xb.dtype), indices=idx, shape=shape,
                       meta=("fixedk", self.block), batch=batch)

    def decompress(self, payload: Payload) -> torch.Tensor:
        block = payload.meta[1]
        d = int(math.prod(payload.shape))
        nb = -(-d // block)
        out = _scatter_rows(nb, payload.indices, payload.values)
        flat = out.reshape(payload.batch + (-1,))[..., :d]
        return flat.reshape(payload.batch + payload.shape)

    def wire_elements(self, shape, node=None) -> int:
        d = int(math.prod(shape))
        nb = -(-d // self.block)
        kb = sparsifier.num_kept(nb, self._p_static(node))
        return min(kb * self.block, d)

    def wire_bits(self, shape, *, value_bits=32, index_sync=False,
                  node=None) -> int:
        d = int(math.prod(shape))
        nb = -(-d // self.block)
        kb = sparsifier.num_kept(nb, self._p_static(node))
        bits = min(kb * self.block, d) * value_bits
        if not index_sync:
            bits += kb * index_bits(nb)
        return bits

    def coord_sensitivity_transfer(self, beta, shape):
        # kept blocks are rescaled by nb/kb, largest at the smallest p;
        # distinct top-k indices never stack two blocks on a coordinate
        d = int(math.prod(shape))
        nb = -(-d // self.block)
        return beta * nb / sparsifier.num_kept(nb, self.p_min)



@dataclasses.dataclass(frozen=True)
class RowsCompressor(Compressor):
    """Fixed-k over trailing-dim rows (blocks = whole rows of the leaf)."""

    name: str = dataclasses.field(default="rows", init=False, repr=False)

    def _rows_cols(self, shape: Tuple[int, ...]) -> Tuple[int, int]:
        d = int(math.prod(shape))
        cols = shape[-1] if len(shape) > 1 else 1
        return d // cols, cols

    def compress(self, key, x, *, node=None) -> Payload:
        key, batch, shape = _split_shape(key, x)
        rows, cols = self._rows_cols(shape)
        xb = x.reshape(batch + (rows, cols))
        if isinstance(self.p, tuple):
            raise ValueError("rows compressor does not support per-node p "
                             "(use fixedk/block for pad-to-max-k payloads)")
        kb = sparsifier.num_kept(rows, self.p)
        idx = sparsifier.fixedk_indices(key, rows, kb)
        vals = _gather_rows(xb, idx) * (rows / kb)
        return Payload(values=vals.to(xb.dtype), indices=idx, shape=shape,
                       meta=("rows",), batch=batch)

    def decompress(self, payload: Payload) -> torch.Tensor:
        rows, _ = self._rows_cols(payload.shape)
        out = _scatter_rows(rows, payload.indices, payload.values)
        return out.reshape(payload.batch + payload.shape)

    def wire_elements(self, shape, node=None) -> int:
        rows, cols = self._rows_cols(tuple(shape))
        return sparsifier.num_kept(rows, self._p_static(node)) * cols

    def wire_bits(self, shape, *, value_bits=32, index_sync=False,
                  node=None) -> int:
        rows, cols = self._rows_cols(tuple(shape))
        kb = sparsifier.num_kept(rows, self._p_static(node))
        bits = kb * cols * value_bits
        if not index_sync:
            bits += kb * index_bits(rows)
        return bits

    def coord_sensitivity_transfer(self, beta, shape):
        rows, _ = self._rows_cols(tuple(shape))
        return beta * rows / sparsifier.num_kept(rows, self.p_min)



# ==========================================================================
# QSGD-style stochastic quantizer.
# ==========================================================================

def _l2_norm(xf: torch.Tensor, batch: Tuple[int, ...]) -> torch.Tensor:
    """Per-node sqrt(sum(x^2)) over the non-batch dims."""
    return torch.sqrt(torch.sum(torch.square(xf.reshape(batch + (-1,))),
                                dim=-1))


def _unpack_levels(data: torch.Tensor, d: int, bits: int) -> torch.Tensor:
    """(*batch, n_bytes) packed bytes -> (*batch, d) int32 encoded levels."""
    k = 8 // bits
    mask = (1 << bits) - 1
    data = data.to(torch.int32)
    parts = [(data >> (j * bits)) & mask for j in range(k)]
    return torch.stack(parts, dim=-1).reshape(
        tuple(data.shape[:-1]) + (-1,))[..., :d]


@dataclasses.dataclass(frozen=True)
class QSGDCompressor(Compressor):
    """Q(x): per-tensor l2 norm + stochastic b-bit levels (sign-magnitude),
    s = 2^(b-1) - 1; unbiased. 2/4-bit levels are offset-encoded and
    packed 8/b per u8 byte; other widths ship int8."""

    bits: int = 8
    name: str = dataclasses.field(default="qsgd", init=False, repr=False)

    def __post_init__(self) -> None:
        super().__post_init__()
        if not 2 <= self.bits <= 8:
            raise ValueError("qsgd bits must be in [2, 8] (int8 wire)")

    @property
    def levels(self) -> int:
        return 2 ** (self.bits - 1) - 1

    @property
    def pack_factor(self) -> int:
        return 8 // self.bits if self.bits in (2, 4) else 1

    @property
    def release_probability(self):
        return 1.0

    def compress(self, key, x, *, node=None) -> Payload:
        from repro_torch.kernels.wire_compress import (qsgd_inv,
                                                       qsgd_quantize_pack_ref)
        key, batch, shape = _split_shape(key, x)
        xf = x.to(torch.float32)
        norm = _l2_norm(xf, batch)
        u = prng.uniform(key, shape)
        inv = qsgd_inv(norm, self.bits)
        if self.pack_factor == 1:
            s = float(self.levels)
            ratio = torch.abs(xf) * _bcast(inv, len(shape))
            level = torch.floor(ratio)
            level = level + (u < (ratio - level)).to(level.dtype)
            q = (torch.sign(xf) * torch.clamp(level, max=s)).to(torch.int32)
            return Payload(values=q.to(torch.int8), scale=norm, shape=shape,
                           meta=("qsgd", self.bits), batch=batch)
        # the unfused packer computes the same bytes as the fused oracle
        data = qsgd_quantize_pack_ref(xf, u, inv, bits=self.bits)
        return Payload(values=data, scale=norm, shape=shape,
                       meta=("qsgd", self.bits, "u8pack"), batch=batch)

    def decompress(self, payload: Payload) -> torch.Tensor:
        bits = payload.meta[1]
        s = 2 ** (bits - 1) - 1
        d = int(math.prod(payload.shape))
        if len(payload.meta) > 2 and payload.meta[2] == "u8pack":
            q = (_unpack_levels(payload.values, d, bits) - s).to(torch.float32)
        else:
            q = payload.values.to(torch.float32)
        q = q.reshape(payload.batch + payload.shape)
        scale = payload.scale * sparsifier.f32_reciprocal(s)
        return _bcast(scale, len(payload.shape)) * q

    def wire_elements(self, shape, node=None) -> int:
        return int(math.prod(shape))

    def wire_bits(self, shape, *, value_bits=32, index_sync=False,
                  node=None) -> int:
        del value_bits, index_sync
        d = int(math.prod(shape))
        if self.pack_factor > 1:
            return -(-d // self.pack_factor) * 8 + 32
        return d * self.bits + 32

    def coord_sensitivity_transfer(self, beta, shape):
        # a decompressed coordinate is (||x|| / s) q with |q| <= s: at most
        # the l2 norm, <= beta sqrt(d)
        return beta * math.sqrt(int(math.prod(shape)))



@dataclasses.dataclass(frozen=True)
class FusedQSGDCompressor(QSGDCompressor):
    """QSGD through the fused quantize-and-pack kernel, with the f32 norm
    appended as 4 little-endian bytes: ONE u8 buffer per node. Levels
    are bit-identical to ``qsgd``; bits 8 ships offset-encoded u8."""

    name: str = dataclasses.field(default="qsgdf", init=False, repr=False)

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.bits not in (2, 4, 8):
            raise ValueError(
                "qsgdf bits must be in {2, 4, 8}: the fused single-buffer "
                "format needs an exact byte image")

    def compress(self, key, x, *, node=None) -> Payload:
        from repro_torch.kernels import wire_compress
        key, batch, shape = _split_shape(key, x)
        xf = x.to(torch.float32).contiguous()
        norm = _l2_norm(xf, batch)
        u = prng.uniform(key, shape)         # canonical-shape draw
        data = wire_compress.qsgd_pack(xf, u, norm, bits=self.bits)
        tail = norm.reshape(batch + (1,)).contiguous().view(torch.uint8)
        return Payload(values=torch.cat([data, tail], dim=-1), shape=shape,
                       meta=("qsgdf", self.bits), batch=batch)

    def decompress(self, payload: Payload) -> torch.Tensor:
        from repro_torch.kernels.wire_compress import norm_from_tail
        bits = payload.meta[1]
        s = 2 ** (bits - 1) - 1
        v = payload.values
        norm = norm_from_tail(v)
        d = int(math.prod(payload.shape))
        if bits == 8:
            q = v[..., :d].to(torch.int32) - s
        else:
            q = _unpack_levels(v[..., :-4], d, bits) - s
        q = q.to(torch.float32).reshape(payload.batch + payload.shape)
        scale = norm * sparsifier.f32_reciprocal(s)
        return _bcast(scale, len(payload.shape)) * q


# ==========================================================================
# Registry + CLI spec parsing.
# ==========================================================================

_FAMILIES: Dict[str, Callable[..., Compressor]] = {}


def register(family: str, factory: Callable[..., Compressor]) -> None:
    _FAMILIES[family] = factory


def names() -> Tuple[str, ...]:
    return tuple(sorted(_FAMILIES))


register("bernoulli", lambda p, arg=None: BernoulliCompressor(p=p))
register("fixedk", lambda p, arg=None: FixedKCompressor(
    p=p, block=int(arg) if arg else 1))
register("block", lambda p, arg=None: FixedKCompressor(
    p=p, block=int(arg) if arg else 128))
register("rows", lambda p, arg=None: RowsCompressor(p=p))
register("qsgd", lambda p, arg=None: QSGDCompressor(
    p=p, bits=int(arg) if arg else 8))
register("qsgdf", lambda p, arg=None: FusedQSGDCompressor(
    p=p, bits=int(arg) if arg else 4))


def make(spec: str, p: "float | Tuple[float, ...]" = 0.2) -> Compressor:
    """Parse a CLI compressor spec: ``family`` or ``family:<arg>``."""
    spec = spec.strip().lower()
    family, _, arg = spec.partition(":")
    if family not in _FAMILIES:
        raise ValueError(
            f"unknown compressor {spec!r}; registered: {', '.join(names())}")
    return _FAMILIES[family](p, arg or None)


# ==========================================================================
# Tree-level accounting helpers (exact, as in the JAX package).
# ==========================================================================

def node_mean_exact(p, per_node_fn) -> "Fraction | float":
    """Across-node EXACT mean of per-node accounting expectations."""
    if isinstance(p, tuple):
        vals = [per_node_fn(i) for i in range(len(p))]
        return sum(vals) / len(vals)
    return per_node_fn(None)


def tree_wire_elements_exact(comp: Compressor, params,
                             node: int | None = None) -> "Fraction | float":
    return sum(comp.wire_elements_exact(tuple(x.shape), node=node)
               for x in tree_mod.leaves(params))


def tree_wire_elements(comp: Compressor, params, node: int | None = None
                       ) -> int:
    """Informative elements one node transmits per step over a pytree:
    the exact sum rounded once (round(p d_total), the paper's Fig-3
    convention; packed and quantized counts are integers already)."""
    return int(round(tree_wire_elements_exact(comp, params, node=node)))


def tree_wire_bits_exact(comp: Compressor, params, *, value_bits: int = 32,
                         index_sync: bool = False,
                         node: int | None = None) -> "Fraction | float":
    return sum(
        comp.wire_bits_exact(tuple(x.shape), value_bits=value_bits,
                             index_sync=index_sync, node=node)
        for x in tree_mod.leaves(params))


def tree_wire_bits(comp: Compressor, params, *, value_bits: int = 32,
                   index_sync: bool = False, node: int | None = None) -> int:
    """Exact wire bits one node transmits per step over a pytree."""
    return int(round(tree_wire_bits_exact(comp, params,
                                          value_bits=value_bits,
                                          index_sync=index_sync, node=node)))
