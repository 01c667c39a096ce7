"""What each hand-written kernel must move and compute: one place for the
formulas that ``chip_smoke.py`` turns into each kernel's bound and that
the dry-run (``launch/dryrun``) charges when a wrapper is called on the
``meta`` device.

* ``nbytes``: each input read once and each output written once.
* ``flops``: what ``torch.utils.flop_counter.FlopCounterMode`` counts for
  the same function, 2 per multiply-add of a matmul-class product (the
  two products of attention: q k^T and p v). The elementwise kernels
  (``sdm_update``, ``qsgd_pack``, ``fixedk_gather_pack``) count 0, as the
  flop counter does for their plain versions; their bound is their bytes.

``bound`` divides a ``Cost`` by the H100 SXM's datasheet peaks (not
measurements): HBM3 3.35 TB/s, dense bf16 tensor-core 989 TFLOP/s, f32
outside the tensor cores 67 TFLOP/s.

``KernelTally`` is the dry-run's counter: inside its ``with`` block each
wrapper called on meta tensors adds its kernel's ``Cost`` (``charge``)
and returns empty meta outputs. Nothing is computed there and nothing
is launched, so the wrappers' ``.launches`` do not move.
"""
from __future__ import annotations

from collections import Counter
from typing import List, NamedTuple, Optional, Sequence, Tuple

__all__ = ["Cost", "HBM_BYTES_PER_S", "BF16_FLOPS", "F32_FLOPS", "bound",
           "paged_decode", "attention_pairs", "flash_attn", "sdm_update",
           "qsgd_pack", "fixedk_gather_pack", "ring_exchange_packed",
           "KernelTally", "charge"]

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores


class Cost(NamedTuple):
    flops: int
    nbytes: int


def bound(cost: Cost, elt_bytes: int = 4) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time of ``cost`` on the
    card, its bytes over HBM bandwidth against its flops over the peak
    for the inputs' type (bf16 for 2-byte elements, else f32)."""
    peak = BF16_FLOPS if elt_bytes == 2 else F32_FLOPS
    t_bytes, t_ops = cost.nbytes / HBM_BYTES_PER_S, cost.flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def paged_decode(seq_lens: Sequence[int], *, window: Optional[int],
                 kvh: int, group: int, dh: int, page: int, n_blocks: int,
                 elt_bytes: int) -> Cost:
    """One paged decode call: the visible pages of K and V, q, out, the
    table and the lengths; 4 dh flops per visible (query head, key)."""
    h = kvh * group
    nbytes = flops = 0
    for n in seq_lens:
        n = min(int(n), n_blocks * page)
        vis = min(n, window) if window else n
        first = (n - vis) // page
        pages = -(-n // page) - first if vis else 0
        nbytes += pages * page * kvh * dh * 2 * elt_bytes
        flops += 4 * vis * h * dh
    b = len(seq_lens)
    nbytes += 2 * b * h * dh * elt_bytes + b * n_blocks * 4 + b * 4
    return Cost(flops, nbytes)


def attention_pairs(sq: int, skv: int, *, causal: bool,
                    window: Optional[int]) -> int:
    """Visible (query, key) pairs of one head: query i sees keys j with
    max(0, i - window + 1) <= j, and j <= i if causal, j < skv."""
    if causal and sq == skv:
        if window is None or window >= sq:
            return sq * (sq + 1) // 2
        return window * (window + 1) // 2 + (sq - window) * window
    total = 0
    for i in range(sq):
        lo = max(0, i - window + 1) if window else 0
        hi = min(i, skv - 1) if causal else skv - 1
        total += max(0, hi - lo + 1)
    return total


def flash_attn(b: int, sq: int, skv: int, h: int, kvh: int, dh: int, *,
               causal: bool, window: Optional[int], elt_bytes: int) -> Cost:
    """One prefill attention call: q, k, v and out moved once; 4 dh flops
    per visible pair and query head."""
    flops = 4 * dh * h * b * attention_pairs(sq, skv, causal=causal,
                                             window=window)
    nbytes = b * dh * elt_bytes * (2 * sq * h + 2 * skv * kvh)
    return Cost(flops, nbytes)


def sdm_update(n: int) -> Cost:
    """The fused update over n plane elements: x, s, nb, g (f32) and the
    three 32-bit bit streams read, x, s and sd written: 40 bytes each."""
    return Cost(0, 40 * n)


def qsgd_pack(n_nodes: int, d: int, bits: int) -> Cost:
    """QSGD pack of n_nodes planes of d f32: values and uniforms read,
    one f32 scale a node read, ceil(d / (8 / bits)) bytes a node
    written."""
    per_byte = 8 // bits
    return Cost(0, n_nodes * (d * 8 + 4 + -(-d // per_byte)))


def fixedk_gather_pack(n_nodes: int, kb: int, block: int) -> Cost:
    """kb kept rows of ``block`` f32 a node: gathered (read), written,
    and their int32 indices read."""
    return Cost(0, n_nodes * (kb * block * 4 * 2 + kb * 4))


def ring_exchange_packed(n_nodes: int, kb: int, rows: int,
                         block: int) -> Cost:
    """The ring helpers' data movement (not a kernel; the index draws not
    counted): the kept rows gathered (read + write), two ring copies
    (read + write each), the three packed arrays read by the scatters,
    and two dense (rows, block) f32 outputs written."""
    packed = n_nodes * kb * block * 4
    dense = n_nodes * rows * block * 4
    return Cost(0, 2 * packed + 4 * packed + 3 * packed + 2 * dense)


_TALLIES: List["KernelTally"] = []


class KernelTally:
    """Kernel costs charged on meta inside the block: ``flops``,
    ``nbytes`` and ``calls`` (kernel name -> count)."""

    def __init__(self):
        self.flops = 0
        self.nbytes = 0
        self.calls: Counter = Counter()

    def __enter__(self) -> "KernelTally":
        _TALLIES.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _TALLIES.remove(self)


def charge(name: str, cost: Cost, calls: int = 1) -> None:
    """Add ``cost`` and ``calls`` calls of kernel ``name`` to every open
    ``KernelTally`` (``calls`` 0: work that is not a kernel call)."""
    for t in _TALLIES:
        t.flops += cost.flops
        t.nbytes += cost.nbytes
        if calls:
            t.calls[name] += calls
