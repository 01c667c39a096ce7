"""Paged KV cache: fixed-size page pool + per-slot block tables.

Port of ``repro.serving.kv_cache``. KV storage is a pool of fixed-size
pages -- one pool per attention period-slot, shaped ``(n_periods,
n_pages+1, page_size, kv_heads, head_dim)`` -- and each request slot
owns a BLOCK TABLE row mapping its logical block j to a physical page
id. A slot is charged ``ceil((prompt + budget) / page_size)`` pages at
admission and returns them at retirement.

Conventions:

* **page 0 is the trash page**: never allocated; the decode step routes
  writes of finished / empty rows there. A freed slot's table row is
  reset to all zeros, so a stale table never aliases a page that has
  been handed to another slot.
* one physical page id indexes every layer's pool, so one allocation
  covers the whole depth of the model.
* allocation is on the host (a LIFO free list: recycled pages are reused
  at once); the pools live on the device and are written in place, and
  the tables have a cached device copy.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import host_to_device, resolve_device
from repro_torch.models.config import ModelConfig

__all__ = ["PagedKVCache", "TRASH_PAGE"]

TRASH_PAGE = 0


def _attn_slots(cfg: ModelConfig) -> List[str]:
    return [str(i) for i, s in enumerate(cfg.period)
            if s.mixer in ("attn", "attn_local")]


class PagedKVCache:
    """Host-side manager for the device page pools + block tables.

    ``n_pages`` counts usable pages EXCLUDING the trash page (the pools
    carry n_pages + 1 physical pages). The default pool is a full dense
    reservation; ragged traffic runs on a smaller pool with
    admission-time backpressure (``can_admit``)."""

    def __init__(self, cfg: ModelConfig, *, max_batch: int, max_seq: int,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.page_size = page_size
        self.n_blocks = math.ceil(max_seq / page_size)
        if n_pages is None:
            n_pages = max_batch * self.n_blocks
        self.n_pages = n_pages
        self.dtype = dtype
        self.device = resolve_device(device)
        kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        shape = (cfg.n_periods, n_pages + 1, page_size, kv, hd)
        self.pages: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {
            si: (torch.zeros(shape, dtype=dtype, device=self.device),
                 torch.zeros(shape, dtype=dtype, device=self.device))
            for si in _attn_slots(cfg)
        }
        self._tables = np.zeros((max_batch, self.n_blocks), np.int32)
        self._tables_dev: Optional[torch.Tensor] = None
        self._free: List[int] = list(range(n_pages, 0, -1))  # LIFO, 1-based
        self._owned: Dict[int, List[int]] = {}               # slot -> pages
        self.peak_in_use = 0

    # ---------------- allocation ----------------

    def pages_needed(self, n_tokens: int) -> int:
        return math.ceil(max(n_tokens, 1) / self.page_size)

    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def can_admit(self, n_tokens: int) -> bool:
        return self.pages_needed(n_tokens) <= len(self._free)

    def alloc(self, slot: int, n_tokens: int) -> None:
        """Charge ``slot`` enough pages for ``n_tokens`` and build its
        table row. Raises if the pool is exhausted (check ``can_admit``)
        or the slot already holds pages."""
        if slot in self._owned:
            raise ValueError(f"slot {slot} already holds pages")
        need = self.pages_needed(n_tokens)
        if n_tokens > self.max_seq:
            raise ValueError(f"{n_tokens} tokens > max_seq {self.max_seq}")
        if need > len(self._free):
            raise ValueError(f"pool exhausted: need {need}, "
                             f"free {len(self._free)}")
        got = [self._free.pop() for _ in range(need)]
        self._owned[slot] = got
        row = np.zeros(self.n_blocks, np.int32)
        row[:need] = got
        self._tables[slot] = row
        self._tables_dev = None
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use())

    def release(self, slot: int) -> None:
        """Return ``slot``'s pages to the free list and zero its table
        row (all blocks point at the trash page again)."""
        got = self._owned.pop(slot, None)
        if got is None:
            return
        self._free.extend(reversed(got))
        self._tables[slot] = 0
        self._tables_dev = None

    def owned(self, slot: int) -> Tuple[int, ...]:
        return tuple(self._owned.get(slot, ()))

    def tables(self) -> torch.Tensor:
        """Device copy of the block tables (int32, cached until the next
        alloc/release)."""
        if self._tables_dev is None:
            self._tables_dev = host_to_device(self._tables.copy(),
                                              self.device)
        return self._tables_dev

    # ---------------- device writes / reads ----------------

    def write_prompt(self, slot: int,
                     dense: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                     length: int) -> None:
        """Scatter a prefilled DENSE cache into ``slot``'s pages.

        ``dense``: {period-slot -> (k, v)} shaped (n_periods, 1, L,
        kv_heads, head_dim) from a single-request prefill; only the
        first ``length`` positions are real -- padded tail positions are
        routed to the trash page, so bucket-padded prefills stay
        page-clean.
        """
        if not dense:
            return
        Lp = next(iter(dense.values()))[0].shape[2]
        pos = np.arange(Lp)
        row = self._tables[slot]
        real = pos < length
        page_id = np.where(real, row[np.minimum(pos // self.page_size,
                                                self.n_blocks - 1)],
                           TRASH_PAGE)
        in_page = np.where(real, pos % self.page_size, 0)
        page_id = host_to_device(page_id, self.device)
        in_page = host_to_device(in_page, self.device)
        for si, (k_dense, v_dense) in dense.items():
            kp, vp = self.pages[si]
            kp[:, page_id, in_page] = k_dense[:, 0].to(kp.dtype)
            vp[:, page_id, in_page] = v_dense[:, 0].to(vp.dtype)

    def gather_dense(self, slot: int, length: int
                     ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Debug/test read-back: ``slot``'s first ``length`` cached
        tokens as dense (n_periods, length, kv, hd) tensors per layer."""
        row = self._tables[slot]
        pos = np.arange(length)
        page_id = torch.as_tensor(row[pos // self.page_size],
                                  device=self.device)
        in_page = torch.as_tensor(pos % self.page_size, device=self.device)
        return {si: (kp[:, page_id, in_page], vp[:, page_id, in_page])
                for si, (kp, vp) in self.pages.items()}

    def dense_equivalent_pages(self) -> int:
        """What a dense max_batch x max_seq reservation costs, in pages."""
        return self.max_batch * self.n_blocks
