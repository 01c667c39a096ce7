"""Serving engines: continuous batching (default) + static batch baseline.

Port of ``repro.serving.engine``: attention-only models, those with
recurrent (mamba / rwkv) mixers, and those that cross-attend to a
context (whisper's audio frames, the VLM's image patches).

``ServingEngine`` is a slot-based continuous-batching scheduler over the
paged KV cache (``kv_cache.py``): finished requests free their slot and
their pages, queued requests are admitted mid-flight (a single-request
prefill lands in the freed slot) and the decode step keeps a device-side
done-mask and token buffer. Per decode step the host does one small
done-mask poll; the rest of the bookkeeping (prefill, page alloc/free,
output read-back) happens only when a request is admitted or retired.
The device state is updated in place; the JAX engine donates it to its
jitted step for the same effect.

``StaticServingEngine`` prefills a batch of right-padded prompts
together and decodes until every row is done, over a dense cache with
per-row offsets -- the baseline the continuous engine is held against
(batched == one-at-a-time).

Models with recurrent mixers: a recurrent state that has consumed
right-padding cannot be repaired by masking, so the continuous engine
prefills them at the exact prompt length (not a power-of-two bucket) and
the static engine groups them into equal-prompt-length batches. Their
states sit beside the page pools, one row per slot, and advance every
step for every row, as in the JAX engine.

``serve(requests, context)`` keeps the JAX engines' context rows: the
continuous engine encodes ``context[:1]`` once a serve and gives that one
row to every slot; the static engine encodes ``context[:b]`` for each
batch of b, rows 0..b-1 whatever the batch. Both hand the ENCODED
context to ``prefill``, which encodes it again (the JAX engines do the
same: whisper's first token comes from a doubly encoded context, its
decode steps from a singly encoded one; the VLM's encode is the
identity). The context's dtype must be the weights'.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serving.kv_cache import PagedKVCache

__all__ = ["Request", "ServingEngine", "StaticServingEngine", "ServeStats"]


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine:
    output: Optional[List[int]] = None
    ttft_s: Optional[float] = None     # submit -> first token available
    finish_s: Optional[float] = None   # submit -> retirement


@dataclasses.dataclass
class ServeStats:
    """Per-``serve()`` call instrumentation."""
    wall_s: float = 0.0
    tokens: int = 0
    step_wall_s: List[float] = dataclasses.field(default_factory=list)
    step_tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    pages_peak: int = 0
    pages_dense_equiv: int = 0
    prefills: int = 0
    decode_steps: int = 0


@dataclasses.dataclass
class _DecodeState:
    """Device-resident continuous-batching state (one row per slot)."""
    rec: Dict[str, Any]       # {period-slot -> recurrent state (n, B, ...)}
    offsets: torch.Tensor     # (B,) int32 tokens already cached per slot
    last_tok: torch.Tensor    # (B,) int32 token to feed next
    out_buf: torch.Tensor     # (B, max_out) int32 generated tokens
    n_out: torch.Tensor       # (B,) int32
    budget: torch.Tensor      # (B,) int32 max_new_tokens per slot
    eos: torch.Tensor         # (B,) int32 eos id or -1
    active: torch.Tensor      # (B,) bool: slot holds a live request
    done: torch.Tensor        # (B,) bool: finished, awaiting retirement


def _is_recurrent(cfg: ModelConfig) -> bool:
    return any(s.mixer not in transformer.ATTN for s in cfg.period)


def _bucket(n: int, cap: int) -> int:
    """Next power-of-two prefill length (the JAX engine bounds its jit
    retraces with it; kept so both engines compute the same shapes)."""
    return min(max(8, 1 << (n - 1).bit_length()), cap)


def _check_params(params, device: torch.device) -> None:
    got = params["embed"].device
    if got.type != device.type:
        raise ValueError(f"params live on {got}, the engine on {device}")


class ServingEngine:
    """Continuous-batching engine over a paged KV cache.

    ``n_pages`` sizes the shared page pool (default: the dense
    equivalent ``max_batch * ceil(max_seq/page_size)``; ragged traffic
    runs far below that -- admission applies backpressure). On CUDA,
    decode attention runs the paged flash-decode kernel; on the CPU its
    plain version. The host polls the done-mask after every step.
    """

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_seq: int = 256, dtype: torch.dtype = torch.float32,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        _check_params(params, self.device)
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.dtype = dtype
        self.page_size = page_size
        self.n_pages = n_pages
        self.recurrent = _is_recurrent(cfg)
        self.last_stats: Optional[ServeStats] = None
        self._attn_slots = [str(i) for i, s in enumerate(cfg.period)
                            if s.mixer in transformer.ATTN]
        self._rec_slots = [str(i) for i, s in enumerate(cfg.period)
                           if s.mixer not in transformer.ATTN]

    def _zeros(self, *shape, dtype=torch.int32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    @torch.no_grad()
    def _step(self, st: _DecodeState, kv: PagedKVCache,
              tables: torch.Tensor, ctx: Optional[torch.Tensor]) -> None:
        emit = st.active & ~st.done
        logits = transformer.decode_step_paged(
            self.params, self.cfg, st.last_tok, kv.pages, tables,
            st.offsets, emit, rec=st.rec, context=ctx)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        rows = torch.arange(st.out_buf.shape[0], device=self.device)
        idx = torch.clamp(st.n_out, 0, st.out_buf.shape[1] - 1)
        st.out_buf[rows, idx] = torch.where(emit, nxt, st.out_buf[rows, idx])
        emit_i = emit.to(torch.int32)
        st.n_out += emit_i
        st.done |= emit & ((nxt == st.eos) | (st.n_out >= st.budget))
        st.offsets += emit_i
        st.last_tok.copy_(torch.where(emit, nxt, st.last_tok))

    # ---------------- serve ----------------

    def serve(self, requests: List[Request],
              context: Optional[torch.Tensor] = None) -> List[Request]:
        """Serve all requests with continuous batching; returns them with
        ``output`` (and timing fields) filled, in the original order.
        ``context`` (n, s, d): row 0 is every request's, as in JAX."""
        if not requests:
            return requests
        t0 = time.monotonic()
        stats = ServeStats()
        B = self.max_batch
        max_out = max(r.max_new_tokens for r in requests)

        ctx1 = ctx_b = None
        if context is not None:
            with torch.no_grad():
                ctx1 = transformer.encode_context(
                    self.params, self.cfg, context[:1].to(self.device))
            ctx_b = ctx1.expand((B,) + tuple(ctx1.shape[1:]))

        kv = PagedKVCache(self.cfg, max_batch=B, max_seq=self.max_seq,
                          page_size=self.page_size, n_pages=self.n_pages,
                          dtype=self.dtype, device=self.device)
        rec = {}
        if self._rec_slots:
            slots = transformer.init_cache(self.cfg, B, 1, self.dtype,
                                           self.device).slots
            rec = {si: slots[si] for si in self._rec_slots}
        st = _DecodeState(
            rec=rec, offsets=self._zeros(B), last_tok=self._zeros(B),
            out_buf=self._zeros(B, max_out), n_out=self._zeros(B),
            budget=torch.ones(B, dtype=torch.int32, device=self.device),
            eos=torch.full((B,), -1, dtype=torch.int32, device=self.device),
            active=self._zeros(B, dtype=torch.bool),
            done=self._zeros(B, dtype=torch.bool))

        queue = deque(requests)
        submit = {id(r): t0 for r in requests}
        free = list(range(B - 1, -1, -1))
        live: Dict[int, Request] = {}

        def admit_ready() -> bool:
            return bool(queue) and bool(free) and \
                kv.can_admit(len(queue[0].prompt) +
                             queue[0].max_new_tokens)

        while queue or live:
            while admit_ready():
                req = queue.popleft()
                slot = free.pop()
                kv.alloc(slot, len(req.prompt) + req.max_new_tokens)
                self._prefill_into(st, kv, slot, req, ctx1)
                live[slot] = req
                req.ttft_s = time.monotonic() - submit[id(req)]
                stats.ttft_s.append(req.ttft_s)
                stats.prefills += 1
            if not live:
                need = kv.pages_needed(len(queue[0].prompt) +
                                       queue[0].max_new_tokens)
                raise RuntimeError(
                    f"request needs {need} pages but the pool only has "
                    f"{kv.n_pages}; raise n_pages or max_seq")

            done_np = (st.done & st.active).cpu().numpy()
            if not done_np.any():
                emit_n = int((st.active & ~st.done).sum())
                ts = time.monotonic()
                self._step(st, kv, kv.tables(), ctx_b)
                stats.decode_steps += 1
                # the one host poll per step; it waits for the step
                done_np = (st.done & st.active).cpu().numpy()
                stats.step_wall_s.append(time.monotonic() - ts)
                stats.step_tokens.append(emit_n)

            for slot in np.nonzero(done_np)[0].tolist():
                req = live.pop(slot)
                n = int(st.n_out[slot])
                req.output = st.out_buf[slot, :n].cpu().tolist()
                req.finish_s = time.monotonic() - submit[id(req)]
                kv.release(slot)
                st.active[slot] = False
                st.done[slot] = False
                st.offsets[slot] = 0
                free.append(slot)

        stats.pages_peak = kv.peak_in_use
        stats.pages_dense_equiv = kv.dense_equivalent_pages()
        stats.tokens = sum(len(r.output) for r in requests)
        stats.wall_s = time.monotonic() - t0
        self.last_stats = stats
        return requests

    @torch.no_grad()
    def _prefill_into(self, st: _DecodeState, kv: PagedKVCache, slot: int,
                      req: Request, ctx1: Optional[torch.Tensor]) -> None:
        L = len(req.prompt)
        if L < 1:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # recurrent mixers must see the EXACT prompt (a right-padded tail
        # would enter their state); attention models prefill at a
        # power-of-two bucket, which causal masking + last_index keep exact
        Lp = L if self.recurrent else _bucket(L, self.max_seq)
        toks = np.zeros((1, Lp), np.int32)
        toks[0, :L] = req.prompt
        cache = transformer.init_cache(self.cfg, 1, Lp, self.dtype,
                                       self.device)
        # ctx1 is already encoded and prefill encodes it again, as the
        # JAX engine does
        logits, cache = transformer.prefill(
            self.params, self.cfg, torch.as_tensor(toks, device=self.device),
            cache, context=ctx1,
            last_index=torch.tensor([L - 1], device=self.device))
        first = int(torch.argmax(logits, dim=-1)[0])
        kv.write_prompt(slot, {si: (cache.slots[si].k, cache.slots[si].v)
                               for si in self._attn_slots}, L)
        for si in self._rec_slots:
            # a state shorter than the slot's (mamba's conv after a prompt
            # of fewer than d_conv - 1 tokens) broadcasts, as in JAX
            for dst, src in zip(st.rec[si], cache.slots[si]):
                dst[:, slot] = src[:, 0]
        eos = -1 if req.eos_id is None else req.eos_id
        st.offsets[slot] = L
        st.last_tok[slot] = first
        st.out_buf[slot] = 0
        st.out_buf[slot, 0] = first
        st.n_out[slot] = 1
        st.budget[slot] = req.max_new_tokens
        st.eos[slot] = eos
        st.active[slot] = True
        st.done[slot] = req.max_new_tokens <= 1 or first == eos


# --------------------------------------------------------------------------
# Static-batch baseline
# --------------------------------------------------------------------------

class StaticServingEngine:
    """Static batches of ``max_batch``: prefill together, decode until
    EVERY row in the batch is finished, then start the next batch.
    Per-token bookkeeping is on the host by design."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_seq: int = 256, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        self.device = resolve_device(device)
        _check_params(params, self.device)
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.dtype = dtype
        self.recurrent = _is_recurrent(cfg)
        self.last_stats: Optional[ServeStats] = None

    def serve(self, requests: List[Request],
              context: Optional[torch.Tensor] = None) -> List[Request]:
        """Serve requests in static batches of max_batch (recurrent-mixer
        models additionally split into equal-prompt-length groups).
        ``context`` (n, s, d): a batch of b takes rows 0..b-1, as in
        JAX."""
        t0 = time.monotonic()
        stats = ServeStats()
        if self.recurrent:
            by_len: Dict[int, List[Request]] = {}
            for r in requests:
                by_len.setdefault(len(r.prompt), []).append(r)
            groups = [g for _, g in sorted(by_len.items())]
        else:
            groups = [requests]
        for group in groups:
            for i in range(0, len(group), self.max_batch):
                self._serve_batch(group[i:i + self.max_batch], context,
                                  t0, stats)
        stats.tokens = sum(len(r.output) for r in requests)
        stats.wall_s = time.monotonic() - t0
        self.last_stats = stats
        return requests

    @torch.no_grad()
    def _serve_batch(self, batch: List[Request],
                     context: Optional[torch.Tensor], t0: float,
                     stats: ServeStats) -> None:
        b = len(batch)
        # right-pad prompts to the longest; each row's first token reads
        # at its OWN last real position and decode continues from its
        # OWN length
        lens = np.array([len(r.prompt) for r in batch], np.int32)
        plen = int(lens.max())
        prompts = np.zeros((b, plen), np.int32)
        for i, r in enumerate(batch):
            prompts[i, :len(r.prompt)] = r.prompt
        max_new = max(r.max_new_tokens for r in batch)
        if plen + max_new > self.max_seq:
            raise ValueError(f"prompt {plen} + {max_new} new tokens > "
                             f"max_seq {self.max_seq}")

        dev = self.device
        ctx = None
        if context is not None:
            ctx = transformer.encode_context(self.params, self.cfg,
                                             context[:b].to(dev))
        cache = transformer.init_cache(self.cfg, b, self.max_seq, self.dtype,
                                       dev)
        # ctx is already encoded and prefill encodes it again, as the JAX
        # engine does
        logits, cache = transformer.prefill(
            self.params, self.cfg, torch.as_tensor(prompts, device=dev),
            cache, context=ctx,
            last_index=torch.as_tensor(lens - 1, device=dev))
        next_tok = torch.argmax(logits, dim=-1).cpu()
        ttft = time.monotonic() - t0
        stats.prefills += 1
        for r in batch:
            r.ttft_s = ttft
            stats.ttft_s.append(ttft)
        offsets = torch.as_tensor(lens, device=dev)
        outs = [[] for _ in range(b)]
        done = [False] * b
        for _ in range(max_new):
            emitted = 0
            for i in range(b):
                if not done[i]:
                    outs[i].append(int(next_tok[i]))
                    emitted += 1
                    r = batch[i]
                    if (r.eos_id is not None and outs[i][-1] == r.eos_id) or \
                            len(outs[i]) >= r.max_new_tokens:
                        done[i] = True
            if all(done):
                break
            ts = time.monotonic()
            logits, cache = transformer.decode_step(
                self.params, self.cfg, next_tok.to(dev), cache, context=ctx,
                offsets=offsets)
            offsets = offsets + 1
            next_tok = torch.argmax(logits, dim=-1).cpu()
            stats.step_wall_s.append(time.monotonic() - ts)
            stats.step_tokens.append(emitted)
            stats.decode_steps += 1
        now = time.monotonic() - t0
        for r, o in zip(batch, outs):
            r.output = o
            r.finish_s = now
