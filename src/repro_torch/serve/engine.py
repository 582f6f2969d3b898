"""Continuous-batching serving engine (port of ``repro/serve/engine.py``).

  * ``scheduler.Scheduler``  — FIFO + priority queues, admission control,
    slot refill, prefill grouping (host-side policy).
  * ``kvcache.PagedKVCache`` — block-table paged KV pool for the 'paged'
    families (the dense and MoE families' attention), with the
    shared-prefix index; the 'state' families (zamba2's and xlstm's
    recurrent state, and the modality families: internvl2's kv caches,
    whisper's self-attention kv beside its static cross k/v ``xk``/``xv``)
    keep contiguous per-slot caches.
  * ``sampling.make_sampler`` — greedy / temperature / top-k / top-p under
    one engine-owned, seeded ``torch.Generator``.
  * ``speculate.DraftSpec`` — the optional draft model of speculative
    decoding.
  * ``metrics.ServeMetrics`` — TTFT / TPOT / throughput / queue depth,
    prefix hits, accepted drafts.

A *prefill* step pushes a whole padded group of freshly admitted prompts
through ``transformer.prefill``, scatters the returned kv into the pool and
emits each request's first token; with the prefix cache on, only each
prompt's un-hit tail runs, through ``transformer.extend`` over the slot's
gathered view.  A *decode* step advances every in-flight slot by one
token: by default the blocks attend the read-only pool through the block
tables (K4) and the step writes every layer's new entries back in one
scatter; with ``fused_decode=False`` the step gathers each slot's view,
decodes against it as a contiguous cache (K4 under the identity table) and
scatters the new entries back.  With a draft, a decode step is a
speculative round: the draft bursts γ proposals, the target verifies them
in one extend.  The 'state' family has no chunked prefill: it feeds one
prompt token a step through the decode path (as ``chunked_prefill=False``
does for the paged family), and a placed slot's state is wiped to 0, as
the reference's ``reset_rows`` wipes it (``engine.py:230-236``), also on
the first admission into a fresh cache.  For the sLSTM that sets its
normaliser n to 0 where its cache init and its training scan start it
at 1, so xlstm's first decode steps differ from its forward; the port
keeps the reference's wipe, so that its tokens equal the JAX engine's
(ROADMAP.md, Queue 3, fault 4).  Whisper's slots are wiped the same way,
``xk``/``xv`` included, and nothing writes the encoder's k/v into them,
as in the reference, so served whisper attends zeros; served internvl2
prefills its text alone, through the decode path, with no patches (Queue
3, fault 5).

The engine runs on the device its parameters lie on.  A MoE model's
padding rows and idle slots take expert capacity, as in the reference, so
its tokens depend on the batches, which copy the reference's.  MLA
(deepseek-v3-671b) serves through the latent pool {"c_kv", "k_rope",
"pos"} on the fused and the gather-view decode; as in the reference it
takes neither the prefix cache nor a draft (no extend path over latents).
The state families take neither (their refusals are the reference's).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..core.params import init_params, tree_leaves
from ..core.topology import Layout
from ..models import blocks as B
from ..models import transformer
from ..obs.trace import NULL
from . import kvcache, sampling, speculate
from .metrics import ServeMetrics
from .scheduler import Scheduler, pad_bucket

@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new: int = 32
    priority: int = 0               # > 0 drains before the FIFO queue
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: str = ""                 # admission-rejection reason (out stays [])
    # prompt tokens already fed on the sequential-prefill path
    _fed: int = 0


class Engine:
    """Slot-based continuous batching: fixed decode batch of ``batch_size``
    slots, refilled from the scheduler queues as requests complete."""

    def __init__(self, cfg: ModelConfig, layout: Layout, params, *,
                 batch_size: int = 8, max_len: int = 512,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 seed: int = 0, block_size: int = 16,
                 n_blocks: Optional[int] = None, prefill_chunk: int = 4096,
                 chunked_prefill: bool = True,
                 fused_decode: Optional[bool] = None,
                 prefix_cache: bool = False,
                 draft: Optional[speculate.DraftSpec] = None, tracer=None):
        self.cfg, self.layout, self.params = cfg, layout, params
        # observability: per-request lifecycle spans come from the metrics
        # hooks; the engine adds one span per device tick on the "engine"
        # lane.  The default NULL tracer makes all of it free.
        self.tracer = tracer if tracer is not None else NULL
        self.B, self.max_len = batch_size, max_len
        self.paged = transformer.serve_cache_mode(cfg) == "paged"
        self.chunked = chunked_prefill and self.paged
        # fused paged decode (default on): attend the pool through the
        # block tables instead of gathering each slot's view
        self.fused = (fused_decode if fused_decode is not None
                      else True) and self.paged
        if prefix_cache:
            if not (self.paged and self.chunked):
                raise ValueError(
                    "prefix_cache requires a paged family with chunked "
                    "prefill (the shared blocks enter via the block tables)")
            if cfg.mla is not None:
                raise ValueError(
                    "prefix_cache: MLA latent caches have no extend path "
                    "yet; serve this model without --prefix-cache")
        self.prefix = bool(prefix_cache)
        if draft is not None:
            reason = speculate.draft_unsupported_reason(cfg, draft.cfg)
            if reason:
                raise ValueError(reason)
            if not self.chunked:
                raise ValueError("speculative decoding requires chunked "
                                 "prefill (the verify step extends the "
                                 "paged pool)")
            if temperature > 0 and (top_k or top_p):
                raise ValueError(
                    "speculative decoding keeps the sampled distribution "
                    "exact only for greedy or plain-temperature sampling; "
                    "drop top_k/top_p or --draft")
        dtype = params["embed"].dtype
        self.device = params["embed"].device
        self.sampler = sampling.make_sampler(temperature, top_k, top_p)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.scheduler = Scheduler(batch_size, max_len,
                                   chunk_tokens=prefill_chunk)
        self.metrics = ServeMetrics(tracer=self.tracer)

        self.pos = np.zeros(batch_size, np.int32)
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.steps = 0
        # rows whose logits held a non-finite value, over the current run
        self.nonfinite_rows = 0

        self.spec = None
        if self.paged:
            self.kv = kvcache.PagedKVCache(cfg, batch_size, max_len,
                                           block=block_size,
                                           n_blocks=n_blocks, dtype=dtype,
                                           prefix_cache=self.prefix)
            self.pool = self.kv.init_pool(self.device)
            if draft is not None:
                self.spec = draft.build(batch_size, max_len, temperature)
                self._verify = speculate.make_verify(
                    cfg, layout, self.kv.block, self.spec.gamma,
                    self._spec_pad(), temperature)
        else:
            tree = kvcache.cache_with_dtype(
                transformer.abstract_cache(cfg, layout, batch_size, max_len),
                dtype)
            self.cache = init_params(tree, None, self.device)

    # ------------------------------------------------------------------
    # Device steps
    # ------------------------------------------------------------------
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sample(self, logits):
        """-> host (tokens (B,), non-finite-row flags (B,)) in one copy."""
        logits = logits.float()
        tok = self.sampler(logits, self.generator)
        bad = ~torch.isfinite(logits).all(dim=-1)
        host = torch.stack([tok.long(), bad.long()]).cpu().numpy()
        return host[0], host[1].astype(bool)

    def _decode_step(self, tok, pos, tables, active):
        """One paged decode step: fused through the block tables, or over
        the gathered views (``fused_decode=False``)."""
        blk, L = self.kv.block, self.kv.view_len
        batch = {"token": tok, "pos": pos}
        rows = torch.arange(tok.shape[0], device=self.device)
        slot = pos.long() % L
        phys = tables[rows, slot // blk].long() * blk + slot % blk
        phys = torch.where(active, phys, blk + rows % blk)   # idle -> trash
        if self.fused:
            page = B.PageInfo(tables=tables, active=active, block=blk)
            logits, upd = transformer.forward(
                self.cfg, self.layout, self.params, batch, mode="decode",
                cache=self.pool, page=page)
            kvcache.scatter_step(self.pool, upd, phys)
        else:
            view = kvcache.gather_view(self.pool, tables, blk)
            logits, view = transformer.forward(
                self.cfg, self.layout, self.params, batch, mode="decode",
                cache=view)
            kvcache.scatter_decode(self.pool, view, slot, phys)
        return self._sample(logits)

    def _state_step(self, tok, pos):
        """One decode step against the contiguous per-slot caches."""
        logits, self.cache = transformer.forward(
            self.cfg, self.layout, self.params, {"token": tok, "pos": pos},
            mode="decode", cache=self.cache)
        return self._sample(logits)

    def _reset_rows(self, mask):
        """Wipe placed slots' state (every float leaf to 0, sLSTM's n and
        whisper's cross k/v included; kv positions to -1) so that a new
        request never sees its predecessor's context (reference
        ``engine.py:230-236``)."""
        for leaf in tree_leaves(self.cache):
            m = mask.view((1, -1) + (1,) * (leaf.dim() - 2))
            leaf.masked_fill_(m, 0 if leaf.is_floating_point() else -1)

    def _prefill_step(self, tokens, length, phys_map):
        logits, kv = transformer.prefill(
            self.cfg, self.layout, self.params,
            {"tokens": tokens, "length": length})
        p = torch.arange(tokens.shape[1], device=self.device)[None, :]
        pos2d = torch.where(p < length[:, None], p, -1)
        updates = transformer.pack_prefill_cache(self.cfg, kv, pos2d)
        kvcache.scatter_prefill(self.pool, updates, phys_map)
        return self._sample(logits)

    def _extend_step(self, tokens, offset, length, tables, phys_map):
        """Prefix-hit tail prefill: only the un-hit prompt tails run, and
        attend the shared blocks through the gathered view."""
        view = kvcache.gather_view(self.pool, tables, self.kv.block)
        logits, kv, positions = transformer.extend(
            self.cfg, self.layout, self.params,
            {"tokens": tokens, "offset": offset, "length": length}, view)
        updates = transformer.pack_prefill_cache(self.cfg, kv, positions)
        kvcache.scatter_prefill(self.pool, updates, phys_map)
        idx = (length.long() - 1).clamp(0, tokens.shape[1] - 1)
        rows = torch.arange(tokens.shape[0], device=self.device)
        return self._sample(logits[rows, idx])

    def _spec_pad(self) -> int:
        """Verify-batch padded length: γ + 1 rounded to the prefill
        buckets."""
        return pad_bucket(self.spec.gamma + 1)

    # ------------------------------------------------------------------
    # Request lifecycle
    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.metrics.submit(req.uid)
        if not self.scheduler.submit(req):
            self.metrics.reject(req.uid)

    def _can_place(self, req: Request, slot: int) -> bool:
        if not self.paged:
            return True
        return self.kv.can_admit(len(req.prompt) + req.max_new,
                                 req.prompt if self.prefix else None)

    def _admit(self):
        free = [i for i in range(self.B) if self.slots[i] is None]
        placed = []
        for slot, req in self.scheduler.fill(free, self._can_place):
            if self.paged and not self.kv.admit(
                    slot, len(req.prompt) + req.max_new,
                    req.prompt if self.prefix else None):
                # the free count moved between can_place and admit (an
                # earlier admission of this tick took blocks, or shrank
                # this prompt's prefix hit): requeue at the head
                self.scheduler.pending_prefill.remove(slot)
                q = (self.scheduler.prio if req.priority > 0
                     else self.scheduler.fifo)
                q.appendleft(req)
                continue
            self.slots[slot] = req
            self.pos[slot] = 0
            req._fed = 0
            placed.append((slot, req))
            self.metrics.admit(req.uid)
        if placed:
            mask = np.zeros((self.B,), bool)
            mask[[s for s, _ in placed]] = True
            if self.paged:
                # invalidate recycled blocks before anything reads them
                # (the slots' private blocks only: shared prefix blocks
                # keep their content), then copy any partly shared block
                idx = self.kv.clear_targets([s for s, _ in placed])
                kvcache.clear_positions(self.pool, self._to_dev(idx))
                if self.prefix:
                    cow = self.kv.cow_rows([s for s, _ in placed])
                    if cow is not None:
                        kvcache.copy_block(self.pool,
                                           *map(self._to_dev, cow))
                    for s, _ in placed:
                        self.kv.cow_done(s)
                if self.spec is not None:
                    self.spec.reset(self._to_dev(mask))
            else:
                self._reset_rows(self._to_dev(mask))
        if not self.chunked:
            # sequential prefill starts feeding immediately, no prefill queue
            self.scheduler.pending_prefill.clear()
        if not placed and not self.scheduler.pending_prefill \
                and self.scheduler.has_queued() \
                and all(s is None for s in self.slots):
            # nothing running and the queue head can never be placed (needs
            # more blocks than the whole pool): reject instead of spinning
            req = (self.scheduler.prio or self.scheduler.fifo).popleft()
            req.error = ("request needs more KV blocks than the pool holds "
                         f"(prompt {len(req.prompt)} + max_new {req.max_new})")
            req.done = True
            self.metrics.reject(req.uid)

    def _finish(self, i: int):
        req = self.slots[i]
        req.done = True
        self.slots[i] = None
        if self.paged:
            self.kv.release(i)
        self.metrics.finish(req.uid)

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def step(self):
        """One engine step: admit waiting work, then either one chunked
        prefill group, one speculative round or one global decode tick."""
        self._admit()
        tr = self.tracer
        if self.chunked and self.scheduler.pending_prefill:
            with tr.span("prefill_tick", track="engine"):
                self._prefill_tick()
            kind = "prefill"
        elif self.spec is not None:
            with tr.span("spec_tick", track="engine"):
                self._spec_tick()
            kind = "decode"
        else:
            with tr.span("decode_tick", track="engine"):
                self._decode_tick()
            kind = "decode"
        self.metrics.observe_step(self.scheduler.queue_depth(), kind)
        if tr.enabled:
            tr.counter("active_slots",
                       sum(s is not None for s in self.slots),
                       track="engine")
        self.steps += 1

    def _emit(self, i: int, toks, bad: bool):
        """Append the tokens a step emitted for slot ``i``; finish it at
        ``max_new`` or at the length bound."""
        req = self.slots[i]
        req.out.extend(int(t) for t in toks)
        self.nonfinite_rows += int(bad)
        self.metrics.token(req.uid, len(toks))
        if len(req.out) >= req.max_new or self.pos[i] >= self.max_len - 1:
            self._finish(i)

    def _prefill_tick(self):
        # with the prefix cache on, each slot prefills only its un-hit
        # tail: grouping, padding and the token budget run on the tail
        hit = {s: self.kv.hit_len(s) if self.prefix else 0
               for s in self.scheduler.pending_prefill}
        lens = {s: len(self.slots[s].prompt) - hit[s] for s in hit}
        group, s_pad = self.scheduler.prefill_group(lens)
        tokens = np.zeros((self.B, s_pad), np.int64)
        length = np.zeros((self.B,), np.int32)
        offset = np.zeros((self.B,), np.int32)
        for s in group:
            p = self.slots[s].prompt
            tokens[s, :lens[s]] = p[hit[s]:]
            length[s] = lens[s]
            offset[s] = hit[s]
        if self.prefix:
            phys_map = self.kv.extend_phys_map(
                {s: (hit[s], lens[s]) for s in group}, s_pad)
            tok, bad = self._extend_step(
                self._to_dev(tokens), self._to_dev(offset),
                self._to_dev(length), self.kv.tables_device(self.device),
                self._to_dev(phys_map))
        else:
            phys_map = self.kv.prefill_phys_map(
                {s: lens[s] for s in group}, s_pad)
            tok, bad = self._prefill_step(self._to_dev(tokens),
                                          self._to_dev(length),
                                          self._to_dev(phys_map))
        if self.spec is not None:
            # the draft prefills the FULL prompt into its private cache: it
            # shares no prefix, and its bursts need the whole context
            d_pad = pad_bucket(max(len(self.slots[s].prompt) for s in group))
            dtok = np.zeros((self.B, d_pad), np.int64)
            dlen = np.zeros((self.B,), np.int32)
            for s in group:
                p = self.slots[s].prompt
                dtok[s, :len(p)] = p
                dlen[s] = len(p)
            self.spec.prefill(self._to_dev(dtok), self._to_dev(dlen))
        for s in group:
            req = self.slots[s]
            self.pos[s] = len(req.prompt)
            req._fed = len(req.prompt)
            if self.prefix:
                # publish this prompt's full blocks before any release
                # below: completed requests still seed the index
                self.kv.register_prefix(s)
            self._emit(s, tok[s:s + 1], bad[s])

    def _decode_tick(self):
        tok = np.zeros((self.B, 1), np.int64)
        active = np.zeros((self.B,), bool)
        pending = set(self.scheduler.pending_prefill)
        for i, req in enumerate(self.slots):
            if req is None or i in pending:
                continue
            if req._fed < len(req.prompt):
                tok[i, 0] = req.prompt[req._fed]     # sequential prefill
                active[i] = True
            elif req.out:
                tok[i, 0] = req.out[-1]
                active[i] = True
        if not active.any():
            return
        if self.paged:
            nxt, bad = self._decode_step(
                self._to_dev(tok), self._to_dev(self.pos),
                self.kv.tables_device(self.device), self._to_dev(active))
        else:
            nxt, bad = self._state_step(self._to_dev(tok),
                                        self._to_dev(self.pos))
        for i, req in enumerate(self.slots):
            if req is None or not active[i]:
                continue
            self.pos[i] += 1
            if req._fed < len(req.prompt):
                req._fed += 1
                if req._fed < len(req.prompt):
                    continue
            self._emit(i, nxt[i:i + 1], bad[i])

    def _spec_tick(self):
        """One speculative round: the draft bursts γ proposals per active
        slot, the target verifies them in one batched extend, and each row
        emits ``accepted + 1`` tokens (accepted drafts + bonus)."""
        gamma, s_pad = self.spec.gamma, self._spec_pad()
        t0 = np.zeros((self.B,), np.int64)
        tprev = np.zeros((self.B,), np.int64)
        posv = np.ones((self.B,), np.int32)
        limit = np.zeros((self.B,), np.int64)
        active = np.zeros((self.B,), bool)
        pending = set(self.scheduler.pending_prefill)
        rows = {}
        for i, req in enumerate(self.slots):
            if req is None or i in pending or not req.out:
                continue
            t0[i] = req.out[-1]
            tprev[i] = req.out[-2] if len(req.out) >= 2 else req.prompt[-1]
            posv[i] = self.pos[i]
            # emit at most limit + 1 tokens: stay under max_new and under
            # the decode length bound (pos must end < max_len - 1, as in
            # the non-speculative finish condition)
            limit[i] = max(min(req.max_new - len(req.out),
                               self.max_len - 1 - self.pos[i]) - 1, 0)
            active[i] = True
            rows[i] = (int(self.pos[i]), gamma + 1)
        if not active.any():
            return
        t0_d, pos_d = self._to_dev(t0), self._to_dev(posv)
        drafts, qprobs = self.spec.propose(self._to_dev(tprev), t0_d, pos_d,
                                           self.generator)
        vtok = torch.zeros((self.B, s_pad), dtype=torch.long,
                           device=self.device)
        vtok[:, 0] = t0_d
        vtok[:, 1:gamma + 1] = drafts
        phys_map = self.kv.extend_phys_map(rows, s_pad)
        length = np.where(active, gamma + 1, 0).astype(np.int32)
        a, emit, bad = self._verify(
            self.params, self.pool, vtok, drafts, qprobs, pos_d,
            self._to_dev(length), self.kv.tables_device(self.device),
            self._to_dev(phys_map), self._to_dev(limit), self.generator)
        host = torch.cat([a[:, None], emit, bad.long()[:, None]],
                         dim=1).cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None or not active[i]:
                continue
            n = int(host[i, 0]) + 1
            self.metrics.spec_accept(n - 1)
            self.pos[i] += n
            self._emit(i, host[i, 1:1 + n], bool(host[i, -1]))

    # ------------------------------------------------------------------
    def _busy(self) -> bool:
        return (self.scheduler.has_queued()
                or bool(self.scheduler.pending_prefill)
                or any(s is not None for s in self.slots))

    def run(self, requests: List[Request], progress: Callable = None):
        # per-run metrics: each run() reports exactly its own requests
        self.metrics = ServeMetrics(tracer=self.tracer)
        self.nonfinite_rows = 0
        if self.paged:
            self.kv.lookups = self.kv.hits = self.kv.tokens_reused = 0
            self.kv.allocator.evictions = 0
        for r in requests:
            self.submit(r)
        t0 = time.time()
        start = self.steps
        while self._busy():
            self.step()
            if progress and (self.steps - start) % 16 == 0:
                progress(self.steps)
        wall = time.time() - t0
        if self.paged:
            self.metrics.prefix_stats(self.kv.lookups, self.kv.hits,
                                      self.kv.tokens_reused,
                                      self.kv.allocator.evictions)
        stats = self.metrics.summary(wall)
        stats.update(steps=self.steps - start, wall_s=wall,
                     tokens=sum(len(r.out) for r in requests),
                     nonfinite_rows=self.nonfinite_rows)
        return stats
