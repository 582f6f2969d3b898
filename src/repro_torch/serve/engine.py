"""Continuous-batching serving engine (port of ``repro/serve/engine.py``
for the dense family's paged serving path).

  * ``scheduler.Scheduler``  — FIFO + priority queues, admission control,
    slot refill, prefill grouping (host-side policy).
  * ``kvcache.PagedKVCache`` — block-table paged KV pool.
  * ``sampling.make_sampler`` — greedy / temperature / top-k / top-p under
    one engine-owned, seeded ``torch.Generator``.
  * ``metrics.ServeMetrics`` — TTFT / TPOT / throughput / queue depth.

A *prefill* step pushes a whole padded group of freshly admitted prompts
through ``transformer.prefill``, scatters the returned kv into the pool and
emits each request's first token.  A *decode* step advances every
in-flight slot by one token: the blocks attend the read-only pool through
the block tables (the K4 kernel), and the step writes every layer's new
entries back in one scatter.  With ``chunked_prefill=False`` prompts are
fed one token per decode step instead.

The engine runs on the device its parameters lie on.  Not in this slice
(each raises ValueError): recurrent-state and MoE/MLA families, the
gather-view decode (``fused_decode=False``), the prefix cache and
speculative decoding.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import Family, ModelConfig
from ..core.params import tree_leaves
from ..core.topology import Layout
from ..models import blocks as B
from ..models import transformer
from ..obs.trace import NULL
from . import kvcache, sampling
from .metrics import ServeMetrics
from .scheduler import Scheduler

LATER = "arrives with a later serving slice of the port (ROADMAP.md)"


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
                 prefix_cache: bool = False, draft=None, tracer=None):
        if transformer.serve_cache_mode(cfg) != "paged":
            raise ValueError(
                f"{cfg.arch}: family {cfg.family.value!r} serves with "
                f"recurrent state; its engine {LATER}")
        if cfg.family != Family.DENSE:
            raise ValueError(f"{cfg.arch}: family {cfg.family.value!r} {LATER}")
        if fused_decode is False:
            raise ValueError(f"fused_decode=False (gather-view decode) {LATER}")
        if prefix_cache:
            raise ValueError(f"prefix_cache=True (shared-prefix KV reuse) "
                             f"{LATER}")
        if draft is not None:
            raise ValueError(f"draft=... (speculative decoding) {LATER}")
        self.cfg, self.layout, self.params = cfg, layout, params
        # observability: per-request lifecycle spans come from the metrics
        # hooks; the engine adds one span per device tick on the "engine"
        # lane.  The default NULL tracer makes all of it free.
        self.tracer = tracer if tracer is not None else NULL
        self.B, self.max_len = batch_size, max_len
        self.chunked = chunked_prefill
        first = tree_leaves(params)[0]
        self.device = first.device
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

        self.kv = kvcache.PagedKVCache(cfg, batch_size, max_len,
                                       block=block_size, n_blocks=n_blocks,
                                       dtype=params["embed"].dtype)
        self.pool = self.kv.init_pool(self.device)

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
        blk, L = self.kv.block, self.kv.view_len
        page = B.PageInfo(tables=tables, active=active, block=blk)
        logits, upd = transformer.forward(
            self.cfg, self.layout, self.params, {"token": tok, "pos": pos},
            mode="decode", cache=self.pool, page=page)
        rows = torch.arange(tok.shape[0], device=self.device)
        slot = pos.long() % L
        phys = tables[rows, slot // blk].long() * blk + slot % blk
        phys = torch.where(active, phys, blk + rows % blk)   # idle -> trash
        kvcache.scatter_step(self.pool, upd, phys)
        return self._sample(logits)

    def _prefill_step(self, tokens, length, phys_map):
        logits, kv = transformer.prefill(
            self.cfg, self.layout, self.params,
            {"tokens": tokens, "length": length})
        p = torch.arange(tokens.shape[1], device=self.device)[None, :]
        pos2d = torch.where(p < length[:, None], p, -1)
        updates = transformer.pack_prefill_cache(self.cfg, kv, pos2d)
        kvcache.scatter_prefill(self.pool, updates, phys_map)
        return self._sample(logits)

    # ------------------------------------------------------------------
    # Request lifecycle
    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.metrics.submit(req.uid)
        if not self.scheduler.submit(req):
            self.metrics.reject(req.uid)

    def _can_place(self, req: Request, slot: int) -> bool:
        return self.kv.can_admit(len(req.prompt) + req.max_new)

    def _admit(self):
        free = [i for i in range(self.B) if self.slots[i] is None]
        placed = []
        for slot, req in self.scheduler.fill(free, self._can_place):
            if not self.kv.admit(slot, len(req.prompt) + req.max_new):
                # can_place saw the free count before this tick's earlier
                # admissions took their blocks: requeue at the head
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
            # invalidate recycled blocks before anything reads them
            idx = self.kv.clear_targets([s for s, _ in placed])
            kvcache.clear_positions(self.pool, self._to_dev(idx))
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
        self.kv.release(i)
        self.metrics.finish(req.uid)

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def step(self):
        """One engine step: admit waiting work, then either one chunked
        prefill group or one global decode tick."""
        self._admit()
        tr = self.tracer
        if self.chunked and self.scheduler.pending_prefill:
            with tr.span("prefill_tick", track="engine"):
                self._prefill_tick()
            kind = "prefill"
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

    def _emit(self, i: int, tok: int, bad: bool):
        req = self.slots[i]
        req.out.append(int(tok))
        self.nonfinite_rows += int(bad)
        self.metrics.token(req.uid)
        if len(req.out) >= req.max_new or self.pos[i] >= self.max_len - 1:
            self._finish(i)

    def _prefill_tick(self):
        lens = {s: len(self.slots[s].prompt)
                for s in self.scheduler.pending_prefill}
        group, s_pad = self.scheduler.prefill_group(lens)
        tokens = np.zeros((self.B, s_pad), np.int64)
        length = np.zeros((self.B,), np.int32)
        for s in group:
            p = self.slots[s].prompt
            tokens[s, :len(p)] = p
            length[s] = len(p)
        phys_map = self.kv.prefill_phys_map({s: lens[s] for s in group},
                                            s_pad)
        tok, bad = self._prefill_step(self._to_dev(tokens),
                                      self._to_dev(length),
                                      self._to_dev(phys_map))
        for s in group:
            req = self.slots[s]
            self.pos[s] = len(req.prompt)
            req._fed = len(req.prompt)
            self._emit(s, tok[s], bad[s])

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
        nxt, bad = self._decode_step(
            self._to_dev(tok), self._to_dev(self.pos),
            self.kv.tables_device(self.device), self._to_dev(active))
        for i, req in enumerate(self.slots):
            if req is None or not active[i]:
                continue
            self.pos[i] += 1
            if req._fed < len(req.prompt):
                req._fed += 1
                if req._fed < len(req.prompt):
                    continue
            self._emit(i, nxt[i], bad[i])

    # ------------------------------------------------------------------
    def _busy(self) -> bool:
        return (self.scheduler.has_queued()
                or bool(self.scheduler.pending_prefill)
                or any(s is not None for s in self.slots))

    def run(self, requests: List[Request], progress: Callable = None):
        # per-run metrics: each run() reports exactly its own requests
        self.metrics = ServeMetrics(tracer=self.tracer)
        self.nonfinite_rows = 0
        for r in requests:
            self.submit(r)
        t0 = time.time()
        start = self.steps
        while self._busy():
            self.step()
            if progress and (self.steps - start) % 16 == 0:
                progress(self.steps)
        wall = time.time() - t0
        stats = self.metrics.summary(wall)
        stats.update(steps=self.steps - start, wall_s=wall,
                     tokens=sum(len(r.out) for r in requests),
                     nonfinite_rows=self.nonfinite_rows)
        return stats
