"""Continuous-batching scheduler: FIFO + priority queues, admission
control, slot refill, and prefill grouping (copy of
``repro/serve/scheduler.py`` for the port).

Pure host-side policy: the engine owns the device work; this
module decides *which* requests run.  Contracts:

  * ``submit`` applies admission control: a prompt that can never fit the
    engine's cache (``len(prompt) >= max_len``, or empty) is rejected
    immediately — it never occupies a slot, so a too-long prompt cannot
    wedge the batch (the rejection reason lands on ``req.error``).
  * Two queues: requests with ``priority > 0`` drain strictly before the
    FIFO queue; within each queue order is FIFO (no head-of-line skipping,
    so capacity-blocked heads cannot be starved by later short requests).
  * ``fill`` assigns queued requests to free slots, gated by the engine's
    ``can_place`` capacity callback (paged engines check the block free
    list) — a request that doesn't fit *now* stays queued and is retried
    when completions free blocks.
  * ``prefill_group`` picks the next chunk of freshly placed slots to
    prefill under a token budget: the padded prefill batch costs
    ``batch_size x S_pad`` device tokens per step, so the group's padded
    length is capped at ``chunk_tokens / batch_size`` (rounded up to a
    power-of-two bucket to bound jit retraces); the head of the pending
    list always runs, whatever its length — budget bounds batching, it
    never starves a long prompt.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Tuple


def pad_bucket(n: int, lo: int = 8) -> int:
    """Smallest power-of-two >= n (>= lo): the prefill padding buckets."""
    s = lo
    while s < n:
        s *= 2
    return s


class Scheduler:
    def __init__(self, batch_size: int, max_len: int,
                 chunk_tokens: int = 4096):
        self.B = batch_size
        self.max_len = max_len
        self.chunk_tokens = max(chunk_tokens, 1)
        self.fifo: deque = deque()
        self.prio: deque = deque()
        # slots freshly placed and awaiting their (chunked) prefill step,
        # in placement order
        self.pending_prefill: List[int] = []

    # ---- admission ----
    def admit_error(self, req) -> Optional[str]:
        if not req.prompt:
            return "empty prompt"
        if len(req.prompt) >= self.max_len:
            return (f"prompt length {len(req.prompt)} >= max_len "
                    f"{self.max_len}: can never fit the cache")
        return None

    def submit(self, req) -> bool:
        """Queue a request; False when admission control rejects it
        (``req.done`` set, ``req.error`` carries the reason)."""
        err = self.admit_error(req)
        if err is not None:
            req.error, req.done = err, True
            return False
        (self.prio if req.priority > 0 else self.fifo).append(req)
        return True

    def queue_depth(self) -> int:
        return len(self.prio) + len(self.fifo)

    def has_queued(self) -> bool:
        return bool(self.prio or self.fifo)

    # ---- slot refill ----
    def fill(self, free_slots: List[int],
             can_place: Callable[[object, int], bool]) -> List[Tuple[int, object]]:
        """Place queued requests into ``free_slots`` (priority queue first),
        gated per-request by ``can_place(req, slot)``.  Returns the
        (slot, request) placements; placed slots are appended to the
        pending-prefill list in order."""
        placed = []
        for slot in free_slots:
            # strict priority: while the priority queue is nonempty only its
            # head is considered — a capacity-blocked priority request is
            # never leapfrogged by FIFO traffic (it waits for completions to
            # free blocks, or for the engine's idle wedge-rejection)
            q = self.prio if self.prio else self.fifo
            if not q or not can_place(q[0], slot):
                break
            req = q.popleft()
            placed.append((slot, req))
            self.pending_prefill.append(slot)
        return placed

    # ---- prefill grouping ----
    def prefill_group(self, prompt_len: Dict[int, int]) -> Tuple[List[int], int]:
        """Pop the next prefill group: the longest prefix of the pending
        list whose prompts fit one padding bucket under the token budget.
        Returns (slots, s_pad); ([], 0) when nothing is pending."""
        if not self.pending_prefill:
            return [], 0
        budget = max(self.chunk_tokens // self.B, 1)
        # the head always runs, whatever its length; others join while they
        # fit the budget cap, and the batch pads to the group's true max
        cap = max(prompt_len[self.pending_prefill[0]], budget)
        group = [s for s in self.pending_prefill if prompt_len[s] <= cap]
        s_pad = pad_bucket(max(prompt_len[s] for s in group))
        self.pending_prefill = [s for s in self.pending_prefill
                                if s not in group]
        return group, s_pad
