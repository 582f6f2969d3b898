"""Serving metrics: TTFT / TPOT / throughput / queue depth (copy of
``repro/serve/metrics.py`` for the port).

The engine calls the ``submit`` / ``admit`` / ``token`` / ``finish`` /
``reject`` hooks as requests move through it and ``observe_step`` once
per engine step; ``summary()`` reduces everything to a plain dict
(p50/p95 latencies in seconds, tok/s, queue-depth histogram) and
``format_summary`` renders the launcher's report.  Pure host-side
bookkeeping — nothing here touches the device.

When a recording tracer (``repro_torch.obs.trace``) is attached, each hook also
emits the shared obs event schema, so serve runs and train runs produce
one trace format: per-request lanes ``req<uid>`` carry
``submit -> queue -> prefill -> decode -> finish`` (queue/prefill/decode
as retroactive spans from the hook timestamps), ``observe_step`` emits a
``queue_depth`` counter on the ``engine`` lane.  With the default
``NULL`` tracer all of that is a no-op.

Definitions:
  * TTFT  — submit() to first token per request (queueing + prefill).
  * TPOT  — (t_last - t_first) / (n_tokens - 1) per request with >= 2
            generated tokens: the steady decode cadence.
  * queue wait — submit() to admit() (slot placement) per request.
  * throughput — generated tokens / wall seconds over the whole run.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np

from ..obs.trace import NULL


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile over the finite values.  Total on the edge
    cases: empty (or all-non-finite) -> 0.0, single sample -> that sample
    for every q, q clamped into [0, 100]."""
    vals = [v for v in values if math.isfinite(v)]
    if not vals:
        return 0.0
    return float(np.percentile(vals, min(max(q, 0.0), 100.0),
                               method="nearest"))


def histogram(values: List[float], bins: int = 8):
    """Equal-width histogram -> (edges [bins+1], counts [bins]).  Total on
    the edge cases: empty/all-non-finite -> ([0, 1], [0]); a single sample
    or an all-equal series gets a unit-width range centred on the value
    (numpy's degenerate-range padding) with every count in one bin —
    callers always see len(edges) == bins + 1, sum(counts) == n_finite."""
    vals = [v for v in values if math.isfinite(v)]
    if not vals:
        return [0.0, 1.0], [0]
    counts, edges = np.histogram(vals, bins=bins)
    return edges.tolist(), counts.tolist()


class _Track:
    __slots__ = ("t_submit", "t_admit", "t_first", "t_last", "n_tokens")

    def __init__(self, t):
        self.t_submit = t
        self.t_admit: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.n_tokens = 0


class ServeMetrics:
    def __init__(self, clock=time.perf_counter, tracer=None):
        self._clock = clock
        self.tracer = tracer if tracer is not None else NULL
        self._reqs: Dict[int, _Track] = {}
        self.rejected = 0
        self.completed = 0
        self.queue_depths: List[int] = []
        self.prefill_steps = 0
        self.decode_steps = 0
        # prefix-sharing counters (engine copies them from the kv manager)
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.evictions = 0
        # accepted-draft lengths, one entry per speculative verify per row
        self.accepted: List[int] = []

    # ---- request lifecycle ----
    def submit(self, uid: int):
        self._reqs[uid] = _Track(self._clock())
        self.tracer.instant("submit", track=f"req{uid}")

    def reject(self, uid: int):
        self.rejected += 1
        self._reqs.pop(uid, None)
        self.tracer.instant("reject", track=f"req{uid}")

    def admit(self, uid: int):
        """Request placed into a decode slot (queue wait ends here)."""
        tr = self._reqs.get(uid)
        if tr is None or tr.t_admit is not None:
            return
        tr.t_admit = self._clock()
        t = self.tracer
        if t.enabled:
            t.span_at("queue", t.rel(tr.t_submit), t.rel(tr.t_admit),
                      track=f"req{uid}")

    def token(self, uid: int, n: int = 1):
        tr = self._reqs.get(uid)
        if tr is None:
            return
        now = self._clock()
        if tr.t_first is None:
            tr.t_first = now
            t = self.tracer
            if t.enabled:
                # the prefill span runs admit (or submit, when the engine
                # never called admit) -> first emitted token
                t.span_at("prefill", t.rel(tr.t_admit or tr.t_submit),
                          t.rel(now), track=f"req{uid}")
        tr.t_last = now
        tr.n_tokens += n

    def finish(self, uid: int):
        self.completed += 1
        tr = self._reqs.get(uid)
        t = self.tracer
        if t.enabled and tr is not None and tr.t_first is not None:
            t.span_at("decode", t.rel(tr.t_first), t.rel(tr.t_last),
                      track=f"req{uid}", tokens=tr.n_tokens)
            t.instant("finish", track=f"req{uid}")

    def spec_accept(self, n: int):
        """Record one verify outcome: n drafts accepted (0..γ)."""
        self.accepted.append(int(n))

    def prefix_stats(self, lookups: int, hits: int, tokens_reused: int,
                     evictions: int):
        self.prefix_lookups = lookups
        self.prefix_hits = hits
        self.prefix_tokens_reused = tokens_reused
        self.evictions = evictions

    # ---- engine step ----
    def observe_step(self, queue_depth: int, kind: str):
        self.queue_depths.append(queue_depth)
        if kind == "prefill":
            self.prefill_steps += 1
        else:
            self.decode_steps += 1
        if self.tracer.enabled:
            self.tracer.counter("queue_depth", queue_depth, track="engine")

    # ---- reduction ----
    def summary(self, wall_s: float) -> dict:
        ttft = [t.t_first - t.t_submit for t in self._reqs.values()
                if t.t_first is not None]
        tpot = [(t.t_last - t.t_first) / (t.n_tokens - 1)
                for t in self._reqs.values()
                if t.t_first is not None and t.n_tokens > 1]
        qwait = [t.t_admit - t.t_submit for t in self._reqs.values()
                 if t.t_admit is not None]
        tokens = sum(t.n_tokens for t in self._reqs.values())
        return {
            "queue_wait_p50_s": percentile(qwait, 50),
            "queue_wait_p95_s": percentile(qwait, 95),
            "wall_s": wall_s,
            "tokens": tokens,
            "tok_per_s": tokens / wall_s if wall_s > 0 else 0.0,
            "completed": self.completed,
            "rejected": self.rejected,
            "ttft_p50_s": percentile(ttft, 50),
            "ttft_p95_s": percentile(ttft, 95),
            "tpot_p50_s": percentile(tpot, 50),
            "tpot_p95_s": percentile(tpot, 95),
            "queue_depth_max": max(self.queue_depths, default=0),
            "queue_depth_hist": histogram([float(q) for q in
                                           self.queue_depths]),
            "ttft_hist": histogram(ttft),
            "tpot_hist": histogram(tpot),
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (self.prefix_hits / self.prefix_lookups
                                if self.prefix_lookups else 0.0),
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "evictions": self.evictions,
            "spec_steps": len(self.accepted),
            "accepted_mean": (float(np.mean(self.accepted))
                              if self.accepted else 0.0),
            "accepted_hist": histogram([float(a) for a in self.accepted]),
        }


def format_summary(s: dict) -> str:
    return (
        f"served {s['completed']} requests ({s['rejected']} rejected): "
        f"{s['tokens']} tokens / {s['wall_s']:.2f}s = "
        f"{s['tok_per_s']:.1f} tok/s\n"
        f"  TTFT p50 {s['ttft_p50_s']*1e3:7.1f} ms   "
        f"p95 {s['ttft_p95_s']*1e3:7.1f} ms\n"
        f"  TPOT p50 {s['tpot_p50_s']*1e3:7.1f} ms   "
        f"p95 {s['tpot_p95_s']*1e3:7.1f} ms\n"
        f"  steps: {s['prefill_steps']} prefill + {s['decode_steps']} decode"
        f"   queue depth max {s['queue_depth_max']}"
        + (f"\n  prefix cache: {s['prefix_hits']}/{s['prefix_lookups']} hits"
           f" ({s['prefix_hit_rate']:.0%}), "
           f"{s['prefix_tokens_reused']} tokens reused, "
           f"{s['evictions']} evictions"
           if s.get("prefix_lookups") else "")
        + (f"\n  speculative: {s['spec_steps']} verifies, mean accepted "
           f"{s['accepted_mean']:.2f} drafts"
           if s.get("spec_steps") else ""))
