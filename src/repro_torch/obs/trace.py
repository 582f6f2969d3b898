"""Low-overhead span tracer (copy of ``repro/obs/trace.py`` for the port).

One event schema everywhere (the JSONL log is the source of truth; the
Chrome-trace JSON is a view of the same events):

  * span     — {"ev": "span", "name", "track", "ts", "dur", "args"?}
  * instant  — {"ev": "instant", "name", "track", "ts", "args"?}
  * counter  — {"ev": "counter", "name", "track", "ts", "value"}

Timestamps are seconds relative to tracer construction (``perf_counter``
based); a ``track`` is a horizontal lane in the viewer — the train loop
uses ``"train"``, the serve engine ``"engine"`` plus one ``"req<uid>"``
lane per request, so a serve trace reads as a swimlane diagram of the
request lifecycle.

Design constraints (the reason this is not a logging wrapper):

  * strict no-op when disabled: ``NULL`` is a :class:`NullTracer` whose
    ``span()`` returns a shared singleton context manager — no allocation,
    no clock read, no branch in the caller.  Pass a tracer everywhere and
    default it to ``NULL``; never ``if tracer is not None`` in hot paths.
  * no implicit device syncs: CUDA launches are async, so a span around a
    device call measures *dispatch* unless the caller opts in.  Either call
    ``span.sync(value)`` before exit (synchronizes the value's device and
    attributes the wait to the span) or time at natural sync points (a copy
    to the host, printing a loss).
  * spans nest by construction (enter/exit discipline) and survive
    exceptions: a span whose body raises is still emitted, tagged with
    ``error=<ExceptionType>``.
  * ``annotate=True`` (default) additionally wraps each span in
    ``torch.profiler.record_function`` so the same names land inside
    ``torch.profiler`` traces when one is being captured.

Export: ``write_jsonl(path)`` and ``write_chrome(path)``; the Chrome file
loads in ``chrome://tracing`` / Perfetto (``ph:"X"`` complete events, one
tid per track, thread-name metadata).  ``tools/check_trace.py`` validates
both formats.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional

import torch


class _NullSpan:
    """Shared do-nothing context manager returned by the disabled tracer."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        pass

    def sync(self, value):
        return value


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every method is a no-op, ``span`` hands back one
    shared singleton.  The hot-path cost of passing this around is a method
    call returning a constant — nothing is recorded, timed, or allocated."""
    enabled = False
    events: tuple = ()

    def span(self, name, track="main", annotate=None, **args):
        return _NULL_SPAN

    def traced(self, name=None, track="main"):
        def deco(fn):
            return fn
        return deco

    def instant(self, name, track="main", **args):
        pass

    def counter(self, name, value, track="main"):
        pass

    def span_at(self, name, t0, t1, track="main", **args):
        pass

    def now(self) -> float:
        return 0.0

    def rel(self, t_abs: float) -> float:
        return 0.0

    def write_jsonl(self, path):
        pass

    def write_chrome(self, path):
        pass


NULL = NullTracer()


class _Span:
    __slots__ = ("_tr", "name", "track", "args", "t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, track: str,
                 annotate: bool, args: dict):
        self._tr = tracer
        self.name = name
        self.track = track
        self.args = args
        self.t0 = 0.0
        self._ann = tracer._annotation(name) if annotate else None

    def __enter__(self):
        if self._ann is not None:
            self._ann.__enter__()
        self.t0 = self._tr.now()
        return self

    def set(self, **args):
        """Attach extra args to the span (merged at exit)."""
        self.args.update(args)
        return self

    def sync(self, value):
        """Opt-in sync point: block until ``value``'s device is idle so the
        span covers device time, not just dispatch.  Returns ``value``."""
        if isinstance(value, torch.Tensor) and value.is_cuda:
            torch.cuda.synchronize(value.device)
        return value

    def __exit__(self, exc_type, exc, tb):
        t1 = self._tr.now()
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        ev = {"ev": "span", "name": self.name, "track": self.track,
              "ts": self.t0, "dur": t1 - self.t0}
        if self.args:
            ev["args"] = self.args
        self._tr._emit(ev)
        return False


class Tracer:
    """Recording tracer.  Thread-safe appends; host-side only (events live
    in a python list until exported)."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 annotate: bool = True):
        self._clock = clock
        self._t0 = clock()
        self.events: List[dict] = []
        self._lock = threading.Lock()
        self.annotate = annotate
        self._ann_cls = torch.profiler.record_function if annotate else None

    # -- clock ---------------------------------------------------------------
    def now(self) -> float:
        """Seconds since tracer construction (the event timebase)."""
        return self._clock() - self._t0

    def rel(self, t_abs: float) -> float:
        """Convert an absolute stamp of the *same* clock into the event
        timebase (for retroactive ``span_at`` from timestamps recorded
        outside the tracer, e.g. serve/metrics.py request stamps)."""
        return t_abs - self._t0

    def _annotation(self, name):
        return self._ann_cls(name) if self._ann_cls is not None else None

    def _emit(self, ev: dict):
        with self._lock:
            self.events.append(ev)

    # -- recording API -------------------------------------------------------
    def span(self, name: str, track: str = "main",
             annotate: Optional[bool] = None, **args) -> _Span:
        """Context manager timing its body.  ``with tracer.span("step"):``"""
        ann = self.annotate if annotate is None else annotate
        return _Span(self, name, track, ann, args)

    def traced(self, name: Optional[str] = None, track: str = "main"):
        """Decorator form: ``@tracer.traced()`` spans every call."""
        def deco(fn):
            label = name or fn.__qualname__

            def wrapper(*a, **kw):
                with self.span(label, track=track):
                    return fn(*a, **kw)
            wrapper.__name__ = fn.__name__
            wrapper.__qualname__ = fn.__qualname__
            wrapper.__doc__ = fn.__doc__
            return wrapper
        return deco

    def instant(self, name: str, track: str = "main", **args):
        ev = {"ev": "instant", "name": name, "track": track, "ts": self.now()}
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, value: float, track: str = "main"):
        self._emit({"ev": "counter", "name": name, "track": track,
                    "ts": self.now(), "value": float(value)})

    def span_at(self, name: str, t0: float, t1: float, track: str = "main",
                **args):
        """Retroactive span from recorded timestamps (tracer timebase, i.e.
        values of ``now()``).  The serve engine uses this to emit
        queue/prefill/decode phases at finish time from per-request stamps
        instead of holding a context manager open across engine steps."""
        ev = {"ev": "span", "name": name, "track": track,
              "ts": float(t0), "dur": max(float(t1) - float(t0), 0.0)}
        if args:
            ev["args"] = args
        self._emit(ev)

    # -- export --------------------------------------------------------------
    def write_jsonl(self, path: str):
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")

    def chrome_trace(self) -> dict:
        """Events as a Chrome-trace/Perfetto document (ts/dur in us)."""
        tids: Dict[str, int] = {}
        out = []
        for ev in self.events:
            track = ev["track"]
            if track not in tids:
                tid = tids[track] = len(tids)
                out.append({"ph": "M", "name": "thread_name", "pid": 0,
                            "tid": tid, "args": {"name": track}})
            tid = tids[track]
            base = {"name": ev["name"], "pid": 0, "tid": tid,
                    "ts": ev["ts"] * 1e6}
            if ev["ev"] == "span":
                base.update(ph="X", dur=ev["dur"] * 1e6)
                if "args" in ev:
                    base["args"] = ev["args"]
            elif ev["ev"] == "instant":
                base.update(ph="i", s="t")
                if "args" in ev:
                    base["args"] = ev["args"]
            else:                    # counter
                base.update(ph="C", args={ev["name"]: ev["value"]})
            out.append(base)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write_chrome(self, path: str):
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


def make_tracer(enabled: bool, **kw):
    """``Tracer(**kw)`` when enabled, the shared ``NULL`` otherwise."""
    return Tracer(**kw) if enabled else NULL
