"""Span-based tracer: thread-safe ring buffer, Chrome trace-event export.

Design constraints, in priority order:

1. **~zero cost when disabled.**  Production code guards every
   instrumentation point with one module attribute load
   (``trace.active() is None``); nothing else runs.  Hot loops (the
   ``ExecPlan`` kernel sequence) hoist that check out of the loop.
2. **Bounded memory when enabled.**  Completed spans land in a
   ``deque(maxlen=capacity)`` ring — recording never allocates beyond
   the ring, and a long soak keeps the most recent spans.
3. **Cross-thread attribution.**  Every span records its thread id and
   name; request spans additionally carry the **trace id** minted at
   ``Session.submit()``, so one request can be followed from the
   submitting thread through the worker that served it.

The export (:meth:`Tracer.chrome_trace`) is the Chrome trace-event JSON
array format — complete (``"X"``) spans, instant (``"i"``) events,
thread-name metadata and flow arrows stitching each trace id across
threads — loadable in Perfetto (ui.perfetto.dev) or chrome://tracing.

Recording uses ``time.monotonic()`` (the serving runtime's latency
clock), *not* the chaos-skewable deadline clock: traces measure what
actually happened, fault injection included.

Started as a copy of the JAX package's ``obs/trace.py`` (pure Python;
the port imports nothing of that package).  It has since parted from the
original: the phases of a served batch (:class:`Phase`), each carrying the
batch's id.  No test holds the two files equal.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

#: event tuple layout (kept a plain tuple — recording is the hot path):
#: (name, cat, t0, t1_or_None, thread_id, thread_name, trace_id, args)
Event = Tuple[str, str, float, Optional[float], int, str,
              Optional[int], Optional[dict]]

_ids = itertools.count(1)


def new_trace_id() -> int:
    """Mint a process-unique request trace id (cheap, always-on: ids
    are assigned at submit time whether or not tracing is enabled, so
    enabling mid-run attributes in-flight requests correctly)."""
    return next(_ids)


_batch_ids = itertools.count(1)


def new_batch_id() -> int:
    """Mint a process-unique batch id: a serving session takes one for
    each batch it executes while tracing is armed, and every span of that
    batch carries it as its ``batch`` argument, so a reader groups a
    batch's spans without relying on time containment."""
    return next(_batch_ids)


class Phase:
    """One phase of a served batch, from its start to :meth:`end`: a
    span of category ``serving`` carrying the batch id its thread serves
    (:meth:`Tracer.set_batch`) and the counts given to :meth:`end`.  A
    phase whose work raises is never ended, and records nothing."""

    __slots__ = ("_tracer", "_name", "_t0")

    def __init__(self, tracer: "Tracer", name: str,
                 t0: Optional[float] = None):
        self._tracer = tracer
        self._name = name
        self._t0 = time.monotonic() if t0 is None else t0

    def end(self, t1: Optional[float] = None, **args) -> None:
        """Record the span [start, ``t1``] (``t1`` defaults to now) with
        ``args`` and the thread's batch id."""
        t1 = time.monotonic() if t1 is None else t1
        args["batch"] = getattr(self._tracer._local, "batch", None)
        self._tracer.complete(self._name, "serving", self._t0, t1,
                              args=args)


class Tracer:
    """One armed span ring buffer.

    ``complete``/``instant`` are safe from any thread: appends to a
    bounded deque are atomic under the GIL, so the record path takes no
    lock.  ``plan_steps`` controls whether :meth:`ExecPlan.run
    <repro_torch.core.execplan.ExecPlan.run>` emits one span per lowered
    kernel (the finest — and by far the highest-volume — level)."""

    def __init__(self, capacity: int = 131072, plan_steps: bool = True):
        self.capacity = int(capacity)
        self.plan_steps = bool(plan_steps)
        self.epoch = time.monotonic()
        self._buf: "deque[Event]" = deque(maxlen=self.capacity)
        self._local = threading.local()

    # -- recording (hot) ----------------------------------------------------
    @staticmethod
    def clock() -> float:
        return time.monotonic()

    def complete(self, name: str, cat: str, t0: float,
                 t1: Optional[float] = None,
                 trace_id: Optional[int] = None,
                 args: Optional[dict] = None) -> None:
        """Record a finished span [t0, t1] (t1 defaults to now)."""
        th = threading.current_thread()
        self._buf.append((name, cat, t0,
                          time.monotonic() if t1 is None else t1,
                          th.ident or 0, th.name, trace_id, args))

    def instant(self, name: str, cat: str = "",
                trace_id: Optional[int] = None,
                args: Optional[dict] = None) -> None:
        """Record a zero-duration event (state transitions: breaker
        trips, worker recycles, cache tier outcomes)."""
        th = threading.current_thread()
        self._buf.append((name, cat, time.monotonic(), None,
                          th.ident or 0, th.name, trace_id, args))

    def phase(self, name: str, t0: Optional[float] = None) -> Phase:
        """Start a :class:`Phase` of the batch this thread serves (at
        ``t0``, default now)."""
        return Phase(self, name, t0)

    def set_batch(self, batch_id: Optional[int]) -> None:
        """The batch this thread now serves (None: none): every phase it
        ends carries the id."""
        self._local.batch = batch_id

    @contextmanager
    def span(self, name: str, cat: str = "",
             trace_id: Optional[int] = None, **args):
        """Context-manager convenience for non-hot paths."""
        t0 = time.monotonic()
        try:
            yield self
        finally:
            self.complete(name, cat, t0, trace_id=trace_id,
                          args=args or None)

    # -- inspection ---------------------------------------------------------
    def events(self) -> List[Event]:
        return list(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    def clear(self) -> None:
        self._buf.clear()

    # -- export -------------------------------------------------------------
    def chrome_trace(self) -> dict:
        """The ring's contents as a Chrome trace-event JSON document:
        ``{"traceEvents": [...], "displayTimeUnit": "ms"}``.  Spans are
        complete (``"X"``) events with microsecond ``ts``/``dur``
        relative to the tracer's epoch; instants are ``"i"`` events;
        thread names ship as ``"M"`` metadata; and every trace id seen
        on two or more threads gets flow (``"s"``/``"t"``/``"f"``)
        arrows so Perfetto draws the request's hop from the submitting
        thread to the worker that served it."""
        pid = os.getpid()
        evs: List[dict] = []
        tid_names: Dict[int, str] = {}
        by_id: Dict[int, List[dict]] = {}
        for name, cat, t0, t1, tid, tname, trace_id, args in self._buf:
            tid_names[tid] = tname
            if cat.startswith("async:") and t1 is not None:
                # cross-thread interval (e.g. queue wait: starts on the
                # submitting thread, ends on the worker): an async
                # begin/end pair keyed by trace id — these render in
                # their own track and never distort thread nesting
                base = {"name": name, "cat": cat[6:], "pid": pid,
                        "tid": tid, "id": trace_id or 0}
                b = dict(base, ph="b",
                         ts=round((t0 - self.epoch) * 1e6, 3))
                if args:
                    b["args"] = dict(args)
                evs.append(b)
                evs.append(dict(base, ph="e",
                                ts=round((t1 - self.epoch) * 1e6, 3)))
                continue
            d: dict = {"name": name, "cat": cat or "repro", "pid": pid,
                       "tid": tid,
                       "ts": round((t0 - self.epoch) * 1e6, 3)}
            if t1 is None:
                d["ph"] = "i"
                d["s"] = "t"
            else:
                d["ph"] = "X"
                d["dur"] = round(max(0.0, t1 - t0) * 1e6, 3)
            a = dict(args) if args else {}
            if trace_id is not None:
                a["trace_id"] = trace_id
                if d["ph"] == "X":
                    by_id.setdefault(trace_id, []).append(d)
            if a:
                d["args"] = a
            evs.append(d)
        flows: List[dict] = []
        for trace_id, seq in by_id.items():
            if len(seq) < 2 or len({d["tid"] for d in seq}) < 2:
                continue
            seq.sort(key=lambda d: d["ts"])
            last = len(seq) - 1
            for i, d in enumerate(seq):
                f = {"name": "request", "cat": "flow", "id": trace_id,
                     "pid": pid, "tid": d["tid"],
                     # nudge inside the span so the arrow binds to it
                     "ts": round(d["ts"] + 0.001, 3),
                     "ph": "s" if i == 0 else ("f" if i == last else "t")}
                if f["ph"] == "f":
                    f["bp"] = "e"
                flows.append(f)
        meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": tname}}
                for tid, tname in sorted(tid_names.items())]
        return {"traceEvents": meta + evs + flows,
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write :meth:`chrome_trace` to ``path`` (open the file in
        ui.perfetto.dev or chrome://tracing)."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


# --------------------------------------------------------------------------
# Module-level switchboard (what the instrumented code consults)
# --------------------------------------------------------------------------

_LOCK = threading.Lock()
_TRACER: Optional[Tracer] = None


def enable(capacity: int = 131072, plan_steps: bool = True) -> Tracer:
    """Arm a fresh global tracer (replacing any armed one) and return
    it.  ``plan_steps=False`` keeps serving/compile spans but skips the
    per-kernel level (the highest-volume events)."""
    global _TRACER
    with _LOCK:
        _TRACER = Tracer(capacity=capacity, plan_steps=plan_steps)
        return _TRACER


def disable() -> Optional[Tracer]:
    """Disarm tracing; returns the tracer (with its recorded spans) so
    callers can still export after disabling."""
    global _TRACER
    with _LOCK:
        t, _TRACER = _TRACER, None
        return t


def active() -> Optional[Tracer]:
    """The armed tracer, or None — the one-load guard every
    instrumentation point uses."""
    return _TRACER


@contextmanager
def maybe_span(name: str, cat: str = "",
               trace_id: Optional[int] = None, **args):
    """Span when tracing is armed, no-op otherwise (cool paths only —
    hot loops should hoist an ``active()`` check instead)."""
    t = _TRACER
    if t is None:
        yield None
        return
    t0 = time.monotonic()
    try:
        yield t
    finally:
        t.complete(name, cat, t0, trace_id=trace_id, args=args or None)


def instant(name: str, cat: str = "", trace_id: Optional[int] = None,
            args: Optional[dict] = None) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, cat, trace_id=trace_id, args=args)


@contextmanager
def session(capacity: int = 131072, plan_steps: bool = True):
    """``with trace.session() as t: ...`` — arm, run, disarm."""
    t = enable(capacity=capacity, plan_steps=plan_steps)
    try:
        yield t
    finally:
        with _LOCK:
            global _TRACER
            if _TRACER is t:
                _TRACER = None


# --------------------------------------------------------------------------
# Cross-process merge (worker-process tracers -> one document)
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# Progress: long host work (a plan's lowering, its steps) reports that it
# moves to whoever listens on its thread: a serving worker's heartbeat
# --------------------------------------------------------------------------

_PROGRESS = threading.local()


def progress_listener():
    """The callable listening for this thread's progress, or None."""
    return getattr(_PROGRESS, "fn", None)


def progress() -> None:
    """Report progress on this thread (a no-op with no listener)."""
    fn = getattr(_PROGRESS, "fn", None)
    if fn is not None:
        fn()


@contextmanager
def on_progress(fn):
    """Call `fn` for every progress report of this thread inside the
    context (nestable: the previous listener comes back)."""
    prev = getattr(_PROGRESS, "fn", None)
    _PROGRESS.fn = fn
    try:
        yield
    finally:
        _PROGRESS.fn = prev


def merge_chrome_traces(parent_doc: dict, parent_epoch: float,
                        children) -> dict:
    """Merge worker processes' trace documents into the parent's.

    ``children`` is an iterable of ``(child_epoch, child_doc)`` pairs
    (what the process pool's ``collect_child_traces``
    returns).  Each child's event timestamps are relative to its own
    tracer epoch; ``time.monotonic()`` is CLOCK_MONOTONIC — one
    system-wide clock shared by every process on the host — so rebasing
    by the epoch delta puts all events on the parent's timeline.  Each
    child keeps its own ``pid``, so per-(pid, tid) span nesting (what
    :func:`validate_chrome_trace` checks) is preserved."""
    evs = list(parent_doc.get("traceEvents", ()))
    for child_epoch, child_doc in children:
        shift_us = (float(child_epoch) - float(parent_epoch)) * 1e6
        for d in (child_doc or {}).get("traceEvents", ()):
            d = dict(d)
            if "ts" in d:
                d["ts"] = round(d["ts"] + shift_us, 3)
            evs.append(d)
    out = {k: v for k, v in parent_doc.items() if k != "traceEvents"}
    out.setdefault("displayTimeUnit", "ms")
    out["traceEvents"] = evs
    return out


# --------------------------------------------------------------------------
# Schema validation (tests, benches and CI all assert through this)
# --------------------------------------------------------------------------

def validate_chrome_trace(doc: dict) -> List[str]:
    """Structural validation of a Chrome trace-event document; returns
    a list of problems (empty = valid).  Checks the JSON object form,
    per-phase required keys, and — per thread — that complete spans
    nest properly (no partial overlap), which is what makes the
    Perfetto flame view meaningful."""
    problems: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document must be an object with a traceEvents array"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        return ["traceEvents must be an array"]
    spans_by_tid: Dict[Tuple[int, int], List[Tuple[float, float, str]]] = {}
    for i, d in enumerate(evs):
        if not isinstance(d, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = d.get("ph")
        if ph not in ("X", "i", "I", "M", "s", "t", "f", "b", "e"):
            problems.append(f"event {i}: unsupported ph {ph!r}")
            continue
        if ph == "M":
            continue
        for k in ("name", "pid", "tid", "ts"):
            if k not in d:
                problems.append(f"event {i} ({d.get('name')!r}): "
                                f"missing {k!r}")
        if ph == "X":
            if "dur" not in d or d["dur"] < 0:
                problems.append(f"event {i} ({d.get('name')!r}): "
                                f"X event needs dur >= 0")
            else:
                spans_by_tid.setdefault(
                    (d.get("pid", 0), d.get("tid", 0)), []).append(
                    (d["ts"], d["ts"] + d["dur"], d.get("name", "?")))
        if ph in ("s", "t", "f", "b", "e") and "id" not in d:
            problems.append(f"event {i}: flow/async event missing id")
    for (pid, tid), spans in spans_by_tid.items():
        # sort outermost-first; a proper nesting never partially
        # overlaps the enclosing span on its own thread
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: List[Tuple[float, float, str]] = []
        for t0, t1, name in spans:
            while stack and t0 >= stack[-1][1]:
                stack.pop()
            if stack and t1 > stack[-1][1] + 1e-6:
                problems.append(
                    f"tid {tid}: span {name!r} [{t0:.1f},{t1:.1f}] "
                    f"partially overlaps {stack[-1][2]!r} "
                    f"[{stack[-1][0]:.1f},{stack[-1][1]:.1f}]")
                continue
            stack.append((t0, t1, name))
    return problems
