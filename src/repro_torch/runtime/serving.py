"""Fault-tolerant serving runtime: deadlines, backpressure, worker pool.

Counterpart of ``repro/runtime/serving.py``, the robustness layer around
:class:`repro_torch.api.Session`:

* **typed request outcomes** — every submitted :class:`Ticket`
  terminates with a result or a typed error (:class:`Overloaded` with a
  retry-after hint when admission control sheds load,
  :class:`DeadlineExceeded` when a ticket expires before execution,
  :class:`FlushError` aggregating per-model batch failures).  Nothing
  is ever silently dropped.
* **:class:`ServerPool`** — N worker threads, each owning its *own*
  plan arena (``CompiledModel.plan_for(owner=worker)``) and, on CUDA,
  its own ``torch.cuda.Stream``, under which it runs every batch it
  claims.  Bounded per-model queues with a deadline-driven auto-flush:
  a batch dispatches when it fills, when its oldest entry has lingered
  ``linger_ms``, or when its earliest deadline minus the model's recent
  batch time and the pool's own wake-up lateness (an idle worker's
  timed wait returning late) comes due; until the model has served
  MIN_EST_SAMPLES batches there is no batch time to lean on, and a
  ticket with a deadline dispatches at once.
* **fault detection + re-dispatch** — workers heartbeat a
  :class:`~repro_torch.runtime.fault.FaultMonitor`; a supervisor
  recycles workers whose beats stop (a hung kernel), re-dispatches their
  in-flight batch to a healthy worker and issues speculative backups for
  stragglers.  Tickets are idempotent — the first fulfillment wins.
  While a worker runs a batch it beats from the batch's own progress
  (``obs.trace.progress``: each plan step, each op of a lowering), at
  most every quarter of the heartbeat timeout: a batch slower than the
  timeout is not taken for a hung one as long as it moves, and a kernel
  that hangs stops the beats.  A beat is allowed the pool's own
  measured wake-up lateness past the timeout, the host's scheduling
  delay.  A pool on CUDA builds the kernels before its first worker
  starts (``_build.build_all``), so no batch waits for nvcc.
* **:class:`CircuitBreaker`** + :class:`LatencyHistogram` — the
  per-model trip/half-open/recover state machine and the p50/p99
  surface ``Session.stats()`` reports.

Fault injection for all of the above lives in
:mod:`repro_torch.runtime.chaos`.  The process pool
(:class:`repro_torch.runtime.procpool.ProcPool`) subclasses
:class:`ServerPool` through its hooks (``_worker_ready``,
``_idle_beat``, ``_extra_dead_locked``, ``_on_recycle_locked``,
``_on_close``, ``_worker_stream``) and re-dispatches a batch whose worker
process died (:class:`WorkerCrashed`, :meth:`ServerPool.redispatch`).
"""
from __future__ import annotations

import contextlib
import heapq
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..obs import trace as _trace
from ..obs.metrics import LogHistogram, MetricsRegistry
from .fault import BackupDispatcher, FaultMonitor
from . import chaos as _chaos


# --------------------------------------------------------------------------
# Typed errors
# --------------------------------------------------------------------------


class ServingError(RuntimeError):
    """Base class of the serving runtime's typed request errors."""


class Overloaded(ServingError):
    """Admission control shed this request: the model's bounded queue
    is full.  ``retry_after_ms`` estimates when capacity frees up."""

    def __init__(self, model: str, depth: int, retry_after_ms: float):
        self.model = model
        self.queue_depth = depth
        self.retry_after_ms = float(retry_after_ms)
        super().__init__(
            f"{model}: queue full ({depth} queued) — retry in "
            f"~{self.retry_after_ms:.0f} ms")


class BreakerOpen(ServingError):
    """The model's circuit breaker is open on a CUDA session: its batch
    failed fast instead of running.  There is no host rung on the card
    (the reference's interpretive engine serves only ``device="cpu"``
    sessions); ``retry_after_ms`` is the time left until the breaker's
    recovery probe may close it."""

    def __init__(self, model: str, retry_after_ms: float):
        self.model = model
        self.retry_after_ms = float(retry_after_ms)
        super().__init__(
            f"{model}: circuit breaker open — retry in "
            f"~{self.retry_after_ms:.0f} ms")


class DeadlineExceeded(ServingError):
    """The ticket's deadline passed before its batch executed; the
    stale work was dropped instead of run."""

    def __init__(self, model: str, late_ms: float = 0.0):
        self.model = model
        self.late_ms = float(late_ms)
        super().__init__(f"{model}: deadline exceeded "
                         f"({self.late_ms:.1f} ms late)")


class WorkerLost(ServingError):
    """The session shut down (or a worker died unrecoverably) with this
    request still queued — the terminal error of a drained ticket."""


class Cancelled(ServingError):
    """The caller cancelled this ticket (:meth:`Ticket.cancel`) before
    it produced a result.  Settlement is first-wins: a cancel that
    races the real result loses cleanly (``cancel()`` returns False and
    ``result()`` returns the value)."""

    def __init__(self, model: str):
        self.model = model
        super().__init__(f"{model}: request cancelled")


class WorkerCrashed(ServingError):
    """A worker *process* died (SIGKILL/SIGSEGV/OOM, or a CUDA context
    poisoned by a sticky device fault) with this batch in flight.  Never
    a terminal ticket error: the executor catches it and re-dispatches
    the batch to a surviving worker (first-fulfillment-wins tickets
    settle any duplicated work)."""

    def __init__(self, worker: int, detail: str = ""):
        self.worker = int(worker)
        super().__init__(f"worker {worker} crashed"
                         + (f": {detail}" if detail else ""))


class FrameCorrupt(ServingError):
    """A process-pool pipe frame failed its CRC32 integrity check.
    Message boundaries survive corruption (the pipe transport is
    length-prefixed), so this is a *payload* fault, not a protocol
    desync: only the one batch the frame carried fails, and the
    executor re-dispatches it to a healthy worker instead of recycling
    the stream (the process pool's ``ProtocolError`` is the
    desync case).  ``header`` holds the frame's parsed header when the
    corruption spared it (how the reader attributes the fault to its
    pending request)."""

    def __init__(self, worker: int = -1, detail: str = "",
                 header: Optional[dict] = None):
        self.worker = int(worker)
        self.header = header
        super().__init__(f"worker {worker}: corrupt frame"
                         + (f": {detail}" if detail else ""))


class FlushError(ServingError):
    """One or more models' batches failed during a drain.  Every other
    model's requests were still executed; ``errors`` maps each failed
    model to its (typed) batch error."""

    def __init__(self, errors: Dict[str, BaseException]):
        self.errors = dict(errors)
        super().__init__("; ".join(
            f"{n}: {type(e).__name__}: {e}" for n, e in errors.items()))


# --------------------------------------------------------------------------
# Ticket
# --------------------------------------------------------------------------


class Ticket:
    """Handle for one queued request.

    Terminates exactly once — with a value or a typed error — no matter
    how many workers race to complete it (re-dispatched and speculative
    backup executions settle by first-fulfillment-wins).  ``result()``
    blocks on the worker pool (pooled sessions) or drains *only this
    model's* queue (synchronous sessions) — a slow unrelated model never
    blocks an independent ticket."""

    __slots__ = ("name", "deadline", "submitted_at", "trace_id",
                 "_session", "_event", "_lock", "_done", "_value",
                 "_error", "_cbs")

    def __init__(self, session, name: str,
                 deadline: Optional[float] = None):
        self._session = session
        self.name = name
        self.deadline = deadline          # chaos-clock absolute seconds
        self.submitted_at = time.monotonic()
        self.trace_id = _trace.new_trace_id()
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._done = False
        self._value = None
        self._error: Optional[BaseException] = None
        self._cbs: List[Callable] = []

    def _settle_locked(self) -> List[Callable]:
        self._done = True
        cbs, self._cbs = self._cbs, []
        return cbs

    def _fulfill(self, value) -> bool:
        with self._lock:
            if self._done:
                return False
            self._value = value
            cbs = self._settle_locked()
        self._event.set()
        for fn in cbs:
            fn(self)
        return True

    def _fail(self, error: BaseException) -> bool:
        with self._lock:
            if self._done:
                return False
            self._error = error
            cbs = self._settle_locked()
        self._event.set()
        for fn in cbs:
            fn(self)
        return True

    def on_done(self, fn: Callable[["Ticket"], None]) -> None:
        """Register ``fn(ticket)`` to run once when the ticket settles
        (immediately if it already has).  Callbacks run on whichever
        thread settles the ticket — possibly a pool worker holding the
        pool lock — so they must not block or call back into the
        settling pool (the fleet router obeys this by only recording
        state and waking its own thread)."""
        with self._lock:
            if not self._done:
                self._cbs.append(fn)
                return
        fn(self)

    def cancel(self) -> bool:
        """Cancel the request.  A ticket still queued is dropped before
        dispatch (its EDF heap slot freed); one already in flight
        settles :class:`Cancelled` unless the real result wins the race
        first.  Returns True when the cancellation settled the ticket,
        False when it had already settled (its result/error stands)."""
        sess = self._session
        if sess is not None and hasattr(sess, "_cancel"):
            return sess._cancel(self)
        return self._fail(Cancelled(self.name))

    @property
    def done(self) -> bool:
        return self._done

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    def result(self, timeout: Optional[float] = None):
        if not self._done:
            self._session._resolve(self, timeout)
        if not self._done:
            raise TimeoutError(
                f"{self.name}: ticket unresolved after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value


# --------------------------------------------------------------------------
# Latency histogram (p50/p99 without storing samples)
# --------------------------------------------------------------------------

#: the log-spaced histogram moved to :class:`repro_torch.obs.metrics.
#: LogHistogram` (same O(1) record / ~5% quantile resolution, now also
#: the registry's summary-rendering child type); this alias keeps the
#: serving-era name importable.
LatencyHistogram = LogHistogram


# --------------------------------------------------------------------------
# Circuit breaker (per model)
# --------------------------------------------------------------------------


class CircuitBreaker:
    """K-consecutive-failure breaker with half-open recovery.

    ``closed`` — plan path; ``open`` — degraded to the interpretive
    oracle engine (slow but correct) on a CPU session, failed fast with
    ``BreakerOpen`` on a CUDA one, until ``cooldown_s`` elapses;
    ``half_open`` — a re-lower probe is in flight; its outcome closes
    or re-opens the breaker."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 2.0,
                 name: str = ""):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.name = name                  # trace attribution only
        self.state = "closed"
        self.failures = 0                 # consecutive
        self.trips = 0
        self.recoveries = 0
        self.opened_at = 0.0
        self._lock = threading.Lock()

    def allow_plan(self) -> bool:
        with self._lock:
            return self.state == "closed"

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            if self.state == "half_open":
                self.state = "closed"
                self.recoveries += 1

    def record_failure(self, now: Optional[float] = None) -> bool:
        """Returns True when this failure trips the breaker open."""
        now = _chaos.now() if now is None else now
        with self._lock:
            self.failures += 1
            if self.state == "closed" and self.failures >= self.threshold:
                self.state = "open"
                self.opened_at = now
                self.trips += 1
                _trace.instant("breaker_open", "fault",
                               args={"model": self.name,
                                     "failures": self.failures})
                return True
            return False

    def try_probe(self, now: Optional[float] = None) -> bool:
        """Claim the half-open recovery probe once the cooldown has
        elapsed (only one caller wins per cooldown window)."""
        now = _chaos.now() if now is None else now
        with self._lock:
            if self.state == "open" and \
                    now - self.opened_at >= self.cooldown_s:
                self.state = "half_open"
                _trace.instant("breaker_half_open", "fault",
                               args={"model": self.name})
                return True
            return False

    def probe_failed(self, now: Optional[float] = None) -> None:
        now = _chaos.now() if now is None else now
        with self._lock:
            self.state = "open"
            self.opened_at = now

    def probe_succeeded(self) -> None:
        with self._lock:
            self.state = "closed"
            self.failures = 0
            self.recoveries += 1
        _trace.instant("breaker_closed", "fault",
                       args={"model": self.name})

    def retry_after_ms(self, now: Optional[float] = None) -> float:
        """Milliseconds left of the open breaker's cooldown (at least
        one: the probe still has to run)."""
        now = _chaos.now() if now is None else now
        with self._lock:
            left = self.opened_at + self.cooldown_s - now
        return max(1.0, left * 1e3)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"state": self.state, "failures": self.failures,
                    "trips": self.trips, "recoveries": self.recoveries,
                    "threshold": self.threshold}


# --------------------------------------------------------------------------
# Worker pool
# --------------------------------------------------------------------------


class _InFlight:
    __slots__ = ("name", "entries", "started", "seq", "backed_up")

    def __init__(self, name, entries, started, seq):
        self.name = name
        self.entries = entries
        self.started = started
        self.seq = seq
        self.backed_up = False


class _Worker:
    __slots__ = ("wid", "thread", "abandoned", "batches", "requests",
                 "started_at", "seq", "stream")

    def __init__(self, wid: int):
        self.wid = wid
        self.thread: Optional[threading.Thread] = None
        #: the raw handle of the worker's CUDA stream (None on the CPU)
        self.stream: Optional[int] = None
        self.abandoned = False
        self.batches = 0
        self.requests = 0
        self.started_at = time.monotonic()
        self.seq = 0


class ServerPool:
    """N serving workers over bounded per-model queues.

    ``execute(name, entries, worker_id)`` is the session's robust batch
    executor: it must fulfill or fail every ticket in ``entries`` and
    never raise (the pool still backstops it).  The pool owns admission
    control, SLO-aware dispatch, heartbeat-based failure detection,
    in-flight re-dispatch and worker recycling.

    **Dispatch policy** (SLO-aware, not FIFO): within a model, queued
    entries drain earliest-deadline-first (deadline-less entries rank
    last, in submission order); across models, a due batch from a
    higher ``set_priority()`` class always dispatches before a
    lower one.  Shedding prefers low-priority / least-urgent work: a
    full queue evicts its *latest*-deadline entry for an
    earlier-deadline arrival, and a full pool (``max_queue_total``)
    evicts from the lowest-priority backlogged model before shedding a
    higher-priority arrival."""

    #: dispatch estimate before a model has served enough batches for a
    #: meaningful p99 (and the admission-control retry-hint fallback)
    DEFAULT_EST_MS = 5.0
    #: batches a model must have served before its histogram is trusted
    MIN_EST_SAMPLES = 4
    #: the least wake-up slack (ms) a deadline reserves and a heartbeat is
    #: allowed: an idle worker's timed wait returns late on a loaded
    #: machine, by more than a fast model's batch time
    WAKE_FLOOR_MS = 20.0
    #: recompute the memoized p99 after this many new samples
    EST_REFRESH = 16
    #: recycles kept in ``recycle_log``
    RECYCLE_LOG = 64
    #: worker fault domain ("thread" here; "process" in
    #: :class:`repro_torch.runtime.procpool.ProcPool`)
    mode = "thread"

    def __init__(self, execute: Callable, *, workers: int = 2,
                 max_batch: int = 8, max_queue: int = 64,
                 max_queue_total: Optional[int] = None,
                 linger_ms: float = 2.0,
                 heartbeat_timeout_s: float = 0.5,
                 straggler_backup_after_s: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None,
                 device=None):
        self._execute = execute
        #: the device the workers' batches run on: each worker makes one
        #: CUDA stream there; None or the CPU means no stream
        self.device = None if device is None else torch.device(device)
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.max_queue_total = (None if max_queue_total is None
                                else int(max_queue_total))
        self.linger_s = float(linger_ms) / 1e3
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.backup_after_s = (straggler_backup_after_s
                               if straggler_backup_after_s is not None
                               else 4 * self.heartbeat_timeout_s)
        self.monitor = FaultMonitor(n_hosts=0,
                                    timeout_s=heartbeat_timeout_s)
        self.dispatcher = BackupDispatcher(self.monitor)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        #: per-model batch service time — the deadline-driven auto-flush
        #: reserves this model's *p99* before each ticket's deadline
        #: (tail-safe, unlike the EWMA it replaced: one slow outlier
        #: batch no longer decays out of the estimate while stragglers
        #: are still possible)
        self._batch_ms = self.registry.histogram(
            "repro_pool_batch_ms",
            "batch service time per model (pool workers)", ("model",))
        #: name -> (hist count at compute time, p99) memo — _claim_locked
        #: runs under the pool lock on every worker wake, so the bucket
        #: scan is amortized over EST_REFRESH new samples (key None: the
        #: wake-up slack's)
        self._est_memo: Dict[Optional[str], Tuple[int, float]] = {}
        #: how far past the due time an idle worker's wait was timed to
        #: (linger or deadline) it wakes and claims: the host's scheduling
        #: delay, which a deadline reserves on top of the batch time and a
        #: heartbeat is allowed (``_wake_slack_ms``)
        self._wake_late_ms = self.registry.histogram(
            "repro_pool_wake_late_ms",
            "an idle worker's claim time past the due time its wait was "
            "timed to")

        self._cv = threading.Condition()
        #: name -> EDF min-heap of (deadline_key, seq, feed, ticket, enq)
        self._queues: Dict[str, List[tuple]] = {}
        self.priorities: Dict[str, int] = {}
        self._inflight: Dict[int, _InFlight] = {}
        self._workers: Dict[int, _Worker] = {}
        self._running = True
        self._next_wid = workers
        self._seq = 0
        self._enq_seq = 0        # submission order within a deadline class
        self._requeue_seq = 0    # negative: re-dispatched work goes first
        #: the last RECYCLE_LOG recycles: the worker, its replacement and
        #: what it was doing (the in-flight batch's model, size and age,
        #: the age of its last beat)
        self.recycle_log: List[Dict[str, object]] = []
        self.counters = {"dispatched_batches": 0, "dispatched_requests": 0,
                         "shed": 0, "deadline_misses": 0,
                         "priority_evictions": 0,
                         "redispatched_batches": 0, "recycled_workers": 0,
                         "speculative_backups": 0}
        self.deadline_misses: Dict[str, int] = {}
        self.shed: Dict[str, int] = {}

        if self.device is not None and self.device.type == "cuda" \
                and workers:
            from repro_torch.kernels import _build
            _build.build_all()
        for wid in range(workers):
            self._spawn_locked(wid)
        self._supervisor = threading.Thread(
            target=self._supervise, name="npu-pool-supervisor", daemon=True)
        self._supervisor.start()

    def set_priority(self, name: str, priority: int) -> None:
        """Assign the model's dispatch priority class (default 0;
        higher dispatches first and is preferred when shedding)."""
        with self._cv:
            self.priorities[name] = int(priority)

    # -- dispatch estimate (p99 of served batches) --------------------------
    def _dispatch_est_ms(self, name: str, p: float = 99.0) -> float:
        """How long a batch of ``name`` is expected to take, from the
        *p99* of its served-batch histogram — the reservation the
        deadline-driven auto-flush subtracts from a ticket's deadline.
        Memoized by sample count (the claim loop calls this constantly
        under the pool lock)."""
        return self._percentile_memo(name, self._batch_ms.labels(model=name),
                                     p, self.DEFAULT_EST_MS)

    def _wake_slack_ms(self) -> float:
        """The host's scheduling delay that a deadline reserves and a
        heartbeat is allowed: the p99 of ``repro_pool_wake_late_ms``,
        never less than ``WAKE_FLOOR_MS``; memoized as the batch time."""
        return max(self.WAKE_FLOOR_MS, self._percentile_memo(
            None, self._wake_late_ms.labels(), 99.0, self.WAKE_FLOOR_MS))

    def _percentile_memo(self, key: Optional[str], h, p: float,
                         default: float) -> float:
        """Percentile `p` of histogram `h` once it has MIN_EST_SAMPLES
        samples (else `default`), recomputed after EST_REFRESH new
        ones."""
        count = h.count
        if count < self.MIN_EST_SAMPLES:
            return default
        memo = self._est_memo.get(key)
        if memo is not None and count - memo[0] < self.EST_REFRESH:
            return memo[1]
        est = h.percentile(p)
        self._est_memo[key] = (count, est)
        return est

    # -- admission ----------------------------------------------------------
    @staticmethod
    def _dl_key(ticket: Ticket) -> float:
        return ticket.deadline if ticket.deadline is not None else math.inf

    def _push_locked(self, name: str, feed, ticket: Ticket,
                     requeue: bool = False) -> None:
        q = self._queues.setdefault(name, [])
        if requeue:
            # re-dispatched work is the pool's oldest: negative seq ranks
            # it ahead of every queued entry in the same deadline class
            self._requeue_seq -= 1
            seq = self._requeue_seq
        else:
            self._enq_seq += 1
            seq = self._enq_seq
        heapq.heappush(q, (self._dl_key(ticket), seq, feed, ticket,
                           _chaos.now()))

    def _requeue_locked(self, name: str, entries) -> int:
        """Push a failed/straggling batch's still-live entries back for
        another worker (first-fulfillment-wins settles duplicates)."""
        live = 0
        for feed, ticket in entries:
            if ticket.done:
                continue
            self._push_locked(name, feed, ticket, requeue=True)
            live += 1
        if live:
            self._cv.notify_all()
        return live

    def _evict_locked(self, name: str) -> bool:
        """Evict the least-urgent (latest-deadline, newest) entry of the
        model's queue to admit more urgent work; False if empty."""
        q = self._queues.get(name)
        if not q:
            return False
        victim = max(q, key=lambda e: (e[0], e[1]))
        q.remove(victim)
        heapq.heapify(q)
        _, _, _, ticket, _ = victim
        self.counters["shed"] += 1
        self.counters["priority_evictions"] += 1
        self.shed[name] = self.shed.get(name, 0) + 1
        _trace.instant("priority_eviction", "serving",
                       trace_id=ticket.trace_id,
                       args={"model": name, "depth": len(q)})
        ticket._fail(Overloaded(name, len(q), self._retry_hint(name)))
        return True

    def _retry_hint(self, name: str) -> float:
        # retry hint from the typical (p50) batch time — the tail
        # estimate would over-back-off healthy clients
        q = self._queues.get(name, ())
        h = self._batch_ms.labels(model=name)
        est = h.percentile(50) \
            if h.count >= self.MIN_EST_SAMPLES else 10.0
        return max(1.0, est * (len(q) / max(1, self.max_batch)))

    def submit(self, name: str, feed, ticket: Ticket) -> None:
        with self._cv:
            if not self._running:
                raise ServingError("pool is closed")
            prio = self.priorities.get(name, 0)
            q = self._queues.setdefault(name, [])
            if self.max_queue_total is not None and \
                    sum(len(x) for x in self._queues.values()) >= \
                    self.max_queue_total and len(q) < self.max_queue:
                # pool-wide saturation: prefer shedding a lower-priority
                # model's least-urgent entry over this arrival
                victims = sorted(
                    (n for n, x in self._queues.items()
                     if x and self.priorities.get(n, 0) < prio),
                    key=lambda n: self.priorities.get(n, 0))
                if not (victims and self._evict_locked(victims[0])):
                    self._shed_locked(name, ticket, len(q))
            if len(q) >= self.max_queue:
                # model queue full: an earlier-deadline arrival evicts
                # the queue's latest-deadline entry; anything else sheds
                worst = max(q, key=lambda e: (e[0], e[1]))
                if not (self._dl_key(ticket) < worst[0]
                        and self._evict_locked(name)):
                    self._shed_locked(name, ticket, len(q))
            self._push_locked(name, feed, ticket)
            # every waiter: each idle worker recomputes its next due time
            # (one notify could wake a drain() waiter and leave the
            # workers asleep past a deadline this entry brought forward)
            self._cv.notify_all()

    def _shed_locked(self, name: str, ticket: Ticket, depth: int):
        self.counters["shed"] += 1
        self.shed[name] = self.shed.get(name, 0) + 1
        _trace.instant("shed", "serving", trace_id=ticket.trace_id,
                       args={"model": name, "depth": depth})
        raise Overloaded(name, depth, self._retry_hint(name))

    def queue_depth(self, name: Optional[str] = None) -> int:
        with self._cv:
            if name is not None:
                return len(self._queues.get(name, ()))
            return sum(len(q) for q in self._queues.values())

    def discard(self, name: str, ticket: Ticket) -> int:
        """Drop a (cancelled) ticket's queued entries, freeing their
        EDF heap slots immediately — a cancelled ticket must not hold
        queue capacity until a worker pops past it.  Entries already
        claimed by a worker are left to settle first-wins."""
        with self._cv:
            q = self._queues.get(name)
            if not q:
                return 0
            keep = [e for e in q if e[3] is not ticket]
            removed = len(q) - len(keep)
            if removed:
                q[:] = keep
                heapq.heapify(q)
        return removed

    # -- dispatch (deadline-driven auto-flush) ------------------------------
    def _miss_locked(self, name: str, ticket: Ticket, now: float) -> None:
        self.counters["deadline_misses"] += 1
        self.deadline_misses[name] = self.deadline_misses.get(name, 0) + 1
        _trace.instant("deadline_miss", "serving",
                       trace_id=ticket.trace_id,
                       args={"model": name,
                             "late_ms": (now - ticket.deadline) * 1e3})
        ticket._fail(DeadlineExceeded(
            name, late_ms=(now - ticket.deadline) * 1e3))

    def _claim_locked(self, now: float
                      ) -> Tuple[Optional[Tuple[str, List]], float]:
        """Pick the most urgent dispatchable model batch, or the time
        until one becomes due.  A batch is due when it is full, when its
        oldest entry has lingered ``linger_ms``, or when its earliest
        deadline minus the model's recent batch time and the host's
        wake-up slack (``_wake_slack_ms``) arrives.  Among due models
        the highest priority class wins, breaking ties by urgency;
        entries pop in EDF order."""
        best, next_due = None, math.inf
        for name, q in self._queues.items():
            if not q:
                continue
            # q[0] is the EDF head (earliest deadline); linger is keyed
            # to the *oldest* entry so deadline-less work still flushes
            due = min(e[4] for e in q) + self.linger_s
            head_dl = q[0][0]
            if math.isfinite(head_dl):
                if self._batch_ms.labels(model=name).count \
                        < self.MIN_EST_SAMPLES:
                    due = now      # no batch time known: dispatch at once
                else:
                    due = min(due, head_dl
                              - (self._dispatch_est_ms(name)
                                 + self._wake_slack_ms()) / 1e3)
            if len(q) >= self.max_batch:
                due = now
            if due <= now:
                cand = (-self.priorities.get(name, 0), due, name)
                if best is None or cand < best:
                    best = cand
            else:
                next_due = min(next_due, due)
        if best is None:
            return None, next_due
        best_name = best[2]
        q = self._queues[best_name]
        entries = []
        while q and len(entries) < self.max_batch:
            _, _, feed, ticket, _ = heapq.heappop(q)
            if ticket.done:
                continue           # settled elsewhere (requeue duplicate)
            if ticket.deadline is not None and now > ticket.deadline:
                self._miss_locked(best_name, ticket, now)
                continue
            entries.append((feed, ticket))
        if not entries:                    # the whole head was expired
            return None, 0.0
        return (best_name, entries), 0.0

    # -- workers ------------------------------------------------------------
    def _spawn_locked(self, wid: int) -> None:
        w = _Worker(wid)
        w.thread = threading.Thread(target=self._worker_loop, args=(wid,),
                                    name=f"npu-worker-{wid}", daemon=True)
        self._workers[wid] = w
        self.monitor.register(wid)         # explicit: clears tombstones
        w.thread.start()

    def _worker_ready(self, wid: int) -> bool:
        """Whether this worker may claim work (process pools gate on
        the child process having finished loading its models)."""
        return True

    def _idle_beat(self, wid: int, seq: int) -> None:
        """Heartbeat for an idle worker.  Thread pools beat from the
        dispatcher thread itself; process pools leave this to the child
        process's heartbeat frames, so a hung child goes stale even
        while its parent-side dispatcher is healthy."""
        self.monitor.beat(wid, seq)

    def _worker_stream(self, wid: int):
        """A context that runs the worker's batches on a CUDA stream of
        its own (made here, on the worker's thread), or a no-op on the
        CPU."""
        if self.device is None or self.device.type != "cuda":
            return contextlib.nullcontext()
        stream = torch.cuda.Stream(device=self.device)
        with self._cv:
            w = self._workers.get(wid)
            if w is not None:
                w.stream = stream.cuda_stream
        return torch.cuda.stream(stream)

    def _worker_loop(self, wid: int) -> None:
        with self._worker_stream(wid):
            self._serve(wid)

    def _serve(self, wid: int) -> None:
        beat_every = max(0.01, self.heartbeat_timeout_s / 4)
        timed_to = math.inf     # the due time this idle worker waits for
        while True:
            with self._cv:
                w = self._workers.get(wid)
                if w is None or w.abandoned or not self._running:
                    return
                if not self._worker_ready(wid):
                    # still booting (process spawn/model load): beat so
                    # the supervisor doesn't recycle a healthy boot
                    self.monitor.beat(wid, w.seq)
                    self._cv.wait(beat_every)
                    continue
                now = _chaos.now()
                claim, next_due = self._claim_locked(now)
                if claim is None:
                    self._idle_beat(wid, w.seq)
                    wait = beat_every if next_due is math.inf else \
                        min(beat_every, max(0.0, next_due - now))
                    timed_to = next_due if next_due - now <= beat_every \
                        else math.inf
                    self._cv.wait(wait)
                    continue
                if now >= timed_to:     # woke late for the due batch
                    self._wake_late_ms.observe((now - timed_to) * 1e3)
                timed_to = math.inf
                name, entries = claim
                self._seq += 1
                w.seq = self._seq
                self._inflight[wid] = _InFlight(
                    name, entries, time.monotonic(), w.seq)
                self.counters["dispatched_batches"] += 1
                self.counters["dispatched_requests"] += len(entries)

            # ---- outside the lock: chaos stall = a hung kernel (no
            # heartbeats while stalled — that IS the failure signature)
            c = _chaos.active()
            if c is not None:
                stall = c.maybe_stall_s(wid)
                if stall:
                    time.sleep(stall)
            with self._cv:
                inf = self._inflight.get(wid)
                if inf is None or inf.seq != w.seq:
                    # supervisor re-dispatched this batch while we hung —
                    # drop the duplicate work (tickets settle first-wins)
                    continue
            self.monitor.beat(wid, w.seq)
            t0 = time.monotonic()
            try:
                with _trace.on_progress(self._progress_beat(wid, w.seq)):
                    self._execute(name, entries, wid)
            except BaseException as e:     # backstop: executor must not
                for _, ticket in entries:  # raise, but never lose tickets
                    ticket._fail(e if isinstance(e, Exception)
                                 else ServingError(repr(e)))
            dt = time.monotonic() - t0
            self._batch_ms.observe(dt * 1e3, model=name)
            with self._cv:
                self._inflight.pop(wid, None)
                w.batches += 1
                w.requests += len(entries)
                self.monitor.beat(wid, w.seq, step_time_s=dt)
                self._cv.notify_all()

    def _progress_beat(self, wid: int, seq: int) -> Callable[[], None]:
        """The worker's beat for its batch's progress reports, at most
        every quarter of the heartbeat timeout."""
        every = self.heartbeat_timeout_s / 4
        last = [time.monotonic()]
        monitor = self.monitor

        def beat() -> None:
            now = time.monotonic()
            if now - last[0] >= every:
                last[0] = now
                monitor.beat(wid, seq)
        return beat

    # -- supervision: detect, re-dispatch, recycle --------------------------
    def _extra_dead_locked(self) -> List[int]:
        """Extra dead-worker ids beyond heartbeat staleness (process
        pools report child exitcodes here)."""
        return []

    def _supervise(self) -> None:
        interval = max(0.02, self.heartbeat_timeout_s / 4)
        while True:
            time.sleep(interval)
            with self._cv:
                if not self._running:
                    return
                # a beat the host's scheduling delayed has not stopped:
                # a worker is allowed the pool's wake-up slack past the
                # timeout (a progressing batch beats every step, whose
                # beat the same delay makes late)
                slack_s = self._wake_slack_ms() / 1e3
                dead = {wid for wid in self.monitor.dead_hosts(
                            time.monotonic() - slack_s)
                        if wid in self._workers
                        and not self._workers[wid].abandoned}
                dead.update(wid for wid in self._extra_dead_locked()
                            if wid in self._workers
                            and not self._workers[wid].abandoned)
                for wid in sorted(dead):
                    self._recycle_locked(wid)
                # stragglers: speculative backup (first result wins)
                stragglers = set(self.monitor.stragglers())
                now = time.monotonic()
                for wid, inf in list(self._inflight.items()):
                    slow = now - inf.started > self.backup_after_s
                    if inf.backed_up or not slow or (
                            wid not in stragglers and
                            now - inf.started < 2 * self.backup_after_s):
                        continue
                    inf.backed_up = True
                    live = self._requeue_locked(inf.name, inf.entries)
                    self.dispatcher.backups_issued.append(
                        (inf.seq, wid, -1))
                    self.counters["speculative_backups"] += 1
                    _trace.instant("speculative_backup", "fault",
                                   args={"model": inf.name,
                                         "worker": wid,
                                         "live": live})
                    self._cv.notify_all()

    def _on_recycle_locked(self, wid: int) -> None:
        """Subclass hook: tear down the recycled worker's process/pipe
        resources (called under the pool lock, old worker abandoned)."""

    def _recycle_locked(self, wid: int) -> None:
        """A worker stopped heartbeating mid-batch (or its process
        died): re-dispatch its in-flight work to the healthy workers,
        abandon the thread (it drops its duplicate results if it ever
        wakes) and spawn a replacement."""
        w = self._workers[wid]
        w.abandoned = True
        inf = self._inflight.pop(wid, None)
        new_wid = self._next_wid
        self._next_wid += 1
        if inf is not None:
            self._requeue_locked(inf.name, inf.entries)
            self.counters["redispatched_batches"] += 1
            self.dispatcher.backups_issued.append((inf.seq, wid, new_wid))
        hb = self.monitor.beats.get(wid)
        now = time.monotonic()
        entry = {"worker": wid, "replacement": new_wid,
                 "redispatched": inf is not None,
                 "model": inf.name if inf is not None else None,
                 "n": len(inf.entries) if inf is not None else 0,
                 "batch_age_s": (now - inf.started) if inf is not None
                 else None,
                 "beat_age_s": (now - hb.last_beat) if hb else None}
        self.recycle_log = (self.recycle_log + [entry])[-self.RECYCLE_LOG:]
        self.monitor.retire(wid)
        self.counters["recycled_workers"] += 1
        _trace.instant("worker_recycled", "fault", args=entry)
        self._on_recycle_locked(wid)
        self._spawn_locked(new_wid)
        self._cv.notify_all()

    def redispatch(self, name: str, entries, wid: int) -> None:
        """A dispatched batch lost its worker (:class:`WorkerCrashed`):
        hand the still-live entries to the survivors — or, if the pool
        is shutting down, terminate them with a typed error."""
        with self._cv:
            if self._running:
                if self._requeue_locked(name, entries):
                    self.counters["redispatched_batches"] += 1
                    _trace.instant("crash_redispatch", "fault",
                                   args={"model": name, "worker": wid})
                return
        for _, ticket in entries:
            ticket._fail(WorkerLost(
                f"{name}: worker {wid} lost during shutdown"))

    # -- draining / shutdown ------------------------------------------------
    def drain(self, names=None, timeout: Optional[float] = None) -> bool:
        """Block until every queued/in-flight request (of ``names``, or
        all) has terminated.  Returns False on timeout."""
        def clear():
            for name, q in self._queues.items():
                if names is not None and name not in names:
                    continue
                if q:
                    return False
            for inf in self._inflight.values():
                if names is None or inf.name in names:
                    return False
            return True
        with self._cv:
            return self._cv.wait_for(clear, timeout)

    def _on_close(self) -> None:
        """Subclass hook: tear down worker processes (called after the
        pool stops, before the dispatcher threads are joined)."""

    def close(self, timeout: float = 5.0) -> None:
        with self._cv:
            self._running = False
            leftovers = []
            for name, q in self._queues.items():
                while q:
                    _, _, feed, ticket, _ = heapq.heappop(q)
                    leftovers.append((name, ticket))
            self._cv.notify_all()
        for name, ticket in leftovers:
            ticket._fail(WorkerLost(f"{name}: session closed with the "
                                    f"request still queued"))
        self._on_close()
        deadline = time.monotonic() + timeout
        for w in list(self._workers.values()):
            if w.thread is not None and not w.abandoned:
                w.thread.join(max(0.0, deadline - time.monotonic()))

    # -- health -------------------------------------------------------------
    def worker_health(self) -> Dict[int, Dict[str, object]]:
        with self._cv:
            now = time.monotonic()
            out = {}
            for wid, w in self._workers.items():
                hb = self.monitor.beats.get(wid)
                times = self.monitor.step_times.get(wid, [])
                out[wid] = {
                    "alive": bool(w.thread and w.thread.is_alive()),
                    "abandoned": w.abandoned,
                    "batches": w.batches,
                    "requests": w.requests,
                    "inflight": self._inflight.get(wid) is not None,
                    "stream": w.stream,
                    "last_beat_age_s": (now - hb.last_beat) if hb
                    else None,
                    "mean_batch_s": (sum(times[-16:]) / len(times[-16:]))
                    if times else None,
                }
            return out

    def stats(self) -> Dict[str, object]:
        with self._cv:
            return {
                "workers": len([w for w in self._workers.values()
                                if not w.abandoned]),
                "queued": {n: len(q) for n, q in self._queues.items()
                           if q},
                "dispatch_est_ms": {
                    n: round(self._dispatch_est_ms(n), 3)
                    for (n,), h in self._batch_ms.series().items()
                    if h.count},
                "batch_ms": {
                    n: h.snapshot()
                    for (n,), h in self._batch_ms.series().items()
                    if h.count},
                "backups_issued": len(self.dispatcher.backups_issued),
                **self.counters,
            }
