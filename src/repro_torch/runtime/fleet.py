"""Fleet-level serving: replicated pools, health-aware routing, hedged
requests, and a silent-corruption auditor.

Counterpart of ``repro/runtime/fleet.py``.  A :class:`Fleet` manages N
*replica* :class:`~repro_torch.api.session.Session` instances — each
with its own worker pool (thread- or process-mode), each modeling one
host — behind a single ``submit()`` surface.  The replicas serve on the
sessions' device (the card unless ``device="cpu"`` is passed on to
them); the auditor and the update canary re-execute requests on the
host interpreter (``engine="interp"``), the oracle the port keeps on
the host by design.

What the fleet layer adds on top of the single-pool runtime:

* **health-scored routing** — each replica in a model's placement set
  is scored from its queue depth, circuit-breaker state and recent p99
  (read straight from the session's ``repro_request_latency_ms``
  metrics family); requests route to the best-scoring replica.
  Placement is per-model (``add(..., replicas=k)``) and
  :meth:`rebalance` re-homes models (and their program-cache pins)
  onto the least-loaded replicas as traffic shifts.
* **request hedging** — when a request's only attempt is still
  unsettled after a p99-derived timeout, the router re-issues it to a
  second replica; the existing idempotent first-fulfillment-wins
  :class:`~repro_torch.runtime.serving.Ticket` settles whichever copy lands
  first (request-level speculative execution across pools — the
  roadmap item).
* **pool-level failover** — a replica whose pool dies (every worker
  lost; chaos ``kill_pool`` or a supervisor giving up) fails its
  queued attempts with ``WorkerLost``; the router catches each one and
  re-homes the request on a surviving replica under bounded
  exponential backoff + jitter.  Zero ticket loss: every fleet ticket
  still terminates with a result or a typed error.
* **rolling artifact updates** — :meth:`update` swaps one replica at a
  time (drain, swap, restore), gated by a *canary* that shadow-verifies
  the new artifact's plan outputs against the interpretive oracle
  before any replica swaps; a mismatch rejects the update with
  :class:`UpdateRejected` and no replica is touched.
* **silent-corruption auditor** — a configurable fraction of fulfilled
  responses is re-executed on the interpretive oracle in the
  background; a replica whose audit-mismatch count crosses the
  threshold is *quarantined* (routing stops immediately) and then
  recycled (session torn down and rebuilt).  This is the only defense
  against a replica that corrupts results without erroring.

Every routing / hedge / failover / audit / update decision emits a
trace instant (``fleet_*``) and counts into ``repro_fleet_*`` metrics
families on the fleet's own registry.

Construction goes through :meth:`repro_torch.api.Session.fleet`::

    fleet = Session.fleet(replicas=3, workers=2, audit_fraction=0.05)
    fleet.add("mobilenet_v2", precision="int8", replicas=2)
    t = fleet.submit("mobilenet_v2", image, deadline_ms=100)
    out = t.result()

Fault injection for all of the above lives in
:mod:`repro_torch.runtime.chaos` (``kill_pool`` / ``corrupt_output`` /
``corrupt_canary``).
"""
from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..obs import trace as _trace
from ..obs.metrics import MetricsRegistry
from . import chaos as _chaos
from .serving import (Cancelled, DeadlineExceeded, Overloaded,
                      ServingError, Ticket, WorkerLost)

#: request errors that are the caller's fault: terminal, never re-homed
_CLIENT_ERRORS = (ValueError, TypeError, KeyError)
#: errors that terminate the fleet ticket instead of re-dispatching
_TERMINAL = (DeadlineExceeded, Cancelled) + _CLIENT_ERRORS


def _f64(v) -> np.ndarray:
    """An output (a tensor on any device, or an array) as float64 numpy
    on the host."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float64)


class FleetError(ServingError):
    """Base class of fleet-level typed errors."""


class UpdateRejected(FleetError):
    """A rolling artifact update was rejected: the canary's
    shadow-verification of the new artifact against the interpretive
    oracle mismatched (or a replica swap failed).  When the canary
    rejects, *no* replica was swapped — the fleet keeps serving the
    old artifact."""


class Replica:
    """One replica: a Session (own worker pool) plus fleet-side state.

    ``state``: ``live`` (routable) / ``updating`` (draining for an
    artifact swap) / ``quarantined`` (audit caught it corrupting) /
    ``dead`` (pool lost; being recycled).  Only ``live`` replicas
    receive new work."""

    __slots__ = ("rid", "session", "state", "deaths", "quarantines",
                 "audit_mismatches", "served")

    def __init__(self, rid: int, session):
        self.rid = rid
        self.session = session
        self.state = "live"
        self.deaths = 0
        self.quarantines = 0
        self.audit_mismatches = 0
        self.served = 0


class _Request:
    """Router-side state of one fleet ticket: which replicas have been
    tried, how many attempts are live, hedge/backoff bookkeeping."""

    __slots__ = ("ticket", "name", "feed", "t0", "tried", "attempts",
                 "live", "hedged", "hedge_rid", "hedge_after_s",
                 "redispatches", "retry_at", "last_err")

    def __init__(self, ticket: Ticket, name: str, feed,
                 hedge_after_s: Optional[float]):
        self.ticket = ticket
        self.name = name
        self.feed = feed
        self.t0 = _chaos.now()
        self.tried: Set[int] = set()
        self.attempts: List[Tuple[int, Ticket]] = []
        self.live = 0
        self.hedged = False
        self.hedge_rid = -1
        self.hedge_after_s = hedge_after_s     # None = hedging disabled
        self.redispatches = 0
        self.retry_at: Optional[float] = None  # chaos-clock abs seconds
        self.last_err: Optional[BaseException] = None


class Fleet:
    """N replica Sessions behind one health-routed ``submit()``.

    The fleet absorbs backpressure instead of surfacing it: an
    ``Overloaded`` shed on one replica re-routes to another (bounded by
    ``max_redispatch`` backoff rounds), so ``submit()`` never raises
    ``Overloaded`` — a ticket whose re-dispatch budget exhausts fails
    with the last typed error instead.  Deadlines stay absolute across
    re-homes and hedges."""

    #: hedge timeout before a model has served enough requests for a
    #: meaningful p99
    DEFAULT_HEDGE_MS = 50.0
    #: samples required before the latency p99 drives the hedge timeout
    MIN_HEDGE_SAMPLES = 16
    #: breaker-state routing penalties (scored against ~queue-depth/
    #: max_batch units; an open breaker must lose to any healthy queue)
    _BREAKER_PENALTY = {"closed": 0.0, "half_open": 2.0, "open": 4.0}

    def __init__(self, replicas: int = 2, *,
                 session_factory=None,
                 workers: int = 2, mode: str = "thread",
                 max_batch: int = 8, max_queue: int = 64,
                 hedge: bool = True,
                 hedge_after_ms: Optional[float] = None,
                 hedge_floor_ms: float = 5.0,
                 hedge_cap_ms: float = 1000.0,
                 hedge_budget: float = 0.10,
                 audit_fraction: float = 0.0,
                 audit_threshold: int = 3,
                 audit_backlog: int = 64,
                 max_redispatch: int = 8,
                 backoff_base_ms: float = 2.0,
                 backoff_cap_ms: float = 100.0,
                 seed: int = 0,
                 **session_kw):
        if replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        if int(workers) < 1:
            raise ValueError("fleet replicas need worker pools "
                             "(workers >= 1)")
        if session_factory is None:
            from repro_torch.api.session import Session
            session_factory = Session
        self._factory = session_factory
        self._mode = mode
        self._workers = int(workers)
        self._max_batch = int(max_batch)
        self._max_queue = int(max_queue)
        self._session_kw = dict(session_kw)
        self.hedge = bool(hedge)
        self.hedge_after_ms = hedge_after_ms
        self.hedge_floor_ms = float(hedge_floor_ms)
        self.hedge_cap_ms = float(hedge_cap_ms)
        #: hedges are capped to this fraction of submitted requests —
        #: the tail-at-scale guardrail: a hedge timeout that lags a
        #: load shift (the p99 estimate is trailing) must not double
        #: the offered load and *create* the tail it exists to cut
        self.hedge_budget = float(hedge_budget)
        self.audit_fraction = float(audit_fraction)
        self.audit_threshold = int(audit_threshold)
        self.audit_backlog = int(audit_backlog)
        self.max_redispatch = int(max_redispatch)
        self.backoff_base_ms = float(backoff_base_ms)
        self.backoff_cap_ms = float(backoff_cap_ms)
        self._rng = random.Random(seed)

        #: the fleet's own metrics surface (replica sessions keep their
        #: own registries; this one aggregates fleet decisions)
        self.registry = MetricsRegistry()
        self._m_latency = self.registry.histogram(
            "repro_fleet_request_ms",
            "end-to-end fleet request latency (first-winning attempt)",
            ("model",))
        self.registry.register_collector(self._collect_metrics)
        self.counters = {
            "requests": 0, "completed": 0, "failed": 0,
            "hedges": 0, "hedge_wins": 0, "redispatches": 0,
            "pool_deaths": 0, "quarantines": 0, "recycles": 0,
            "audit_ok": 0, "audit_mismatch": 0, "audit_error": 0,
            "audit_dropped": 0, "updates_ok": 0,
            "updates_rolled_back": 0, "updates_failed": 0,
            "cancelled": 0, "deadline_misses": 0, "exhausted": 0,
        }

        #: the fleet lock.  Rule: never call into a replica's pool or
        #: session while holding it — attempt-ticket callbacks run
        #: under pool locks and re-enter here (pool lock -> fleet lock
        #: is the only permitted order)
        self._cv = threading.Condition()
        self._replicas: Dict[int, Replica] = {}
        self._placement: Dict[str, Set[int]] = {}
        self._specs: Dict[str, dict] = {}
        self._oracles: Dict[str, object] = {}
        self._requests: Dict[Ticket, _Request] = {}
        self._req_counts: Dict[str, int] = {}
        self._audit_q: deque = deque()
        self._running = True
        self.closed = False

        for rid in range(int(replicas)):
            self._replicas[rid] = Replica(rid, self._new_session(rid))

        self._router_t = threading.Thread(
            target=self._router, name="npu-fleet-router", daemon=True)
        self._router_t.start()
        self._audit_t = threading.Thread(
            target=self._auditor, name="npu-fleet-auditor", daemon=True)
        self._audit_t.start()

    # -- construction / registry -------------------------------------------
    def _new_session(self, rid: int):
        return self._factory(workers=(self._mode, self._workers),
                             max_batch=self._max_batch,
                             max_queue=self._max_queue,
                             tag=f"r{rid}", **self._session_kw)

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def replicas(self) -> Dict[int, str]:
        """rid -> state snapshot."""
        with self._cv:
            return {rid: rep.state
                    for rid, rep in sorted(self._replicas.items())}

    def _choose_rids(self, replicas) -> List[int]:
        with self._cv:
            live = sorted(rid for rid, rep in self._replicas.items())
            loads = {rid: sum(1 for p in self._placement.values()
                              if rid in p) for rid in live}
        if replicas is None:
            return live
        if isinstance(replicas, int):
            k = max(1, min(int(replicas), len(live)))
            return sorted(sorted(live, key=lambda r: (loads[r], r))[:k])
        rids = sorted(int(r) for r in replicas)
        bad = [r for r in rids if r not in loads]
        if bad:
            raise ValueError(f"unknown replica id(s) {bad}")
        return rids

    def _apply_spec(self, sess, spec: dict) -> None:
        if spec["kind"] == "load":
            sess.load(spec["path"], name=spec["name"],
                      pin=spec["pin"], priority=spec["priority"])
        else:
            sess.add(spec["source"], name=spec["name"],
                     precision=spec["precision"], options=spec["options"],
                     warmup=spec["warmup"], pin=spec["pin"],
                     priority=spec["priority"], **spec["kw"])

    def add(self, source, name: Optional[str] = None,
            replicas=None, precision: str = "auto", options=None,
            warmup: bool = False, pin: bool = False,
            priority: Optional[int] = None, **kw):
        """Compile and register one model on its replica set —
        ``replicas`` is ``None`` (all), a count (that many least-loaded
        replicas) or an explicit list of replica ids.  The compile is
        shared through the process-global program cache, so N replicas
        cost one solve.  Returns the :class:`CompiledModel` (also the
        fleet's audit/canary oracle reference)."""
        rids = self._choose_rids(replicas)
        with self._cv:
            sessions = [self._replicas[r].session for r in rids]
        model = sessions[0].add(source, name=name, precision=precision,
                                options=options, warmup=warmup, pin=pin,
                                priority=priority, **kw)
        name = name or model.name
        # replicas 2..N (and future recycles) register the already-
        # quantized bundle: PTQ ran once, and a Graph source must not be
        # re-quantized (calibration annotates the graph in place)
        if model.qm is not None:
            source, precision = model.qm, "auto"
        for sess in sessions[1:]:
            sess.add(source, name=name, precision=precision,
                     options=options, warmup=warmup, pin=pin,
                     priority=priority, **kw)
        with self._cv:
            self._specs[name] = dict(
                kind="add", source=source, name=name,
                precision=precision, options=options, warmup=warmup,
                pin=pin, priority=priority, kw=dict(kw))
            self._placement[name] = set(rids)
            self._oracles[name] = model
        return model

    def load(self, path: str, name: Optional[str] = None,
             replicas=None, pin: bool = False,
             priority: Optional[int] = None):
        """Register a model from an on-disk artifact on its replica set
        (replicas mmap the same artifact copy-on-write)."""
        rids = self._choose_rids(replicas)
        with self._cv:
            sessions = [self._replicas[r].session for r in rids]
        model = sessions[0].load(path, name=name, pin=pin,
                                 priority=priority)
        name = name or model.name
        for sess in sessions[1:]:
            sess.load(path, name=name, pin=pin, priority=priority)
        with self._cv:
            self._specs[name] = dict(kind="load", path=path, name=name,
                                     pin=pin, priority=priority)
            self._placement[name] = set(rids)
            self._oracles[name] = model
        return model

    def models(self) -> List[str]:
        with self._cv:
            return sorted(self._specs)

    def placement(self) -> Dict[str, List[int]]:
        with self._cv:
            return {n: sorted(p) for n, p in self._placement.items()}

    # -- health-scored routing ----------------------------------------------
    def _candidates(self, name: str,
                    exclude: Optional[Set[int]] = None) -> List[Replica]:
        with self._cv:
            placed = self._placement.get(name, ())
            return [rep for rid, rep in self._replicas.items()
                    if rep.state == "live" and rid in placed
                    and not (exclude and rid in exclude)]

    def _score(self, rep: Replica, name: str) -> Optional[Tuple]:
        """(load score sans p99, raw p99) — p99 is normalized against
        the candidate median by the caller.  None = unscorable (pool
        torn down under us)."""
        sess = rep.session
        pool = sess._pool
        try:
            depth = pool.queue_depth(name) if pool is not None else 0
        except Exception:
            return None
        br = sess._breakers.get(name)
        pen = 0.0 if br is None else \
            self._BREAKER_PENALTY.get(br.state, 4.0)
        # recent p99, read from the session's existing metrics family
        fam = sess.registry.histogram(
            "repro_request_latency_ms",
            "end-to-end served request latency", ("model",))
        h = fam.labels(model=name)
        p99 = h.percentile(99) if h.count >= 8 else 0.0
        return (depth / max(1, self._max_batch) + pen, p99)

    def _pick(self, name: str,
              exclude: Optional[Set[int]] = None) -> Optional[Replica]:
        """The best-scoring live replica of the model's placement set:
        queue depth (batches of backlog) + breaker penalty + recent p99
        (normalized by the candidate median so a uniformly-slow model
        doesn't distort the comparison).  Ties break toward the replica
        that has served least."""
        cands = self._candidates(name, exclude)
        if not cands and exclude:
            cands = self._candidates(name, None)   # all tried: reuse
        if not cands:
            return None
        scored = []
        for rep in cands:               # no fleet lock: pool locks inside
            s = self._score(rep, name)
            if s is not None:
                scored.append((rep,) + s)
        if not scored:
            return None
        pos = sorted(s[2] for s in scored if s[2] > 0)
        med = pos[len(pos) // 2] if pos else 0.0
        return min(scored,
                   key=lambda s: (s[1] + (s[2] / med if med else 0.0),
                                  s[0].served, s[0].rid))[0]

    # -- request path --------------------------------------------------------
    def submit(self, name: str, inputs, deadline_ms: Optional[float] = None,
               hedge: Optional[bool] = None) -> Ticket:
        """Route one request to the healthiest replica and return its
        fleet :class:`Ticket`.  ``hedge=None`` uses the fleet default;
        the hedge timeout derives from the model's fleet-level p99.
        Backpressure and replica loss re-route internally (bounded);
        the ticket terminates with a value or a typed error, never
        silently."""
        with self._cv:
            if not self._running:
                raise ServingError("fleet is closed")
            if name not in self._specs:
                raise KeyError(
                    f"model {name!r} not registered "
                    f"(have: {sorted(self._specs)})")
            self._req_counts[name] = self._req_counts.get(name, 0) + 1
            self.counters["requests"] += 1
        now = _chaos.now()
        deadline = None
        if deadline_ms is not None:
            deadline = now + float(deadline_ms) / 1e3
        ticket = Ticket(self, name, deadline)
        if deadline is not None and deadline <= now:
            with self._cv:
                self.counters["deadline_misses"] += 1
            ticket._fail(DeadlineExceeded(name, 0.0))
            return ticket
        use_hedge = self.hedge if hedge is None else bool(hedge)
        req = _Request(ticket, name, inputs,
                       self._hedge_after_s(name) if use_hedge else None)
        with self._cv:
            self._requests[ticket] = req
        if not self._dispatch(req):
            self._backoff_or_fail(req)
        return ticket

    def _hedge_after_s(self, name: str) -> float:
        if self.hedge_after_ms is not None:
            return float(self.hedge_after_ms) / 1e3
        h = self._m_latency.labels(model=name)
        if h.count >= self.MIN_HEDGE_SAMPLES:
            ms = h.percentile(99)
        else:
            ms = self.DEFAULT_HEDGE_MS
        return min(max(ms, self.hedge_floor_ms), self.hedge_cap_ms) / 1e3

    def _dispatch(self, req: _Request, hedge: bool = False) -> bool:
        """Submit one attempt for ``req`` on the best replica.  Returns
        False only when no live replica is routable; admission errors
        flow through the attempt ticket into :meth:`_attempt_done`
        (single settlement path)."""
        rep = self._pick(req.name, exclude=req.tried or None)
        if rep is None:
            return False
        if hedge and rep.rid in req.tried:
            return False           # a hedge must land on a new replica
        sess = rep.session
        attempt = Ticket(sess, req.name, req.ticket.deadline)
        attempt.trace_id = req.ticket.trace_id    # one trace, N attempts
        with self._cv:
            if req.ticket.done:
                return True
            req.live += 1
            req.tried.add(rep.rid)
            req.attempts.append((rep.rid, attempt))
            if hedge:
                req.hedge_rid = rep.rid
                self.counters["hedges"] += 1
            rep.served += 1
        attempt.on_done(
            lambda a, _rid=rep.rid: self._attempt_done(req, _rid, a))
        _trace.instant("fleet_hedge" if hedge else "fleet_route",
                       "fleet", trace_id=req.ticket.trace_id,
                       args={"model": req.name, "replica": rep.rid})
        try:
            pool = sess._pool
            if pool is None:
                raise ServingError("replica has no pool")
            pool.submit(req.name, req.feed, attempt)
        except (Overloaded, ServingError) as e:
            # shed or closing pool: settle the attempt so the failure
            # takes the one normal path (bookkeeping + backoff re-home)
            attempt._fail(e)
        except Exception as e:                     # pool teardown races
            attempt._fail(ServingError(repr(e)))
        return True

    def _attempt_done(self, req: _Request, rid: int, a: Ticket) -> None:
        """Attempt-ticket settlement hook.  May run on a pool worker
        thread holding that pool's lock: only fleet-lock state updates
        and (for the winning value) the fleet ticket settlement happen
        here — re-dispatch work is deferred to the router thread."""
        err = a.error
        if err is None:
            won = req.ticket._fulfill(a._value)
            with self._cv:
                req.live -= 1
                hedge_win = won and req.hedged and rid == req.hedge_rid
                if won:
                    self._requests.pop(req.ticket, None)
                    self.counters["completed"] += 1
                    if hedge_win:
                        self.counters["hedge_wins"] += 1
                self._cv.notify_all()
            if won:
                self._m_latency.observe(
                    (time.monotonic() - req.ticket.submitted_at) * 1e3,
                    model=req.name)
                if hedge_win:
                    _trace.instant("fleet_hedge_win", "fleet",
                                   trace_id=req.ticket.trace_id,
                                   args={"model": req.name,
                                         "replica": rid})
                self._maybe_audit(req.name, rid, req.feed, a._value)
            return
        with self._cv:
            req.live -= 1
            if req.ticket.done:
                self._requests.pop(req.ticket, None)
                self._cv.notify_all()
                return
            if isinstance(err, _TERMINAL):
                req.ticket._fail(err)
                self._requests.pop(req.ticket, None)
                self.counters["failed"] += 1
                if isinstance(err, DeadlineExceeded):
                    self.counters["deadline_misses"] += 1
                self._cv.notify_all()
                return
            req.last_err = err
            if req.live > 0:
                # a hedge twin is still racing: let it settle the ticket
                self._cv.notify_all()
                return
            if req.redispatches >= self.max_redispatch:
                req.ticket._fail(err)
                self._requests.pop(req.ticket, None)
                self.counters["failed"] += 1
                self.counters["exhausted"] += 1
                self._cv.notify_all()
                return
            self._schedule_retry_locked(req, err)

    def _schedule_retry_locked(self, req: _Request,
                               err: BaseException) -> None:
        """Arm a bounded-exponential-backoff re-dispatch (jittered so
        a mass failover doesn't re-converge on one survivor)."""
        req.redispatches += 1
        self.counters["redispatches"] += 1
        base = min(self.backoff_cap_ms,
                   self.backoff_base_ms * (2 ** (req.redispatches - 1)))
        delay_ms = base * (0.5 + 0.5 * self._rng.random())
        req.retry_at = _chaos.now() + delay_ms / 1e3
        _trace.instant("fleet_failover", "fleet",
                       trace_id=req.ticket.trace_id,
                       args={"model": req.name,
                             "reason": type(err).__name__,
                             "redispatch": req.redispatches,
                             "delay_ms": round(delay_ms, 2)})
        self._cv.notify_all()

    def _backoff_or_fail(self, req: _Request) -> None:
        """No replica was routable right now: back off (one may recycle
        back to life) until the re-dispatch budget exhausts."""
        with self._cv:
            if req.ticket.done or req.live > 0 or \
                    req.retry_at is not None:
                return
            err = req.last_err or WorkerLost(
                f"{req.name}: no live replica")
            if req.redispatches >= self.max_redispatch:
                req.ticket._fail(err)
                self._requests.pop(req.ticket, None)
                self.counters["failed"] += 1
                self.counters["exhausted"] += 1
                self._cv.notify_all()
                return
            self._schedule_retry_locked(req, err)

    def _resolve(self, ticket: Ticket, timeout: Optional[float]) -> None:
        ticket._event.wait(timeout)

    def _cancel(self, ticket: Ticket) -> bool:
        """:meth:`Ticket.cancel` on a fleet ticket: settle it
        ``Cancelled`` (first-wins) and cancel every replica attempt so
        queued copies free their EDF heap slots."""
        won = ticket._fail(Cancelled(ticket.name))
        with self._cv:
            req = self._requests.pop(ticket, None)
            if won:
                self.counters["cancelled"] += 1
            attempts = list(req.attempts) if req is not None else []
            self._cv.notify_all()
        if won:
            _trace.instant("fleet_cancel", "fleet",
                           trace_id=ticket.trace_id,
                           args={"model": ticket.name})
        for _rid, attempt in attempts:
            attempt.cancel()
        return won

    # -- router thread -------------------------------------------------------
    def _router(self) -> None:
        while True:
            due: List[Tuple[_Request, str]] = []
            with self._cv:
                if not self._running:
                    return
                now = _chaos.now()
                next_due = now + 0.05
                for req in list(self._requests.values()):
                    t = req.ticket
                    if t.done:
                        self._requests.pop(t, None)
                        continue
                    dl = t.deadline
                    if dl is not None and now > dl and req.live == 0:
                        # stranded in backoff past its deadline
                        t._fail(DeadlineExceeded(
                            req.name, (now - dl) * 1e3))
                        self._requests.pop(t, None)
                        self.counters["failed"] += 1
                        self.counters["deadline_misses"] += 1
                        continue
                    if req.retry_at is not None:
                        if now >= req.retry_at:
                            req.retry_at = None
                            due.append((req, "retry"))
                        else:
                            next_due = min(next_due, req.retry_at)
                    elif req.hedge_after_s is not None and \
                            not req.hedged and req.live == 1:
                        h_at = req.t0 + req.hedge_after_s
                        if now < h_at:
                            next_due = min(next_due, h_at)
                        elif self.counters["hedges"] < \
                                self.hedge_budget * max(
                                    1, self.counters["requests"]):
                            req.hedged = True     # claim under the lock
                            due.append((req, "hedge"))
                        # over budget: leave it — the pool serves it
                self._cv.notify_all()
            # outside the fleet lock: chaos + pool calls
            self._poll_chaos()
            for req, act in due:
                if act == "hedge":
                    self._dispatch(req, hedge=True)
                elif not self._dispatch(req):
                    self._backoff_or_fail(req)
            with self._cv:
                if not self._running:
                    return
                wait = max(0.001, min(next_due - _chaos.now(), 0.05))
                self._cv.wait(wait)

    def _poll_chaos(self) -> None:
        c = _chaos.active()
        if c is None:
            return
        for rid in c.take_pool_kills():
            self.kill_replica(rid, reason="chaos")

    # -- pool-level failover -------------------------------------------------
    def kill_replica(self, rid: int, reason: str = "dead") -> bool:
        """Declare one replica's pool dead (every worker lost at once).
        Its queued attempts fail ``WorkerLost`` — the router re-homes
        each on the survivors with backoff — and the replica recycles
        in the background (tear down, rebuild, re-register, resume)."""
        with self._cv:
            rep = self._replicas.get(rid)
            if rep is None or rep.state != "live":
                return False
            rep.state = "dead"
            rep.deaths += 1
            self.counters["pool_deaths"] += 1
        _trace.instant("fleet_pool_dead", "fleet",
                       args={"replica": rid, "reason": reason})
        threading.Thread(target=self._recycle, args=(rid, reason),
                         name=f"npu-fleet-recycle-{rid}",
                         daemon=True).start()
        return True

    def _recycle(self, rid: int, reason: str) -> None:
        """Tear the replica's session down (queued attempts drain back
        to the router as ``WorkerLost`` failures) and rebuild it from
        the registered model specs."""
        with self._cv:
            rep = self._replicas.get(rid)
            if rep is None:
                return
            old = rep.session
            names = [n for n, p in self._placement.items() if rid in p]
            specs = [dict(self._specs[n]) for n in names]
        try:
            old.close()
        except Exception:
            pass
        try:
            sess = self._new_session(rid)
            for spec in specs:
                self._apply_spec(sess, spec)
        except Exception as e:
            _trace.instant("fleet_recycle_failed", "fleet",
                           args={"replica": rid, "error": repr(e)})
            return                 # replica stays dead; others serve
        with self._cv:
            rep.session = sess
            rep.audit_mismatches = 0
            rep.state = "live"
            self.counters["recycles"] += 1
            self._cv.notify_all()
        _trace.instant("fleet_replica_recycled", "fleet",
                       args={"replica": rid, "reason": reason})

    # -- silent-corruption auditor ------------------------------------------
    def _maybe_audit(self, name: str, rid: int, feed, out) -> None:
        if self.audit_fraction <= 0.0:
            return
        with self._cv:
            if self._rng.random() >= self.audit_fraction:
                return
            if len(self._audit_q) >= self.audit_backlog:
                self.counters["audit_dropped"] += 1
                return
            self._audit_q.append((name, rid, feed, out))
            self._cv.notify_all()

    def _auditor(self) -> None:
        while True:
            with self._cv:
                while self._running and not self._audit_q:
                    self._cv.wait(0.1)
                if not self._running:
                    return
                name, rid, feed, out = self._audit_q.popleft()
                oracle = self._oracles.get(name)
            if oracle is None:
                continue
            try:
                mismatch = self._audit_mismatch(oracle, feed, out)
            except Exception:
                with self._cv:
                    self.counters["audit_error"] += 1
                continue
            with self._cv:
                self.counters[
                    "audit_mismatch" if mismatch else "audit_ok"] += 1
                over = False
                if mismatch:
                    rep = self._replicas.get(rid)
                    if rep is not None:
                        rep.audit_mismatches += 1
                        over = (rep.audit_mismatches >=
                                self.audit_threshold and
                                rep.state == "live")
            if mismatch:
                _trace.instant("fleet_audit_mismatch", "fleet",
                               args={"model": name, "replica": rid})
                if over:
                    self._quarantine(rid)

    @staticmethod
    def _audit_mismatch(oracle, feed, out) -> bool:
        """Re-execute the sampled request on the interpretive oracle
        and compare every output within the model's plan-parity
        tolerance (floored: bit-identical semantics still deserve an
        epsilon against dtype round-tripping)."""
        want = oracle(feed, engine="interp")
        sem = oracle.semantics
        for k, w in want.items():
            got = _f64(out[k])
            ref = _f64(w)
            if got.shape != ref.shape:
                return True
            if not got.size:
                continue
            tol = max(sem.plan_parity_tol(k, ref), 1e-6) \
                if sem is not None else 1e-6
            if float(np.max(np.abs(got - ref))) > tol:
                return True
        return False

    def _quarantine(self, rid: int) -> None:
        """Audit verdict: the replica returns wrong bytes.  Stop
        routing to it *now*, then recycle it in the background."""
        with self._cv:
            rep = self._replicas.get(rid)
            if rep is None or rep.state != "live":
                return
            rep.state = "quarantined"
            rep.quarantines += 1
            self.counters["quarantines"] += 1
            mismatches = rep.audit_mismatches
        _trace.instant("fleet_quarantine", "fleet",
                       args={"replica": rid, "mismatches": mismatches})
        threading.Thread(target=self._recycle, args=(rid, "audit"),
                         name=f"npu-fleet-recycle-{rid}",
                         daemon=True).start()

    # -- rolling artifact updates -------------------------------------------
    def update(self, name: str, path: str, probe_feeds: int = 2) -> int:
        """Rolling artifact update: canary-verify the new artifact,
        then drain and swap one replica at a time (requests keep
        routing to the others).  The canary runs *before* any swap —
        plan outputs of the new artifact shadow-verified against its
        interpretive oracle — and a mismatch raises
        :class:`UpdateRejected` with zero replicas touched (the
        rollback).  Returns the number of replicas swapped."""
        with self._cv:
            spec = self._specs.get(name)
            if spec is None:
                raise KeyError(f"model {name!r} not registered")
            spec = dict(spec)
            rids = sorted(self._placement.get(name, ()))
        from repro_torch.api.compiled import CompiledModel
        with self._cv:
            device = self._oracles[name].device
        new = CompiledModel.load(path, mmap=True, device=device)
        detail = self._canary(name, new, probe_feeds)
        if detail is not None:
            with self._cv:
                self.counters["updates_rolled_back"] += 1
            _trace.instant("fleet_update_rollback", "fleet",
                           args={"model": name, "detail": detail})
            raise UpdateRejected(
                f"{name}: canary rejected the new artifact ({detail}) "
                f"— rolled back, no replica swapped")
        pin = bool(spec.get("pin", False))
        priority = spec.get("priority")
        swapped = 0
        for rid in rids:
            with self._cv:
                rep = self._replicas.get(rid)
                if rep is None or rep.state != "live":
                    continue       # recycling replicas rebuild from the
                rep.state = "updating"     # updated spec written below
            try:
                rep.session.flush(name, timeout=30.0)       # drain
                if pin and name in rep.session._pinned:
                    rep.session.unpin(name)
                rep.session.load(path, name=name, pin=pin,
                                 priority=priority)
                swapped += 1
            except Exception as e:
                with self._cv:
                    rep.state = "live"
                    self.counters["updates_failed"] += 1
                    self._cv.notify_all()
                raise UpdateRejected(
                    f"{name}: swap failed on replica {rid} after "
                    f"{swapped} swap(s): {e}") from e
            with self._cv:
                rep.state = "live"
                self._cv.notify_all()
            _trace.instant("fleet_update_swap", "fleet",
                           args={"model": name, "replica": rid})
        with self._cv:
            self._specs[name] = dict(kind="load", path=path, name=name,
                                     pin=pin, priority=priority)
            self._oracles[name] = new
            self.counters["updates_ok"] += 1
        return swapped

    @staticmethod
    def _canary(name: str, new, probe_feeds: int) -> Optional[str]:
        """Shadow-verify the new artifact: its compiled replay plan
        must match its interpretive oracle on probe inputs, within the
        plan-parity tolerance.  Returns a mismatch description, or
        None when the canary passes."""
        rng = np.random.default_rng(0)
        sem = new.semantics
        for i in range(max(1, int(probe_feeds))):
            feed = {t.name: (np.zeros(t.shape, dtype=np.float32) if i == 0
                             else rng.standard_normal(t.shape)
                             .astype(np.float32))
                    for t in new.graph.inputs}
            want = new(feed, engine="interp")
            got = new(feed)                       # plan engine
            c = _chaos.active()
            if c is not None and c.check_canary(name):
                got = _chaos.flip_outputs(got)    # a bad artifact swap
            for k, ref in want.items():
                g = _f64(got[k])
                r = _f64(ref)
                tol = max(sem.plan_parity_tol(k, r), 1e-6) \
                    if sem is not None else 1e-6
                err = float(np.max(np.abs(g - r))) if g.size else 0.0
                if g.shape != r.shape or err > tol:
                    return (f"probe {i} output {k}: max|err|="
                            f"{err:.3e} > tol {tol:.3e}")
        return None

    # -- pin rebalancing -----------------------------------------------------
    def rebalance(self) -> Dict[str, List[int]]:
        """Re-home models onto the least-loaded live replicas from
        observed traffic (heaviest models placed first, keeping each
        model's replica-set size).  Program-cache pins follow: a pinned
        model pins on its new homes and unpins where it left.  Returns
        the models that moved with their new placement."""
        with self._cv:
            live = sorted(rid for rid, rep in self._replicas.items()
                          if rep.state == "live")
            traffic = {n: self._req_counts.get(n, 0)
                       for n in self._placement}
            sizes = {n: max(1, len(p))
                     for n, p in self._placement.items()}
            specs = {n: dict(self._specs[n]) for n in self._placement}
            old_placement = {n: set(p)
                             for n, p in self._placement.items()}
        if not live:
            return {}
        load = {rid: 0.0 for rid in live}
        moves: Dict[str, List[int]] = {}
        for n in sorted(traffic, key=lambda n: (-traffic[n], n)):
            k = min(sizes[n], len(live))
            homes = set(sorted(live, key=lambda r: (load[r], r))[:k])
            share = max(1, traffic[n]) / k
            for r in homes:
                load[r] += share
            old = old_placement[n]
            spec = specs[n]
            for rid in sorted(homes - old):       # register on new homes
                with self._cv:
                    sess = self._replicas[rid].session
                if n not in sess:
                    self._apply_spec(sess, spec)
                elif spec.get("pin"):
                    sess.pin(n)
            for rid in sorted(old - homes):       # unpin where it left
                with self._cv:
                    rep = self._replicas.get(rid)
                if rep is None or rep.state != "live":
                    continue
                if spec.get("pin") and n in rep.session._pinned:
                    rep.session.unpin(n)
            with self._cv:
                self._placement[n] = homes
            if homes != old:
                moves[n] = sorted(homes)
        if moves:
            _trace.instant("fleet_rebalance", "fleet",
                           args={"moves": {n: v
                                           for n, v in moves.items()}})
        return moves

    # -- draining / shutdown -------------------------------------------------
    def flush(self, timeout: float = 60.0) -> bool:
        """Block until every submitted fleet ticket has settled.
        Returns False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cv:
            return self._cv.wait_for(
                lambda: not self._requests,
                max(0.0, deadline - time.monotonic()))

    def close(self) -> None:
        """Shut the fleet down: unsettled tickets fail with a typed
        ``WorkerLost`` (never silently lost), replicas close."""
        if self.closed:
            return
        self.closed = True
        with self._cv:
            self._running = False
            reqs = list(self._requests.values())
            self._requests.clear()
            self._audit_q.clear()
            reps = list(self._replicas.values())
            self._cv.notify_all()
        for req in reqs:
            req.ticket._fail(WorkerLost(
                f"{req.name}: fleet closed with the request unsettled"))
        self._router_t.join(2.0)
        self._audit_t.join(2.0)
        for rep in reps:
            try:
                rep.session.close()
            except Exception:
                pass

    # -- observability -------------------------------------------------------
    _STATE_CODE = {"live": 0, "updating": 1, "quarantined": 2, "dead": 3}

    def _collect_metrics(self) -> None:
        reg = self.registry
        with self._cv:
            counters = dict(self.counters)
            reps = [(rid, rep.state, rep.served, rep.deaths,
                     rep.quarantines, rep.audit_mismatches)
                    for rid, rep in sorted(self._replicas.items())]
            inflight = len(self._requests)
            req_counts = dict(self._req_counts)
        ev = reg.counter("repro_fleet_events_total",
                         "fleet routing/hedge/failover/audit events",
                         ("event",))
        for k, v in counters.items():
            ev.set_total(v, event=k)
        reg.gauge("repro_fleet_inflight",
                  "unsettled fleet requests").set(inflight)
        st = reg.gauge("repro_fleet_replica_state",
                       "replica state (0=live 1=updating 2=quarantined "
                       "3=dead)", ("replica",))
        routed = reg.counter("repro_fleet_routed_total",
                             "attempts routed per replica", ("replica",))
        deaths = reg.counter("repro_fleet_replica_deaths_total",
                             "pool deaths per replica", ("replica",))
        quar = reg.counter("repro_fleet_quarantines_total",
                           "audit quarantines per replica", ("replica",))
        mism = reg.gauge("repro_fleet_audit_mismatches",
                         "audit mismatches since last recycle",
                         ("replica",))
        for rid, state, served, d, q, m in reps:
            st.set(self._STATE_CODE.get(state, 3), replica=rid)
            routed.set_total(served, replica=rid)
            deaths.set_total(d, replica=rid)
            quar.set_total(q, replica=rid)
            mism.set(m, replica=rid)
        reqs = reg.counter("repro_fleet_requests_total",
                           "fleet requests submitted", ("model",))
        for n, v in req_counts.items():
            reqs.set_total(v, model=n)

    def metrics(self) -> str:
        """The fleet registry as Prometheus text exposition."""
        return self.registry.render()

    def stats(self) -> dict:
        with self._cv:
            reps = {rid: {"state": rep.state, "served": rep.served,
                          "deaths": rep.deaths,
                          "quarantines": rep.quarantines,
                          "audit_mismatches": rep.audit_mismatches}
                    for rid, rep in sorted(self._replicas.items())}
            out = {"replicas": reps,
                   "placement": {n: sorted(p)
                                 for n, p in self._placement.items()},
                   "inflight": len(self._requests),
                   "per_model_requests": dict(self._req_counts),
                   **{k: v for k, v in self.counters.items()}}
        out["latency"] = {
            n: h.snapshot()
            for (n,), h in self._m_latency.series().items() if h.count}
        return out

    def report(self) -> str:
        s = self.stats()
        lines = [f"Fleet: {len(s['replicas'])} replica(s), "
                 f"{s['requests']} request(s), {s['hedges']} hedged "
                 f"({s['hedge_wins']} hedge wins), "
                 f"{s['redispatches']} re-dispatched, "
                 f"{s['pool_deaths']} pool death(s), "
                 f"{s['quarantines']} quarantine(s)"]
        for rid, r in s["replicas"].items():
            lines.append(
                f"  r{rid}: {r['state']:<12} served {r['served']:>6}  "
                f"deaths {r['deaths']}  quarantines {r['quarantines']}  "
                f"audit-mismatches {r['audit_mismatches']}")
        for n, lat in s["latency"].items():
            lines.append(f"  {n}: p50 {lat['p50_ms']:.2f} ms / "
                         f"p99 {lat['p99_ms']:.2f} ms "
                         f"({lat['count']} served)")
        return "\n".join(lines)
