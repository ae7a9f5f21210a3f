"""Multi-model serving session: micro-batching, deadlines, fault
tolerance, on the device.

Counterpart of ``repro/api/session.py``.  A :class:`Session` is a
registry of :class:`~repro_torch.api.compiled.CompiledModel` instances
(each with its own precision) behind one hardware config, one options
baseline, one two-tier compiled-program cache and one torch device
(CUDA unless the caller passes ``device="cpu"``):

    sess = Session(max_batch=8, workers=2)            # two worker threads
    sess.add("mobilenet_v2", precision="int8")        # int8 plan on K1
    sess.add("mobilenet_v2", name="mnv2_f32", precision="float32")
    out = sess.run("mobilenet_v2", image)             # single request
    t1 = sess.submit("mobilenet_v2", img_a, deadline_ms=50)
    t1.result()                                       # latency-bounded

Requests execute on each model's device plan (lowered once,
batch-vectorized; every conv and fc on K1); the coalescing queue groups
same-model submissions into one plan replay of up to ``max_batch``
requests.  **A served request resolves to a dict of CPU tensors**: the
worker copies the batch's outputs to the host once, on its own stream,
and synchronizes that stream inside the batch's ``try``, so a CUDA
error of the batch fails that batch only, the service time includes the
device's time, and no tensor allocated on a worker's stream is handed to
another thread.  Each ticket gets its row as a view.  ``run``,
``run_many`` and the degraded interpreter path return the same type;
``CompiledModel.__call__`` keeps returning device tensors.

**Robustness contract** (see :mod:`repro_torch.runtime.serving`): every
submitted ticket terminates with a result or a *typed* error.  The
bounded per-model queue sheds load with ``Overloaded``; tickets whose
deadline passes before execution fail with ``DeadlineExceeded``; a
failing plan execution fails only its own batch's tickets, is retried
once, and after ``breaker_threshold`` consecutive failures the model's
circuit breaker trips while a background re-lower probe attempts
recovery.  On a ``device="cpu"`` session the requests meanwhile degrade
to the interpretive oracle engine (slow but correct, counted in
``degraded_requests``), as in the reference.  On a CUDA session they fail
fast with :class:`~repro_torch.runtime.serving.BreakerOpen`, carrying a
retry hint (counted in ``breaker_rejects``): the work never moves off
the card, whose fault (a kernel that fails to build or launch, a
sticky CUDA error) the host engine would only hide.  With ``workers >
0`` a thread :class:`~repro_torch.runtime.serving.ServerPool` serves the
queues, each worker with its own plan arena and CUDA stream.  A pool on
CUDA builds the kernels before its workers start, and a model added to
it is lowered before any worker takes a batch of it, so a worker's first
batch only allocates its arena.  ``workers=("process", n)`` swaps in a
:class:`~repro_torch.runtime.procpool.ProcPool`: each worker is a
separate OS process that opens the model artifacts (spooled to a
temporary directory when a model was compiled in the session) on the
session's device, with a CUDA context and a device copy of the weights
of its own, and lowers and warms every model before it takes a batch
(``add`` returns once every live child has, and raises a child's load
error).  A SIGKILL/SIGSEGV/OOM death, or a sticky CUDA fault that
poisons a child's context, re-dispatches the batch in flight to the
survivors and respawns the child off the request path, with zero ticket
loss.  A thread pool cannot replace a poisoned context: its batches fail
until the process ends.  :meth:`Session.fleet` puts replica sessions
behind one router (:mod:`repro_torch.runtime.fleet`).
"""
from __future__ import annotations

import os
import random
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.npu import NEUTRON_2TOPS, NPUConfig
from repro_torch.core.pipeline import (CompilerOptions,
                                       program_cache_configure,
                                       program_cache_info, program_cache_pin,
                                       program_cache_unpin)
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime import chaos as _chaos
from repro_torch.runtime.serving import (BreakerOpen, Cancelled,
                                         CircuitBreaker,
                                         DeadlineExceeded, FlushError,
                                         FrameCorrupt, LatencyHistogram,
                                         Overloaded, ServerPool, Ticket,
                                         WorkerCrashed)

from .compiled import CompiledModel, Inputs, Outputs, _host

#: request errors that are the *caller's* fault (bad shape, bad name):
#: not retried, never counted against the model's circuit breaker.
_CLIENT_ERRORS = (ValueError, TypeError, KeyError)


def _on_host(run, device: torch.device, tracer=None) -> Outputs:
    """The outputs of ``run()`` (device tensors) on the host: one
    device-to-host copy per output on the current stream, then a
    synchronize of that stream, where an asynchronous CUDA error of the
    launches before it surfaces.  The stream is synchronized when
    ``run`` raises too, so that the next batch finds it drained.  With
    ``tracer`` armed, the copies are its ``copy_back`` phase (they wait
    for the stream's last kernels first)."""
    if device.type != "cuda":
        return run()
    try:
        out = run()
        if tracer is not None:
            phase = tracer.phase("copy_back")
        out = {k: v.to("cpu") for k, v in out.items()}
        if tracer is not None:
            phase.end()
        return out
    finally:
        torch.cuda.current_stream(device).synchronize()


def _served(model: CompiledModel, feeds, owner=None) -> List[Outputs]:
    """One batch of single-sample requests through the model's plan
    (``owner``'s arena, on the current stream): one copy of the batch to
    the device, one copy of each output back, then each request's row
    as a view."""
    host = _on_host(lambda: model.run_batch(feeds, owner=owner),
                    model.device, _trace.active())
    return [{k: v[i] for k, v in host.items()} for i in range(len(feeds))]


class Session:
    """Multi-model registry + micro-batched request path + stats."""

    def __init__(self, config: Optional[NPUConfig] = None,
                 options: Optional[CompilerOptions] = None,
                 cache_dir: Optional[str] = None,
                 max_entries: Optional[int] = None,
                 max_bytes: Optional[int] = None,
                 max_batch: int = 8,
                 workers: Union[int, Tuple[str, int]] = 0,
                 max_queue: int = 256,
                 linger_ms: float = 2.0,
                 heartbeat_timeout_s: float = 0.5,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 2.0,
                 retry_backoff_ms: float = 10.0,
                 tag: Optional[str] = None,
                 device=None):
        self.cfg = config or NEUTRON_2TOPS
        #: the device every model of the session replays on (CUDA unless
        #: the caller asks for the CPU); passed on to compile and load
        self.device = resolve_device(device)
        self.options = options
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.retry_backoff_s = float(retry_backoff_ms) / 1e3
        #: chaos-attribution tag (fleet replicas pass their replica id
        #: so per-replica faults — silent output corruption — can be
        #: aimed at one session among many in the same process)
        self.tag = tag
        # only forward knobs the caller actually set — the store is
        # process-wide and an omitted knob must not reset prior config
        if cache_dir is not None:
            program_cache_configure(disk_dir=cache_dir)
        if max_entries is not None:
            program_cache_configure(max_entries=max_entries)
        if max_bytes is not None:
            program_cache_configure(max_bytes=max_bytes)
        self._models: Dict[str, CompiledModel] = {}
        self._stats: Dict[str, dict] = {}
        self._stats_lock = threading.Lock()
        self._pinned: set = set()
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._hists: Dict[str, LatencyHistogram] = {}
        #: the session's metrics surface (repro_torch.obs.metrics): the
        #: latency/queue-wait/service histograms live here as families,
        #: every dict counter is mirrored in by a render-time collector,
        #: and Session.metrics() renders the whole registry
        self.registry = MetricsRegistry()
        self._m_latency = self.registry.histogram(
            "repro_request_latency_ms",
            "end-to-end served request latency", ("model",))
        self._m_queue_wait = self.registry.histogram(
            "repro_queue_wait_ms",
            "submit-to-execution queue wait", ("model",))
        self._m_service = self.registry.histogram(
            "repro_batch_service_ms",
            "batch execution (service) time", ("model",))
        self.registry.register_collector(self._collect_metrics)
        #: synchronous-mode coalescing queue: name -> [(feed, ticket)]
        self._queue: Dict[str, List[tuple]] = {}
        self._queue_depth = 0
        self._pool: Optional[ServerPool] = None
        self.closed = False
        #: background half-open recovery probes, one timer per tripped
        #: model (canceled on close)
        self._probe_lock = threading.Lock()
        self._probe_timers: Dict[str, threading.Timer] = {}
        #: artifact spool for process pools (workers load models from
        #: here when they were compiled in-session rather than loaded
        #: from an artifact path)
        self._spool_dir: Optional[str] = None
        # workers policy: n threads, or ("thread"|"process", n)
        if isinstance(workers, (tuple, list)):
            pool_mode, n_workers = workers
            n_workers = int(n_workers)
        else:
            pool_mode, n_workers = "thread", int(workers)
        if pool_mode not in ("thread", "process"):
            raise ValueError(
                f"workers mode must be 'thread' or 'process', "
                f"got {pool_mode!r}")
        if n_workers:
            kw = dict(max_batch=self.max_batch, max_queue=self.max_queue,
                      linger_ms=linger_ms,
                      heartbeat_timeout_s=heartbeat_timeout_s,
                      registry=self.registry, device=self.device)
            if pool_mode == "process":
                from repro_torch.runtime.procpool import ProcPool
                self._pool = ProcPool(self._execute_entries,
                                      workers=n_workers, **kw)
            else:
                self._pool = ServerPool(self._execute_entries,
                                        workers=n_workers, **kw)

    @classmethod
    def fleet(cls, replicas: int = 2, **kw) -> "Fleet":  # noqa: F821
        """Construct a :class:`~repro_torch.runtime.fleet.Fleet` of
        ``replicas`` Sessions (each with its own worker pool, modeling
        one host) behind a single health-routed, hedged ``submit()``
        surface.  Keyword arguments are forwarded to
        :class:`~repro_torch.runtime.fleet.Fleet`; per-session knobs
        (``workers``, ``max_batch``, ``device``, …) reach every
        replica."""
        from repro_torch.runtime.fleet import Fleet
        return Fleet(replicas=replicas, session_factory=cls, **kw)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Shut the session down: queued-but-unexecuted tickets fail
        with a typed ``WorkerLost`` error (never silently lost)."""
        if self.closed:
            return
        self.closed = True
        with self._probe_lock:
            timers = list(self._probe_timers.values())
            self._probe_timers.clear()
        for t in timers:
            t.cancel()
        if self._pool is not None:
            self._pool.close()
        if self._spool_dir is not None:
            import shutil
            shutil.rmtree(self._spool_dir, ignore_errors=True)
            self._spool_dir = None

    def _model_stats(self, name: str) -> dict:
        return self._stats.setdefault(name, {
            "requests": 0, "run_s": 0.0,
            "batched_requests": 0, "batches": 0, "max_batch_seen": 0,
            "compiles": {"solved": 0, "memory": 0, "disk": 0,
                         "artifact": 0},
            # robustness counters
            "shed": 0, "deadline_misses": 0, "degraded_requests": 0,
            "breaker_rejects": 0,
            "retries": 0, "submit_retries": 0, "plan_failures": 0,
            "breaker_trips": 0, "recoveries": 0, "failed_recoveries": 0,
            "crash_redispatches": 0, "frame_corrupt": 0, "cancelled": 0,
        })

    def _count(self, name: str, counter: str, n: int = 1) -> None:
        with self._stats_lock:
            self._model_stats(name)[counter] += n

    def _breaker(self, name: str) -> CircuitBreaker:
        br = self._breakers.get(name)
        if br is None:
            br = self._breakers[name] = CircuitBreaker(
                threshold=self.breaker_threshold,
                cooldown_s=self.breaker_cooldown_s, name=name)
        return br

    def _hist(self, name: str) -> LatencyHistogram:
        h = self._hists.get(name)
        if h is None:
            # the registry family child IS the session's histogram —
            # one series, readable both as stats()["latency"] and as
            # the repro_request_latency_ms summary in metrics()
            h = self._hists[name] = self._m_latency.labels(model=name)
        return h

    # -- registry -----------------------------------------------------------
    def _register(self, name: str, model: CompiledModel,
                  path: Optional[str], priority: Optional[int],
                  pin: bool) -> None:
        """Hand a newly registered model to the worker pool: a thread
        pool on CUDA gets it lowered, so that no worker's first batch
        lowers it; a process pool gets an on-disk artifact (spooled here
        if the model was compiled in-session) that every child loads,
        lowers and warms before this returns."""
        pool = self._pool
        if pool is None:
            if priority is not None:
                raise ValueError(
                    f"{name}: priority= needs a worker pool "
                    f"(workers > 0)")
        else:
            if priority is not None:
                pool.set_priority(name, int(priority))
            if pool.mode == "process":
                if model.semantics is None:
                    raise RuntimeError(
                        f"{name}: cost-model-only models (dtype-cast "
                        f"graphs) have no executable semantics and cannot "
                        f"be served by a process pool")
                if path is None:
                    if self._spool_dir is None:
                        self._spool_dir = tempfile.mkdtemp(
                            prefix="repro-torch-procpool-")
                    path = os.path.join(self._spool_dir, f"{name}.rpa")
                    model.save(path)
                pool.register_model(name, path)
            elif self.device.type == "cuda" and model.semantics is not None:
                model.lower()
        if pin:
            self.pin(name)

    def add(self, source, name: Optional[str] = None,
            precision: str = "auto",
            options: Optional[CompilerOptions] = None,
            warmup: bool = False, pin: bool = False,
            priority: Optional[int] = None,
            **kw) -> CompiledModel:
        """Compile (or fetch from the program cache) and register one
        model on the session's device.  ``source`` is anything
        ``api.compile`` takes, or a :class:`CompiledModel` already
        compiled for this device (registered as it is, not compiled
        again).  ``precision`` selects the per-model execution precision
        ("auto" / "float32" / "int8"); ``warmup=True`` runs one zero
        input through the program; ``pin=True`` marks the model's
        compiled program exempt from in-process LRU eviction;
        ``priority`` assigns the pool dispatch/shedding priority class
        (higher dispatches first)."""
        if isinstance(source, CompiledModel):
            if source.device != self.device:
                raise ValueError(
                    f"{source.name}: compiled for {source.device}, the "
                    f"session serves on {self.device}")
            model = source
        else:
            from . import compile as api_compile
            model = api_compile(source, self.cfg,
                                options if options is not None
                                else self.options,
                                precision=precision, device=self.device,
                                **kw)
        name = name or model.name
        self._models[name] = model
        st = self._model_stats(name)
        st["precision"] = model.precision
        st["compile_s"] = model.compile_s
        st["latency_ms"] = model.program.latency_ms()
        st["compiles"][model.cache_tier or "solved"] += 1
        self._register(name, model, None, priority, pin)
        if warmup:
            self.warmup(name)
        return model

    def load(self, path: str, name: Optional[str] = None,
             mmap: bool = True, pin: bool = False,
             priority: Optional[int] = None) -> CompiledModel:
        """Register a model from an on-disk artifact (no compilation),
        replaying on the session's device.  ``mmap=True`` maps the
        artifact's weight arrays copy-on-write instead of reading them
        into RAM."""
        model = CompiledModel.load(path, mmap=mmap, device=self.device)
        name = name or model.name
        self._models[name] = model
        st = self._model_stats(name)
        st["precision"] = model.precision
        st["compile_s"] = 0.0
        st["latency_ms"] = model.program.latency_ms()
        st["compiles"]["artifact"] += 1
        self._register(name, model, path, priority, pin)
        return model

    def warmup(self, name: Optional[str] = None) -> None:
        """Run one all-zeros input through the named model (or all) —
        builds the batch-1 replay plan, so first-request latency is
        pure execution."""
        names = [name] if name else list(self._models)
        for n in names:
            m = self._models[n]
            m({t.name: np.zeros(t.shape, dtype=np.float32)
               for t in m.graph.inputs})

    def get(self, name: str) -> CompiledModel:
        return self._models[name]

    __getitem__ = get

    def __contains__(self, name: str) -> bool:
        return name in self._models

    def models(self):
        return list(self._models)

    # -- admission policy ---------------------------------------------------
    def pin(self, name: str) -> None:
        """Exempt this model's compiled program from in-process LRU
        eviction (hot-model admission policy)."""
        model = self._get(name)
        program_cache_pin(model.fingerprint)
        self._pinned.add(name)

    def unpin(self, name: str) -> None:
        model = self._get(name)
        program_cache_unpin(model.fingerprint)
        self._pinned.discard(name)

    def pinned(self) -> List[str]:
        return sorted(self._pinned)

    # -- request path -------------------------------------------------------
    def _get(self, name: str) -> CompiledModel:
        try:
            return self._models[name]
        except KeyError:
            raise KeyError(
                f"model {name!r} not registered "
                f"(have: {sorted(self._models)})") from None

    def run(self, name: str, inputs: Inputs, check: bool = False
            ) -> Outputs:
        """One request (or one batched array) through the model,
        synchronously; outputs as CPU tensors."""
        model = self._get(name)
        t0 = time.monotonic()
        out = _on_host(lambda: model(inputs, check=check), model.device)
        dt = time.monotonic() - t0
        with self._stats_lock:
            st = self._model_stats(name)
            st["requests"] += 1
            st["run_s"] += dt
        self._hist(name).record(dt * 1e3)
        return out

    def run_many(self, name: str, requests: List[Inputs],
                 check: bool = False) -> List[dict]:
        """Execute a group of same-model requests as chunked plan
        replays of at most ``max_batch`` requests each; outputs as CPU
        tensors."""
        model = self._get(name)
        out: List[dict] = []
        t0 = time.monotonic()
        nb = nr = 0
        mx = 0
        for i in range(0, len(requests), self.max_batch):
            group = requests[i:i + self.max_batch]
            if check:            # the interpreter, one sample at a time
                out.extend({k: v.cpu() for k, v in o.items()}
                           for o in model.run_many(group, check=True))
            else:
                out.extend(_served(model, group))
            nb += 1
            nr += len(group)
            mx = max(mx, len(group))
        dt = time.monotonic() - t0
        with self._stats_lock:
            st = self._model_stats(name)
            st["batches"] += nb
            st["batched_requests"] += nr
            st["max_batch_seen"] = max(st["max_batch_seen"], mx)
            st["requests"] += len(requests)
            st["run_s"] += dt
        return out

    def submit(self, name: str, inputs: Inputs,
               deadline_ms: Optional[float] = None,
               retries: int = 0,
               retry_cap_ms: float = 250.0) -> Ticket:
        """Queue one request for micro-batching and return its
        :class:`Ticket`.

        ``deadline_ms`` bounds end-to-end latency: the batch carrying
        this request auto-flushes early enough to make the deadline
        (pooled sessions), and a ticket whose deadline passes before it
        executes fails with ``DeadlineExceeded`` instead of running
        stale work.  When the model's bounded queue (``max_queue``) is
        full the request is shed with :class:`Overloaded` carrying a
        retry-after hint.

        ``retries=N`` turns the shed into client-side retry: each
        :class:`Overloaded` is retried after an exponential backoff
        with *full jitter* — ``sleep(U(0, min(cap, hint * 2**attempt)))``
        seeded from the shed hint's p50-derived ``retry_after_ms`` and
        capped at ``retry_cap_ms`` — so synchronized retry storms decor-
        relate.  The deadline is absolute: backoff spends it, it never
        extends it.  Retries count into ``repro_retries_total``."""
        self._get(name)                       # fail fast on bad names
        now = _chaos.now()
        deadline = None
        if deadline_ms is not None:
            deadline = now + float(deadline_ms) / 1e3
        for attempt in range(int(retries)):
            try:
                return self._submit_once(name, inputs, deadline,
                                         deadline_ms)
            except Overloaded as e:
                self._count(name, "submit_retries")
                base = min(float(retry_cap_ms),
                           max(1.0, e.retry_after_ms) * (2 ** attempt))
                delay_s = random.random() * base / 1e3
                if deadline is not None and \
                        _chaos.now() + delay_s >= deadline:
                    raise          # backoff would outlive the deadline
                time.sleep(delay_s)
        return self._submit_once(name, inputs, deadline, deadline_ms)

    def _submit_once(self, name: str, inputs: Inputs,
                     deadline: Optional[float],
                     deadline_ms: Optional[float]) -> Ticket:
        now = _chaos.now()
        ticket = Ticket(self, name, deadline)
        tracer = _trace.active()
        if tracer is None:
            return self._enqueue(name, inputs, ticket, now)
        t0 = time.monotonic()
        try:
            return self._enqueue(name, inputs, ticket, now)
        finally:
            tracer.complete("submit", "serving", t0,
                            trace_id=ticket.trace_id,
                            args={"model": name, "deadline_ms": deadline_ms})

    def _enqueue(self, name: str, inputs: Inputs, ticket: Ticket,
                 now: float) -> Ticket:
        if ticket.deadline is not None and ticket.deadline <= now:
            self._count(name, "deadline_misses")
            ticket._fail(DeadlineExceeded(name, 0.0))
            return ticket
        if self._pool is not None:
            # the pool counts shed/deadline misses itself; stats() merges
            self._pool.submit(name, inputs, ticket)
            return ticket
        q = self._queue.setdefault(name, [])
        if len(q) >= self.max_queue:
            self._count(name, "shed")
            _trace.instant("shed", "serving", trace_id=ticket.trace_id,
                           args={"model": name, "depth": len(q)})
            st = self._stats.get(name) or {}
            est = st.get("latency_ms", 10.0) or 10.0
            raise Overloaded(name, len(q), max(
                1.0, est * (len(q) / max(1, self.max_batch))))
        q.append((inputs, ticket))
        self._queue_depth += 1
        return ticket

    def _resolve(self, ticket: Ticket, timeout: Optional[float]) -> None:
        """Block until a ticket terminates: waits on the worker pool, or
        drains *only that ticket's model* in synchronous mode (a slow
        unrelated model never blocks an independent result)."""
        if self._pool is not None:
            ticket._event.wait(timeout)
            return
        try:
            self.flush(ticket.name)
        except FlushError:
            pass          # the ticket's own stored error is re-raised

    def _cancel(self, ticket: Ticket) -> bool:
        """:meth:`Ticket.cancel` body: settle the ticket ``Cancelled``
        (first-wins — a real result that already landed stands) and
        free its queue slot so a cancelled request stops holding
        admission capacity."""
        won = ticket._fail(Cancelled(ticket.name))
        if won:
            self._count(ticket.name, "cancelled")
            _trace.instant("cancel", "serving", trace_id=ticket.trace_id,
                           args={"model": ticket.name})
        # purge the queue slot either way: a settled ticket would be
        # skipped on claim, but its heap entry still occupies capacity
        if self._pool is not None:
            self._pool.discard(ticket.name, ticket)
        else:
            q = self._queue.get(ticket.name)
            if q:
                n0 = len(q)
                q[:] = [e for e in q if e[1] is not ticket]
                self._queue_depth -= n0 - len(q)
        return won

    # -- robust batch execution (shared by sync flush and the pool) ---------
    def _plan_run(self, name: str, model: CompiledModel, feeds,
                  worker=None, trace_ids=None) -> List[Outputs]:
        """One batch through the model's plan: the worker's own arena,
        on the worker's stream, synchronized before this returns; in a
        process pool, through the worker's child process (its outputs
        as CPU tensors too)."""
        c = _chaos.active()
        if c is not None:
            c.check_plan(name)
        pool = self._pool
        if pool is not None and pool.mode == "process" \
                and worker is not None:
            # normalize here (run_many's client-error contract) so the
            # child only ever sees clean single-sample numpy dicts
            feeds = model._single_samples(feeds)
            feeds = [{k: _host(v) for k, v in f.items()} for f in feeds]
            return pool.remote_run(worker, name, feeds,
                                   trace_ids=trace_ids)
        return _served(model, feeds, owner=worker)

    def _degraded_run(self, model: CompiledModel, feeds) -> List[Outputs]:
        """A CPU session's breaker-open path: the batch through the
        interpretive oracle engine on the host, one sample at a time, as
        CPU tensors."""
        model._require_semantics()
        return [{k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in model._run_one(model._normalize(f),
                                            False).items()}
                for f in feeds]

    # -- breaker recovery (background probe, off the request path) ----------
    def _schedule_probe(self, name: str, delay_s: float) -> None:
        """Arm (at most) one background re-lower+verify probe timer for
        a tripped model — recovery no longer piggybacks on request
        batches, so an idle model heals too."""
        if self.closed:
            return
        with self._probe_lock:
            if name in self._probe_timers:
                return
            t = threading.Timer(max(0.01, delay_s), self._probe,
                                args=(name,))
            t.daemon = True
            self._probe_timers[name] = t
            t.start()

    def _probe(self, name: str) -> None:
        """Half-open probe body: re-lower the plan from scratch and
        verify it against the interpretive oracle; success closes the
        breaker, failure re-opens it and re-arms the timer."""
        with self._probe_lock:
            self._probe_timers.pop(name, None)
        if self.closed:
            return
        model = self._models.get(name)
        br = self._breakers.get(name)
        if model is None or br is None:
            return
        if not br.try_probe():
            if br.state == "open":     # cooldown not yet elapsed
                self._schedule_probe(name, self.breaker_cooldown_s / 2)
            return
        try:
            c = _chaos.active()
            if c is not None:
                c.check_plan(name)
            model.invalidate_plans()
            feed = {t.name: np.zeros(t.shape, dtype=np.float32)
                    for t in model.graph.inputs}
            model.verify(feed)
        except Exception:
            br.probe_failed()
            self._count(name, "failed_recoveries")
            self._schedule_probe(name, self.breaker_cooldown_s)
        else:
            br.probe_succeeded()
            self._count(name, "recoveries")

    def _crash_redispatch(self, name: str, entries,
                          err: WorkerCrashed) -> None:
        """A worker *process* died with this batch in flight: hand the
        still-live entries back to the pool for the survivors.  No
        ticket fails, nothing counts against the breaker — the crash is
        a fault-domain event, not a model fault (first-fulfillment-wins
        tickets settle any duplicated work)."""
        self._count(name, "crash_redispatches")
        _trace.instant("worker_crashed", "fault",
                       args={"model": name, "worker": err.worker,
                             "n": len(entries)})
        if self._pool is not None:
            self._pool.redispatch(name, entries, err.worker)
        else:                      # sync session: no pool to re-home to
            for _, ticket in entries:
                ticket._fail(err)
        return None

    def _frame_redispatch(self, name: str, entries,
                          err: FrameCorrupt) -> None:
        """A pipe frame failed its CRC: the batch's bytes are
        untrusted but the worker and its stream are intact (the
        transport is length-prefixed — corruption can't desync it).
        Re-dispatch the batch so a healthy worker serves it; no ticket
        fails, nothing counts against the breaker, nobody recycles."""
        self._count(name, "frame_corrupt")
        _trace.instant("frame_redispatch", "fault",
                       args={"model": name, "worker": err.worker,
                             "n": len(entries)})
        if self._pool is not None:
            self._pool.redispatch(name, entries, err.worker)
        else:                      # sync session: no pool to re-home to
            for _, ticket in entries:
                ticket._fail(err)
        return None

    def _execute_entries(self, name: str, entries, worker=None
                         ) -> Optional[BaseException]:
        """Execute one claimed batch, fulfilling or failing every ticket
        in ``entries``; never raises.  The degradation ladder: plan
        engine -> one retry with backoff (transient faults) -> circuit
        breaker trips after K consecutive batch failures -> interpretive
        oracle engine (slow but correct) until a re-lower probe
        recovers (on a CUDA session the open breaker fails the batch
        fast with ``BreakerOpen`` instead).  Returns the batch error, if
        any."""
        model = self._models[name]
        br = self._breaker(name)
        feeds = [feed for feed, _ in entries]
        trace_ids = [t.trace_id for _, t in entries]
        outs = None
        err: Optional[BaseException] = None
        moved: Optional[BaseException] = None   # back to the pool
        engine = "plan"
        tracer = _trace.active()
        t0 = time.monotonic()
        if tracer is not None:
            tracer.set_batch(_trace.new_batch_id())
            phase = tracer.phase("batch", t0)
            # queue wait: submit (on the caller's thread) -> execution
            # start, as async b/e pairs keyed by trace id so the
            # cross-thread interval never distorts thread nesting
            for _, ticket in entries:
                tracer.complete("queue_wait", "async:serving",
                                ticket.submitted_at, t0,
                                trace_id=ticket.trace_id,
                                args={"model": name})
        for _, ticket in entries:
            self._m_queue_wait.observe(
                (t0 - ticket.submitted_at) * 1e3, model=name)
        if br.allow_plan():
            try:
                outs = self._plan_run(name, model, feeds, worker,
                                      trace_ids)
            except (WorkerCrashed, FrameCorrupt) as e:
                moved = e
            except _CLIENT_ERRORS as e:
                err = e
            except Exception:
                # transient server-side fault: one retry with backoff
                self._count(name, "retries")
                time.sleep(self.retry_backoff_s)
                try:
                    outs = self._plan_run(name, model, feeds, worker,
                                          trace_ids)
                except (WorkerCrashed, FrameCorrupt) as e2:
                    moved = e2
                except Exception as e2:
                    err = e2
            if moved is not None:
                if tracer is not None:
                    tracer.set_batch(None)
                if isinstance(moved, WorkerCrashed):
                    return self._crash_redispatch(name, entries, moved)
                return self._frame_redispatch(name, entries, moved)
            if outs is not None:
                br.record_success()
            elif not isinstance(err, _CLIENT_ERRORS):
                self._count(name, "plan_failures")
                if br.record_failure():
                    self._count(name, "breaker_trips")
                    self._schedule_probe(name, self.breaker_cooldown_s)
        elif model.device.type == "cuda":
            # breaker open on the card: fail fast with a retry hint, and
            # never move the work to the host (the recovery probe runs
            # on its own timer, never on this request path)
            engine = "none"
            err = BreakerOpen(name, br.retry_after_ms())
            self._count(name, "breaker_rejects", len(feeds))
            self._schedule_probe(name, self.breaker_cooldown_s)
        else:
            # breaker open on the CPU: serve correct (oracle) outputs,
            # slowly, instead of failing — graceful degradation
            engine = "interp"
            try:
                outs = self._degraded_run(model, feeds)
                self._count(name, "degraded_requests", len(feeds))
            except _CLIENT_ERRORS as e:
                err = e
            except Exception as e:
                err = e
                br.record_failure()
            self._schedule_probe(name, self.breaker_cooldown_s)
        dt = time.monotonic() - t0
        self._m_service.observe(dt * 1e3, model=name)
        if tracer is not None:
            phase.end(t0 + dt, model=name, n=len(entries), engine=engine,
                      ok=err is None)
        with self._stats_lock:
            st = self._model_stats(name)
            st["batches"] += 1
            st["batched_requests"] += len(entries)
            st["max_batch_seen"] = max(st["max_batch_seen"], len(entries))
            st["requests"] += len(entries)
            st["run_s"] += dt
            st["engine"] = engine
        done_t = time.monotonic()
        if tracer is not None:
            # settlement: after `done_t`, where the `serve` spans end
            phase = tracer.phase("settle")
        if err is not None:
            for _, ticket in entries:
                ticket._fail(err)
        else:
            c = _chaos.active()
            if c is not None and c.maybe_corrupt_output(name, self.tag):
                # silent corruption: serve *wrong bytes* with no error —
                # the fault class only the fleet's interp-oracle audit
                # sampler can catch (and quarantine the replica for)
                outs = [_chaos.flip_outputs(o) for o in outs]
            hist = self._hist(name)
            for (_, ticket), out in zip(entries, outs):
                if ticket._fulfill(out):
                    hist.record((done_t - ticket.submitted_at) * 1e3)
                    if tracer is not None:
                        # one span per request over its execution
                        # window, carrying the trace id — the
                        # cross-thread hop the exporter stitches flow
                        # arrows through
                        tracer.complete("serve", "serving", t0, done_t,
                                        trace_id=ticket.trace_id,
                                        args={"model": name,
                                              "engine": engine})
        if tracer is not None:
            phase.end()
            tracer.set_batch(None)
        return err

    def flush(self, name: Optional[str] = None, timeout: float = 60.0
              ) -> int:
        """Drain the coalescing queue — all models, or just ``name``.
        Returns the number of requests executed.

        Every model's queue is drained even when an earlier model's
        batch fails: one aggregated :class:`FlushError` (mapping each
        failed model to its typed error) is raised *after* the drain,
        so one bad model never strands another model's tickets.
        Expired tickets fail with ``DeadlineExceeded`` without
        executing.  On pooled sessions this is a barrier: it waits for
        the workers to drain the selected queues."""
        if self._pool is not None:
            if not self._pool.drain(None if name is None else {name},
                                    timeout=timeout):
                raise FlushError({name or "*": TimeoutError(
                    f"pool did not drain within {timeout}s")})
            return 0
        executed = 0
        errors: Dict[str, BaseException] = {}
        names = list(self._queue) if name is None else \
            ([name] if name in self._queue else [])
        for n in names:
            entries = self._queue.pop(n, [])
            self._queue_depth -= len(entries)
            now = _chaos.now()
            live = []
            for feed, ticket in entries:
                if ticket.deadline is not None and now > ticket.deadline:
                    self._count(n, "deadline_misses")
                    ticket._fail(DeadlineExceeded(
                        n, (now - ticket.deadline) * 1e3))
                else:
                    live.append((feed, ticket))
            for i in range(0, len(live), self.max_batch):
                group = live[i:i + self.max_batch]
                err = self._execute_entries(n, group)
                if err is not None:
                    errors[n] = err
                else:
                    executed += len(group)
        if errors:
            raise FlushError(errors)
        return executed

    @property
    def queue_depth(self) -> int:
        if self._pool is not None:
            return self._pool.queue_depth()
        return self._queue_depth

    # -- metrics exposition -------------------------------------------------
    _BREAKER_STATES = {"closed": 0, "half_open": 1, "open": 2}
    _MODEL_COUNTERS = (
        ("requests", "repro_requests_total", "requests served"),
        ("run_s", "repro_run_seconds_total", "wall time executing"),
        ("batches", "repro_batches_total", "batches executed"),
        ("batched_requests", "repro_batched_requests_total",
         "requests served through batches"),
        ("shed", "repro_shed_total", "requests shed by admission control"),
        ("deadline_misses", "repro_deadline_misses_total",
         "tickets expired before execution"),
        ("degraded_requests", "repro_degraded_requests_total",
         "requests served by the interpretive oracle (breaker open)"),
        ("frame_corrupt", "repro_frame_corrupt_total",
         "batches re-dispatched after a corrupt pipe frame"),
        ("crash_redispatches", "repro_crash_redispatches_total",
         "batches re-dispatched after a worker-process crash"),
        ("breaker_rejects", "repro_breaker_rejects_total",
         "requests failed fast by an open breaker (CUDA sessions)"),
        ("retries", "repro_retries_total",
         "retries: transient batch + client-side submit"),
        ("submit_retries", "repro_submit_retries_total",
         "client-side submit retries after Overloaded sheds"),
        ("cancelled", "repro_cancelled_total",
         "tickets cancelled by the caller"),
        ("plan_failures", "repro_plan_failures_total",
         "plan-engine batch failures"),
        ("breaker_trips", "repro_breaker_trips_total",
         "circuit breaker trips"),
        ("recoveries", "repro_recoveries_total",
         "successful re-lower recovery probes"),
        ("failed_recoveries", "repro_failed_recoveries_total",
         "failed re-lower recovery probes"),
    )

    def _collect_metrics(self) -> None:
        """Render-time collector: mirror every dict-based counter — the
        per-model stats, the breaker states, the pool's counters and
        worker health, the program cache's tier stats — into registry
        families.  The dicts stay the source of truth (and the
        ``stats()`` surface); the registry is the exposition surface."""
        reg = self.registry
        pool = self._pool
        with self._stats_lock:
            snap = {n: dict(s) for n, s in self._stats.items()}
        for key, metric, help in self._MODEL_COUNTERS:
            fam = reg.counter(metric, help, ("model",))
            for n, st in snap.items():
                v = st.get(key, 0)
                if key == "shed" and pool is not None:
                    v += pool.shed.get(n, 0)
                elif key == "deadline_misses" and pool is not None:
                    v += pool.deadline_misses.get(n, 0)
                elif key == "retries":
                    # repro_retries_total is the satellite's umbrella:
                    # transient batch retries + client submit retries
                    # (broken out in repro_submit_retries_total)
                    v += st.get("submit_retries", 0)
                fam.set_total(v, model=n)
        compiles = reg.counter("repro_compiles_total",
                               "model compiles by cache tier",
                               ("model", "tier"))
        modeled = reg.gauge("repro_modeled_latency_ms",
                            "cost-model predicted latency", ("model",))
        for n, st in snap.items():
            for tier, v in st.get("compiles", {}).items():
                compiles.set_total(v, model=n, tier=tier)
            if "latency_ms" in st:
                modeled.set(st["latency_ms"], model=n)
        breaker = reg.gauge(
            "repro_breaker_state",
            "circuit breaker state (0=closed 1=half_open 2=open)",
            ("model",))
        for n, br in self._breakers.items():
            breaker.set(self._BREAKER_STATES.get(br.state, -1), model=n)
        reg.gauge("repro_queue_depth",
                  "requests queued, all models").set(self.queue_depth)
        reg.gauge("repro_pinned_models",
                  "models pinned in the program cache"
                  ).set(len(self._pinned))
        info = program_cache_info()
        cache_ev = reg.counter("repro_program_cache_total",
                               "program cache events", ("event",))
        for ev in ("mem_hits", "mem_misses", "mem_evictions",
                   "disk_hits", "disk_misses", "disk_writes",
                   "disk_rejects", "disk_evictions"):
            cache_ev.set_total(info.get(ev, 0), event=ev)
        cache_sz = reg.gauge("repro_program_cache_entries",
                             "programs cached", ("tier",))
        cache_sz.set(info.get("entries", 0), tier="memory")
        cache_sz.set(info.get("disk_entries", 0), tier="disk")
        cache_b = reg.gauge("repro_program_cache_bytes",
                            "program cache resident bytes", ("tier",))
        cache_b.set(info.get("bytes", 0), tier="memory")
        cache_b.set(info.get("disk_bytes", 0), tier="disk")
        if pool is not None:
            pc = reg.counter("repro_pool_total",
                             "worker pool events", ("event",))
            for ev, v in pool.counters.items():
                pc.set_total(v, event=ev)
            reg.gauge("repro_pool_workers", "live pool workers").set(
                len([w for w in pool._workers.values()
                     if not w.abandoned]))
            alive = reg.gauge("repro_worker_alive",
                              "worker thread liveness", ("worker",))
            wbatch = reg.counter("repro_worker_batches_total",
                                 "batches served per worker", ("worker",))
            wreq = reg.counter("repro_worker_requests_total",
                               "requests served per worker", ("worker",))
            wpid = None
            if pool.mode == "process":
                wpid = reg.gauge("repro_worker_pid",
                                 "worker process id (-1 = not ready)",
                                 ("worker",))
            for wid, h in pool.worker_health().items():
                if wpid is not None:
                    wpid.set(h.get("pid") or -1, worker=wid)
                alive.set(1 if h["alive"] and not h["abandoned"] else 0,
                          worker=wid)
                wbatch.set_total(h["batches"], worker=wid)
                wreq.set_total(h["requests"], worker=wid)

    def metrics(self) -> str:
        """The session's metrics registry as Prometheus text exposition
        — request latency / queue wait / batch service summaries,
        shed/deadline/breaker/retry counters, program-cache tier stats,
        pool counters and worker health."""
        return self.registry.render()

    # -- reporting ----------------------------------------------------------
    def stats(self) -> dict:
        pool = self._pool
        models = {}
        with self._stats_lock:
            snap = {n: dict(s) for n, s in self._stats.items()}
        for n, d in snap.items():
            if n in self._models:
                d["plan"] = self._models[n].plan_cache_info()
            if n in self._breakers:
                d["breaker"] = self._breakers[n].snapshot()
            if n in self._hists:
                d["latency"] = self._hists[n].snapshot()
            if pool is not None:
                d["shed"] += pool.shed.get(n, 0)
                d["deadline_misses"] += pool.deadline_misses.get(n, 0)
            models[n] = d
        out = {"models": models,
               "pinned": self.pinned(),
               "queue_depth": self.queue_depth,
               "max_batch": self.max_batch,
               "max_queue": self.max_queue,
               "program_cache": program_cache_info()}
        if pool is not None:
            out["pool"] = pool.stats()
            out["workers"] = pool.worker_health()
        return out

    def report(self) -> str:
        cache = program_cache_info()
        lines = [f"Session: {len(self._models)} model(s), "
                 f"cache {cache['entries']} entries in memory "
                 f"({cache['pinned_entries']} pinned)"
                 + (f", disk tier at {cache['disk_dir']}"
                    if cache["disk_dir"] else ", no disk tier")]
        stats = self.stats()["models"]
        for n, st in stats.items():
            tiers = st["compiles"]
            pin_mark = "*" if n in self._pinned else " "
            lines.append(
                f" {pin_mark}{n:<24} [{st['precision']:>7}]  "
                f"{st['requests']:>5} reqs "
                f"({st['batched_requests']} in {st['batches']} batches)  "
                f"modeled {st['latency_ms']:.3f} ms  "
                f"compiles solved/mem/disk/artifact = "
                f"{tiers['solved']}/{tiers['memory']}/{tiers['disk']}"
                f"/{tiers['artifact']}")
            lat = st.get("latency")
            br = st.get("breaker")
            if lat and lat["count"]:
                lines.append(
                    f"   {'':24} served p50 {lat['p50_ms']:.2f} ms / "
                    f"p99 {lat['p99_ms']:.2f} ms"
                    + (f"  breaker {br['state']}"
                       f" (trips {br['trips']})" if br else "")
                    + (f"  shed {st['shed']}" if st["shed"] else "")
                    + (f"  deadline-miss {st['deadline_misses']}"
                       if st["deadline_misses"] else "")
                    + (f"  degraded {st['degraded_requests']}"
                       if st["degraded_requests"] else "")
                    + (f"  breaker-rejects {st['breaker_rejects']}"
                       if st["breaker_rejects"] else ""))
            qw = self._m_queue_wait.labels(model=n)
            sv = self._m_service.labels(model=n)
            if qw.count and sv.count:
                # where a request's time went: waiting for its batch to
                # form vs executing in it
                lines.append(
                    f"   {'':24} breakdown queue-wait p50 "
                    f"{qw.percentile(50):.2f} / p99 "
                    f"{qw.percentile(99):.2f} ms  |  service p50 "
                    f"{sv.percentile(50):.2f} / p99 "
                    f"{sv.percentile(99):.2f} ms")
        if self._pool is not None:
            ps = self._pool.stats()
            lines.append(
                f"  pool: {ps['workers']} workers, "
                f"{ps['dispatched_batches']} batches dispatched, "
                f"{ps['recycled_workers']} recycled, "
                f"{ps['redispatched_batches']} re-dispatched, "
                f"{ps['speculative_backups']} speculative backups")
        return "\n".join(lines)
