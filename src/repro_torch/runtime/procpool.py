"""Process-level fault isolation for the serving runtime.

Counterpart of ``repro/runtime/procpool.py``.  :class:`ProcPool` is
:class:`~repro_torch.runtime.serving.ServerPool` with the execution fault
domain moved out of the parent: each worker id owns a real OS *process*,
started with ``spawn`` (a forked child of a parent that holds a CUDA
context cannot use the card), that opens every registered model's
``.rpa`` artifact with ``mmap=True`` on the session's device, lowers its
own plans and serves batches over a length-prefixed pipe protocol.  A
segfault-class fault, an OOM kill, a runaway kernel or a poisoned CUDA
context in one worker leaves every other worker — and the parent —
serving.

On CUDA each child holds its own CUDA context and its own device copy of
the weights and plan constants (no CUDA IPC: the artifact's host pages
are shared through the page cache, the device copies are not).  The
parent builds the kernel libraries before the first spawn
(``ServerPool`` calls ``_build.build_all()``), so a child loads them and
never runs nvcc.  A child answers ``ready`` only after it has loaded its
models, lowered every batch bucket up to the pool's ``max_batch`` and
run one warm batch (kernel libraries loaded, arenas allocated), because
a batch in progress is silent and the parent supervises that silence.
Inputs go to the device once, in the child; outputs come back to the
host once, into the ``res`` frame's blobs, and the parent resolves
tickets to CPU tensors, as the thread pool does.

A batch that raises a CUDA error is then tested by
:func:`device_context_lost`: when a synchronize of the device still
raises, the error was sticky (an illegal address, a trap), every later
batch of that context would fail too, and the child exits with
:data:`DEVICE_LOST_EXIT`.  The parent sees the batch in flight on a dead
child, raises :class:`~repro_torch.runtime.serving.WorkerCrashed`,
re-dispatches the batch to the survivors, and the supervisor spawns a
fresh process (a fresh context).  A child never falls back to the CPU:
one whose device cannot be opened reports the load error, which
:meth:`ProcPool.register_model` raises and ``worker_health()`` shows.

Wire protocol (parent <-> child, one duplex pipe per worker)
------------------------------------------------------------

Every message is one *frame*::

    b"rpa2" | u32 header_len | u32 crc32 | header JSON | raw blobs

where ``crc32`` covers everything after itself (header + blobs).  The
pipe transport is length-prefixed, so a flipped bit in transit can
never desynchronize framing — it corrupts one frame's *payload*.  The
CRC turns that into a typed, attributable fault:
:func:`unpack_frame` raises :class:`~repro.runtime.serving.
FrameCorrupt` carrying the frame's header (headers that still parse
identify the pending request), the reader fails *only that batch*, and
the executor re-dispatches it to a healthy worker.  Only a frame whose
header is itself unreadable degrades to :class:`ProtocolError` and a
worker recycle.

The header carries the frame type plus an ``arrays`` manifest
(name/dtype/shape per blob, in blob order); request frames thread the
batch's ticket **trace ids** through so child-side spans attribute to
the originating requests.  Frame types:

== =========================================================
``ready``  child finished loading its models (pid, model list, device,
           kernel launch counts)
``hb``     child heartbeat, idle or loading a model (the *only* idle
           liveness signal)
``run``    parent -> child: one stacked batch (+ trace ids)
``res``    child -> parent: stacked outputs for a ``run`` (and the
           child's kernel launch counts)
``err``    child -> parent: typed execution error for a ``run``
``load``   parent -> child: register one more model artifact; the
           child answers ``loaded`` (with the load error, if any)
``crash``  parent -> child: die *now* (chaos trampoline: segv/oom)
``spans``  round-trip: child exports its tracer ring for merging
``close``  parent -> child: drain and exit; child answers ``bye``
== =========================================================

Crash-fault supervision
-----------------------

The parent extends the pool's heartbeat supervision with *real* process
liveness: a worker is dead when its pipe EOFs or its exitcode is set
(``_extra_dead_locked``), not only when beats go stale — and idle beats
come exclusively from child ``hb`` frames (``_idle_beat`` is a no-op
here), so a hung-but-alive child goes heartbeat-stale even while the
parent-side dispatcher thread is healthy.  On death the dispatcher's
in-flight ``remote_run`` fails with :class:`~repro.runtime.serving.
WorkerCrashed`; the executor re-dispatches the batch to the survivors
(never failing tickets — first-fulfillment-wins settles duplicates) and
the supervisor respawns a replacement process *off the request path* (a
launcher thread; dispatch gates on ``_worker_ready`` until the child
reports ready).  Zero ticket loss under worker murder is pinned by
``tests/test_torch_procpool.py`` and ``chip_smoke.py`` phase 17.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import multiprocessing as mp
import os
import signal
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import trace as _trace
from . import chaos as _chaos
from .serving import FrameCorrupt, ServerPool, ServingError, WorkerCrashed

FRAME_MAGIC = b"rpa2"
_U32 = struct.Struct("<I")
#: magic(4) | header_len u32 | crc32 u32
_HDR_OFF = 12


class ProtocolError(ServingError):
    """A pipe frame failed to parse (bad magic / truncated / unreadable
    header): the endpoints have desynchronized and the worker must be
    recycled.  A frame that *parses* but fails its CRC raises
    :class:`~repro.runtime.serving.FrameCorrupt` instead — an
    attributable single-batch fault, not a stream fault."""


def _frame_shell(header: dict, metas: List[dict],
                 payload: int) -> Tuple[bytearray, int]:
    """Allocate a frame buffer with magic + JSON header written; returns
    ``(frame, offset_of_first_blob)``.  The CRC field is zero until
    :func:`_seal_frame` stamps it (after the blobs are written)."""
    h = dict(header)
    if metas:
        h["arrays"] = metas
    hb = json.dumps(h, separators=(",", ":")).encode()
    frame = bytearray(_HDR_OFF + len(hb) + payload)
    frame[0:4] = FRAME_MAGIC
    _U32.pack_into(frame, 4, len(hb))
    frame[_HDR_OFF:_HDR_OFF + len(hb)] = hb
    return frame, _HDR_OFF + len(hb)


def _seal_frame(frame: bytearray) -> bytearray:
    """Stamp the frame's CRC32 over header + blobs (everything after
    the CRC field itself)."""
    crc = zlib.crc32(memoryview(frame)[_HDR_OFF:]) & 0xFFFFFFFF
    _U32.pack_into(frame, 8, crc)
    return frame


def pack_frame(header: dict,
               arrays: Optional[Dict[str, np.ndarray]] = None
               ) -> bytearray:
    """Serialize one frame: magic, u32 length-prefixed JSON header,
    then each array's raw bytes (C-contiguous) in manifest order —
    written straight into one preallocated buffer (per-array
    ``tobytes`` + join would copy every payload twice; the saturated
    1-core serving path feels that)."""
    metas: List[dict] = []
    blobs: List[np.ndarray] = []
    total = 0
    for name, arr in (arrays or {}).items():
        a = np.asarray(arr)
        if a.ndim and not a.flags.c_contiguous:
            a = np.ascontiguousarray(a)   # would promote 0-d to (1,)
        metas.append({"name": name, "dtype": str(a.dtype),
                      "shape": list(a.shape)})
        blobs.append(a)
        total += a.nbytes
    frame, off = _frame_shell(header, metas, total)
    mv = memoryview(frame)
    for a in blobs:
        n = a.nbytes
        if n:
            mv[off:off + n] = a.data.cast("B") if a.ndim else a.tobytes()
        off += n
    return _seal_frame(frame)


def pack_run_frame(header: dict, feeds: List[Dict[str, np.ndarray]]
                   ) -> bytearray:
    """Serialize a batch of per-request feeds as one stacked run frame,
    stacking each input *directly into the wire buffer* (a separate
    ``np.stack`` + ``pack_frame`` pass would copy the batch three
    times).  The child unpacks it as ordinary stacked arrays."""
    keys = list(feeds[0])
    metas: List[dict] = []
    rows: Dict[str, List[np.ndarray]] = {}
    total = 0
    for k in keys:
        rs = []
        for f in feeds:
            a = np.asarray(f[k])
            if a.ndim and not a.flags.c_contiguous:
                a = np.ascontiguousarray(a)
            rs.append(a)
        rows[k] = rs
        metas.append({"name": k, "dtype": str(rs[0].dtype),
                      "shape": [len(rs)] + list(rs[0].shape)})
        total += rs[0].nbytes * len(rs)
    frame, off = _frame_shell(header, metas, total)
    for k in keys:
        for r in rows[k]:
            n = r.nbytes
            if n:
                stacked = np.frombuffer(frame, r.dtype.base, r.size, off)
                np.copyto(stacked, r.reshape(-1), casting="no")
            off += n
    return _seal_frame(frame)


def unpack_frame(buf: bytes, copy: bool = True
                 ) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Parse one frame back into (header, arrays); raises
    :class:`ProtocolError` on any structural mismatch.

    ``copy=False`` returns read-only views into ``buf`` (the views keep
    it alive) — right for the parent's result path, where rows are
    sliced per ticket anyway; the child copies so kernels get aligned,
    writable activations.

    Integrity: the frame's CRC32 is verified first.  A mismatch raises
    :class:`~repro.runtime.serving.FrameCorrupt` carrying the parsed
    header when the corruption spared it (the caller fails just that
    frame's batch); only an unreadable header — framing itself
    untrustworthy — raises :class:`ProtocolError`."""
    mv = memoryview(buf)
    if len(mv) < _HDR_OFF or bytes(mv[:4]) != FRAME_MAGIC:
        raise ProtocolError("bad frame magic")
    (hlen,) = _U32.unpack_from(mv, 4)
    (want_crc,) = _U32.unpack_from(mv, 8)
    if _HDR_OFF + hlen > len(mv):
        raise ProtocolError(f"truncated header ({hlen} declared, "
                            f"{len(mv) - _HDR_OFF} available)")
    crc_ok = (zlib.crc32(mv[_HDR_OFF:]) & 0xFFFFFFFF) == want_crc
    try:
        header = json.loads(bytes(mv[_HDR_OFF:_HDR_OFF + hlen]).decode())
    except ValueError as e:
        if not crc_ok:
            raise ProtocolError(
                "corrupt frame with unreadable header (crc mismatch)"
            ) from None
        raise ProtocolError(f"unparseable header: {e}") from None
    if not crc_ok:
        raise FrameCorrupt(
            detail=f"crc mismatch on {header.get('type')!r} frame",
            header=header)
    off = _HDR_OFF + hlen
    arrays: Dict[str, np.ndarray] = {}
    for m in header.pop("arrays", ()):
        dt = np.dtype(m["dtype"])
        shape = tuple(int(s) for s in m["shape"])
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        if off + n > len(mv):
            raise ProtocolError(f"truncated blob {m['name']!r}")
        arr = np.frombuffer(mv[off:off + n], dtype=dt).reshape(shape)
        arrays[m["name"]] = arr.copy() if copy else arr
        off += n
    if off != len(mv):
        raise ProtocolError(f"{len(mv) - off} trailing bytes")
    return header, arrays


# --------------------------------------------------------------------------
# Child process
# --------------------------------------------------------------------------

#: exit status of a child whose CUDA context a sticky device fault
#: poisoned (the parent sees a crash and re-dispatches the batch)
DEVICE_LOST_EXIT = 75
#: how long ``register_model`` waits for the live children to load,
#: lower and warm a model (a CUDA child's boot alone takes seconds)
LOAD_TIMEOUT_S = 300.0


def _is_cuda_error(err: BaseException) -> bool:
    """Whether ``err`` (or an exception it was raised from) is a CUDA
    error: torch's ``AcceleratorError`` or a message naming one, as the
    kernel wrappers' launch checks and torch's own do."""
    seen = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        if type(err).__name__ == "AcceleratorError" or \
                "CUDA error" in str(err):
            return True
        err = err.__cause__ or err.__context__
    return False


def device_context_lost(err: BaseException, synchronize) -> bool:
    """Whether the batch error ``err`` left its CUDA context unusable: it
    is a CUDA error, and ``synchronize()`` (``torch.cuda.synchronize`` of
    the batch's device) still raises.  An asynchronous fault (an illegal
    address, a trap) is sticky, so the synchronize raises again; a
    launch that was refused (a bad configuration) is not, and the
    synchronize returns."""
    if not _is_cuda_error(err):
        return False
    try:
        synchronize()
    except RuntimeError:
        return True
    return False


def _launch_counts() -> Dict[str, int]:
    """This process's kernel launches so far, by kernel wrapper."""
    from repro_torch.kernels import (flash_attention, flash_decode,
                                     neutron_matmul, ssd_scan)
    return {m.__name__.rsplit(".", 1)[1]: int(m.launches)
            for m in (neutron_matmul, flash_attention, flash_decode,
                      ssd_scan)}


class _Beating:
    """While the child loads a model it answers nothing, so this context
    sends ``hb`` frames from a thread every ``every`` seconds: a load is
    not a hung batch.  ``send`` must be safe to call from two threads."""

    def __init__(self, send, every: float):
        self._send, self._every = send, every
        self._stop = threading.Event()
        self._t: Optional[threading.Thread] = None

    def _loop(self) -> None:
        while not self._stop.wait(self._every):
            try:
                self._send({"type": "hb", "seq": 0})
            except (BrokenPipeError, OSError):
                return

    def __enter__(self) -> "_Beating":
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._t.join()


def _warm(model, max_batch: int) -> None:
    """Lower every batch bucket up to ``max_batch`` (arena allocated on
    the device) and run one warm batch of zeros through the largest, so
    that no served batch of the child loads a kernel library or lowers."""
    from repro_torch.api.compiled import PLAN_BUCKETS
    top = next((b for b in PLAN_BUCKETS if b >= max_batch), PLAN_BUCKETS[-1])
    for b in PLAN_BUCKETS:
        if b <= top:
            model.plan_for(b)
    feed = {t.name: np.zeros((top,) + t.shape, dtype=np.float32)
            for t in model.graph.inputs}
    model._run_plan_batch(feed, top)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)


def _worker_main(conn, wid: int, model_paths: Dict[str, str],
                 hb_every: float, trace_capacity: int, device: str,
                 max_batch: int, threads: int) -> None:
    """Worker process entry: load the artifacts onto ``device``, lower
    and warm them, report ready, then serve ``run`` frames until
    ``close`` (heartbeating while idle — a batch in progress is
    *silent*, which is exactly the staleness signature the parent
    supervises).  ``threads`` is the child's share of the parent's torch
    threads for its CPU work: every child taking all the cores, their
    parallel regions spin against each other."""
    from repro_torch.api.compiled import CompiledModel

    torch.set_num_threads(threads)
    dev = torch.device(device)
    tracer = _trace.enable(capacity=trace_capacity) \
        if trace_capacity else None
    models: Dict[str, object] = {}
    load_errors: Dict[str, str] = {}
    send_lock = threading.Lock()

    def send(header: dict, arrays=None) -> None:
        frame = pack_frame(header, arrays)
        with send_lock:
            conn.send_bytes(frame)

    def _load(name: str, path: str) -> None:
        try:
            model = CompiledModel.load(path, mmap=True, device=dev)
            if model.semantics is not None:
                _warm(model, max_batch)
            models[name] = model
            load_errors.pop(name, None)
        except Exception as e:
            load_errors[name] = f"{type(e).__name__}: {e}"

    with _Beating(send, hb_every):
        for name, path in model_paths.items():
            _load(name, path)
    send({"type": "ready", "wid": wid, "pid": os.getpid(),
          "device": str(dev), "models": sorted(models),
          "errors": dict(load_errors), "launches": _launch_counts()})

    seq = 0
    while True:
        try:
            if not conn.poll(hb_every):
                send({"type": "hb", "seq": seq})
                continue
            buf = conn.recv_bytes()
        except (EOFError, OSError):
            return
        try:
            header, arrays = unpack_frame(buf)
        except FrameCorrupt as e:
            # a run frame arrived with flipped payload bits: refuse to
            # execute untrusted inputs, answer a typed error so the
            # parent fails (and re-dispatches) only this batch
            req = (e.header or {}).get("req")
            if req is not None:
                send({"type": "err", "req": req, "cls": "FrameCorrupt",
                      "msg": str(e)})
            continue
        kind = header.get("type")
        if kind == "close":
            try:
                send({"type": "bye"})
            except (BrokenPipeError, OSError):
                pass
            return
        if kind == "crash":
            # chaos trampoline: die the way real faults do, not via a
            # Python exception the frame loop could catch
            mode = header.get("mode", "oom")
            if mode == "segv":
                signal.signal(signal.SIGSEGV, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGSEGV)
            os._exit(137)          # OOM-killed exit status
        if kind == "load":
            with _Beating(send, hb_every):
                _load(header["model"], header["path"])
            send({"type": "loaded", "model": header["model"],
                  "error": load_errors.get(header["model"]),
                  "launches": _launch_counts()})
            continue
        if kind == "spans":
            doc = tracer.chrome_trace() if tracer is not None \
                else {"traceEvents": []}
            send({"type": "spans", "req": header["req"],
                  "epoch": tracer.epoch if tracer is not None else 0.0,
                  "pid": os.getpid(), "doc": doc})
            continue
        if kind != "run":
            continue               # unknown frame: ignore, stay alive
        req = header["req"]
        name = header["model"]
        n = int(header["n"])
        ids = header.get("trace_ids") or []
        seq += 1
        t0 = time.monotonic()
        try:
            model = models.get(name)
            if model is None:
                raise RuntimeError(
                    f"worker {wid}: model {name!r} unavailable"
                    + (f" ({load_errors[name]})"
                       if name in load_errors else ""))
            # one copy of each output to the host, which also waits for
            # the batch's kernels, so their errors surface here
            out = {k: v.cpu().numpy()
                   for k, v in model._run_plan_batch(arrays, n).items()}
            if tracer is not None:
                tracer.complete(
                    "proc_batch", "serving", t0,
                    trace_id=(ids[0] if ids else None),
                    args={"model": name, "n": n, "worker": wid,
                          "trace_ids": ids})
            send({"type": "res", "req": req, "seq": seq,
                  "launches": _launch_counts()}, out)
        except Exception as e:
            if dev.type == "cuda" and device_context_lost(
                    e, lambda: torch.cuda.synchronize(dev)):
                os._exit(DEVICE_LOST_EXIT)
            send({"type": "err", "req": req, "seq": seq,
                  "cls": type(e).__name__, "msg": str(e)})


def _rebuild_error(cls: str, msg: str) -> Exception:
    """Reconstruct a child-side execution error as the closest typed
    parent-side error (the session's retry/breaker ladder discriminates
    on type: client errors are never retried, ``PlanError`` counts
    against the breaker)."""
    from repro_torch.core.execplan import PlanError
    if cls == "FrameCorrupt":      # child refused a corrupt run frame
        return FrameCorrupt(detail=msg)
    table = {"PlanError": PlanError, "ValueError": ValueError,
             "TypeError": TypeError, "KeyError": KeyError,
             "RuntimeError": RuntimeError,
             "ChaosError": _chaos.ChaosError,
             "TransientChaosError": _chaos.TransientChaosError}
    return table.get(cls, ServingError)(msg)


# --------------------------------------------------------------------------
# Parent side
# --------------------------------------------------------------------------


class _Proc:
    """Parent-side handle for one worker process."""

    __slots__ = ("wid", "proc", "conn", "reader", "ready", "dead",
                 "exitcode", "pid", "send_lock", "models", "detail",
                 "lanes", "device", "launches", "acks", "retired")

    def __init__(self, wid: int):
        self.wid = wid
        #: dispatch lanes (ServerPool worker ids) feeding this process
        self.lanes = {wid}
        self.proc = None
        self.conn = None
        self.reader: Optional[threading.Thread] = None
        self.ready = threading.Event()
        self.dead = False
        self.exitcode: Optional[int] = None
        self.pid: Optional[int] = None
        self.send_lock = threading.Lock()
        self.models: set = set()
        self.detail = ""
        #: the device the child's plans run on, as it reported it
        self.device: Optional[str] = None
        #: the child's kernel launches, as its last ``res`` frame said
        self.launches: Dict[str, int] = {}
        #: model -> load error (None: loaded), as the child reported it
        self.acks: Dict[str, Optional[str]] = {}
        #: set when the supervisor recycles one of its lanes: the process
        #: is being killed, and no lane may join it any more
        self.retired = False

    def send(self, frame: bytes) -> None:
        conn = self.conn
        if conn is None or self.dead:
            raise WorkerCrashed(self.wid, self.detail or "process gone")
        with self.send_lock:
            conn.send_bytes(frame)


class ProcPool(ServerPool):
    """:class:`ServerPool` whose workers are separate OS processes.

    Dispatch, admission control, EDF/priority scheduling, heartbeat
    supervision and recycling are all inherited — this subclass swaps
    the execution transport (``remote_run`` over the pipe protocol) and
    the liveness sources (child ``hb`` frames + exitcodes).  ``device``
    (a ``ServerPool`` argument) is where every child replays its plans;
    ``max_batch`` the largest bucket it lowers and warms before it
    reports ready."""

    mode = "process"

    def __init__(self, execute, *,
                 model_paths: Optional[Dict[str, str]] = None,
                 child_trace_capacity: int = 65536,
                 lanes_per_proc: int = 2, **kw):
        # subclass state first: the base __init__ spawns workers, which
        # calls straight back into our overridden _spawn_locked
        self._ctx = mp.get_context("spawn")
        self._plock = threading.RLock()
        self._procs: Dict[int, _Proc] = {}
        self._model_paths: Dict[str, str] = dict(model_paths or {})
        self._pending: Dict[int, tuple] = {}
        self._req_ids = itertools.count(1)
        self._boot_failures = 0    # consecutive died-before-ready spawns
        self._child_trace_capacity = int(child_trace_capacity) \
            if _trace.active() is not None else 0
        #: dispatch lanes per child process.  One lane ping-pongs with
        #: the child (send batch -> wait -> claim next), leaving the
        #: child idle for the whole parent-side turnaround every batch;
        #: a second lane keeps the pipe primed with the next batch.
        self._lanes = max(1, int(lanes_per_proc))
        #: lane wid -> its process (many lanes share one _Proc)
        self._lane_proc: Dict[int, _Proc] = {}
        self._child_device = str(torch.device(kw.get("device") or "cpu"))
        self._child_max_batch = int(kw.get("max_batch", 8))
        procs = max(1, int(kw.get("workers", 2)))
        # the children share the parent's budget of torch threads
        self._child_threads = max(1, torch.get_num_threads() // procs)
        kw["workers"] = procs * self._lanes
        super().__init__(execute, **kw)

    # -- model registry ----------------------------------------------------
    def register_model(self, name: str, path: str) -> None:
        """Hand one model's artifact to every worker (and to all future
        spawns), then wait until each live child has loaded, lowered and
        warmed it.  Children mmap it copy-on-write; the pipe is ordered,
        so a batch submitted after this call never races the load.
        Raises when a child reports that it could not load the model (a
        device it cannot open, a bad artifact): no child serves it from
        anywhere else."""
        with self._plock:
            self._model_paths[name] = path
            procs = [p for p in self._procs.values() if not p.dead]
            for p in procs:
                p.acks.pop(name, None)
            # a child launched after this point loads the model from its
            # path snapshot and acknowledges it in its ready frame
            launched = [p for p in procs if p.conn is not None]
        for p in launched:
            try:
                p.send(pack_frame({"type": "load", "model": name,
                                   "path": path}))
            except (WorkerCrashed, BrokenPipeError, OSError):
                pass               # dying worker: its replacement spawns
                                   # with the updated path snapshot
        deadline = time.monotonic() + LOAD_TIMEOUT_S
        while True:
            waiting = [p for p in procs
                       if not (p.dead or p.retired) and name not in p.acks]
            if not waiting:
                break
            if time.monotonic() > deadline:
                raise ServingError(
                    f"{name}: worker(s) {[p.wid for p in waiting]} did not "
                    f"load it within {LOAD_TIMEOUT_S:.0f} s")
            time.sleep(0.01)
        errors = {p.wid: p.acks[name] for p in procs
                  if p.acks.get(name) is not None}
        if errors:
            raise RuntimeError(f"{name}: worker(s) could not load it: "
                               + "; ".join(f"{w}: {e}"
                                           for w, e in errors.items()))

    # -- spawning (off the request path) -----------------------------------
    def _spawn_locked(self, wid: int) -> None:
        with self._plock:
            p = next((q for q in self._procs.values()
                      if not (q.dead or q.retired)
                      and len(q.lanes) < self._lanes), None)
            if p is not None:
                # share an existing child process: a second dispatch
                # lane keeps its pipe primed with the next batch
                p.lanes.add(wid)
                self._lane_proc[wid] = p
            else:
                p = _Proc(wid)
                self._procs[wid] = p
                self._lane_proc[wid] = p
                threading.Thread(target=self._launch, args=(wid, p),
                                 name=f"npu-proc-launch-{wid}",
                                 daemon=True).start()
        super()._spawn_locked(wid)

    def _launch(self, wid: int, p: _Proc) -> None:
        """Launcher thread: process spawn, artifact load, lowering and
        the warm batch take seconds — never on a dispatcher thread
        (dispatch gates on ``_worker_ready`` and the dispatcher beats
        for booting workers)."""
        boots = self._boot_failures
        if boots:                  # crash-loop backoff: a child that dies
            time.sleep(min(0.05 * (2 ** min(boots, 6)), 2.0))
        try:                       # before ready must not spin respawns
            with self._plock:
                paths = dict(self._model_paths)
                parent_conn, child_conn = self._ctx.Pipe(duplex=True)
                p.conn = parent_conn
            proc = self._ctx.Process(
                target=_worker_main,
                args=(child_conn, wid, paths,
                      max(0.01, self.heartbeat_timeout_s / 4),
                      self._child_trace_capacity, self._child_device,
                      self._child_max_batch, self._child_threads),
                name=f"npu-proc-{wid}", daemon=True)
            proc.start()
            child_conn.close()
            p.proc = proc
            p.reader = threading.Thread(
                target=self._reader, args=(wid, p),
                name=f"npu-proc-reader-{wid}", daemon=True)
            p.reader.start()
        except Exception as e:     # spawn failed: supervisor recycles
            p.detail = repr(e)
            self._mark_dead(p)

    # -- per-process reader thread -----------------------------------------
    def _reader(self, wid: int, p: _Proc) -> None:
        """Demux one child's frames: heartbeats feed the FaultMonitor,
        replies wake their pending ``remote_run``, EOF marks death."""
        conn = p.conn
        while True:
            try:
                buf = conn.recv_bytes()
                c = _chaos.active()
                if c is not None:
                    buf = c.maybe_flip_frame(buf)
                # copies: the outputs become writable CPU tensors
                header, arrays = unpack_frame(buf)
            except (EOFError, OSError):
                break
            except FrameCorrupt as e:
                # payload integrity fault, framing intact: fail only
                # the pending batch this frame answered (the executor
                # re-dispatches it to a healthy worker) and keep
                # reading — the stream is NOT poisoned
                req = (e.header or {}).get("req")
                with self._plock:
                    slot = self._pending.pop(req, None) \
                        if req is not None else None
                if slot is not None:
                    ev, box = slot[0], slot[1]
                    box["corrupt"] = str(e)
                    ev.set()
                    _trace.instant("frame_corrupt", "fault",
                                   args={"worker": wid, "req": req})
                    continue
                p.detail = str(e)  # unattributable: recycle the worker
                break
            except ProtocolError as e:
                p.detail = str(e)  # desynchronized: recycle the worker
                break
            kind = header.get("type")
            if "launches" in header:
                p.launches = dict(header["launches"])
            if kind == "hb":
                seq = int(header.get("seq", 0))
                for lane in tuple(p.lanes):
                    self.monitor.beat(lane, seq)
            elif kind == "ready":
                p.pid = header.get("pid")
                p.device = header.get("device")
                p.models = set(header.get("models", ()))
                errors = header.get("errors") or {}
                if errors:
                    p.detail = "; ".join(f"{n}: {e}"
                                         for n, e in errors.items())
                p.acks.update(dict.fromkeys(p.models))
                p.acks.update(errors)
                p.ready.set()
                self._boot_failures = 0
                for lane in tuple(p.lanes):
                    self.monitor.beat(lane, 0)
                _trace.instant("proc_ready", "fault",
                               args={"worker": wid, "pid": p.pid})
                with self._cv:
                    self._cv.notify_all()
            elif kind == "loaded":
                err = header.get("error")
                if err is None:
                    p.models.add(header["model"])
                else:
                    p.detail = f"{header['model']}: {err}"
                p.acks[header["model"]] = err
            elif kind in ("res", "err", "spans"):
                # any reply is liveness evidence: a saturated child is
                # never idle long enough to emit hb frames
                for lane in tuple(p.lanes):
                    self.monitor.beat(lane, int(header.get("req", 0)))
                with self._plock:
                    slot = self._pending.pop(header["req"], None)
                if slot is not None:
                    ev, box = slot[0], slot[1]
                    if kind == "res":
                        box["out"] = arrays
                    elif kind == "err":
                        box["err"] = (header.get("cls", ""),
                                      header.get("msg", ""))
                    else:
                        box["spans"] = (float(header.get("epoch", 0.0)),
                                        header.get("doc") or
                                        {"traceEvents": []})
                    ev.set()
            elif kind == "bye":
                break
            # unknown frames: nothing to do
        self._mark_dead(p)

    def _mark_dead(self, p: _Proc) -> None:
        if p.dead:
            return
        p.dead = True
        if not p.ready.is_set():
            self._boot_failures += 1
        if p.proc is not None:
            p.proc.join(timeout=0.5)
            p.exitcode = p.proc.exitcode
        with self._plock:
            stale = [k for k, s in self._pending.items() if s[2] is p]
            slots = [self._pending.pop(k) for k in stale]
        for ev, box, _ in slots:
            box["crash"] = True
            ev.set()
        _trace.instant("proc_dead", "fault",
                       args={"worker": p.wid, "pid": p.pid,
                             "exitcode": p.exitcode})
        with self._cv:
            self._cv.notify_all()

    # -- remote execution ---------------------------------------------------
    def remote_run(self, wid: int, name: str, feeds: List[dict],
                   trace_ids: Optional[List[int]] = None
                   ) -> List[Dict[str, torch.Tensor]]:
        """Stack ``feeds`` (numpy arrays), ship them to worker ``wid``'s
        process, and split the reply into one dict of CPU tensors per
        request (rows of one tensor per output).  Raises
        :class:`WorkerCrashed` if the process dies with the batch in
        flight (the executor re-dispatches) and rebuilds typed
        child-side errors otherwise."""
        p = self._lane_proc.get(wid)
        if p is None or not self._worker_ready(wid):
            raise WorkerCrashed(wid, (p.detail if p else "")
                                or "no live process")
        c = _chaos.active()
        kill_mode = c.maybe_kill(wid) if c is not None else None
        req = next(self._req_ids)
        ev = threading.Event()
        box: dict = {}
        with self._plock:
            if p.dead:
                raise WorkerCrashed(wid, p.detail or "process died")
            self._pending[req] = (ev, box, p)
        try:
            if kill_mode in ("segv", "oom"):
                # crash trampoline: the child dies on this frame, the
                # run frame behind it is lost in the pipe — a faithful
                # mid-flight crash
                p.send(pack_frame({"type": "crash", "mode": kill_mode}))
            elif kill_mode == "kill":
                # SIGKILL with the batch claimed and in flight: no
                # goodbye frame, the parent only ever sees pipe EOF
                if p.proc is not None:
                    p.proc.kill()
                    p.proc.join(0.1)
            p.send(pack_run_frame(
                {"type": "run", "req": req, "model": name,
                 "n": len(feeds), "trace_ids": list(trace_ids or ())},
                feeds))
        except (WorkerCrashed, BrokenPipeError, OSError) as e:
            with self._plock:
                self._pending.pop(req, None)
            # a failed send is definitive: mark the worker dead *now* so
            # its dispatcher thread stops claiming (waiting for the
            # reader's EOF would let it crash-loop through the queue)
            self._mark_dead(p)
            raise WorkerCrashed(wid, p.detail or repr(e)) from None
        # the reader sets ``ev`` on every outcome — result, child error,
        # pipe EOF (_mark_dead) and pool close (close kills the child,
        # EOF follows); the long-timeout re-check is a backstop
        while not ev.wait(1.0):
            if p.dead or box:
                break
            if not self._running:
                with self._plock:
                    self._pending.pop(req, None)
                raise WorkerCrashed(wid, "pool closed")
        if "out" in box:
            out = {k: torch.from_numpy(v) for k, v in box["out"].items()}
            return [{k: v[i] for k, v in out.items()}
                    for i in range(len(feeds))]
        if "corrupt" in box:
            raise FrameCorrupt(wid, box["corrupt"])
        if "err" in box:
            err = _rebuild_error(*box["err"])
            if isinstance(err, FrameCorrupt):
                err.worker = wid   # attribute the child-side refusal
            raise err
        raise WorkerCrashed(
            wid, p.detail or (f"exitcode {p.exitcode}"
                              if p.exitcode is not None else "pipe EOF"))

    # -- ServerPool hooks ---------------------------------------------------
    def _worker_ready(self, wid: int) -> bool:
        p = self._lane_proc.get(wid)
        return (p is not None and p.ready.is_set() and not p.dead
                and not p.retired)

    def _idle_beat(self, wid: int, seq: int) -> None:
        """No parent-side idle beats: the child's ``hb`` frames are the
        only idle liveness signal, so a hung child goes stale even
        while its dispatcher thread spins healthily."""

    def _worker_stream(self, wid: int):
        """The dispatcher threads launch nothing (their children do), so
        they run on no stream of their own."""
        return contextlib.nullcontext()

    def _extra_dead_locked(self) -> List[int]:
        dead = []
        for wid, p in list(self._lane_proc.items()):
            if p.dead:
                dead.append(wid)
            elif p.proc is not None and p.proc.exitcode is not None:
                dead.append(wid)
        return dead

    def _on_recycle_locked(self, wid: int) -> None:
        p = self._lane_proc.pop(wid, None)
        if p is None:
            return
        p.lanes.discard(wid)
        # a replacement lane must spawn a new process, never join this one
        # (the reader marks it dead only once the pipe's EOF arrives)
        p.retired = True
        try:
            if p.proc is not None and p.proc.is_alive():
                p.proc.kill()
        except Exception:
            pass
        try:
            if p.conn is not None:
                p.conn.close()     # reader EOFs -> _mark_dead -> pending
        except Exception:          # remote_runs fail with WorkerCrashed
            pass

    def _on_close(self) -> None:
        procs = list(self._procs.values())
        for p in procs:
            if p.dead or p.conn is None:
                continue
            try:
                p.send(pack_frame({"type": "close"}))
            except (WorkerCrashed, BrokenPipeError, OSError):
                pass
        deadline = time.monotonic() + 1.0
        for p in procs:
            if p.proc is None:
                continue
            p.proc.join(max(0.0, deadline - time.monotonic()))
            if p.proc.is_alive():
                p.proc.kill()
                p.proc.join(0.5)
            if p.exitcode is None:
                p.exitcode = p.proc.exitcode

    # -- observability ------------------------------------------------------
    def child_launches(self) -> Dict[str, int]:
        """Kernel launches by wrapper, summed over every child this pool
        has spawned, as each one's last ``ready``, ``loaded`` or ``res``
        frame reported them (the warm batches of its loads included)."""
        total: Dict[str, int] = {}
        for p in list(self._procs.values()):
            for k, v in p.launches.items():
                total[k] = total.get(k, 0) + int(v)
        return total

    def collect_child_traces(self, timeout: float = 2.0
                             ) -> List[Tuple[float, dict]]:
        """Pull every live child's tracer ring: a list of
        ``(child_epoch, chrome_trace_doc)`` pairs ready for
        :func:`repro_torch.obs.trace.merge_chrome_traces`."""
        out: List[Tuple[float, dict]] = []
        for wid, p in sorted(self._procs.items()):
            if p.dead or not p.ready.is_set():
                continue
            req = next(self._req_ids)
            ev = threading.Event()
            box: dict = {}
            with self._plock:
                self._pending[req] = (ev, box, p)
            try:
                p.send(pack_frame({"type": "spans", "req": req}))
            except (WorkerCrashed, BrokenPipeError, OSError):
                with self._plock:
                    self._pending.pop(req, None)
                continue
            if ev.wait(timeout) and "spans" in box:
                out.append(box["spans"])
            else:
                with self._plock:
                    self._pending.pop(req, None)
        return out

    def worker_health(self) -> Dict[int, Dict[str, object]]:
        out = super().worker_health()
        for wid, h in out.items():
            p = self._lane_proc.get(wid)
            if p is None:
                continue
            h["pid"] = p.pid
            h["ready"] = self._worker_ready(wid)
            h["device"] = p.device
            h["error"] = p.detail or None
            h["exitcode"] = p.exitcode if p.exitcode is not None else (
                p.proc.exitcode if p.proc is not None else None)
        return out
