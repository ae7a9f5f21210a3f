"""Chaos hooks: controlled fault injection for the serving runtime.

The robustness contract of the serving stack ("every submitted ticket
terminates with a result or a typed error, within latency bounds,
while things break") is only testable if the breakage is reproducible.
This module is the single switchboard the runtime consults at its
instrumented points; tests and ``chip_smoke.py`` arm it, production code
never does (the hooks are ``None`` and every check is
one attribute load on the happy path).

Injectable fault classes
------------------------

* **worker stalls** — ``stall_worker(wid, seconds)``: the next batch
  that worker picks up hangs mid-execution *without heartbeating*,
  exactly like a wedged kernel; the pool's ``FaultMonitor`` must detect
  the missed beats, re-dispatch the in-flight batch and recycle the
  worker.
* **plan poisoning** — ``poison_plan(model, times=N)``: the model's
  compiled-replay execution raises (``PlanError`` by default, or any
  error you pass, e.g. a transient one) for the next N batches.  Drives
  the retry path, the per-model circuit breaker and what an open
  breaker does: the interpretive oracle engine on a CPU session,
  ``BreakerOpen`` on a CUDA one.
* **artifact corruption** — ``corrupt_artifacts(times=N)``: the program
  cache's disk tier raises ``ArtifactError`` on read, exercising the
  reject-and-recompile path (never silently replay a bad artifact).
* **clock skew** — ``skew_clock(seconds)``: shifts the serving
  runtime's deadline clock (``now()``), expiring queued tickets the way
  an NTP step or a suspended VM does.
* **worker murder** — ``kill_worker(wid, mode)`` /
  ``oom_worker(wid)``: the next batch dispatched to that worker's
  *process* (``repro_torch.runtime.procpool.ProcPool``) dies mid-flight —
  ``"kill"`` SIGKILLs from the parent mid-compute, ``"segv"`` trips a
  child-side SIGSEGV crash trampoline, ``"oom"`` aborts the child with
  the OOM-killed exit status.  ``worker_id=-1`` murders whichever
  worker dispatches next.  Exercises crash detection, in-flight
  re-dispatch and off-request-path respawn (zero ticket loss).
* **pool murder** — ``kill_pool(replica)``: the fleet router
  (``repro_torch.runtime.fleet``) tears the whole replica pool down — every
  worker lost at once, the host-death fault class.  Queued attempts
  fail ``WorkerLost`` and the router re-homes them on the surviving
  replicas with bounded backoff (zero ticket loss).
* **frame corruption** — ``corrupt_frames(times=N)``: flips one bit in
  the blob payload of the next N process-pool data frames on the
  parent's receive path.  The frame's CRC32 must catch it, fail only
  that batch with a typed ``FrameCorrupt`` and re-dispatch — never
  recycle the stream.
* **silent output corruption** — ``corrupt_output(model, times=N,
  tag=...)``: the tagged session serves *wrong bytes* for the model's
  next N batches without any error — the bit-flip fault class that
  only an end-to-end audit (the fleet's interp-oracle re-execution
  sampler) can catch.
* **artifact-swap corruption** — ``corrupt_canary(model, times=N)``:
  the next rolling-update canary for the model sees corrupted plan
  outputs; ``Fleet.update`` must reject the swap and roll back.

Usage::

    with chaos.inject() as c:
        c.poison_plan("mobilenet_v2", times=5)
        ...                       # serve traffic; watch it degrade
    # hooks disarmed, counters in c.stats()
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional


class ChaosError(RuntimeError):
    """Default error raised by armed plan-poisoning hooks."""


class TransientChaosError(ChaosError):
    """A chaos error the serving retry policy treats as transient."""


class Chaos:
    """One armed fault schedule.  All mutators and probes are
    thread-safe (the serving pool probes from worker threads)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stalls: Dict[int, float] = {}       # worker id -> seconds
        self._plan_faults: Dict[str, list] = {}   # model -> [err, ...]
        self._artifact_faults = 0
        self._kills: Dict[int, str] = {}          # worker id -> mode
        self._skew_s = 0.0
        self._pool_kills: list = []               # fleet replica ids
        self._frame_faults = 0
        #: (model, session tag or None) -> remaining silent corruptions
        self._output_faults: Dict[tuple, int] = {}
        self._canary_faults: Dict[str, int] = {}  # model -> remaining
        self.injected = {"stalls": 0, "plan_faults": 0,
                         "artifact_faults": 0, "kills": 0,
                         "pool_kills": 0, "frame_flips": 0,
                         "output_flips": 0, "canary_corruptions": 0}

    # -- arming (tests / benchmarks) ----------------------------------------
    def stall_worker(self, worker_id: int, seconds: float) -> None:
        """The next batch this worker claims stalls for ``seconds``
        without heartbeating (one-shot)."""
        with self._lock:
            self._stalls[int(worker_id)] = float(seconds)

    def poison_plan(self, model: str, error: Optional[Exception] = None,
                    times: int = 1) -> None:
        """The model's next ``times`` plan executions raise ``error``
        (fresh ``ChaosError`` instances by default)."""
        with self._lock:
            q = self._plan_faults.setdefault(model, [])
            q.extend([error] * times)

    def corrupt_artifacts(self, times: int = 1) -> None:
        """The next ``times`` disk-tier artifact reads fail."""
        with self._lock:
            self._artifact_faults += int(times)

    def kill_worker(self, worker_id: int, mode: str = "kill") -> None:
        """Murder the worker *process* during its next dispatched
        batch (one-shot).  ``mode``: ``"kill"`` = parent-side SIGKILL
        mid-compute; ``"segv"`` = child-side SIGSEGV crash trampoline;
        ``"oom"`` = child aborts with exit status 137.
        ``worker_id=-1`` targets whichever worker dispatches next."""
        if mode not in ("kill", "segv", "oom"):
            raise ValueError(f"unknown kill mode {mode!r}")
        with self._lock:
            self._kills[int(worker_id)] = mode

    def oom_worker(self, worker_id: int) -> None:
        """The worker process aborts as if the OOM killer took it."""
        self.kill_worker(worker_id, mode="oom")

    def skew_clock(self, seconds: float) -> None:
        """Shift the serving deadline clock by ``seconds`` (cumulative;
        positive = forward, expiring pending deadlines)."""
        with self._lock:
            self._skew_s += float(seconds)

    def kill_pool(self, replica: int) -> None:
        """Mark a whole fleet replica pool for death: the fleet router
        consumes the arm on its next tick and tears the replica's pool
        down (every worker lost at once — the host-death fault)."""
        with self._lock:
            self._pool_kills.append(int(replica))

    def corrupt_frames(self, times: int = 1) -> None:
        """Flip one bit in the blob payload of the next ``times``
        process-pool data frames on the parent's receive path."""
        with self._lock:
            self._frame_faults += int(times)

    def corrupt_output(self, model: str, times: int = 1,
                       tag: Optional[str] = None) -> None:
        """The tagged session (``Session(tag=...)``; ``tag=None``
        matches any session) silently serves perturbed outputs for the
        model's next ``times`` batches — no error raised, nothing trips
        a breaker.  Only an end-to-end audit catches it."""
        with self._lock:
            key = (model, tag)
            self._output_faults[key] = \
                self._output_faults.get(key, 0) + int(times)

    def corrupt_canary(self, model: str, times: int = 1) -> None:
        """The model's next ``times`` rolling-update canary runs see
        corrupted plan outputs (a bad artifact swap); ``Fleet.update``
        must reject the swap and roll back."""
        with self._lock:
            self._canary_faults[model] = \
                self._canary_faults.get(model, 0) + int(times)

    # -- probes (the serving runtime) ---------------------------------------
    def maybe_stall_s(self, worker_id: int) -> float:
        """Seconds this worker must hang right now (0.0 = healthy);
        consuming the one-shot stall."""
        with self._lock:
            s = self._stalls.pop(int(worker_id), 0.0)
            if s:
                self.injected["stalls"] += 1
            return s

    def check_plan(self, model: str) -> None:
        """Raise the model's next scheduled plan fault, if any."""
        with self._lock:
            q = self._plan_faults.get(model)
            if not q:
                return
            err = q.pop(0)
            self.injected["plan_faults"] += 1
        raise err if err is not None else ChaosError(
            f"chaos: poisoned plan for {model!r}")

    def maybe_kill(self, worker_id: int) -> Optional[str]:
        """The kill mode armed for this worker's next batch (or for any
        worker via the -1 wildcard), consuming the one-shot fault."""
        with self._lock:
            m = self._kills.pop(int(worker_id), None)
            if m is None:
                m = self._kills.pop(-1, None)
            if m is not None:
                self.injected["kills"] += 1
            return m

    def check_artifact(self, path: str) -> None:
        """Raise ``ArtifactError`` if an artifact-read fault is armed."""
        with self._lock:
            if self._artifact_faults <= 0:
                return
            self._artifact_faults -= 1
            self.injected["artifact_faults"] += 1
        from repro_torch.core.serialize import ArtifactError
        raise ArtifactError(f"chaos: corrupted artifact {path}")

    def take_pool_kills(self) -> list:
        """Drain (and count) every armed replica-pool kill."""
        with self._lock:
            kills, self._pool_kills = self._pool_kills, []
            self.injected["pool_kills"] += len(kills)
            return kills

    def maybe_flip_frame(self, buf: bytes) -> bytes:
        """Flip one bit in a pipe frame's blob payload if a frame fault
        is armed.  Frames without a blob payload (heartbeats, ready
        acks) pass through unconsumed — the fault targets data frames,
        whose CRC failure is attributable to one pending batch."""
        import struct as _struct
        if len(buf) < 12:
            return buf
        (hlen,) = _struct.unpack_from("<I", buf, 4)
        blob_off = 12 + hlen
        if len(buf) <= blob_off:
            return buf             # headers-only frame: not a target
        with self._lock:
            if self._frame_faults <= 0:
                return buf
            self._frame_faults -= 1
            self.injected["frame_flips"] += 1
        b = bytearray(buf)
        b[blob_off] ^= 0x40
        return bytes(b)

    def maybe_corrupt_output(self, model: str,
                             tag: Optional[str] = None) -> bool:
        """Consume one armed silent-output corruption for this
        (model, session tag) — exact tag match first, then the
        ``tag=None`` wildcard."""
        with self._lock:
            for key in ((model, tag), (model, None)):
                n = self._output_faults.get(key, 0)
                if n > 0:
                    self._output_faults[key] = n - 1
                    self.injected["output_flips"] += 1
                    return True
            return False

    def check_canary(self, model: str) -> bool:
        """Consume one armed canary corruption for this model."""
        with self._lock:
            n = self._canary_faults.get(model, 0)
            if n > 0:
                self._canary_faults[model] = n - 1
                self.injected["canary_corruptions"] += 1
                return True
            return False

    def now(self) -> float:
        with self._lock:
            return time.monotonic() + self._skew_s

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.injected)


def flip_outputs(out: Dict[str, object]) -> Dict[str, object]:
    """Silently perturb one element of one output tensor (or array) —
    the bit-flip-class corruption a CRC can't see (it happens *before*
    serialization) and only an end-to-end interp-oracle audit catches.
    Returns a new dict; the input values are never mutated."""
    import numpy as np
    import torch
    bad = dict(out)
    for k in sorted(bad):
        v = bad[k]
        if isinstance(v, torch.Tensor):
            w, floating = v.clone(), v.is_floating_point()
        else:
            w = np.array(v)
            floating = w.dtype.kind == "f"
        flat = w.reshape(-1)
        if not len(flat):
            continue
        flat[0] = flat[0] + (1e3 if floating else 64)
        bad[k] = w
        return bad
    return bad


#: the armed schedule, or None (production).  Runtime code reads this
#: once per probe point; ``inject()`` installs/disarms it.
_ACTIVE: Optional[Chaos] = None


def active() -> Optional[Chaos]:
    return _ACTIVE


def now() -> float:
    """The serving runtime's deadline clock: monotonic time plus any
    injected skew.  This is the only clock deadline logic may use."""
    c = _ACTIVE
    return time.monotonic() if c is None else c.now()


@contextmanager
def inject():
    """Arm a fresh fault schedule for the duration of the block (also
    hooks the program cache's disk tier so ``corrupt_artifacts`` works
    without the core layer importing this module)."""
    global _ACTIVE
    from repro_torch.core import pipeline
    c = Chaos()
    prev, _ACTIVE = _ACTIVE, c
    prev_hook = pipeline.set_disk_read_hook(c.check_artifact)
    try:
        yield c
    finally:
        _ACTIVE = prev
        pipeline.set_disk_read_hook(prev_hook)
