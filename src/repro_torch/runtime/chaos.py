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
* **silent output corruption** — ``corrupt_output(model, times=N)``:
  sessions serve *wrong bytes* for the model's next N batches without
  any error — the bit-flip fault class that only an end-to-end audit
  can catch.

The JAX package's ``runtime/chaos.py``, without the hooks that only its
process pool and fleet reach (worker and pool murder, frame and canary
corruption, and the session tag that aims an output corruption at one
fleet replica): they come back with ``ROADMAP.md`` item 10.

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


class Chaos:
    """One armed fault schedule.  All mutators and probes are
    thread-safe (the serving pool probes from worker threads)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stalls: Dict[int, float] = {}       # worker id -> seconds
        self._plan_faults: Dict[str, list] = {}   # model -> [err, ...]
        self._artifact_faults = 0
        self._skew_s = 0.0
        #: model -> remaining silent corruptions
        self._output_faults: Dict[str, int] = {}
        self.injected = {"stalls": 0, "plan_faults": 0,
                         "artifact_faults": 0, "output_flips": 0}

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

    def skew_clock(self, seconds: float) -> None:
        """Shift the serving deadline clock by ``seconds`` (cumulative;
        positive = forward, expiring pending deadlines)."""
        with self._lock:
            self._skew_s += float(seconds)

    def corrupt_output(self, model: str, times: int = 1) -> None:
        """The model's next ``times`` batches, in any session, silently
        serve perturbed outputs — no error raised, nothing trips a
        breaker.  Only an end-to-end audit catches it."""
        with self._lock:
            self._output_faults[model] = \
                self._output_faults.get(model, 0) + int(times)

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

    def check_artifact(self, path: str) -> None:
        """Raise ``ArtifactError`` if an artifact-read fault is armed."""
        with self._lock:
            if self._artifact_faults <= 0:
                return
            self._artifact_faults -= 1
            self.injected["artifact_faults"] += 1
        from repro_torch.core.serialize import ArtifactError
        raise ArtifactError(f"chaos: corrupted artifact {path}")

    def maybe_corrupt_output(self, model: str) -> bool:
        """Consume one armed silent-output corruption for this model."""
        with self._lock:
            n = self._output_faults.get(model, 0)
            if n <= 0:
                return False
            self._output_faults[model] = n - 1
            self.injected["output_flips"] += 1
            return True

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
