"""Fault tolerance: heartbeats, failure detection, elastic re-mesh,
straggler mitigation.

On a real multi-pod deployment each host runs a :class:`Heartbeat`; the
coordinator's :class:`FaultMonitor` detects missed beats, triggers a
checkpoint-restore restart with a *shrunk* data axis (elastic re-mesh) and
keeps a straggler score per host from step-time telemetry (backup-step
dispatch hook).  In this CPU container the same machinery runs with
simulated hosts — the tests inject failures/stragglers and assert the
recovery path (detect -> remesh -> restore -> identical loss curve).

Copy of the JAX package's ``runtime/fault.py`` (pure Python); the port's
serving pool (``runtime/serving.py``) uses ``FaultMonitor`` and
``BackupDispatcher``.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..obs import trace as _trace


# --------------------------------------------------------------------------
# Heartbeats / failure detection
# --------------------------------------------------------------------------


@dataclass
class Heartbeat:
    host_id: int
    last_beat: float = field(default_factory=time.monotonic)
    last_step: int = -1

    def beat(self, step: int) -> None:
        self.last_beat = time.monotonic()
        self.last_step = step


class FaultMonitor:
    """Detects dead hosts (missed heartbeats) and stragglers (step-time
    outliers)."""

    def __init__(self, n_hosts: int, timeout_s: float = 10.0,
                 straggler_ratio: float = 2.0):
        self.timeout_s = timeout_s
        self.ratio = straggler_ratio
        self.beats = {i: Heartbeat(i) for i in range(n_hosts)}
        self.step_times: Dict[int, List[float]] = {i: []
                                                   for i in range(n_hosts)}
        self.failed: set = set()
        self.retired: set = set()

    def register(self, host_id: int) -> None:
        """Explicitly (re-)register a host: clears any tombstone and
        starts a fresh heartbeat record.  Spawning a worker goes through
        here, never through an implicit first ``beat()``."""
        self.retired.discard(host_id)
        self.beats[host_id] = Heartbeat(host_id)
        self.step_times[host_id] = []
        self.failed.discard(host_id)

    def beat(self, host_id: int, step: int,
             step_time_s: Optional[float] = None) -> None:
        if host_id in self.retired:
            # a recycled worker's final heartbeat can still be in flight
            # when retire() runs; without the tombstone it would
            # auto-register below and resurrect the dead entry, which
            # the supervisor then detects (and recycles) forever
            return
        hb = self.beats.get(host_id)
        if hb is None:
            # tolerate (and auto-register) hosts that joined after
            # construction — replacement workers recycled into a serving
            # pool beat with fresh ids
            hb = self.beats[host_id] = Heartbeat(host_id)
        hb.beat(step)
        if step_time_s is not None:
            t = self.step_times.setdefault(host_id, [])
            t.append(step_time_s)
            if len(t) > 64:
                del t[:-64]

    def mark_failed(self, host_id: int) -> None:
        self.failed.add(host_id)
        _trace.instant("host_failed", "fault", args={"host": host_id})

    def retire(self, host_id: int) -> None:
        """Forget a host (a recycled worker): it no longer counts as
        dead, healthy or a straggler, and its id is tombstoned — late
        beats are dropped until :meth:`register` re-admits the id."""
        self.beats.pop(host_id, None)
        self.step_times.pop(host_id, None)
        self.failed.discard(host_id)
        self.retired.add(host_id)
        _trace.instant("host_retired", "fault", args={"host": host_id})

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        # `now if ... else` — not `now or`: now=0.0 is a legitimate
        # simulated-clock value, not "unset"
        now = time.monotonic() if now is None else now
        dead = [h for h, b in self.beats.items()
                if h not in self.failed
                and now - b.last_beat > self.timeout_s]
        return sorted(set(dead) | self.failed)

    def stragglers(self) -> List[int]:
        """Hosts whose recent mean step time exceeds `ratio` x the
        fleet median (median-based: robust at small host counts where a
        single outlier inflates the z-score denominator)."""
        means = {h: float(np.mean(t[-16:]))
                 for h, t in self.step_times.items() if len(t) >= 4}
        if len(means) < 3:
            return []
        med = float(np.median(list(means.values())))
        return [h for h, m in means.items()
                if m > self.ratio * max(med, 1e-9)]

    def healthy_hosts(self) -> List[int]:
        dead = set(self.dead_hosts())
        return [h for h in self.beats if h not in dead]


# --------------------------------------------------------------------------
# Elastic re-mesh
# --------------------------------------------------------------------------


def elastic_data_axis(n_healthy_chips: int, model_axis: int
                      ) -> Tuple[int, int]:
    """Largest (data, model) grid that fits the surviving chips with the
    model axis preserved (TP degree cannot change without resharding the
    weights' inner dimension).  Returns (n_data, dropped_chips)."""
    n_data = n_healthy_chips // model_axis
    if n_data == 0:
        raise RuntimeError(
            f"{n_healthy_chips} chips cannot host model axis {model_axis}")
    # keep the data axis a power of two for collective efficiency
    n_data = 2 ** int(math.floor(math.log2(n_data)))
    return n_data, n_healthy_chips - n_data * model_axis


@dataclass
class ElasticPlan:
    old_shape: Tuple[int, int]
    new_shape: Tuple[int, int]
    batch_per_shard_old: int
    batch_per_shard_new: int

    @property
    def changed(self) -> bool:
        return self.old_shape != self.new_shape


def plan_remesh(global_batch: int, old_data: int, model_axis: int,
                n_healthy_chips: int) -> ElasticPlan:
    new_data, _ = elastic_data_axis(n_healthy_chips, model_axis)
    assert global_batch % new_data == 0, \
        f"global batch {global_batch} not divisible by {new_data}"
    return ElasticPlan(
        old_shape=(old_data, model_axis),
        new_shape=(new_data, model_axis),
        batch_per_shard_old=global_batch // old_data,
        batch_per_shard_new=global_batch // new_data,
    )


# --------------------------------------------------------------------------
# Straggler mitigation: backup-step dispatch
# --------------------------------------------------------------------------


class BackupDispatcher:
    """Speculative re-dispatch: when a host is flagged as straggler, its
    shard of the *next* step is also dispatched to the fastest healthy
    host; whichever result arrives first wins (the other is cancelled).
    Here the dispatch is a callback so tests can simulate timing."""

    def __init__(self, monitor: FaultMonitor):
        self.monitor = monitor
        self.backups_issued: List[Tuple[int, int, int]] = []

    def maybe_backup(self, step: int,
                     run_shard: Callable[[int, int], float]) -> Dict:
        """run_shard(host, step) -> step time.  Returns per-host times
        with backups applied."""
        stragglers = set(self.monitor.stragglers())
        healthy = [h for h in self.monitor.healthy_hosts()
                   if h not in stragglers]
        times: Dict[int, float] = {}
        for h in self.monitor.healthy_hosts():
            t = run_shard(h, step)
            if h in stragglers and healthy:
                fastest = min(healthy,
                              key=lambda x: np.mean(
                                  self.monitor.step_times[x][-4:] or [0]))
                tb = run_shard(fastest, step)
                self.backups_issued.append((step, h, fastest))
                t = min(t, tb)
            times[h] = t
            self.monitor.beat(h, step, t)
        return times
