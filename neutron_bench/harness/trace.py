"""What a traced run (``--trace 1``) records over its window, and the
arithmetic the per-layer readers share.

Two sources are armed together over the whole window: the program's own
span tracer (``repro_torch.obs.trace``: ``queue_wait``, ``batch`` and one
span per plan step, on the host's monotonic clock) and ``torch.profiler``
(CUDA kernels, copies and sets on the device; the CUDA runtime and driver
calls on the host).  A marker taken on both clocks at the start puts the
profiler's events on the monotonic clock, so each kernel can be traced to
the launch call that made it and each launch to the plan step that
issued it.  The idle share's arithmetic (the union of device intervals
against the window) is that of the program's ``launch/serve_vision.py
--profile``, made over the window's timeline rather than summed.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: the kinds of GEMM steps (conv and fc) of the plan
GEMM_KINDS = ("conv", "fc")


def is_api(name: str) -> bool:
    """A CUDA runtime or driver call on the host."""
    return name.startswith("cu")


def is_launch(name: str) -> bool:
    """A host call that launches work (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaGraphLaunch`` and their variants)."""
    return is_api(name) and "Launch" in name


def is_transfer(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


@dataclass
class Trace:
    """The window's events, every time in seconds on the monotonic clock.

    ``device``: (start, end, name, correlation) of every kernel, copy and
    set on the device; ``launches``: (time, name, correlation) of every
    CUDA runtime and driver call on the host; ``spans``: the program's
    tracer events, (name, category, start, end, thread, args).

    A kernel launched through a CUDA runtime linked into another library
    (K1, bound with ``ctypes``) may come with no host call the profiler
    saw: such a kernel is "untraced".  Untraced kernels count as one
    launch each, and are given, in stream order, to the GEMM steps of
    their batch when there are as many of them as of those steps."""
    window: Tuple[float, float]
    device: List[Tuple[float, float, str, int]] = field(default_factory=list)
    launches: List[Tuple[float, str, int]] = field(default_factory=list)
    spans: List[Tuple] = field(default_factory=list)
    clock: str = "marker"

    # -- device time ------------------------------------------------------
    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's intervals, clipped to the window."""
        w0, w1 = self.window
        ivs = sorted((max(a, w0), min(b, w1)) for a, b, _, _ in self.device
                     if b > w0 and a < w1)
        out: List[List[float]] = []
        for a, b in ivs:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return float(sum(b - a for a, b in self.busy_intervals()))

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def gaps(self) -> List[Tuple[float, float]]:
        """The device's idle intervals inside the window."""
        w0, w1 = self.window
        out, t = [], w0
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < w1:
            out.append((t, w1))
        return out

    # -- spans --------------------------------------------------------------
    def named(self, name: str, category: Optional[str] = None) -> List:
        return [s for s in self.spans if s[0] == name
                and (category is None or s[1] == category)]

    def in_window(self, spans: Sequence) -> List:
        w0, w1 = self.window
        return [s for s in spans if w0 <= s[2] < w1]

    def launches_in_window(self) -> int:
        """Launch calls seen on the host in the window, and one for each
        untraced kernel that started in it."""
        w0, w1 = self.window
        calls = sum(1 for t, n, _ in self.launches
                    if w0 <= t < w1 and is_launch(n))
        return calls + sum(1 for i in self.untraced()
                           if w0 <= self.device[i][0] < w1)

    def untraced(self) -> List[int]:
        """Indices of the kernels with no host call of their
        correlation."""
        if not hasattr(self, "_untraced"):
            seen = {c for _, _, c in self.launches}
            self._untraced = [i for i, (_, _, n, c) in enumerate(self.device)
                              if c not in seen and not is_transfer(n)]
        return self._untraced

    def plan_steps(self) -> List[Tuple[float, float, str, int]]:
        """The plan steps' spans, (start, end, label, batch size), in
        order; the batch size is that of the ``batch`` span around the
        step."""
        if not hasattr(self, "_steps"):
            steps = sorted((s[2], s[3], s[0]) for s in self.spans
                           if s[1] == "plan")
            batches = sorted((s[2], s[3], (s[5] or {}).get("n", 0))
                             for s in self.spans
                             if s[0] == "batch" and s[1] == "serving")
            b_starts = [b[0] for b in batches]
            out = []
            for a, b, label in steps:
                k = bisect.bisect_right(b_starts, a) - 1
                n = batches[k][2] if k >= 0 and a <= batches[k][1] else 0
                out.append((a, b, label, n))
            self._steps = out
        return self._steps

    def device_s_by_step(self, gemm: Sequence[int] = ()) -> Dict[int, float]:
        """Device seconds of the kernels each plan step launched (by the
        step's index in :meth:`plan_steps`): a kernel goes through its
        correlation to its host call, and the call to the step whose span
        holds it.  ``gemm``: the indices of the GEMM steps, which the
        untraced kernels of a batch are given to in order (see the
        class)."""
        steps = self.plan_steps()
        starts = [s[0] for s in steps]
        launch_at = {c: t for t, n, c in self.launches}
        out: Dict[int, float] = defaultdict(float)
        for a, b, _, corr in self.device:
            t = launch_at.get(corr)
            if t is None:
                continue
            j = bisect.bisect_right(starts, t) - 1
            if j >= 0 and t <= steps[j][1]:
                out[j] += b - a
        gemm = sorted(gemm)
        g_starts = [steps[j][0] for j in gemm]
        untraced = sorted(self.untraced(), key=lambda i: self.device[i][0])
        u_starts = [self.device[i][0] for i in untraced]
        self.unassigned_batches = 0
        for name, cat, a, b, _, _ in self.spans:
            if name != "batch" or cat != "serving":
                continue
            steps_in = gemm[bisect.bisect_left(g_starts, a):
                            bisect.bisect_right(g_starts, b)]
            kern = untraced[bisect.bisect_left(u_starts, a):
                            bisect.bisect_right(u_starts, b)]
            if not kern:
                continue
            if len(kern) != len(steps_in):
                self.unassigned_batches += 1
                continue
            for j, i in zip(steps_in, kern):
                out[j] += self.device[i][1] - self.device[i][0]
        return out

    def host_activity(self, t: float) -> str:
        """What the serving worker was doing at ``t``: in which plan
        step, in a batch outside its steps, or waiting for a batch."""
        for name, cat, a, b, _, _ in self._spans_at(t):
            if cat == "plan":
                kind = name.split("@")[0].rstrip("_0123456789")
                return f"host in step {kind}"
        for name, cat, a, b, _, _ in self._spans_at(t):
            if name == "batch":
                return "host in a batch, outside its plan steps"
        return "host waiting for a batch (queue, linger, clients)"

    def _spans_at(self, t: float) -> List:
        if not hasattr(self, "_sorted"):
            keep = [s for s in self.spans if s[1] in ("plan", "serving")
                    and s[0] != "serve"]
            self._sorted = sorted(keep, key=lambda s: s[2])
            self._starts = [s[2] for s in self._sorted]
            self._longest = max((s[3] - s[2] for s in keep), default=0.0)
        hi = bisect.bisect_right(self._starts, t)
        lo = bisect.bisect_left(self._starts, t - self._longest)
        return [s for s in self._sorted[lo:hi] if s[3] >= t]

    # -- breakdown ------------------------------------------------------------
    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The device operations that took most time, and the idle time
        by what the host was doing, each the ``top`` largest."""
        w0, w1 = self.window
        by_op: Dict[str, float] = defaultdict(float)
        for a, b, name, _ in self.device:
            if b > w0 and a < w1:
                by_op[name[:96]] += min(b, w1) - max(a, w0)
        by_host: Dict[str, float] = defaultdict(float)
        for a, b in self.gaps():
            by_host[self.host_activity((a + b) / 2)] += b - a
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


class Recorder:
    """Arms the program's tracer and ``torch.profiler`` over a window."""

    def __init__(self):
        self._prof = None
        self._tracer = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.obs import trace as program_trace

        self._tracer = program_trace.enable(capacity=8_000_000,
                                            plan_steps=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        m0 = time.monotonic()
        with torch.profiler.record_function("neutron_bench_clock"):
            pass
        self._mark = (m0 + time.monotonic()) / 2
        self._wall = time.time() - time.monotonic()

    def stop(self, window: Tuple[float, float]) -> Trace:
        import torch
        from repro_torch.obs import trace as program_trace

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        program_trace.disable()
        events = self._prof.profiler.kineto_results.events()
        mark = next((e for e in events
                     if e.name() == "neutron_bench_clock"), None)
        if mark is not None:
            offset = mark.start_ns() * 1e-9 - self._mark
            clock = "marker"
        else:
            offset, clock = self._wall, "wall"
        tr = Trace(window=window, clock=clock)
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            t0 = e.start_ns() * 1e-9 - offset
            if e.device_type() == cuda:
                tr.device.append((t0, t0 + e.duration_ns() * 1e-9,
                                  e.name(), e.correlation_id()))
            elif is_api(e.name()):
                tr.launches.append((t0, e.name(), e.correlation_id()))
        tr.spans = [(n, c, a, b if b is not None else a, tid, args)
                    for n, c, a, b, tid, _, _, args
                    in self._tracer.events()]
        self._prof = self._tracer = None
        return tr


def quantile(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile of ``values`` by the nearest rank (the smallest
    value with at least ``q`` of the values at or below it)."""
    v = np.sort(np.asarray(values, float))
    if not len(v):
        return float("nan")
    return float(v[max(0, int(np.ceil(q * len(v))) - 1)])
