"""Execution profiler: the replay's measured time vs the cost model, per op.

Counterpart of ``repro/obs/profile.py``.  The compiler's cost model
predicts a schedule (cycles per compute job, DDR bytes per transfer);
the device plan then replays it.  This module correlates the two:

* **modeled** — what the schedule claims: latency, compute occupancy
  (compute-busy cycles / total cycles), DDR traffic and the bandwidth
  it implies at modeled speed.  These columns come from the copied
  ``core/program.py`` unchanged, so they equal the reference's for the
  same program;
* **measured** — what one timed :class:`~repro_torch.core.execplan.
  ExecPlan` replay took, per request, with per-step times.  On CUDA the
  replay's wall time lies between two CUDA events around the whole
  replay and each step's time between two events around the step (its
  span on the stream, read after one synchronize); on the CPU both are
  host clock, as in the reference;
* **per-op correlation** — each op's share of modeled cycles vs its
  share of measured step time.  The ``skew`` column (measured share /
  modeled share) says which ops the cost model under-prices on this
  backend.

Steps map to ops by label: the int8 lowering labels a step ``op@op``
and the float32 lowering ``op@f32``, one step per op (the reference's
float lowering also splits an op by rows, ``op[r0:r1@axis]``).  So the
per-op kernel counts equal the reference's at int8 and are one per op at
float32.  ``CompiledModel.profile()`` is the entry point.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch


def _op_of_label(label: str) -> str:
    """Step label -> op name: ``op@op`` (int8), ``op@f32`` (float32) and
    the reference's ``op[r0:r1@axis]`` alike."""
    return label.split("[", 1)[0].split("@", 1)[0]


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _timed_replay(plan, stacked, batch: int, step_times: list) -> float:
    """One replay's wall seconds, filling ``step_times``: between CUDA
    events around the whole replay on a CUDA plan (the replay's outputs
    are left on the card), host clock on the CPU."""
    if plan.device.type != "cuda":
        t0 = time.monotonic()
        plan.run(stacked, n=batch, step_times=step_times)
        return time.monotonic() - t0
    stream = torch.cuda.current_stream(plan.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    plan.run(stacked, n=batch, step_times=step_times)
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / 1e3


@dataclass
class OpProfile:
    op: str
    kind: str
    kernels: int                    # lowered kernels attributed to the op
    measured_ms: float              # per-request wall time in its kernels
    modeled_cycles: int
    macs: int
    measured_share: float = 0.0
    modeled_share: float = 0.0

    @property
    def skew(self) -> float:
        """measured share / modeled share — >1 means the cost model
        under-prices this op on the measuring backend."""
        if self.modeled_share <= 0.0:
            return float("inf") if self.measured_share > 0 else 1.0
        return self.measured_share / self.modeled_share


@dataclass
class ProfileReport:
    model: str
    precision: str
    batch: int
    runs: int
    modeled: Dict[str, float]       # the cost model's claims
    measured: Dict[str, float]      # the timed replay's reality
    ops: List[OpProfile] = field(default_factory=list)
    # per-KIND rollup of ``ops`` (conv, matmul, attention, ...): shares
    # sum over the kind's ops, skew recomputed from the summed shares —
    # the one-line answer to "is the cost model off on attention, or on
    # this one attention op?"
    kinds: List[OpProfile] = field(default_factory=list)

    @staticmethod
    def _row(o: OpProfile) -> Dict:
        return {
            "op": o.op, "kind": o.kind, "kernels": o.kernels,
            "measured_ms": round(o.measured_ms, 6),
            "modeled_cycles": o.modeled_cycles, "macs": o.macs,
            "measured_share": round(o.measured_share, 4),
            "modeled_share": round(o.modeled_share, 4),
            "skew": round(o.skew, 3) if o.skew != float("inf")
            else None,
        }

    def as_dict(self) -> Dict:
        return {
            "model": self.model, "precision": self.precision,
            "batch": self.batch, "runs": self.runs,
            "modeled": dict(self.modeled),
            "measured": dict(self.measured),
            "ops": [self._row(o) for o in self.ops],
            "kinds": [self._row(o) for o in self.kinds],
        }

    def render(self, top: int = 12) -> str:
        mo, me = self.modeled, self.measured
        lines = [
            f"Profile {self.model!r} [{self.precision}]  batch "
            f"{self.batch}, best of {self.runs} run(s)",
            f"  modeled   {mo['latency_ms']:.3f} ms/req  "
            f"({mo['ticks']:.0f} ticks, "
            f"{100 * mo['compute_occupancy']:.0f}% compute-occupied, "
            f"{100 * mo['utilization']:.0f}% of peak TOPS)",
            f"  modeled   DDR {mo['ddr_mb']:.2f} MB/req -> "
            f"{mo['ddr_gb_s']:.2f} GB/s at modeled speed",
            f"  measured  {me['wall_ms_per_request']:.3f} ms/req "
            f"({me['kernel_ms_per_request']:.3f} ms in "
            f"{me['kernels']:.0f} kernels)  "
            f"sim {me['sim_tops']:.4f} TOPS "
            f"({100 * me['sim_utilization']:.2f}% of peak)",
            f"  measured  DDR bandwidth implied {me['ddr_gb_s']:.3f} "
            f"GB/s  |  model-vs-actual speed x"
            f"{me['model_vs_actual']:.1f}",
            f"  {'op':<28}{'kind':<9}{'meas ms':>9}{'meas %':>8}"
            f"{'model %':>9}{'skew':>7}",
        ]
        for o in self.ops[:top]:
            skew = f"{o.skew:6.2f}" if o.skew != float("inf") else "   inf"
            lines.append(
                f"  {o.op:<28}{o.kind:<9}{o.measured_ms:9.3f}"
                f"{100 * o.measured_share:7.1f}%"
                f"{100 * o.modeled_share:8.1f}%{skew:>7}")
        if len(self.ops) > top:
            rest = sum(o.measured_ms for o in self.ops[top:])
            lines.append(f"  ... {len(self.ops) - top} more op(s), "
                         f"{rest:.3f} ms")
        if self.kinds:
            lines.append(
                f"  {'by kind':<28}{'kernels':<9}{'meas ms':>9}"
                f"{'meas %':>8}{'model %':>9}{'skew':>7}")
            for o in self.kinds:
                skew = (f"{o.skew:6.2f}" if o.skew != float("inf")
                        else "   inf")
                lines.append(
                    f"  {o.op:<28}{o.kernels:<9}{o.measured_ms:9.3f}"
                    f"{100 * o.measured_share:7.1f}%"
                    f"{100 * o.modeled_share:8.1f}%{skew:>7}")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.render()

    __repr__ = __str__


def profile_model(model, inputs=None, batch: int = 8, runs: int = 3,
                  warmup: int = 1) -> ProfileReport:
    """Timed, per-step-instrumented plan replay of ``model`` (a
    :class:`repro_torch.api.CompiledModel`), correlated against its cost
    model.  ``inputs`` is one sample feed (dict, array or tensor); zeros
    when omitted.  The best (min wall) of ``runs`` replays is reported —
    per-request numbers divide by ``batch``.  On CUDA every time is the
    card's, between CUDA events."""
    g = model.graph
    if inputs is None:
        feed = {t.name: np.zeros(t.shape, dtype=np.float32)
                for t in g.inputs}
    else:
        feed = model._normalize(inputs)
    stacked = {k: np.repeat(np.asarray(_host(v), dtype=np.float32)[None],
                            batch, axis=0)
               for k, v in feed.items()}
    plan = model.plan_for(batch)
    for _ in range(max(0, warmup)):
        plan.run(stacked, n=batch)

    best_wall = float("inf")
    best_steps: List = []
    for _ in range(max(1, runs)):
        step_times: List = []
        wall = _timed_replay(plan, stacked, batch, step_times)
        if wall < best_wall:
            best_wall, best_steps = wall, step_times

    prog = model.program
    stats = prog.stats()
    lat_cycles = prog.latency_cycles()
    compute_cycles = sum(t.l_c() for t in prog.ticks)
    modeled_s = lat_cycles / model.cfg.freq_hz
    ddr = prog.ddr_bytes()
    modeled = {
        "latency_ms": stats["latency_ms"],
        "ticks": stats["ticks"],
        "gmacs": stats["gmacs"],
        "ddr_mb": stats["ddr_mb"],
        "effective_tops": stats["effective_tops"],
        "utilization": stats["utilization"],
        "compute_occupancy": (compute_cycles / lat_cycles
                              if lat_cycles else 0.0),
        "ddr_gb_s": ddr / modeled_s / 1e9 if modeled_s else 0.0,
    }

    wall_per_req = best_wall / batch
    kernel_s = sum(dt for _, dt in best_steps)
    total_macs = prog.total_macs()
    measured = {
        "wall_ms_per_request": wall_per_req * 1e3,
        "kernel_ms_per_request": kernel_s / batch * 1e3,
        "kernels": float(len(best_steps)),
        "sim_tops": (2 * total_macs / wall_per_req / 1e12
                     if wall_per_req else 0.0),
        "sim_utilization": (2 * total_macs / wall_per_req / 1e12
                            / model.cfg.peak_tops if wall_per_req
                            else 0.0),
        "ddr_gb_s": ddr / wall_per_req / 1e9 if wall_per_req else 0.0,
        # how many x slower the measuring backend runs than the modeled
        # NPU — the correlation constant between the two columns
        "model_vs_actual": (wall_per_req / modeled_s
                            if modeled_s else 0.0),
    }

    # -- per-op attribution -------------------------------------------------
    cyc: Dict[str, int] = {}
    macs: Dict[str, int] = {}
    for cj, _, _, _ in prog.compute_steps():
        cyc[cj.op_name] = cyc.get(cj.op_name, 0) + cj.cycles
        macs[cj.op_name] = macs.get(cj.op_name, 0) + cj.macs
    meas: Dict[str, float] = {}
    nker: Dict[str, int] = {}
    for label, dt in best_steps:
        op = _op_of_label(label)
        meas[op] = meas.get(op, 0.0) + dt
        nker[op] = nker.get(op, 0) + 1
    total_cyc = sum(cyc.values()) or 1
    total_meas = sum(meas.values()) or 1.0
    kinds = {op.name: op.kind for op in g.ops}
    ops: List[OpProfile] = []
    for op in set(cyc) | set(meas):
        o = OpProfile(
            op=op, kind=kinds.get(op, "?"), kernels=nker.get(op, 0),
            measured_ms=meas.get(op, 0.0) / batch * 1e3,
            modeled_cycles=cyc.get(op, 0), macs=macs.get(op, 0))
        o.measured_share = meas.get(op, 0.0) / total_meas
        o.modeled_share = cyc.get(op, 0) / total_cyc
        ops.append(o)
    ops.sort(key=lambda o: o.measured_ms, reverse=True)

    by_kind: Dict[str, OpProfile] = {}
    for o in ops:
        k = by_kind.get(o.kind)
        if k is None:
            k = by_kind[o.kind] = OpProfile(
                op=o.kind, kind=o.kind, kernels=0, measured_ms=0.0,
                modeled_cycles=0, macs=0)
        k.kernels += o.kernels
        k.measured_ms += o.measured_ms
        k.modeled_cycles += o.modeled_cycles
        k.macs += o.macs
        k.measured_share += o.measured_share
        k.modeled_share += o.modeled_share
    kind_rows = sorted(by_kind.values(),
                       key=lambda o: o.measured_ms, reverse=True)

    return ProfileReport(model=model.name, precision=model.precision,
                         batch=batch, runs=max(1, runs),
                         modeled=modeled, measured=measured, ops=ops,
                         kinds=kind_rows)
