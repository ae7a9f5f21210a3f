"""Timed NPU program representation.

The compiler back-end of the paper emits an executable made of *compute
jobs*, *data-transfer jobs* and *synchronization barriers* for the RISC-V
controller (paper §IV).  This module is that artifact: a list of discrete
ticks (the paper's DAE time discretization, §IV-B), each holding at most
one compute job plus any number of datamover jobs.  Latency accounting
follows Eq. (8): ``sum_t max(l_DM(t), l_C(t)) + delta * N_DM`` when the
decoupled access-execute overlap is enabled, or the serialized sum when it
is not (the baseline-compiler mode used for the eNPU-A/B comparisons).

Copy of the JAX package's ``core/program.py`` (pure Python; the port imports
nothing of that package and keeps its own copy).  The tests hold
it equal to the original.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .npu import NPUConfig


@dataclass(frozen=True)
class TileRef:
    """A tile of a tensor.

    axis == "rows": rows [r0, r1) of an (H, W, C) activation.
    axis == "chan": channels [r0, r1) — used for parameter outC chunks and
    for activations produced by huge-parameter ops, which the compiler
    partitions "into smaller sub-problems with fewer output features"
    (paper §III-B) so weights can be streamed set-by-set.
    """

    tensor: str
    index: int
    r0: int
    r1: int
    nbytes: int
    banks: int
    axis: str = "rows"

    @property
    def key(self) -> Tuple[str, int]:
        return (self.tensor, self.index)

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.tensor}#{self.index}[{self.r0}:{self.r1}]"


@dataclass
class ComputeJob:
    op_name: str
    out_tiles: List[TileRef]          # tiles produced (multi for split ops)
    in_tiles: List[TileRef]           # activation + parameter tiles consumed
    fmt: str                          # "depth" | "line"
    cycles: int
    macs: int = 0
    # step range on the tiled axis.  Channel-split steps follow *weight*
    # chunks and may write only a channel slice of a wider (bank-
    # granular) output tile, so the range cannot be derived from
    # out_tiles.  None (legacy) -> derive from out_tiles.
    r0: Optional[int] = None
    r1: Optional[int] = None
    axis: Optional[str] = None

    def __repr__(self) -> str:  # pragma: no cover
        return f"Compute({self.op_name}->{self.out_tiles}, {self.fmt})"


@dataclass
class DmaJob:
    kind: str                         # fetch | push | lcopy | lfetch
    tile: TileRef
    nbytes: int
    cycles: int

    def __repr__(self) -> str:  # pragma: no cover
        return f"Dma({self.kind} {self.tile}, {self.nbytes}B)"


@dataclass
class V2PJob:
    """Virtual-to-physical remap: tensor tile -> physical bank list."""

    tile: TileRef
    banks: List[int]
    cycles: int


@dataclass
class Tick:
    index: int
    compute: Optional[ComputeJob] = None
    dma: List[DmaJob] = field(default_factory=list)
    v2p: List[V2PJob] = field(default_factory=list)

    def l_c(self) -> int:
        return self.compute.cycles if self.compute else 0

    def l_dm(self) -> int:
        return sum(j.cycles for j in self.dma) + \
            sum(j.cycles for j in self.v2p)


@dataclass
class NPUProgram:
    name: str
    cfg: NPUConfig
    ticks: List[Tick] = field(default_factory=list)
    dm_penalty: int = 16              # delta of Eq. (8), cycles per DM job
    meta: Dict = field(default_factory=dict)

    # ---- replay structure ----
    def compute_steps(self) -> List[Tuple[ComputeJob, int, int, str]]:
        """The program's compute jobs in tick order with their step
        ranges resolved: ``(job, r0, r1, axis)``.  Legacy programs
        (``r0 is None``) derive the range from the out tiles exactly
        like the interpretive executor does — this is the step sequence
        both the interpreter and the plan lowering replay."""
        out: List[Tuple[ComputeJob, int, int, str]] = []
        for t in self.ticks:
            cj = t.compute
            if cj is None:
                continue
            if cj.r0 is not None:
                out.append((cj, cj.r0, cj.r1, cj.axis))
            else:
                axis = cj.out_tiles[0].axis
                t0 = cj.out_tiles[0].tensor
                r0 = min(tl.r0 for tl in cj.out_tiles if tl.tensor == t0)
                r1 = max(tl.r1 for tl in cj.out_tiles if tl.tensor == t0)
                out.append((cj, r0, r1, axis))
        return out

    # ---- latency accounting (Eq. 8) ----
    def latency_cycles(self, overlap: Optional[bool] = None) -> int:
        """DAE programs overlap DMA with compute (max per tick, Eq. 8);
        baseline-compiled programs serialize.  Defaults to the mode the
        program was scheduled with."""
        if overlap is None:
            overlap = bool(self.meta.get("overlap", True))
        n_dm = sum(len(t.dma) for t in self.ticks)
        if overlap:
            body = sum(max(t.l_dm(), t.l_c()) for t in self.ticks)
        else:
            body = sum(t.l_dm() + t.l_c() for t in self.ticks)
        return body + self.dm_penalty * n_dm

    def latency_ms(self, overlap: Optional[bool] = None) -> float:
        return self.latency_cycles(overlap) / self.cfg.freq_hz * 1e3

    def total_macs(self) -> int:
        return sum(t.compute.macs for t in self.ticks if t.compute)

    def ddr_bytes(self) -> int:
        return sum(j.nbytes for t in self.ticks for j in t.dma
                   if j.kind in ("fetch", "push", "lfetch"))

    def effective_tops(self) -> float:
        secs = self.latency_cycles() / self.cfg.freq_hz
        return 2 * self.total_macs() / secs / 1e12 if secs else 0.0

    def stats(self) -> Dict[str, float]:
        return {
            "ticks": len(self.ticks),
            "latency_ms": self.latency_ms(),
            "latency_ms_serial": self.latency_ms(overlap=False),
            "ddr_mb": self.ddr_bytes() / 1e6,
            "gmacs": self.total_macs() / 1e9,
            "effective_tops": self.effective_tops(),
            "peak_tops": self.cfg.peak_tops,
            "utilization": self.effective_tops() / self.cfg.peak_tops,
        }

    def memory_timeline(self) -> List[int]:
        """Banks resident per tick (for Fig. 6 reproduction).  Derived by
        replaying fetch/compute/push transitions."""
        resident: Dict[Tuple[str, int], int] = {}
        out = []
        for t in self.ticks:
            for j in t.dma:
                if j.kind in ("fetch", "lfetch", "lcopy"):
                    resident[j.tile.key] = j.tile.banks
                elif j.kind == "push":
                    resident.pop(j.tile.key, None)
            if t.compute:
                for tr in t.compute.out_tiles:
                    resident[tr.key] = tr.banks
                for tr in t.compute.in_tiles:
                    # dead-after-use tiles are dropped by the allocator;
                    # the timeline uses lifetime info stamped in meta.
                    pass
            dead = self.meta.get("dead_after_tick", {}).get(t.index, [])
            for key in dead:
                resident.pop(tuple(key), None)
            out.append(sum(resident.values()))
        return out
