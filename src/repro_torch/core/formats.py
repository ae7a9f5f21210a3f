"""Format selection — depth vs. line parallelism (paper §IV-A).

Every compute job runs on N lockstep engines in one of two *formats*:

  * **depth**: the outC dimension is split across engines; the ifmap is
    broadcast-shared.  No pre-compute copies are needed (the rotating
    word-level addressing over channel fragments handles the layout), but
    utilization collapses when outC < M x engines.
  * **line**: output lines (outH) are split across engines; parameters are
    broadcast-shared.  Works at any channel count, but when filterH > 1
    the per-engine input windows overlap, so halo rows must be duplicated
    across banks with TCM-to-TCM copies before compute.

The compiler picks a format per layer by estimating execution latency
including the format-switch/expansion overhead between consecutive layers
(the paper's own criterion).  The pairwise producer->consumer coupling
makes this a local-interaction energy; we minimize it with coordinate
descent (sweep to fixed point), which is exact on chains and in practice
optimal on the benchmark DAGs (verified against brute force on small
graphs in the tests).

Copy of the JAX package's ``core/formats.py`` (pure Python; the port imports
nothing of that package and keeps its own copy).  The tests hold
it equal to the original.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

from .ir import Graph, Op
from .npu import NPUConfig, compute_job_cost, dma_cost, elem_bytes

FORMATS = ("depth", "line")

#: op kinds that have a spatial receptive field taller than one row (may
#: require halo expansion under line parallelism).
_SPATIAL = ("conv", "dwconv", "maxpool", "avgpool")


def halo_rows(op: Op) -> int:
    """Input rows that overlap between adjacent engine line-partitions."""
    if op.kind in _SPATIAL:
        k = op.attrs.get("k", (1, 1))
        kh = k[0] if isinstance(k, tuple) else k
        s = op.attrs.get("stride", 1)
        return max(0, kh - s)
    return 0


def lcopy_bytes(g: Graph, op: Op, out_rows: int) -> int:
    """TCM-to-TCM copy volume to expand inputs of `op` into line format
    for a tile covering `out_rows` output lines on `engines` partitions.
    (engines-1) internal boundaries each duplicate `halo` input rows."""
    h = halo_rows(op)
    if h == 0:
        return 0
    total = 0
    for t in g.act_inputs(op):
        if len(t.shape) != 3:
            continue
        _, w, c = t.shape
        total += math.ceil(h * w * c * elem_bytes(t.dtype))
    return total * 1  # one copy per internal engine boundary, amortized


def switch_bytes(g: Graph, producer_fmt: str, op: Op) -> int:
    """Layout-rearrangement volume when `op`'s input was produced in
    `producer_fmt` and `op` consumes in the other format.

    depth->depth : 0 (rotating fragment addressing, paper §IV-A)
    *->line      : halo expansion only (counted via lcopy_bytes)
    line->depth  : the line-fragmented ifmap must be re-fragmented by
                   channel — a full copy of the consumed activation.
    """
    if producer_fmt == "line":
        return sum(t.bytes for t in g.act_inputs(op) if len(t.shape) == 3)
    return 0


@dataclass
class FormatPlan:
    fmt: Dict[str, str]               # op name -> format
    cost_cycles: Dict[str, int]       # op name -> modeled cycles (inc. copies)

    def __getitem__(self, op_name: str) -> str:
        return self.fmt[op_name]


def _local_cost(cfg: NPUConfig, g: Graph, op: Op, fmt: str,
                producer_fmts: Dict[str, str]) -> int:
    out = g.tensors[op.output]
    H = out.shape[0] if len(out.shape) == 3 else 1
    c = compute_job_cost(cfg, g, op, H, fmt).cycles
    if fmt == "line":
        c += dma_cost(cfg, lcopy_bytes(g, op, H), kind="tcm")
    if fmt == "depth":
        # pay re-fragmentation for every line-format producer
        for t in g.act_inputs(op):
            p = t.producer
            if p is not None and producer_fmts.get(p) == "line":
                c += dma_cost(cfg, t.bytes, kind="tcm")
    return c


def select_formats(cfg: NPUConfig, g: Graph,
                   allowed: Tuple[str, ...] = FORMATS,
                   max_sweeps: int = 8) -> FormatPlan:
    """Coordinate-descent format assignment.

    `allowed` restricted to ("depth",) reproduces the baseline compiler
    (single-format, the eNPU-A reference behaviour in §V).
    """
    ops = g.topo_ops()
    fmt: Dict[str, str] = {}
    # init: per-op best ignoring neighbours
    for op in ops:
        best = min(allowed,
                   key=lambda f: _local_cost(cfg, g, op, f, {}))
        fmt[op.name] = best
    if len(allowed) > 1:
        for _ in range(max_sweeps):
            changed = False
            for op in ops:
                # own cost + downstream re-fragmentation induced on consumers
                def total(f: str) -> int:
                    trial = dict(fmt)
                    trial[op.name] = f
                    c = _local_cost(cfg, g, op, f, trial)
                    for out_name in op.outputs:
                        for cons in g.tensors[out_name].consumers:
                            cop = g.op(cons)
                            c += _local_cost(cfg, g, cop, trial[cop.name],
                                             trial)
                    return c
                best = min(allowed, key=total)
                if best != fmt[op.name]:
                    fmt[op.name] = best
                    changed = True
            if not changed:
                break
    costs = {op.name: _local_cost(cfg, g, op, fmt[op.name], fmt)
             for op in ops}
    return FormatPlan(fmt, costs)
