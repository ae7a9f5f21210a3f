"""Tick-based decoupled-access-execute scheduling (paper §IV-B).

Scheduling takes the tile compute order produced by tiling/fusion and
turns it into *timed* jobs: per discrete tick, at most one compute job and
any number of datamover jobs, with latency ``sum_t max(l_DM(t), l_C(t)) +
delta*N_DM`` (Eq. 8).  Per the paper, scheduling does **not** re-order
tiles — it "focuses solely on optimizing memory latency hiding":

  * the compute job of step *k* is pinned to tick *k+1*;
  * every fetch / push / l-copy job gets a CP-chosen tick inside its
    feasibility window (fetch: after the tile exists and before its
    compute; push: after produce; l-copy: before the line-format compute);
  * persistency/dependency/memory constraints (Eq. 1/2/7) are enforced via
    the linearized residency formulation;
  * Eq. 3's bank-sharing bus conflicts cannot arise here because tiles are
    allocated at whole-bank granularity (V2P makes physical banks
    interchangeable) — the executor asserts this invariant.

A greedy just-in-time schedule (fetch at k-1, push right after produce,
spill by furthest-next-use) provides both the warm start and the job set;
the CP re-times jobs per partition window (the paper's problem
partitioning, Table II).  ``overlap=False`` reproduces the baseline
(eNPU-A-style) serialized compiler used in the §V comparisons.

Copy of the JAX package's ``core/scheduling.py`` (pure Python; the port imports
nothing of that package and keeps its own copy).  The tests hold
it equal to the original.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import cpsolver
from .cpsolver import CPModel, MaxTerm
from .formats import FormatPlan, halo_rows, lcopy_bytes, switch_bytes
from .ir import Graph, Op
from .npu import NPUConfig, compute_job_cost, dma_cost
from .program import ComputeJob, DmaJob, NPUProgram, Tick, TileRef
from .tiling import ComputeStep, TilingResult, in_row_range


@dataclass
class SchedOptions:
    overlap: bool = True              # DAE on (ours) / off (baseline)
    partition: bool = True            # partition the CP (Table II)
    partition_steps: int = 12
    fetch_window: int = 4             # how early a fetch may move
    cp_time_limit_s: float = 1.0      # per partition
    cp_stall_s: Optional[float] = None   # early-exit: incumbent stall (s)
    cp_stall_nodes: Optional[int] = \
        cpsolver.DEFAULT_STALL_NODES      # …or stall (search nodes)
    parallel_cp: bool = True          # solve partition windows concurrently
    cp_engine: str = "incremental"    # cpsolver.ENGINES key
    tcm_frac: float = 1.0             # usable fraction of TCM banks
    dm_penalty: int = 16              # delta of Eq. (8)


# --------------------------------------------------------------------------
# Step expansion: tiles in / tiles out / cycles / required copies
# --------------------------------------------------------------------------


@dataclass
class _Step:
    idx: int
    op: Op
    out_tiles: List[TileRef]
    in_act: List[TileRef]
    in_par: List[TileRef]
    fmt: str
    cycles: int
    macs: int
    copy_bytes: int                   # l-copy / format-switch volume
    r0: int = 0                       # step range on the tiled axis
    r1: int = 0
    axis: str = "rows"


def _expand_steps(cfg: NPUConfig, g: Graph, plan: FormatPlan,
                  tiling: TilingResult) -> List[_Step]:
    steps: List[_Step] = []
    for k, st in enumerate(tiling.order):
        op = g.op(st.op_name)
        fmt = plan[op.name]
        outs: List[TileRef] = []
        in_act: List[TileRef] = []
        if st.axis == "chan":
            # channel sub-problem: all input rows, one weight chunk
            for oname in op.outputs:
                outs.extend(tiling.tiles[oname].covering_chan(st.r0, st.r1))
            for x in g.act_inputs(op):
                in_act.extend(tiling.tiles[x.name].tiles)
            in_par = [tl for p in g.param_inputs(op)
                      for tl in tiling.tiles[p.name].covering_chan(
                          st.r0, st.r1)]
            out0 = g.tensors[op.outputs[0]]
            H = out0.shape[0] if len(out0.shape) == 3 else 1
            jc = compute_job_cost(cfg, g, op, H, fmt,
                                  out_c=st.r1 - st.r0)
            rows = H
        else:
            for oname in op.outputs:
                outs.extend(tiling.tiles[oname].covering(st.r0, st.r1))
            for x in g.act_inputs(op):
                ih = x.shape[0] if len(x.shape) == 3 else 1
                a, b = in_row_range(op, st.r0, st.r1, ih)
                in_act.extend(tiling.tiles[x.name].covering(a, b))
            in_par = [tl for p in g.param_inputs(op)
                      for tl in tiling.tiles[p.name].tiles]
            rows = st.r1 - st.r0
            jc = compute_job_cost(cfg, g, op, rows, fmt)
        cb = 0
        if fmt == "line":
            cb += math.ceil(lcopy_bytes(g, op, rows) * 1)
        # line->depth re-fragmentation of inputs
        for x in g.act_inputs(op):
            if x.producer and plan.fmt.get(x.producer) == "line" \
                    and fmt == "depth":
                ih = x.shape[0] if len(x.shape) == 3 else 1
                a, b = in_row_range(op, st.r0, st.r1, ih)
                cb += math.ceil(x.bytes * max(0, b - a) / max(ih, 1))
        steps.append(_Step(k, op, outs, in_act, in_par, fmt,
                           jc.cycles, jc.macs, cb,
                           r0=st.r0, r1=st.r1, axis=st.axis))
    return steps


# --------------------------------------------------------------------------
# Greedy JIT schedule — produces the DMA job set + a feasible timing
# --------------------------------------------------------------------------


@dataclass
class _DmaDecision:
    kind: str                         # fetch | push | lcopy
    tile: TileRef
    nbytes: int
    cycles: int
    tick: int                         # greedy placement
    release: int                      # earliest legal tick
    deadline: int                     # latest legal tick


def _greedy_schedule(cfg: NPUConfig, g: Graph, steps: List[_Step],
                     opt: SchedOptions
                     ) -> Tuple[List[_DmaDecision],
                                List[Tuple[Tuple[str, int], int]]]:
    """Simulate ticks; return DMA decisions + tile death ticks.

    Tick layout: tick 0 reserved for initial fetches; compute of step k at
    tick k+1; tick T+1 for final pushes.

    Bank-ledger semantics (shared with the allocator):
      * a push at tick t frees its banks *within* t — the controller
        sequences datamover jobs, and l_DM(t) already sums their
        latencies; evicted tiles are never inputs of t's compute (Eq. 3);
      * a tile dying at tick t (last compute use at t) frees its banks at
        the *start of tick t+1* — a same-tick refill would race with the
        concurrently running compute that reads it (Eq. 3).
    """
    T = len(steps)
    cap = int(cfg.tcm_banks * opt.tcm_frac)

    # --- lifetime analysis ---
    produce_tick: Dict[Tuple[str, int], int] = {}
    last_use: Dict[Tuple[str, int], int] = {}
    uses: Dict[Tuple[str, int], List[int]] = {}
    for s in steps:
        for tl in s.out_tiles:
            produce_tick.setdefault(tl.key, s.idx + 1)
        for tl in s.in_act + s.in_par:
            last_use[tl.key] = s.idx + 1
            uses.setdefault(tl.key, []).append(s.idx + 1)

    import bisect

    def next_use(key: Tuple[str, int], t: int) -> int:
        us = uses.get(key)
        if not us:
            return 10 ** 9
        i = bisect.bisect_left(us, t)
        return us[i] if i < len(us) else 10 ** 9

    import heapq

    resident: Dict[Tuple[str, int], TileRef] = {}
    used_banks = 0
    # banks already subtracted from no tile but embargoed until free_tick
    pending_free: List[Tuple[int, int]] = []   # (free_tick, banks)
    decisions: List[_DmaDecision] = []
    death: List[Tuple[Tuple[str, int], int]] = []   # (key, tick) events
    spilled: Dict[Tuple[str, int], int] = {}   # key -> push tick
    evicted_at: Dict[Tuple[str, int], int] = {}   # key -> last evict tick
    # Belady eviction heap: max-heap on next-use (stored as -next_use).
    # Entries go stale when a tile is evicted/retired (lazy deletion) or
    # when time advances past a use.  A stale-small priority would BURY
    # a far-next-use tile below nearer ones, so a fresh entry is pushed
    # every time one of a resident tile's uses passes (the only event
    # that changes next_use); pops then see an accurate maximum, and
    # leftover stale duplicates are corrected or skipped on pop.
    evict_heap: List[Tuple[int, Tuple[str, int]]] = []

    def avail(at_tick: int) -> int:
        """Free banks usable by an acquisition at `at_tick`."""
        embargo = sum(b for ft, b in pending_free if ft > at_tick)
        return cap - used_banks - embargo

    def reap(at_tick: int) -> None:
        nonlocal pending_free
        pending_free = [(ft, b) for ft, b in pending_free if ft > at_tick]

    def evict(at_tick: int, needed: Set[Tuple[str, int]],
              want: int) -> None:
        """Push/drop resident tiles so `want` banks are free at
        `at_tick`.  Tiles used at this very tick (in `needed`) are
        untouchable (Eq. 3); everything else is evictable — dead tiles
        are dropped, live tiles are SPILLED (push now, re-fetch before
        their next use) in Belady order (farthest next use first),
        served from a lazy max-heap keyed on next-use instead of a
        per-shortfall sort over all residents (O(log n) per pop)."""
        nonlocal used_banks
        skipped: List[Tuple[int, Tuple[str, int]]] = []
        while evict_heap and avail(at_tick) < want:
            negnu, key = heapq.heappop(evict_heap)
            tl = resident.get(key)
            if tl is None:
                continue                   # stale: evicted/retired earlier
            nu = next_use(key, at_tick)
            if -negnu != nu:               # priority aged — fix and retry
                heapq.heappush(evict_heap, (-nu, key))
                continue
            if key in needed or produce_tick.get(key, -1) >= at_tick:
                # untouchable this call (in use now, or still being
                # produced) — park the entry and restore it afterwards
                skipped.append((negnu, key))
                continue
            needs_later = nu < 10 ** 9
            is_param_or_input = g.tensors[tl.tensor].kind in (
                "input",) or g.tensors[tl.tensor].is_param
            is_out = g.tensors[tl.tensor].kind == "output"
            if (needs_later and not is_param_or_input) or is_out:
                # activations must round-trip through DRAM; params and
                # model inputs still live in DRAM — drop and re-fetch.
                # The push may not be re-timed before the tile's last
                # compute use (a push releases the banks in the
                # allocator's replay), so its release is that use + 1,
                # not merely produce + 1.
                us = uses.get(key, ())
                i = bisect.bisect_right(us, at_tick)
                prev_use = us[i - 1] if i else 0
                decisions.append(_DmaDecision(
                    "push", tl, tl.nbytes, dma_cost(cfg, tl.nbytes),
                    at_tick,
                    release=max(produce_tick.get(key, 0), prev_use) + 1,
                    deadline=at_tick))
                if needs_later:
                    spilled[key] = at_tick
            del resident[key]
            used_banks -= tl.banks   # push frees within its tick
            death.append((key, at_tick))
            evicted_at[key] = at_tick
        for entry in skipped:
            heapq.heappush(evict_heap, entry)

    def make_resident(tl: TileRef, at_tick: int, compute_tick: int,
                      needed: Set[Tuple[str, int]],
                      via: Optional[str]) -> None:
        nonlocal used_banks
        if tl.key in resident:
            return
        if via is not None and compute_tick > at_tick \
                and evicted_at.get(tl.key) == at_tick:
            # the tile was evicted *within* this very tick (to make room
            # for this tick's outputs) — a same-tick refetch would race
            # the death event in the allocator/executor replay, so issue
            # the fetch in the compute tick instead (the supported
            # late-fetch slot: the controller sequences DMA before the
            # compute job within a tick).  Interleaved fused orders hit
            # this whenever a tile is used at ticks t-1 and t+1 but not t.
            at_tick = compute_tick
        if avail(at_tick) < tl.banks:
            evict(at_tick, needed, tl.banks)
        if avail(at_tick) < tl.banks and via is not None \
                and compute_tick > at_tick:
            # late-fetch fallback: issue the fetch in the compute tick
            # itself (the controller sequences DMA before the compute
            # job within a tick), so banks embargoed by tiles that died
            # in the previous tick become usable.  Costs pipeline slack,
            # which the DAE max(l_DM, l_C) accounting absorbs.
            reap(compute_tick - 1)
            at_tick = compute_tick
            if avail(at_tick) < tl.banks:
                evict(at_tick, needed, tl.banks)
        if avail(at_tick) < tl.banks:
            raise RuntimeError(
                f"greedy scheduler over capacity at tick {at_tick}: "
                f"need {tl.banks}, avail {avail(at_tick)} "
                f"(working set too large for TCM)")
        if via is not None:
            t = g.tensors[tl.tensor]
            # a re-fetch may never be re-timed before the eviction that
            # made it necessary — the death event would erase it in the
            # allocator/executor replay
            if tl.key in spilled:
                rel = spilled.pop(tl.key) + 1
            elif t.is_param or t.kind == "input":
                rel = evicted_at.get(tl.key, -1) + 1
            else:
                rel = max(produce_tick.get(tl.key, 0),
                          evicted_at.get(tl.key, -1)) + 1
            decisions.append(_DmaDecision(
                via, tl, tl.nbytes, dma_cost(cfg, tl.nbytes),
                max(rel, at_tick), release=rel,
                deadline=compute_tick - 1))
        resident[tl.key] = tl
        used_banks += tl.banks
        heapq.heappush(evict_heap,
                       (-next_use(tl.key, at_tick), tl.key))

    prev_needed: Set[Tuple[str, int]] = set()
    for s in steps:
        now = s.idx + 1
        reap(now - 1)
        needed = {tl.key for tl in s.in_act + s.in_par + s.out_tiles}
        # deps resident by tick `now` (fetched at <= now-1).  The fetch
        # runs concurrently with tick now-1's compute, so that step's
        # tiles are also untouchable (Eq. 3) — evicting them would force
        # the allocator into a repair spill.
        for tl in s.in_act + s.in_par:
            if tl.key not in resident:
                make_resident(tl, now - 1, now, needed | prev_needed,
                              via="fetch")
        # l-copy / format rearrangement right before compute
        if s.copy_bytes:
            dummy = TileRef(f"__halo__{s.idx}", 0, 0, 0, s.copy_bytes,
                            max(1, math.ceil(s.copy_bytes / cfg.bank_bytes)))
            decisions.append(_DmaDecision(
                "lcopy", dummy, s.copy_bytes,
                dma_cost(cfg, s.copy_bytes, kind="tcm"),
                now - 1, release=max(0, now - 2), deadline=now - 1))
            # the staging buffer dies with its compute — without this the
            # allocator holds its banks for the rest of the program
            death.append((dummy.key, now))
        # outputs occupy banks from the compute tick
        reap(now)
        for tl in s.out_tiles:
            make_resident(tl, now, now, needed, via=None)
        # this step consumed its inputs: their next_use advanced — push
        # refreshed heap entries so far-use tiles keep accurate priority
        for tl in s.in_act + s.in_par:
            if tl.key in resident:
                heapq.heappush(evict_heap,
                               (-next_use(tl.key, now + 1), tl.key))
        # retire tiles whose last use was this tick (banks free at now+1)
        for key in list(resident):
            if last_use.get(key, produce_tick.get(key, 0)) <= now \
                    and key not in {o.key for o in s.out_tiles}:
                tl = resident[key]
                is_out = g.tensors[tl.tensor].kind == "output"
                if is_out:
                    # the push IS the release event — recording a death
                    # too would drop the tile before its push executes
                    decisions.append(_DmaDecision(
                        "push", tl, tl.nbytes, dma_cost(cfg, tl.nbytes),
                        min(now + 1, T + 1), release=now + 1,
                        deadline=T + 1))
                else:
                    death.append((key, now))
                del resident[key]
                used_banks -= tl.banks
                pending_free.append((now + 1, tl.banks))
        prev_needed = needed

    # leftover residents that are model outputs must be pushed
    for key, tl in list(resident.items()):
        if g.tensors[tl.tensor].kind == "output":
            decisions.append(_DmaDecision(
                "push", tl, tl.nbytes, dma_cost(cfg, tl.nbytes),
                T + 1,
                release=max(produce_tick.get(key, T),
                            last_use.get(key, 0)) + 1,
                deadline=T + 1))
    return decisions, death


# --------------------------------------------------------------------------
# CP re-timing per partition window
# --------------------------------------------------------------------------


@dataclass
class _WindowCP:
    """One partition window's CP: model + var map + warm start.

    Windows partition the jobs by greedy tick and re-time strictly within
    [a, b), so they share no variables — building them all first and
    solving the batch concurrently (cpsolver.solve_many) is equivalent to
    the sequential sweep."""

    window_jobs: List[_DmaDecision]
    model: CPModel
    x: Dict[Tuple[int, int], int]
    warm: Dict[int, int]

    def apply(self, sol: cpsolver.Solution) -> None:
        if sol.feasible:
            for (ji, t), v in self.x.items():
                if sol[v]:
                    self.window_jobs[ji].tick = t


def _build_window_cp(cfg: NPUConfig, steps: List[_Step],
                     jobs: List[_DmaDecision], a: int, b: int,
                     l_c: Dict[int, int], opt: SchedOptions
                     ) -> Optional[_WindowCP]:
    """Build the CP that re-times jobs whose greedy tick is in [a, b) to
    minimize Eq. (8) over that window."""
    # Jobs whose legal window is inverted (deadline < release) are the
    # scheduler's same-tick late fetches: a tile spilled at tick t and
    # re-needed at t+1 is re-fetched *in* its compute tick (the
    # controller sequences DMA before compute within a tick).  They must
    # stay at their greedy tick — clamping them into [deadline, deadline]
    # would move the fetch before its own spill push and break
    # residency.  Fused (interleaved) orders hit this routinely.
    def _movable(j: _DmaDecision) -> bool:
        return min(j.deadline, b - 1) >= \
            max(j.release, a, j.tick - opt.fetch_window)

    window_jobs = [j for j in jobs if a <= j.tick < b and _movable(j)]
    if not window_jobs:
        return None
    m = CPModel(f"sched[{a}:{b})")
    x: Dict[Tuple[int, int], int] = {}
    for ji, j in enumerate(window_jobs):
        lo = max(j.release, a, j.tick - opt.fetch_window)
        hi = min(j.deadline, b - 1)
        ticks = list(range(lo, hi + 1))
        vs = []
        for t in ticks:
            v = m.bool(f"x[{ji},{t}]")
            x[(ji, t)] = v
            vs.append(v)
        m.add_exactly_one(vs, f"place:{ji}")

    # objective: per tick max(l_C, l_DM); l_DM from job placement
    mts = []
    for t in range(a, b):
        terms = [(v, window_jobs[ji].cycles)
                 for (ji, tt), v in x.items() if tt == t]
        base_dm = sum(j.cycles for j in jobs
                      if j.tick == t and j not in window_jobs)
        mts.append(MaxTerm([(l_c.get(t, 0), []),
                            (base_dm, terms)]))
    m.minimize([], const=0, max_terms=mts)

    # memory: residency extension cost of early fetches / late pushes.
    # fetch at t' keeps banks busy for [t'+1, deadline]; push at t' frees
    # banks after t'.  Capacity per tick:
    cap = int(cfg.tcm_banks * opt.tcm_frac)
    # base occupancy from the greedy placement of *all* jobs:
    # approximate — only constrain the delta movement of window jobs.
    for t in range(a, b):
        terms = []
        for ji, j in enumerate(window_jobs):
            if j.kind == "fetch":
                # resident at t if placed at t' <= t-1 (vs greedy j.tick)
                for tt in range(max(j.release, a), min(t, j.deadline + 1)):
                    if (ji, tt) in x and tt < j.tick:
                        terms.append((x[(ji, tt)], j.tile.banks))
        if terms:
            # headroom: banks unused at tick t under greedy (approximate
            # with 25% of capacity — the greedy targets tcm_frac*banks)
            m.add(terms, "<=", max(1, cap // 4), f"mem:{t}")

    ws = {}
    for (ji, t), v in x.items():
        ws[v] = 1 if window_jobs[ji].tick == t else 0
    # warm start legal by construction (greedy tick inside var range)
    return _WindowCP(window_jobs, m, x, ws)


def _retime_windows(cfg: NPUConfig, steps: List[_Step],
                    jobs: List[_DmaDecision],
                    windows: List[Tuple[int, int]],
                    l_c: Dict[int, int], opt: SchedOptions) -> None:
    """Build every window CP, solve the batch (concurrently when the
    windows are independent), and apply the chosen ticks in place."""
    cps = [w for w in (_build_window_cp(cfg, steps, jobs, a, b, l_c, opt)
                       for a, b in windows) if w is not None]
    if not cps:
        return
    tasks = [cpsolver.SolveTask(w.model, time_limit_s=opt.cp_time_limit_s,
                                warm_start=w.warm,
                                stall_limit_s=opt.cp_stall_s,
                                stall_limit_nodes=opt.cp_stall_nodes,
                                engine=opt.cp_engine)
             for w in cps]
    sols = cpsolver.solve_many(tasks, parallel=opt.parallel_cp)
    for w, sol in zip(cps, sols):
        w.apply(sol)


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------


def schedule(cfg: NPUConfig, g: Graph, plan: FormatPlan,
             tiling: TilingResult, opt: Optional[SchedOptions] = None
             ) -> NPUProgram:
    opt = opt or SchedOptions()
    steps = _expand_steps(cfg, g, plan, tiling)
    T = len(steps)
    jobs, death = _greedy_schedule(cfg, g, steps, opt)
    l_c = {s.idx + 1: s.cycles for s in steps}

    if opt.overlap and opt.cp_time_limit_s > 0:
        if opt.partition:
            P = opt.partition_steps
            windows = [(a, min(a + P, T + 2))
                       for a in range(0, T + 2, P)]
        else:
            windows = [(0, T + 2)]
        _retime_windows(cfg, steps, jobs, windows, l_c, opt)

    ticks = [Tick(i) for i in range(T + 2)]
    for s in steps:
        ticks[s.idx + 1].compute = ComputeJob(
            s.op.name, s.out_tiles, s.in_act + s.in_par, s.fmt,
            s.cycles, s.macs, r0=s.r0, r1=s.r1, axis=s.axis)
    for j in jobs:
        t = min(max(j.tick, 0), T + 1)
        ticks[t].dma.append(DmaJob(j.kind, j.tile, j.nbytes, j.cycles))

    dead_after: Dict[int, List[Tuple[str, int]]] = {}
    for key, t in death:
        dead_after.setdefault(t, []).append(key)

    prog = NPUProgram(g.name, cfg, ticks, dm_penalty=opt.dm_penalty,
                      meta={"dead_after_tick": dead_after,
                            "overlap": opt.overlap,
                            "n_steps": T})
    return prog
