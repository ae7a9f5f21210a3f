"""TCM memory allocation + V2P emission (paper §IV-D).

Given the timed job program, allocation reserves virtual space for every
resident tile, assigns physical banks, and emits the V2P remap updates so
the compute engines see contiguous data.  The paper's four properties map
onto this implementation as:

  a) *virtual-space contiguity* — tiles of a tensor get consecutive
     virtual slots (tensor base + tile index), recorded in the program
     meta for the executor;
  b) *physical preservation* — a tile's bank set never changes while it
     is resident (bank sets are only assigned on acquisition);
  c) *reuse optimization* — banks freed by tiles dying at a tick are
     preferentially recycled for that tick's outputs (output-over-input
     overwriting);
  d) *bank exclusivity* — banks are whole-tile granular, so two tensors
     never share a bank; asserted on every acquisition.

Because the V2P table makes physical banks interchangeable, a feasible
allocation exists whenever the scheduler respected the Eq. (7) capacity
constraint; the paper's CP formulation is needed on hardware with
*address-contiguous* physical constraints, which V2P removes.  The
allocator still verifies capacity tick-by-tick and can locally *re-time*
jobs (delay a prefetch, advance a push) to repair transient
over-subscription introduced by the scheduler's windowed re-timing; a
genuine overflow raises :class:`AllocationError`.

Copy of the JAX package's ``core/allocation.py`` (pure Python; the port imports
nothing of that package and keeps its own copy).  The tests hold
it equal to the original.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .npu import NPUConfig
from .program import DmaJob, NPUProgram, Tick, TileRef, V2PJob


class AllocationError(RuntimeError):
    pass


@dataclass
class Allocation:
    banks: Dict[Tuple[str, int], List[int]] = field(default_factory=dict)
    tiles: Dict[Tuple[str, int], "TileRef"] = field(default_factory=dict)
    peak_banks: int = 0
    v2p_updates: int = 0
    repair_spills: int = 0
    spill_events: List = field(default_factory=list)


def allocate(prog: NPUProgram, cfg: Optional[NPUConfig] = None
             ) -> Allocation:
    """Assign physical banks over the program's ticks; mutates `prog` by
    appending V2P jobs and possibly re-timing DMA jobs (fix-up)."""
    cfg = cfg or prog.cfg
    n_banks = cfg.tcm_banks
    free: List[int] = list(range(n_banks))
    held: Dict[Tuple[str, int], List[int]] = {}
    alloc = Allocation()
    dead_after = prog.meta.get("dead_after_tick", {})

    # Pre-scan (one pass per program): last tick each tile is used by a
    # compute or push job, the sorted compute-input use ticks per tile,
    # and the sorted ticks holding a scheduled push per tile.  The
    # force_spill/acquire fix-ups below consult these indexes instead of
    # rescanning prog.ticks[tick+1:] per repair — the rescan was
    # quadratic on programs with many repair spills.
    last_use: Dict[Tuple[str, int], int] = {}
    use_ticks: Dict[Tuple[str, int], List[int]] = {}
    push_locs: Dict[Tuple[str, int], List[int]] = {}
    for t in prog.ticks:
        if t.compute:
            for tl in t.compute.in_tiles:
                last_use[tl.key] = t.index
                use_ticks.setdefault(tl.key, []).append(t.index)
            for tl in t.compute.out_tiles:
                last_use[tl.key] = t.index
        for j in t.dma:
            if j.kind == "push":
                last_use.setdefault(j.tile.key, t.index)
                push_locs.setdefault(j.tile.key, []).append(t.index)

    def pop_push_loc(key: Tuple[str, int], after: int,
                     before: int) -> Optional[int]:
        """First tick in (after, before) holding a push of `key`; removed
        from the index (the caller moves the job)."""
        locs = push_locs.get(key)
        if not locs:
            return None
        i = bisect.bisect_right(locs, after)
        if i < len(locs) and locs[i] < before:
            return locs.pop(i)
        return None

    def move_push(key: Tuple[str, int], src: int, dst: Tick) -> bool:
        for j in prog.ticks[src].dma:
            if j.kind == "push" and j.tile.key == key:
                prog.ticks[src].dma.remove(j)
                dst.dma.append(j)
                return True
        return False  # pragma: no cover — index out of sync

    from .npu import dma_cost
    from .program import DmaJob

    protected: Set[Tuple[str, int]] = set()

    def force_spill(tick: Tick, want: int) -> None:
        """Last-resort repair: push a resident, not-currently-needed tile
        to DRAM now and schedule a re-fetch right before its next compute
        use.  Functionally exact (the executor round-trips the data);
        costs extra DDR traffic, which the latency accounting charges."""
        cands = sorted(
            ((key, banks) for key, banks in held.items()
             # synthetic staging tiles (l-copy halo buffers) have no DRAM
             # backing — they cannot round-trip through a push
             if key not in protected and not key[0].startswith("__")),
            key=lambda kv: -len(kv[1]))
        for key, banks in cands:
            if len(free) >= want:
                return
            tile = alloc.tiles.get(key)
            if tile is None:
                continue
            # next compute use of this tile (if any), via the use index
            next_use: Optional[int] = None
            us = use_ticks.get(key)
            if us:
                i = bisect.bisect_right(us, tick.index)
                if i < len(us):
                    next_use = us[i]
            # a scheduled push BEFORE the next use would now target a
            # non-resident tile — move it to this tick instead of adding
            # a duplicate
            horizon = next_use if next_use is not None \
                else len(prog.ticks)
            loc = pop_push_loc(key, tick.index, horizon)
            moved = loc is not None and move_push(key, loc, tick)
            if not moved:
                tick.dma.append(DmaJob("push", tile, tile.nbytes,
                                       dma_cost(cfg, tile.nbytes)))
            if next_use is not None:
                prog.ticks[next_use].dma.insert(0, DmaJob(
                    "fetch", tile, tile.nbytes,
                    dma_cost(cfg, tile.nbytes)))
            release(key)
            alloc.repair_spills += 1
            alloc.spill_events.append((tick.index, key, len(banks)))

    def acquire(tick: Tick, tl: TileRef) -> None:
        if tl.key in held:
            return
        if len(free) < tl.banks:
            # fix-up: advance pushes of tiles unused from here on
            for key in list(held):
                if len(free) >= tl.banks:
                    break
                if last_use.get(key, 10 ** 9) > tick.index:
                    continue  # needed later — cannot advance its push
                # tile resident but never used again: if a push job exists
                # in a later tick, advance it here and free the banks
                loc = pop_push_loc(key, tick.index, len(prog.ticks))
                if loc is not None and move_push(key, loc, tick):
                    release(key)
        if len(free) < tl.banks:
            force_spill(tick, tl.banks)
        if len(free) < tl.banks:
            raise AllocationError(
                f"tick {tick.index}: need {tl.banks} banks for {tl}, "
                f"only {len(free)} free")
        got = [free.pop() for _ in range(tl.banks)]
        held[tl.key] = got
        alloc.banks[tl.key] = got
        alloc.tiles[tl.key] = tl
        tick.v2p.append(V2PJob(tl, got, cfg.v2p_cycles))
        alloc.v2p_updates += 1
        alloc.peak_banks = max(alloc.peak_banks, n_banks - len(free))

    def release(key: Tuple[str, int]) -> None:
        banks = held.pop(key, None)
        if banks:
            free.extend(banks)

    for idx, tick in enumerate(prog.ticks):
        # 0. eviction pushes release first: the scheduler frees a pushed
        #    tile's banks within its tick, and evicted tiles are never
        #    inputs of the tick's compute (Eq. 3) — so their release is
        #    ordered before this tick's fetch acquisitions.
        compute_keys = set()
        if tick.compute:
            compute_keys = {tl.key for tl in tick.compute.in_tiles
                            + tick.compute.out_tiles}
        protected.clear()
        protected.update(compute_keys)
        protected.update(j.tile.key for j in tick.dma
                         if j.kind in ("fetch", "lfetch", "lcopy"))
        early_released = set()
        for j in tick.dma:
            if j.kind == "push" and j.tile.key not in compute_keys:
                release(j.tile.key)
                early_released.add(j.tile.key)
        # 1. fetches/l-copies acquire banks (written during this tick).
        #    A fetch that doesn't fit yet is DEFERRED to the next tick —
        #    legal until (and including) the tick of its first compute
        #    use, since the controller sequences DMA before the compute
        #    job within a tick.  This repairs residual drift between the
        #    scheduler's bank model and the physical ledger.
        for j in list(tick.dma):
            if j.kind in ("fetch", "lfetch", "lcopy"):
                if j.tile.key in held:
                    continue
                if len(free) < j.tile.banks \
                        and j.tile.key not in compute_keys \
                        and idx + 1 < len(prog.ticks):
                    tick.dma.remove(j)
                    prog.ticks[idx + 1].dma.append(j)
                    continue
                acquire(tick, j.tile)
        # 2. compute: inputs must be held; outputs acquire
        if tick.compute:
            for tl in tick.compute.in_tiles:
                if tl.key not in held:
                    raise AllocationError(
                        f"tick {tick.index}: input {tl} of "
                        f"{tick.compute.op_name} not resident")
            # bank exclusivity: inputs/outputs disjoint by construction —
            # verify no bank appears twice across held tiles
            for tl in tick.compute.out_tiles:
                acquire(tick, tl)
        # 3. remaining pushes release banks at end of tick
        for j in tick.dma:
            if j.kind == "push" and j.tile.key not in early_released:
                release(j.tile.key)
        # 4. dead tiles release
        for key in dead_after.get(tick.index, []):
            release(tuple(key))
        # invariant: a bank is held by at most one tile
        seen: Set[int] = set()
        for key, banks in held.items():
            for b in banks:
                if b in seen:
                    raise AllocationError(f"bank {b} double-held")
                seen.add(b)

    prog.meta["peak_banks"] = alloc.peak_banks
    prog.meta["v2p_updates"] = alloc.v2p_updates
    return alloc
