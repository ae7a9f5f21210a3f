"""Temporal tiling + layer fusion (paper §IV-C).

Feature maps can exceed the TCM, so tensors are split into line-range
tiles processed at different times; interleaving tiles across layers
(*layer fusion*) shrinks the live working set so intermediate maps never
round-trip through DRAM.  Following the paper:

  * **two tile-size options per tensor** (`LS_{k,i}` selection variables):
    the largest tile whose working set fits the TCM, and that size reduced
    by a fixed factor;
  * a **single-memory-level CP** whose objective minimizes the summed
    over-capacity memory profile ``sum_t MemTh_t`` (Eq. 9-12) — with
    ``MemTh_t`` tight at optimum this equals the linear form
    ``sum_t sum_j banks_j * TCM(j,t)`` used here;
  * **region decomposition**: fusion is attempted only inside regions
    whose activations cannot all be held on-chip; everything else is
    scheduled layer-by-layer (the paper's scalability lever, Table II);
  * ops whose parameters exceed a TCM fraction are partitioned **by
    output channels** ("sub-problems with fewer output features" so
    weights stream set-by-set, paper §III-B) — their outputs are
    channel-tiled and each step consumes only its own weight chunk.

The output is (a) the per-tensor tiling and (b) a global, tile-granular
compute order consumed by the scheduler.

Copy of the JAX package's ``core/tiling.py`` (pure Python; the port imports
nothing of that package and keeps its own copy).  The tests hold
it equal to the original.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs import trace as _trace
from . import cpsolver
from .formats import FormatPlan
from .ir import Graph, Op, Tensor
from .npu import NPUConfig, cross_window_spill_cost
from .program import TileRef

# --------------------------------------------------------------------------
# Receptive-field helpers (shared with the executor)
# --------------------------------------------------------------------------


def in_row_range(op: Op, out_r0: int, out_r1: int, in_h: int
                 ) -> Tuple[int, int]:
    """Input rows [r0, r1) needed to produce output rows [out_r0, out_r1).
    Clipped to the valid input range (padding supplies the rest)."""
    k = op.kind
    a = op.attrs
    if k in ("conv", "dwconv", "maxpool", "avgpool"):
        if k == "avgpool" and a.get("k", 1) == 0:
            return (0, in_h)  # global pool needs everything
        kh = a["k"][0] if isinstance(a.get("k"), tuple) else a.get("k", 1)
        s = a.get("stride", 1)
        pt = a.get("pad", (0, 0, 0, 0))[0]
        r0 = out_r0 * s - pt
        r1 = (out_r1 - 1) * s - pt + kh
        lo = max(0, min(r0, in_h))
        hi = min(in_h, max(0, r1))
        return (min(lo, hi), hi)
    if k == "resize":
        f = a["factor"]
        return (out_r0 // f, min(in_h, (out_r1 + f - 1) // f))
    if k in ("fc",):
        return (0, in_h)
    if k in ("attention", "kvappend"):
        # attention reads the whole KV cache for any query-row tile;
        # kvappend's write offset is dynamic (the pos tensor), so every
        # output tile may need any input row.  matmul / layernorm /
        # softmax are per-token and use the 1:1 default below.
        return (0, in_h)
    if in_h == 1:
        return (0, 1)  # broadcast input (e.g. SE-block (1,1,C) scale)
    # elementwise / concat / split / act / scalar: 1:1 rows
    return (out_r0, min(in_h, out_r1))


# --------------------------------------------------------------------------
# Tiling data model
# --------------------------------------------------------------------------


@dataclass
class TensorTiles:
    tensor: str
    tiles: List[TileRef]

    @property
    def n(self) -> int:
        return len(self.tiles)

    @property
    def axis(self) -> str:
        return self.tiles[0].axis if self.tiles else "rows"

    def covering(self, r0: int, r1: int) -> List[TileRef]:
        """Tiles overlapping output-row range [r0, r1).  Channel-tiled
        tensors span all rows, so every tile overlaps."""
        if self.axis == "chan":
            return list(self.tiles)
        return [t for t in self.tiles if t.r0 < r1 and t.r1 > r0]

    def covering_chan(self, c0: int, c1: int) -> List[TileRef]:
        if self.axis != "chan":
            return list(self.tiles)
        return [t for t in self.tiles if t.r0 < c1 and t.r1 > c0]


@dataclass
class ComputeStep:
    """One tile-granular compute: `op` producing rows (axis == "rows") or
    channels (axis == "chan") [r0, r1) of each of its outputs."""

    op_name: str
    r0: int
    r1: int
    axis: str = "rows"

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.op_name}[{self.r0}:{self.r1}@{self.axis}]"


@dataclass
class TilingResult:
    tiles: Dict[str, TensorTiles]           # tensor -> tiles
    order: List[ComputeStep]                # global tile compute order
    regions: List[List[str]]                # op-name regions (diagnostics)
    fusion_objective: float = 0.0           # CP objective (memory-ticks)
    stats: Dict = field(default_factory=dict)
    #: alternate plan with every windowed region's order replaced by its
    #: greedy order — set only when they differ.  The compile ladder
    #: races both through the scheduler and keeps the better program
    #: (the window CP objective is a proxy; the never-worse-than-greedy
    #: guarantee comes from this race).  Never serialized.
    fallback: Optional["TilingResult"] = None

    def tile_of(self, tensor: str, idx: int) -> TileRef:
        return self.tiles[tensor].tiles[idx]


def _mk_tiles(t: Tensor, n: int, bank_bytes: int,
              axis: str = "rows") -> List[TileRef]:
    """Split tensor into `n` tiles along rows/channels (params: outC)."""
    if t.is_param:
        oc = t.shape[0]
        n = min(n, max(oc, 1))
        per = [oc // n + (1 if i < oc % n else 0) for i in range(n)]
        refs, c0 = [], 0
        bytes_per_oc = t.bytes / max(oc, 1)
        for i, p in enumerate(per):
            nb = max(1, math.ceil(p * bytes_per_oc))
            refs.append(TileRef(t.name, i, c0, c0 + p, nb,
                                max(1, math.ceil(nb / bank_bytes)), "chan"))
            c0 += p
        return refs
    if axis == "chan":
        C = t.shape[-1]
        n = min(n, max(C, 1))
        per = [C // n + (1 if i < C % n else 0) for i in range(n)]
        refs, c0 = [], 0
        bytes_per_c = t.bytes / max(C, 1)
        for i, p in enumerate(per):
            nb = max(1, math.ceil(p * bytes_per_c))
            refs.append(TileRef(t.name, i, c0, c0 + p, nb,
                                max(1, math.ceil(nb / bank_bytes)), "chan"))
            c0 += p
        return refs
    H = t.shape[0] if len(t.shape) == 3 else 1
    n = min(n, max(H, 1))
    rows = [H // n + (1 if i < H % n else 0) for i in range(n)]
    refs, r0 = [], 0
    bytes_per_row = t.bytes / max(H, 1)
    for i, rr in enumerate(rows):
        nb = max(1, math.ceil(rr * bytes_per_row))
        refs.append(TileRef(t.name, i, r0, r0 + rr, nb,
                            max(1, math.ceil(nb / bank_bytes)), "rows"))
        r0 += rr
    return refs


# --------------------------------------------------------------------------
# Tile-size options (the paper's LS_{k,i}, two options per tensor)
# --------------------------------------------------------------------------


def _param_bytes(g: Graph, op: Op) -> int:
    return sum(p.bytes for p in g.param_inputs(op))


def _chan_split(cfg: NPUConfig, g: Graph, op: Op) -> int:
    """#channel sub-problems for a huge-parameter op (0 = not needed).

    The compute steps of a channel-split op follow its *weight* chunks
    (so only one chunk streams through TCM at a time); its output is
    tiled separately at whole-bank granularity (see _tile_options) and
    written channel-slice by channel-slice into resident tiles — output
    co-residency therefore costs the tensor's true footprint, not one
    bank per weight chunk."""
    pb = _param_bytes(g, op)
    if op.kind in ("conv", "fc", "matmul") and pb > cfg.tcm_bytes // 4:
        return min(int(math.ceil(pb / (cfg.tcm_bytes / 8))),
                   g.tensors[op.output].shape[-1])
    return 0


def _tile_options(cfg: NPUConfig, g: Graph, budget_frac: float = 0.5,
                  naive: bool = False
                  ) -> Dict[str, Tuple[int, int, str]]:
    """tensor -> (n_tiles option A, option B, axis).

    ``naive=True`` reproduces the reference-stack behaviour the paper
    describes in §IV-C: the tile bound only ensures the tile itself fits
    the TCM — it ignores the dependencies that must be co-resident, so
    adjacent layers' buffers thrash through DRAM.  This is the
    eNPU-A/B-style baseline tiling."""
    budget = int(cfg.tcm_bytes * budget_frac)
    opts: Dict[str, Tuple[int, int, str]] = {}
    for t in g.tensors.values():
        if t.is_param:
            n = 1
            while t.bytes / n > cfg.tcm_bytes / 8 and n < max(t.shape[0], 1):
                n *= 2
            opts[t.name] = (n, n, "chan")
            continue
        prod = t.producer
        if prod is not None:
            cs = _chan_split(cfg, g, g.op(prod))
            if cs:
                # bank-clamped: each output chunk fills >= 1 bank, so a
                # consumer gathering the whole tensor holds its true
                # byte footprint, not one bank per weight chunk
                n_out = max(1, min(cs, math.ceil(t.bytes
                                                 / cfg.bank_bytes)))
                opts[t.name] = (n_out, n_out, "chan")
                continue
        H = t.shape[0] if len(t.shape) == 3 else 1
        if naive:
            # naive upper bound: the tile alone fits — dependencies are
            # NOT accounted (shrinks along the retry ladder via
            # budget_frac so the baseline still always compiles)
            frac = min(0.45, budget_frac * 0.9)
            n = 1
            while t.bytes / n > cfg.tcm_bytes * frac and n < max(H, 1):
                n *= 2
            opts[t.name] = (n, n, "rows")
            continue
        n = 1
        while n < max(H, 1):
            rows = math.ceil(H / n)
            ws = math.ceil(t.bytes / n)
            if prod is not None:
                op = g.op(prod)
                for x in g.act_inputs(op):
                    ih = x.shape[0] if len(x.shape) == 3 else 1
                    a, b = in_row_range(op, 0, rows, ih)
                    ws += math.ceil(x.bytes * (b - a) / max(ih, 1))
                ws += sum(min(p.bytes, budget // 4)
                          for p in g.param_inputs(op))
            if ws <= budget:
                break
            n *= 2
        opts[t.name] = (n, min(2 * n, max(H, 1)), "rows")
    return opts


# --------------------------------------------------------------------------
# Region decomposition
# --------------------------------------------------------------------------


def _regions(cfg: NPUConfig, g: Graph,
             opts: Dict[str, Tuple[int, int, str]]) -> List[List[Op]]:
    """Maximal runs of row-tiled ops whose activation working set exceeds
    the TCM — fusion candidates; channel-partitioned ops and cold ops form
    singleton regions (paper §IV-C)."""
    thresh = cfg.tcm_bytes // 2
    regions: List[List[Op]] = []
    cur: List[Op] = []
    cur_hot = False
    for op in g.topo_ops():
        acts = [g.tensors[o] for o in op.outputs] + g.act_inputs(op)
        chan = any(opts[o][2] == "chan" for o in op.outputs)
        hot = (not chan) and sum(t.bytes for t in acts) > thresh
        if hot and cur_hot:
            cur.append(op)
        else:
            if cur:
                regions.append(cur)
            cur = [op]
            cur_hot = hot
    if cur:
        regions.append(cur)
    return regions


# --------------------------------------------------------------------------
# Greedy fused order (warm start + large-region fallback)
# --------------------------------------------------------------------------


def _greedy_order(g: Graph, region: List[Op],
                  tiles: Dict[str, TensorTiles]) -> List[ComputeStep]:
    """Depth-first fusion: emit each op's tiles as soon as the input rows
    they need have been produced — classic cascaded/fused execution."""
    region_ops = {op.name for op in region}
    produced_rows: Dict[str, int] = {}   # tensor -> rows available
    for t in g.tensors.values():
        if t.producer is None or t.producer not in region_ops:
            produced_rows[t.name] = t.shape[0] if len(t.shape) == 3 else 1
    emitted: Dict[str, int] = {op.name: 0 for op in region}
    order: List[ComputeStep] = []
    progress = True
    while progress:
        progress = False
        for op in region:
            out0 = g.tensors[op.outputs[0]]
            otiles = tiles[out0.name].tiles
            while emitted[op.name] < len(otiles):
                tl = otiles[emitted[op.name]]
                ok = True
                for x in g.act_inputs(op):
                    ih = x.shape[0] if len(x.shape) == 3 else 1
                    _, need = in_row_range(op, tl.r0, tl.r1, ih)
                    if produced_rows.get(x.name, 0) < need:
                        ok = False
                        break
                if not ok:
                    break
                order.append(ComputeStep(op.name, tl.r0, tl.r1, tl.axis))
                emitted[op.name] += 1
                for o in op.outputs:
                    produced_rows[o] = tl.r1 \
                        if len(g.tensors[o].shape) == 3 else 1
                progress = True
    _emit_leftovers(g, region, tiles, emitted, order)
    return order


def _emit_leftovers(g: Graph, region: List[Op],
                    tiles: Dict[str, TensorTiles],
                    emitted: Dict[str, int],
                    order: List[ComputeStep]) -> None:
    """Safety net for tiles the fixpoint loop could not place (e.g. a
    region handed over in non-topological order).  Leftovers are emitted
    op-by-op in *topological* order, which is row-dependency-sound: by
    the time an op's remaining tiles are appended, every region-internal
    producer has its full output in `order` — either from the fixpoint
    loop or appended earlier in this sweep."""
    left = [op for op in region
            if emitted[op.name]
            < len(tiles[g.tensors[op.outputs[0]].name].tiles)]
    if not left:
        return
    rank = {op.name: i for i, op in enumerate(g.topo_ops())}
    for op in sorted(left, key=lambda o: rank[o.name]):
        out0 = g.tensors[op.outputs[0]]
        otiles = tiles[out0.name].tiles
        for tl in otiles[emitted[op.name]:]:
            order.append(ComputeStep(op.name, tl.r0, tl.r1, tl.axis))
        emitted[op.name] = len(otiles)


def validate_order(g: Graph, region: List[Op],
                   tiles: Dict[str, TensorTiles],
                   order: Sequence[ComputeStep]) -> List[str]:
    """Row-dependency audit of one region's compute order.

    Checks, tile-granularly (what the scheduler and executor require):
      * every step names a region op and no step repeats;
      * every tile of every op's primary output is produced exactly once;
      * when a step runs, every region-internal input tile overlapping
        its receptive field (:func:`in_row_range`) was already produced.

    Returns human-readable violations (empty list == sound).  Shared by
    the windowed-fusion stitcher (seam safety net) and the property
    tests in ``tests/test_fusion_windows.py``.
    """
    errs: List[str] = []
    region_ops = {op.name for op in region}
    produced: Dict[str, set] = {}
    for op in region:
        for o in op.outputs:
            produced[o] = set()
    seen: set = set()
    for pos, st in enumerate(order):
        if st.op_name not in region_ops:
            errs.append(f"step {pos}: {st.op_name} not in region")
            continue
        op = g.op(st.op_name)
        skey = (st.op_name, st.r0, st.r1, st.axis)
        if skey in seen:
            errs.append(f"step {pos}: duplicate {st!r}")
        seen.add(skey)
        for x in g.act_inputs(op):
            if x.producer not in region_ops:
                continue
            ih = x.shape[0] if len(x.shape) == 3 else 1
            if st.axis == "chan":
                a, b = 0, ih
            else:
                a, b = in_row_range(op, st.r0, st.r1, ih)
            for tl in tiles[x.name].covering(a, b):
                if tl.index not in produced[x.name]:
                    errs.append(
                        f"step {pos}: {st!r} needs {x.name}#{tl.index} "
                        f"(rows [{a},{b})) before it is produced")
        for o in op.outputs:
            tt = tiles[o]
            cov = tt.covering_chan(st.r0, st.r1) if st.axis == "chan" \
                else tt.covering(st.r0, st.r1)
            for tl in cov:
                if tl.r0 >= st.r0 and tl.r1 <= st.r1:
                    produced[o].add(tl.index)
    for op in region:
        o0 = op.outputs[0]
        missing = [tl.index for tl in tiles[o0].tiles
                   if tl.index not in produced[o0]]
        if missing:
            errs.append(f"{op.name}: output tiles {missing} never computed")
    return errs


# --------------------------------------------------------------------------
# Fusion CP (per region)
# --------------------------------------------------------------------------


@dataclass
class _FusionCP:
    """One region's fusion CP: model + var maps + greedy fallback.

    Regions share no CP variables, so the models of every fusion-eligible
    region are built first and the batch is solved concurrently
    (cpsolver.solve_many) before the solutions are read back in region
    order."""

    region: List[Op]
    cand: Dict[str, List[List[TileRef]]]
    LS: Dict[Tuple[str, int], int]
    comp: Dict[Tuple[str, int, int, int], int]
    model: CPModel
    warm: Dict[int, int]
    greedy: List[ComputeStep]

    def extract(self, g: Graph, sol: cpsolver.Solution
                ) -> Tuple[Dict[str, int], List[ComputeStep], float]:
        if not sol.feasible:  # fall back to the greedy warm start
            chosen = {onm: len(self.cand[onm][0]) for onm in self.cand}
            return chosen, self.greedy, float("inf")
        chosen: Dict[str, int] = {}
        for oname, variants in self.cand.items():
            for k in range(len(variants)):
                if sol[self.LS[(oname, k)]]:
                    chosen[oname] = len(variants[k])
        steps: List[Tuple[int, ComputeStep]] = []
        for (opn, k, j, t), v in self.comp.items():
            if sol[v]:
                oname = g.op(opn).outputs[0]
                if sol[self.LS[(oname, k)]]:
                    tl = self.cand[oname][k][j]
                    steps.append((t, ComputeStep(opn, tl.r0, tl.r1,
                                                 tl.axis)))
        steps.sort(key=lambda x: x[0])
        return chosen, [s for _, s in steps], sol.objective


def _build_fusion_cp(cfg: NPUConfig, g: Graph, region: List[Op],
                     opts: Dict[str, Tuple[int, int, str]]) -> _FusionCP:
    """Build the CP choosing LS (tiles-per-tensor) and tile order for one
    region."""
    region_ops = {op.name for op in region}
    bank = cfg.bank_bytes

    # candidate tilings per produced tensor (option A / B)
    cand: Dict[str, List[List[TileRef]]] = {}
    for op in region:
        for oname in op.outputs:
            t = g.tensors[oname]
            a, b, axis = opts[oname]
            variants = [_mk_tiles(t, a, bank, axis)]
            if b != a:
                variants.append(_mk_tiles(t, b, bank, axis))
            cand[oname] = variants

    m = cpsolver.CPModel(f"fusion:{region[0].name}")
    LS: Dict[Tuple[str, int], int] = {}
    for oname, variants in cand.items():
        vs = [m.bool(f"LS[{oname},{k}]") for k in range(len(variants))]
        for k, v in enumerate(vs):
            LS[(oname, k)] = v
        m.add_exactly_one(vs, f"one-size:{oname}")

    # T ticks = total tiles of the *larger* option per op
    T = sum(max(len(v) for v in cand[op.outputs[0]]) for op in region)
    T = max(T, 1)

    comp: Dict[Tuple[str, int, int, int], int] = {}
    state: Dict[Tuple[str, int, int, int], int] = {}
    for op in region:
        oname = op.outputs[0]
        for k, variant in enumerate(cand[oname]):
            for j, tl in enumerate(variant):
                cvars = []
                for t in range(T):
                    cv = m.bool(f"c[{op.name},{k},{j},{t}]")
                    comp[(op.name, k, j, t)] = cv
                    cvars.append(cv)
                # computed exactly once iff option selected
                m.add([(cv, 1) for cv in cvars]
                      + [(LS[(oname, k)], -1)], "==", 0,
                      f"once:{op.name}/{k}/{j}")
                # state chain (single-level model: enter only via compute)
                prev = None
                for t in range(T):
                    sv = m.bool(f"s[{oname},{k},{j},{t}]")
                    state[(oname, k, j, t)] = sv
                    terms = [(sv, 1), (comp[(op.name, k, j, t)], -1)]
                    if prev is not None:
                        terms.append((prev, -1))
                    m.add(terms, "<=", 0, f"persist:{oname}/{k}/{j}/{t}")
                    prev = sv

    # at most one compute per tick
    for t in range(T):
        m.add([(v, 1) for (onm, k, j, tt), v in comp.items() if tt == t],
              "<=", 1, f"one-comp:{t}")

    # dependency: computing a tile needs covering region-internal input
    # tiles resident (under whichever option of the input is selected)
    for op in region:
        oname = op.outputs[0]
        for k, variant in enumerate(cand[oname]):
            for j, tl in enumerate(variant):
                for x in g.act_inputs(op):
                    if x.producer not in region_ops:
                        continue
                    ih = x.shape[0] if len(x.shape) == 3 else 1
                    a, b = in_row_range(op, tl.r0, tl.r1, ih)
                    for k2, variant2 in enumerate(cand[x.name]):
                        for j2, tl2 in enumerate(variant2):
                            if tl2.r0 < b and tl2.r1 > a:
                                for t in range(T):
                                    m.add([(comp[(op.name, k, j, t)], 1),
                                           (LS[(x.name, k2)], 1),
                                           (state[(x.name, k2, j2, t)], -1)],
                                          "<=", 1)

    # objective: sum_t sum_j banks_j * state  (== sum_t MemTh_t at optimum)
    obj = [(sv, cand[oname][k][j].banks)
           for (oname, k, j, t), sv in state.items()]
    m.minimize(obj)

    # ---- warm start: option A everywhere + greedy DFS order ----
    ws_tiles = {oname: TensorTiles(oname, cand[oname][0]) for oname in cand}
    greedy = _greedy_order(g, region, ws_tiles)
    ws: Dict[int, int] = {v: 0 for v in range(m.n_vars)}
    for oname in cand:
        ws[LS[(oname, 0)]] = 1
    tick = 0
    step_tick: Dict[Tuple[str, int], int] = {}
    for st in greedy:
        op = g.op(st.op_name)
        oname = op.outputs[0]
        for j, tl in enumerate(cand[oname][0]):
            if tl.r0 == st.r0:
                ws[comp[(op.name, 0, j, tick)]] = 1
                step_tick[(op.name, j)] = tick
        tick += 1
    for op in region:
        oname = op.outputs[0]
        for j, tl in enumerate(cand[oname][0]):
            t0 = step_tick.get((op.name, j))
            if t0 is None:
                continue
            last = t0
            for cons_name in g.tensors[oname].consumers:
                if cons_name not in region_ops:
                    last = T - 1
                    break
                cop = g.op(cons_name)
                c_out = cop.outputs[0]
                ih = g.tensors[oname].shape[0] \
                    if len(g.tensors[oname].shape) == 3 else 1
                for j2, tl2 in enumerate(cand[c_out][0]):
                    a, b = in_row_range(cop, tl2.r0, tl2.r1, ih)
                    if tl.r0 < b and tl.r1 > a:
                        t2 = step_tick.get((cons_name, j2))
                        if t2 is not None:
                            last = max(last, t2)
            for t in range(t0, last + 1):
                ws[state[(oname, 0, j, t)]] = 1

    return _FusionCP(region, cand, LS, comp, m, ws, greedy)


# --------------------------------------------------------------------------
# Windowed fusion CP (oversized regions)
# --------------------------------------------------------------------------
#
# The full fusion CP is O(ops x options x tiles x T) variables, so it is
# only tractable up to ~max_cp_tiles tiles per region — yet the regions
# with the largest working sets (and the most DDR traffic to save) are
# exactly the ones over that cap.  Instead of dropping them onto the
# greedy order wholesale, an oversized region is split into overlapping
# *windows* over its greedy step sequence:
#
#   * tile sizes are fixed at option A (the fused default) — windows
#     optimize the *order* of compute steps plus the residency of
#     boundary tiles, not LS;
#   * each window is a small CP (<= max_cp_window_tiles steps): one
#     compute per tick, tile-granular row dependencies, and a state
#     chain per consumed tile.  Tiles produced before the window enter
#     as *boundary state*: a `carry` precondition (fixed via
#     cpsolver's fixed-assignment support) plus per-tick entry vars
#     priced at npu.cross_window_spill_cost — the window trades "hold
#     the tile resident" (banks per tick) against "refetch it from DDR";
#   * windows share no variables, so the whole batch — across all
#     oversized regions — solves concurrently through
#     cpsolver.solve_many, each window warm-started from its greedy
#     slice (the CP never returns an order worse than greedy under the
#     memory objective);
#   * stitching: emit each window's solved order in window sequence,
#     dropping steps an earlier window already emitted (the overlap),
#     then re-validate the seam with validate_order.  Any violation —
#     or an infeasible window — falls back to the greedy order.


#: objective scaling of the windowed fusion CP — one bank-tick of
#: residency costs 1, so DDR prices (integer multiples of a bank's DMA
#: cost) are scaled up to keep "hold a tile a few more ticks" cheaper
#: than "bounce it through DDR" under capacity.
_SPILL_SCALE = 16


def _est_region_tiles(opts: Dict[str, Tuple[int, int, str]],
                      region: List[Op]) -> int:
    """Upper-bound tile count of a region's fusion-CP model: the larger
    tile-size option of **every** output of every op (multi-output ops
    contribute all their outputs — the candidate sets the model builds)."""
    return sum(max(opts[o][0], opts[o][1])
               for op in region for o in op.outputs)


def _window_bounds(T: int, size: int, overlap: int) -> List[Tuple[int, int]]:
    """Overlapping [a, b) windows covering greedy steps [0, T)."""
    size = max(2, int(size))
    overlap = max(0, min(int(overlap), size - 1))
    bounds: List[Tuple[int, int]] = []
    a = 0
    while True:
        b = min(a + size, T)
        bounds.append((a, b))
        if b >= T:
            return bounds
        a = b - overlap


def _step_products(g: Graph, tiles: Dict[str, TensorTiles],
                   st: ComputeStep) -> List[Tuple[str, TileRef]]:
    """Output tiles (of every output) fully covered by one compute step."""
    op = g.op(st.op_name)
    out: List[Tuple[str, TileRef]] = []
    for oname in op.outputs:
        for tl in tiles[oname].tiles:
            if tl.axis == st.axis and tl.r0 >= st.r0 and tl.r1 <= st.r1:
                out.append((oname, tl))
    return out


def _step_needs(g: Graph, region_ops: set, tiles: Dict[str, TensorTiles],
                st: ComputeStep, internal: bool = True
                ) -> List[Tuple[str, TileRef]]:
    """Input tiles a step's receptive field touches — region-internal
    producers (``internal=True``) or external ones (model inputs and
    other regions' outputs, ``internal=False``)."""
    op = g.op(st.op_name)
    out: List[Tuple[str, TileRef]] = []
    for x in g.act_inputs(op):
        if (x.producer in region_ops) != internal:
            continue
        ih = x.shape[0] if len(x.shape) == 3 else 1
        a, b = in_row_range(op, st.r0, st.r1, ih)
        for tl in tiles[x.name].covering(a, b):
            out.append((x.name, tl))
    return out


@dataclass
class _WindowCP:
    """One window of an oversized fusion region: model + greedy slice."""

    lo: int                              # slice start in the greedy order
    steps: List[ComputeStep]
    model: CPModel
    comp: Dict[Tuple[int, int], int]     # (local step, tick) -> var
    warm: Dict[int, int]
    hi: int = 0                          # slice end in the greedy order
    prefix: frozenset = frozenset()      # tiles produced before ``lo``
    # key -> residency var at the window's last tick; the sequential
    # refinement reads the adopted solution here to learn which tiles
    # this window hands its successor still resident
    state_last: Dict[Tuple[str, int], int] = field(default_factory=dict)

    def order(self, sol: cpsolver.Solution
              ) -> Tuple[List[ComputeStep], float]:
        if not sol.feasible:             # fall back to the greedy slice
            return list(self.steps), float("inf")
        placed = sorted((t, i) for (i, t), v in self.comp.items()
                        if sol[v])
        return [self.steps[i] for _, i in placed], sol.objective


def _wavefront_perm(steps: List[ComputeStep],
                    needs: List[set], prods: List[set],
                    produced_before: set,
                    depth: Dict[str, int]) -> List[int]:
    """Demand-driven permutation of one window's steps: repeatedly emit
    the next tile of the *deepest* op whose dependencies are met.  The
    layer-wise greedy slice keeps whole intermediate tensors live; the
    wavefront interleaves producer/consumer tiles so each lives only a
    few ticks — a far better basin for the window CP's small node budget
    to polish than to find."""
    remaining: Dict[str, List[int]] = {}
    for i, st in enumerate(steps):
        remaining.setdefault(st.op_name, []).append(i)
    names = sorted(remaining, key=lambda n: -depth.get(n, 0))
    produced = set(produced_before)
    out: List[int] = []
    while len(out) < len(steps):
        for name in names:
            q = remaining[name]
            if q and needs[q[0]] <= produced:
                i = q.pop(0)
                out.append(i)
                produced |= prods[i]
                break
        else:   # stuck (cannot happen for a valid greedy slice): finish
            rest = sorted(i for q in remaining.values() for i in q)
            out.extend(rest)
            break
    return out


def _build_window_fusion_cp(cfg: NPUConfig, g: Graph, region: List[Op],
                            tiles: Dict[str, TensorTiles],
                            greedy: List[ComputeStep], lo: int, hi: int,
                            produced_before: set,
                            held: frozenset = frozenset()
                            ) -> Optional[_WindowCP]:
    """CP re-ordering greedy steps [lo, hi) of one region.

    ``produced_before`` is the boundary state threaded in from the
    preceding windows: the (tensor, tile-index) keys the greedy prefix
    [0, lo) has produced.  Returns None when a needed tile is neither in
    the window nor in the prefix (invariant break — caller goes greedy).

    ``held`` is the sequential-refinement input: tiles the *previous*
    window's adopted solution keeps resident at its last tick.  Those
    get their carry fixed to 1 — first-tick residency without paying a
    DDR re-entry — while everything else keeps the concurrent-solve
    assumption (carry 0, the window starts from DDR).
    """
    region_ops = {op.name for op in region}
    ws = greedy[lo:hi]
    Tw = len(ws)
    m = cpsolver.CPModel(f"fusion-win:{g.name}[{lo}:{hi})")

    comp: Dict[Tuple[int, int], int] = {}
    for i in range(Tw):
        vs = [m.bool(f"c[{i},{t}]") for t in range(Tw)]
        for t, v in enumerate(vs):
            comp[(i, t)] = v
        m.add_exactly_one(vs, f"once:{i}")
    for t in range(Tw):
        m.add([(comp[(i, t)], 1) for i in range(Tw)], "<=", 1,
              f"one-comp:{t}")

    producers: Dict[Tuple[str, int], List[int]] = {}
    refs: Dict[Tuple[str, int], TileRef] = {}
    prods: List[set] = []
    for i, st in enumerate(ws):
        p = set()
        for oname, tl in _step_products(g, tiles, st):
            key = (oname, tl.index)
            producers.setdefault(key, []).append(i)
            refs[key] = tl
            p.add(key)
        prods.append(p)
    # a step needs resident: its region-internal input tiles, its
    # region-external input tiles (the model input / other regions'
    # outputs) and its op's weight tiles.  Leaving weights or external
    # inputs out of the model lets the CP interleave many ops and thrash
    # exactly those tensors through DDR.
    needs: List[set] = []
    consumed: Dict[Tuple[str, int], List[int]] = {}
    always_keys: set = set()      # available from DDR at any tick
    for i, st in enumerate(ws):
        row = set()
        for xname, tl in _step_needs(g, region_ops, tiles, st):
            key = (xname, tl.index)
            refs[key] = tl
            row.add(key)
        for xname, tl in _step_needs(g, region_ops, tiles, st,
                                     internal=False):
            key = (xname, tl.index)
            refs[key] = tl
            row.add(key)
            always_keys.add(key)
        for p in g.param_inputs(g.op(st.op_name)):
            for tl in tiles[p.name].tiles:
                key = (p.name, tl.index)
                refs[key] = tl
                row.add(key)
                always_keys.add(key)
        for key in row:
            consumed.setdefault(key, []).append(i)
        needs.append(row)

    boundary = [k for k in consumed
                if k not in producers and k not in always_keys]
    if any(k not in produced_before for k in boundary):
        return None

    # boundary/param tiles start the window in DDR — the windows of a
    # batch solve concurrently, so no window may assume its predecessor
    # left a tile resident.  The sequential refinement pass rebuilds the
    # window with ``held`` populated and fixes carry to 1 for exactly
    # those tiles, letting them start the window resident for free.
    carry = carry_held = None
    if boundary or always_keys:
        carry = m.bool("carry")
        m.fix(carry, 0)
        if held:
            carry_held = m.bool("carry_held")
            m.fix(carry_held, 1)

    # Objective, all in units of (bank-tick / _SPILL_SCALE):
    #   * DDR re-entry of a non-window tile: its DMA cost normalized to
    #     one bank's DMA (npu.cross_window_spill_cost) x _SPILL_SCALE;
    #   * per-tick over-capacity occupancy (the paper's Eq. 9 MemTh_t):
    #     every bank above the cap costs ~ one bank round trip — over
    #     the cap the scheduler *will* spill, so overflow and explicit
    #     re-entries are priced on the same scale;
    #   * a 1-per-bank-tick residency tie-break, so under-capacity
    #     solutions still prefer compact live sets (the unmodeled rest
    #     of the program competes for the same banks).
    # Holding a tile under capacity is therefore ~free relative to
    # refetching it — matching what the DAE scheduler actually does.
    state: Dict[Tuple[Tuple[str, int], int], int] = {}
    entry: Dict[Tuple[Tuple[str, int], int], int] = {}
    obj: List[Tuple[int, int]] = []
    tick_terms: List[List[Tuple[int, int]]] = [[] for _ in range(Tw)]
    for key in sorted(consumed):
        tl = refs[key]
        in_window = key in producers
        if in_window:
            spill = 0
        else:
            # params and model inputs still live in DRAM — a re-entry is
            # one fetch; activations must round-trip (push + refetch)
            t = g.tensors[key[0]]
            one_way = t.is_param or t.kind == "input"
            spill = _SPILL_SCALE * cross_window_spill_cost(
                cfg, tl.nbytes, round_trip=not one_way)
        prev = None
        for t in range(Tw):
            sv = m.bool(f"s[{key[0]}#{key[1]},{t}]")
            state[(key, t)] = sv
            terms = [(sv, 1)]
            if prev is not None:
                terms.append((prev, -1))
            if in_window:
                terms += [(comp[(p, t)], -1) for p in producers[key]]
            else:
                ev = m.bool(f"e[{key[0]}#{key[1]},{t}]")
                entry[(key, t)] = ev
                terms.append((ev, -1))
                if prev is None:
                    terms.append((carry_held if key in held else carry,
                                  -1))
                obj.append((ev, spill))
            m.add(terms, "<=", 0, f"persist:{key}/{t}")
            obj.append((sv, tl.banks))
            tick_terms[t].append((sv, tl.banks))
            prev = sv

    for i, row in enumerate(needs):
        for key in row:
            for t in range(Tw):
                m.add([(comp[(i, t)], 1), (state[(key, t)], -1)],
                      "<=", 0, f"dep:{i}/{key}/{t}")
    over_w = _SPILL_SCALE * cross_window_spill_cost(cfg, cfg.bank_bytes)
    cap = max(4, (cfg.tcm_banks * 3) // 4)
    mts = [cpsolver.MaxTerm([(0, []),
                             (-cap * over_w,
                              [(sv, b * over_w) for sv, b in terms])])
           for terms in tick_terms if terms]
    m.minimize(obj, max_terms=mts)

    def _warm_from(pos: Dict[int, int]) -> Dict[int, int]:
        """Full warm assignment from a step -> tick placement."""
        w: Dict[int, int] = {}
        for i, t in pos.items():
            w[comp[(i, t)]] = 1
        for key, users in consumed.items():
            last = max(pos[i] for i in users)
            if key in producers:
                first = min(pos[p] for p in producers[key])
            else:
                first = min(pos[i] for i in users)
                w[entry[(key, first)]] = 1
            for t in range(first, last + 1):
                w[state[(key, t)]] = 1
        return w

    def _objective(w: Dict[int, int]) -> float:
        vals = [0] * m.n_vars
        for v, val in w.items():
            vals[v] = val
        for v, val in m.fixed.items():
            vals[v] = val
        if m.check(vals):
            return float("inf")
        return m.objective_value(vals)

    # two warm-start candidates: the greedy slice (step i at tick i) and
    # the wavefront interleaving — the incumbent is whichever the model
    # scores lower, so the CP solution is never worse than either
    depth = {op.name: i for i, op in enumerate(region)}
    greedy_warm = _warm_from({i: i for i in range(Tw)})
    perm = _wavefront_perm(ws, needs, prods,
                           produced_before | always_keys, depth)
    wave_warm = _warm_from({i: t for t, i in enumerate(perm)})
    warm = min((greedy_warm, wave_warm), key=_objective)
    if _objective(warm) == float("inf"):     # defensive: greedy must fit
        warm = greedy_warm
    state_last = {key: state[(key, Tw - 1)] for key in consumed}
    return _WindowCP(lo, list(ws), m, comp, warm, hi=hi,
                     prefix=frozenset(produced_before),
                     state_last=state_last)


@dataclass
class _WindowedFusion:
    """An oversized region's window batch + stitcher."""

    region: List[Op]
    tiles: Dict[str, TensorTiles]
    greedy: List[ComputeStep]
    windows: List[_WindowCP]

    def refine(self, cfg: NPUConfig, g: Graph,
               sols: Sequence[Optional[cpsolver.Solution]], *,
               time_limit_s: float, stall_limit_s: Optional[float],
               stall_limit_nodes: Optional[int], engine: str
               ) -> Tuple[List[Optional[cpsolver.Solution]], int]:
        """Sequential second pass over the window chain.

        The concurrent batch solve prices every boundary tile as a DDR
        re-entry because no window may assume anything about its
        neighbours.  Stitched execution *is* sequential though, so after
        the batch lands each window (except the first) is rebuilt with
        ``held`` = the tiles the previous window's adopted solution
        keeps resident at its last tick — their carry is fixed to 1 and
        the phantom re-entry cost disappears.  Adopted refinements chain
        forward: window ``i+1`` reads residency from the *refined*
        window ``i``.  Returns the updated solution list and how many
        windows adopted a refined order."""
        sols = list(sols)
        refined = 0
        for wi in range(1, len(self.windows)):
            prev, psol = self.windows[wi - 1], sols[wi - 1]
            if psol is None or not psol.feasible:
                continue
            held = frozenset(k for k, sv in prev.state_last.items()
                             if psol[sv])
            if not held:
                continue
            w = self.windows[wi]
            w2 = _build_window_fusion_cp(cfg, g, self.region, self.tiles,
                                         self.greedy, w.lo, w.hi,
                                         set(w.prefix), held=held)
            if w2 is None:
                continue
            [sol2] = cpsolver.solve_many(
                [cpsolver.SolveTask(w2.model,
                                    time_limit_s=time_limit_s,
                                    warm_start=w2.warm,
                                    stall_limit_s=stall_limit_s,
                                    stall_limit_nodes=stall_limit_nodes,
                                    engine=engine)],
                parallel=False)
            if not sol2.feasible:
                continue
            self.windows[wi] = w2
            sols[wi] = sol2
            refined += 1
        return sols, refined

    def stitch(self, g: Graph, sols: Sequence[cpsolver.Solution]
               ) -> Tuple[List[ComputeStep], float, Dict[str, int]]:
        """Merge per-window orders: emit windows in sequence, dropping
        the overlap steps an earlier window already emitted, then
        re-validate row-dependency feasibility of the seam.  Returns
        (order, objective, info); any violation falls back to greedy."""
        emitted: set = set()
        order: List[ComputeStep] = []
        objective = 0.0
        solved = fallbacks = 0
        for w, sol in zip(self.windows, sols):
            worder, obj = w.order(sol)
            if obj == float("inf"):
                fallbacks += 1
            else:
                solved += 1
                objective += obj
            for st in worder:
                key = (st.op_name, st.r0, st.r1, st.axis)
                if key in emitted:
                    continue             # overlap duplicate
                emitted.add(key)
                order.append(st)
        info = {"windows": len(self.windows), "window_cp": solved,
                "window_fallbacks": fallbacks}
        if solved == 0 or validate_order(g, self.region, self.tiles, order):
            return list(self.greedy), float("inf"), dict(info, stitched=0)
        return order, objective, dict(info, stitched=1)


def _build_windowed_fusion(cfg: NPUConfig, g: Graph, region: List[Op],
                           opts: Dict[str, Tuple[int, int, str]],
                           window_tiles: int, overlap: int
                           ) -> Optional[_WindowedFusion]:
    bank = cfg.bank_bytes
    tiles: Dict[str, TensorTiles] = {}
    for op in region:
        for oname in op.outputs:
            t = g.tensors[oname]
            tiles[oname] = TensorTiles(
                oname, _mk_tiles(t, opts[oname][0], bank, opts[oname][2]))
        # weight and region-external input tiles also enter the windows
        # (their residency/refetch pressure is part of the objective)
        for p in g.param_inputs(op):
            if p.name not in tiles:
                tiles[p.name] = TensorTiles(
                    p.name, _mk_tiles(p, opts[p.name][0], bank,
                                      opts[p.name][2]))
        for x in g.act_inputs(op):
            if x.name not in tiles:
                tiles[x.name] = TensorTiles(
                    x.name, _mk_tiles(x, opts[x.name][0], bank,
                                      opts[x.name][2]))
    greedy = _greedy_order(g, region, tiles)
    if not greedy or validate_order(g, region, tiles, greedy):
        return None
    windows: List[_WindowCP] = []
    prefix: set = set()
    done = 0
    for a, b in _window_bounds(len(greedy), window_tiles, overlap):
        while done < a:                  # thread boundary state forward
            for oname, tl in _step_products(g, tiles, greedy[done]):
                prefix.add((oname, tl.index))
            done += 1
        w = _build_window_fusion_cp(cfg, g, region, tiles, greedy,
                                    a, b, prefix)
        if w is None:
            return None
        windows.append(w)
    return _WindowedFusion(region, tiles, greedy, windows)


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------


def plan_tiling(cfg: NPUConfig, g: Graph, plan: FormatPlan,
                fusion: bool = True, cp_time_limit_s: float = 1.0,
                max_cp_tiles: int = 36,
                budget_frac: float = 0.5,
                naive: bool = False,
                cp_stall_s: Optional[float] = None,
                cp_stall_nodes: Optional[int] =
                cpsolver.DEFAULT_STALL_NODES,
                parallel_cp: bool = True,
                cp_engine: str = "incremental",
                max_cp_window_tiles: int = 24,
                region_overlap: int = 6,
                window_refine: bool = True) -> TilingResult:
    opts = _tile_options(cfg, g, budget_frac=budget_frac, naive=naive)
    bank = cfg.bank_bytes
    regions = _regions(cfg, g, opts)

    n_tiles: Dict[str, int] = {nm: o[0] for nm, o in opts.items()}

    # Build the fusion CP of every eligible region up front — the joint
    # tile-size + order model when the region fits max_cp_tiles, the
    # windowed decomposition otherwise — then solve the whole batch
    # (regions *and* windows are variable-disjoint) concurrently and
    # read solutions back in region order.  Regions containing
    # multi-output ops always take the windowed path: its tile-granular
    # state model handles secondary outputs, the joint-LS model does not.
    cps: Dict[int, _FusionCP] = {}
    wins: Dict[int, _WindowedFusion] = {}
    est: Dict[int, int] = {}
    for ri, region in enumerate(regions):
        if not (len(region) > 1 and fusion):
            continue
        est[ri] = _est_region_tiles(opts, region)
        multi_out = any(len(op.outputs) > 1 for op in region)
        if est[ri] <= max_cp_tiles and not multi_out:
            cps[ri] = _build_fusion_cp(cfg, g, region, opts)
        elif max_cp_window_tiles > 0:
            wf = _build_windowed_fusion(cfg, g, region, opts,
                                        max_cp_window_tiles,
                                        region_overlap)
            if wf is not None:
                wins[ri] = wf

    # windows are small and start from a strong (wavefront) incumbent,
    # so they get a much tighter stall cutoff than the joint models —
    # there are many more of them, and most of the win is the warm start
    win_stall = None if cp_stall_nodes is None \
        else max(1_000, cp_stall_nodes // 8)
    tasks: List[cpsolver.SolveTask] = []
    slots: List[Tuple[str, int, int]] = []
    for ri, fc in cps.items():
        tasks.append(cpsolver.SolveTask(fc.model,
                                        time_limit_s=cp_time_limit_s,
                                        warm_start=fc.warm,
                                        stall_limit_s=cp_stall_s,
                                        stall_limit_nodes=cp_stall_nodes,
                                        engine=cp_engine))
        slots.append(("cp", ri, 0))
    for ri, wf in wins.items():
        for wi, w in enumerate(wf.windows):
            tasks.append(cpsolver.SolveTask(w.model,
                                            time_limit_s=cp_time_limit_s,
                                            warm_start=w.warm,
                                            stall_limit_s=cp_stall_s,
                                            stall_limit_nodes=win_stall,
                                            engine=cp_engine))
            slots.append(("win", ri, wi))
    sols: Dict[int, cpsolver.Solution] = {}
    win_sols: Dict[int, List[Optional[cpsolver.Solution]]] = {
        ri: [None] * len(wf.windows) for ri, wf in wins.items()}
    if tasks:
        with _trace.maybe_span("fusion_cp_solve", "compile",
                               tasks=len(tasks), regions=len(cps),
                               windows=len(slots) - len(cps)):
            for (kind, ri, wi), sol in zip(
                    slots, cpsolver.solve_many(tasks,
                                               parallel=parallel_cp)):
                if kind == "cp":
                    sols[ri] = sol
                else:
                    win_sols[ri][wi] = sol

    # sequential refinement: re-solve each window chain front-to-back
    # with carry fixed to 1 for the tiles its predecessor's adopted
    # solution holds at its last tick (stitched execution is sequential,
    # so the batch solve's start-from-DDR assumption over-prices the
    # seams)
    window_refined = 0
    if window_refine and wins:
        with _trace.maybe_span("window_refine", "compile",
                               regions=len(wins)):
            for ri, wf in wins.items():
                win_sols[ri], n = wf.refine(
                    cfg, g, win_sols[ri],
                    time_limit_s=cp_time_limit_s,
                    stall_limit_s=cp_stall_s,
                    stall_limit_nodes=win_stall,
                    engine=cp_engine)
                window_refined += n

    _t_stitch = time.monotonic() if _trace.active() is not None else None
    order: List[ComputeStep] = []
    objective = 0.0
    counts = {"cp": 0, "windowed": 0, "greedy": 0, "layerwise": 0}
    windows_total = window_cp = window_fallbacks = 0
    fused_steps = 0
    detail: List[Dict] = []
    seg: List[Tuple[int, int]] = []         # order slice per region
    win_alt: Dict[int, Tuple[List[ComputeStep], float]] = {}
    for ri, region in enumerate(regions):
        big = len(region) > 1 and fusion
        mode = "layerwise"
        n0 = len(order)
        if ri in cps:
            chosen, steps, obj = cps[ri].extract(g, sols[ri])
            n_tiles.update(chosen)
            order.extend(steps)
            if obj != float("inf"):
                objective += obj
                mode = "cp"
            else:
                mode = "greedy"
        elif ri in wins:
            steps, obj, info = wins[ri].stitch(g, win_sols[ri])
            order.extend(steps)
            windows_total += info["windows"]
            window_cp += info["window_cp"]
            window_fallbacks += info["window_fallbacks"]
            if info["stitched"] and obj != float("inf"):
                objective += obj
                mode = "windowed"
                if steps != wins[ri].greedy:
                    win_alt[ri] = (wins[ri].greedy, obj)
            else:
                mode = "greedy"
        else:
            tiles_now = {
                t.name: TensorTiles(t.name, _mk_tiles(
                    t, n_tiles[t.name], bank, opts[t.name][2]))
                for t in g.tensors.values()}
            if big:
                order.extend(_greedy_order(g, region, tiles_now))
                mode = "greedy"
            else:
                for op in region:
                    out0 = g.tensors[op.outputs[0]]
                    otiles = tiles_now[out0.name]
                    if otiles.axis == "chan" and g.param_inputs(op):
                        # channel-split op: one step per *weight* chunk
                        # (weights stream set-by-set, paper §III-B);
                        # each step writes its channel slice into the
                        # covering (bank-granular) output tile
                        wt = g.param_inputs(op)[0]
                        for tl in tiles_now[wt.name].tiles:
                            order.append(ComputeStep(op.name, tl.r0,
                                                     tl.r1, "chan"))
                        continue
                    for tl in otiles.tiles:
                        order.append(ComputeStep(op.name, tl.r0, tl.r1,
                                                 tl.axis))
        counts[mode] += 1
        n_steps = len(order) - n0
        seg.append((n0, len(order)))
        if big:
            fused_steps += n_steps
        detail.append({"ops": len(region), "steps": n_steps,
                       "est_tiles": est.get(ri, 0), "mode": mode})

    if _t_stitch is not None:
        tr = _trace.active()
        if tr is not None:
            tr.complete("window_stitch", "compile", _t_stitch,
                        args={"regions": len(regions),
                              "windows": windows_total,
                              "window_fallbacks": window_fallbacks})

    tiles = {t.name: TensorTiles(
        t.name, _mk_tiles(t, n_tiles[t.name], bank, opts[t.name][2]))
        for t in g.tensors.values()}
    region_names = [[op.name for op in r] for r in regions]

    def _stats(cnt: Dict[str, int], det: List[Dict], n_order: int,
               windowed_active: bool) -> Dict:
        return {"regions": len(regions),
                "cp_regions": cnt["cp"],
                "windowed_regions": cnt["windowed"],
                "greedy_regions": cnt["greedy"],
                "layerwise_regions": cnt["layerwise"],
                "windows": windows_total if windowed_active else 0,
                "window_cp_solved": window_cp if windowed_active else 0,
                "window_fallbacks":
                    window_fallbacks if windowed_active else 0,
                "window_refined":
                    window_refined if windowed_active else 0,
                "fused_steps": fused_steps,
                "fused_steps_cp": sum(
                    d["steps"] for d in det
                    if d["mode"] in ("cp", "windowed") and d["ops"] > 1),
                "steps": n_order,
                "region_detail": det}

    fallback = None
    if win_alt:
        # same plan with every (changed) windowed region's order swapped
        # back to greedy — the caller races both through the scheduler
        fb_order: List[ComputeStep] = []
        fb_detail: List[Dict] = []
        fb_counts = dict(counts)
        fb_objective = objective
        for ri, (a, b) in enumerate(seg):
            d = dict(detail[ri])
            if ri in win_alt:
                steps, obj = win_alt[ri]
                fb_order.extend(steps)
                fb_objective -= obj
                d["mode"] = "greedy"
                d["steps"] = len(steps)
                fb_counts["windowed"] -= 1
                fb_counts["greedy"] += 1
            else:
                fb_order.extend(order[a:b])
            fb_detail.append(d)
        fallback = TilingResult(
            tiles=tiles, order=fb_order, regions=region_names,
            fusion_objective=fb_objective,
            stats=_stats(fb_counts, fb_detail, len(fb_order),
                         windowed_active=False))

    return TilingResult(
        tiles=tiles, order=order, regions=region_names,
        fusion_objective=objective,
        stats=_stats(counts, detail, len(order), windowed_active=True),
        fallback=fallback,
    )
