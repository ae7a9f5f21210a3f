"""Plan lowering and the compiled replay engine, on the device.

Counterpart of ``repro/core/execplan.py``.  A one-time lowering pass
turns a quantized graph into a flat :class:`ExecPlan`:

  * every per-request decision is made once at lowering time: weight
    constants are derived on the host (in numpy, as the reference derives
    them) and moved to the device once;
  * tensors live in **one ``torch.uint8`` arena of shape (capacity,
    total) on the plan's device**, each tensor a view at the static
    offset that :func:`assign_slots` gives it, so slots are reused over
    disjoint live intervals exactly as in the reference;
  * a leading batch dimension runs through every kernel, so one replay
    serves up to ``capacity`` requests.

An arena view is not contiguous across the batch (its row pitch is the
arena's ``total`` bytes): the kernels read it in place and write their
output slot in place, with that pitch as their batch stride.

A plan lowered from a compiled model (``repro_torch.api``) reports its
program's modeled ``ticks`` and ``ddr_bytes_per_request``; the int8
lowering itself reads neither the program nor the tiling, so a bare
quantized graph lowers too (``program=None``).  The float32 lowering is
``ROADMAP.md`` item 7.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

from .ir import Graph

#: arena slots are aligned to this many bytes (cache-line friendly).
ARENA_ALIGN = 64


class PlanError(RuntimeError):
    pass


class PlanConsts:
    """Get-or-compute store for lowering-time kernel constants, keyed
    ``"<step label>/<const name>"`` (copy of the reference's store; the
    arrays are numpy, derived on the host)."""

    def __init__(self,
                 arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
        self._arrays: Dict[str, np.ndarray] = dict(arrays or {})
        self.computed = 0
        self.served = 0

    def __len__(self) -> int:
        return len(self._arrays)

    def get(self, key: str, build: Callable[[], np.ndarray]) -> np.ndarray:
        arr = self._arrays.get(key)
        if arr is None:
            arr = self._arrays[key] = build()
            self.computed += 1
        else:
            self.served += 1
        return arr

    def group(self, label: str, names: Sequence[str],
              build: Callable[[], Dict[str, np.ndarray]]
              ) -> Dict[str, np.ndarray]:
        """Several constants derived by one computation: all served or
        all rebuilt together."""
        keys = [f"{label}/{n}" for n in names]
        if all(k in self._arrays for k in keys):
            self.served += len(keys)
            return {n: self._arrays[k] for n, k in zip(names, keys)}
        got = build()
        for n, k in zip(names, keys):
            self._arrays[k] = got[n]
        self.computed += len(keys)
        return got

    def as_arrays(self) -> Dict[str, np.ndarray]:
        return dict(self._arrays)


@dataclass
class PlanStep:
    """One lowered kernel: ``run(bufs, n)`` reads/writes the first ``n``
    batch rows of the arena views in ``bufs`` (indexed by tensor id).
    ``reads``/``writes`` drive the arena's live-interval analysis."""

    label: str
    reads: Tuple[int, ...]
    writes: Tuple[int, ...]
    run: Callable[[List[torch.Tensor], int], None]


# --------------------------------------------------------------------------
# Arena: static slot offsets from live intervals (linear scan)
# --------------------------------------------------------------------------


def _align(n: int) -> int:
    return (n + ARENA_ALIGN - 1) // ARENA_ALIGN * ARENA_ALIGN


def assign_slots(sizes: Sequence[int],
                 intervals: Sequence[Tuple[int, int]]) -> Tuple[List[int],
                                                                int]:
    """First-fit linear-scan slot assignment (copy of the reference's).

    ``sizes[i]`` bytes must be resident over step interval
    ``intervals[i] = (start, end)`` inclusive; two tensors may share
    bytes only if their intervals are disjoint.  Returns (offsets,
    total_bytes)."""
    order = sorted(range(len(sizes)), key=lambda i: intervals[i][0])
    active: List[Tuple[int, int, int]] = []   # (offset, size, end)
    offsets = [0] * len(sizes)
    total = 0
    for i in order:
        start, end = intervals[i]
        active = [a for a in active if a[2] >= start]
        size = _align(max(1, sizes[i]))
        # first-fit into the lowest gap between active allocations
        off = 0
        for a_off, a_size, _ in sorted(active):
            if off + size <= a_off:
                break
            off = max(off, _align(a_off + a_size))
        offsets[i] = off
        active.append((off, size, end))
        total = max(total, off + size)
    return offsets, total


# --------------------------------------------------------------------------
# ExecPlan
# --------------------------------------------------------------------------


class ExecPlan:
    """A lowered, batch-vectorized replay of one quantized graph on one
    device.  ``run()`` executes up to ``capacity`` requests in one pass.
    Not thread-safe: the arena is owned by the plan."""

    def __init__(self, name: str, graph: Graph, program, semantics,
                 steps: List[PlanStep], ids: Dict[str, int], capacity: int,
                 build_s: float = 0.0, granularity: str = "op",
                 device=None):
        self.name = name
        self.graph = graph
        self.program = program
        self.semantics = semantics
        self.steps = steps
        self.ids = ids
        self.capacity = int(capacity)
        self.granularity = granularity
        self.device = resolve_device(device)
        #: modeled per-request figures of the compiled program (None for
        #: a plan lowered from a bare graph, with no program)
        self.ddr_bytes_per_request = (program.ddr_bytes()
                                      if program is not None else None)
        self.ticks = len(program.ticks) if program is not None else None

        names = [None] * len(ids)
        for nm, i in ids.items():
            names[i] = nm
        self._names: List[str] = names

        # -- live intervals over the step sequence --------------------------
        n_steps = len(steps)
        first = [0] * len(ids)
        last = [n_steps] * len(ids)
        seen = [False] * len(ids)
        for si, st in enumerate(steps):
            for t in st.reads + st.writes:
                if not seen[t]:
                    first[t] = si
                    seen[t] = True
                last[t] = si
        for t in graph.inputs:          # encoded before step 0
            first[ids[t.name]] = -1
        for t in graph.outputs:         # decoded after the last step
            last[ids[t.name]] = n_steps

        # -- static slot offsets + one arena on the device ------------------
        dtypes = [semantics.plan_dtype(graph.tensors[nm]) for nm in names]
        shapes = [graph.tensors[nm].shape for nm in names]
        sizes = [int(np.prod(shp)) * torch.empty((), dtype=dt).element_size()
                 for shp, dt in zip(shapes, dtypes)]
        offsets, total = assign_slots(
            sizes, [(first[i], last[i]) for i in range(len(ids))])
        self.arena_bytes = total
        self.offsets = offsets
        self._arena = torch.empty((self.capacity, max(1, total)),
                                  dtype=torch.uint8, device=self.device)
        # .view, never .reshape: a reshape that cannot alias would copy,
        # and writes into the copy would land nowhere
        self._views: List[torch.Tensor] = [
            self._arena[:, offsets[i]:offsets[i] + sizes[i]]
            .view(dtypes[i]).view((self.capacity,) + tuple(shapes[i]))
            for i in range(len(ids))]
        self.build_s = build_s

    def view(self, name: str) -> torch.Tensor:
        """The arena view (capacity, *shape) of tensor ``name``."""
        return self._views[self.ids[name]]

    # -- execution ----------------------------------------------------------
    def _encode(self, feed: Dict[str, object], n: Optional[int]):
        """Check ``n``, copy each input batch to the device and quantize
        it into its slot.  Returns (n, whether the caller gave unbatched
        shapes)."""
        squeeze = n is None
        n = 1 if n is None else int(n)
        if not 1 <= n <= self.capacity:
            raise PlanError(
                f"{self.name}: batch {n} outside plan capacity "
                f"[1, {self.capacity}]")
        for t in self.graph.inputs:
            arr = feed[t.name]
            arr = (arr if isinstance(arr, torch.Tensor)
                   else torch.from_numpy(np.asarray(arr, np.float32)))
            if squeeze and tuple(arr.shape) == t.shape:
                arr = arr[None]
            if tuple(arr.shape) != (n,) + t.shape:
                raise PlanError(
                    f"{self.name}: input {t.name} has shape "
                    f"{tuple(arr.shape)}, expected {(n,) + t.shape}")
            arr = arr.to(self.device, torch.float32)
            self._views[self.ids[t.name]][:n].copy_(
                self.semantics.encode_input(t.name, arr))
        return n, squeeze

    def run(self, feed: Dict[str, object], n: Optional[int] = None,
            decode: bool = True) -> Dict[str, torch.Tensor]:
        """Replay ``n`` stacked requests.  ``feed`` maps every graph input
        to an ``(n, *shape)`` float array or tensor (``(*shape,)`` when
        ``n`` is None).  The batch goes to the device in one copy and is
        quantized there.  Returns each model output as an ``(n, *shape)``
        tensor on the plan's device: decoded to float32 through the
        semantics, or a copy of the stored integers with
        ``decode=False``.  A failing kernel raises :class:`PlanError`
        naming its step."""
        n, squeeze = self._encode(feed, n)
        bufs = self._views
        st = None
        try:
            for st in self.steps:
                st.run(bufs, n)
        except Exception as e:
            raise PlanError(
                f"{self.name}: lowered kernel "
                f"{st.label if st is not None else '?'} failed: "
                f"{type(e).__name__}: {e}") from e
        outs: Dict[str, torch.Tensor] = {}
        for t in self.graph.outputs:
            raw = bufs[self.ids[t.name]][:n]
            out = self.semantics.decode(t.name, raw) if decode \
                else raw.clone()
            outs[t.name] = out[0] if squeeze else out
        return outs

    def replay_steps(self, feed: Dict[str, object], n: int):
        """Replay as :meth:`run` does, yielding after each step its label
        and a copy of the stored values it wrote, by tensor name: to find
        the first op at which two plans part."""
        n, _ = self._encode(feed, n)
        for st in self.steps:
            st.run(self._views, n)
            yield st.label, {self._names[w]: self._views[w][:n].clone()
                             for w in st.writes}


# --------------------------------------------------------------------------
# Lowering entry points
# --------------------------------------------------------------------------


def lower_steps(program, graph: Graph, tiling,
                weights: Dict[str, np.ndarray], semantics,
                consts: Optional[PlanConsts] = None, device=None
                ) -> Tuple[List[PlanStep], Dict[str, int], str]:
    """Semantics-driven step lowering onto ``device``: ``(steps, tensor
    ids, granularity)``.  Steps read ``n`` at run time, so one step list
    (with its device constants) serves every batch bucket's arena.
    ``program`` and ``tiling`` may be None: the int8 lowering reads
    neither."""
    ids: Dict[str, int] = {}
    for t in graph.tensors.values():
        if not t.is_param:
            ids[t.name] = len(ids)
    lowerer = semantics.plan_lowerer()
    steps, granularity = lowerer(graph, tiling, program, weights, ids,
                                 consts=consts,
                                 device=resolve_device(device))
    return steps, ids, granularity


def lower_plan(program, graph: Graph, tiling,
               weights: Dict[str, np.ndarray], semantics,
               capacity: int = 1,
               lowered: Optional[Tuple[List[PlanStep], Dict[str, int],
                                       str]] = None,
               device=None) -> ExecPlan:
    """Lower a quantized graph into an :class:`ExecPlan` on ``device``
    (CUDA unless the caller asks for the CPU).  Pass ``lowered`` (from
    :func:`lower_steps` on the same device) to share one step list
    across several batch buckets."""
    t0 = time.monotonic()
    device = resolve_device(device)
    if lowered is None:
        lowered = lower_steps(program, graph, tiling, weights, semantics,
                              device=device)
    steps, ids, granularity = lowered
    name = program.name if program is not None else graph.name
    return ExecPlan(name, graph, program, semantics, steps, ids, capacity,
                    build_s=time.monotonic() - t0, granularity=granularity,
                    device=device)


def lower_float_steps(*args, **kwargs):
    raise NotImplementedError(
        "the float32 plan is not ported yet (ROADMAP.md item 7)")
