"""Plan lowering and the compiled replay engine, on the device.

Counterpart of ``repro/core/execplan.py``.  A one-time lowering pass
turns a graph into a flat :class:`ExecPlan`:

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

Both value semantics lower **one batch-vectorized step per op**: the
int8/int4 lowering in ``quant/execplan.py`` and the float32 lowering
here (:func:`lower_float_steps`), whose conv, fc and matmul run on K1
in its Pallas contract with float32 operands.  The causal kinds of the
LM decode path (matmul, layernorm, softmax, attention, kvappend) lower
in both: attention on K3 for one query row and on K2 for more, with each
lane's cache position read from its ``pos`` slot on the device, so a
decode step reads nothing back to the host.  The reference's float32 plan
emits one step per *program step* so as to be bit-exact with its numpy
interpreter; this one is not bit-exact (K1 and torch sum in another
order), and is held to the interpreter within
``executor.float_plan_tol``.

A plan lowered from a compiled model (``repro_torch.api``) reports its
program's modeled ``ticks`` and ``ddr_bytes_per_request``; neither
lowering reads the program or the tiling, so a bare graph lowers too
(``program=None``).

When the tracer is armed with ``plan_steps``, :meth:`ExecPlan.run`
records one span per step (category ``plan``): host time, which on CUDA
is the time to enqueue the step.  ``run(..., step_times=[])`` collects
one ``(label, seconds)`` entry per step for the profiler
(:mod:`repro_torch.obs.profile`): on CUDA the device time between two
events recorded around the step on the current stream (read after one
synchronize at the end of the replay, so the replay is not serialized
step by step), on the CPU the host clock, as the reference.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels import ops

from ..obs import trace as _trace
from .executor import ExecutionReport
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
        tracer = _trace.active()
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
            if tracer is not None:
                phase = tracer.phase("stage.copy_in")
                nbytes = arr.nbytes
            arr = arr.to(self.device, torch.float32)
            if tracer is not None:
                phase.end(bytes=nbytes)
                phase = tracer.phase("stage.encode")
            self._views[self.ids[t.name]][:n].copy_(
                self.semantics.encode_input(t.name, arr))
            if tracer is not None:
                phase.end()
        return n, squeeze

    def run(self, feed: Dict[str, object], n: Optional[int] = None,
            decode: bool = True, trace_id: Optional[int] = None,
            step_times: Optional[list] = None) -> Dict[str, torch.Tensor]:
        """Replay ``n`` stacked requests.  ``feed`` maps every graph input
        to an ``(n, *shape)`` float array or tensor (``(*shape,)`` when
        ``n`` is None).  The batch goes to the device in one copy and is
        encoded there.  Returns each model output as an ``(n, *shape)``
        tensor on the plan's device (never a view of the arena): decoded
        to float32 through the semantics, or a copy of the stored values
        with ``decode=False``.  A failing kernel raises
        :class:`PlanError` naming its step.

        ``step_times`` (a caller-supplied list) collects one ``(label,
        seconds)`` entry per step: device time between CUDA events on a
        CUDA plan, host time on the CPU.  With the tracer armed (and its
        ``plan_steps`` flag set) each step lands as one span of host
        time (on CUDA, the time to enqueue it), tagged with
        ``trace_id``."""
        n, squeeze = self._encode(feed, n)
        bufs = self._views
        phases = tracer = _trace.active()
        if tracer is not None and not tracer.plan_steps:
            tracer = None
        st = None
        beat = _trace.progress_listener()
        try:
            if tracer is None and step_times is None:
                for st in self.steps:
                    st.run(bufs, n)
                    if beat is not None:    # a serving worker's beat
                        beat()
            elif step_times is not None and self.device.type == "cuda":
                self._run_device_timed(bufs, n, tracer, trace_id,
                                       step_times)
            else:
                clock = time.monotonic
                for st in self.steps:
                    t0 = clock()
                    st.run(bufs, n)
                    t1 = clock()
                    if step_times is not None:
                        step_times.append((st.label, t1 - t0))
                    if tracer is not None:
                        tracer.complete(st.label, "plan", t0, t1,
                                        trace_id=trace_id)
        except Exception as e:
            raise PlanError(
                f"{self.name}: lowered kernel "
                f"{st.label if st is not None else '?'} failed: "
                f"{type(e).__name__}: {e}") from e
        if phases is not None:
            phase = phases.phase("decode")
        outs: Dict[str, torch.Tensor] = {}
        for t in self.graph.outputs:
            raw = bufs[self.ids[t.name]][:n]
            out = self.semantics.decode(t.name, raw) if decode else raw
            if out is raw:          # the float32 decode is the identity
                out = raw.clone()
            outs[t.name] = out[0] if squeeze else out
        if phases is not None:
            phase.end()
        return outs

    def _run_device_timed(self, bufs, n: int, tracer, trace_id,
                          step_times: list) -> None:
        """The step loop with a pair of CUDA events around each step on
        the current stream; one synchronize after the last step, then
        each step's device seconds appended to ``step_times``.  A step's
        time is its span on the stream: where the host enqueues a step's
        kernels slower than the card runs them, the span includes the
        card's wait for them."""
        stream = torch.cuda.current_stream(self.device)
        marks = []
        for st in self.steps:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            h0 = time.monotonic()
            e0.record(stream)
            st.run(bufs, n)
            e1.record(stream)
            marks.append((st.label, e0, e1, h0, time.monotonic()))
        if marks:
            marks[-1][2].synchronize()
        for label, e0, e1, h0, h1 in marks:
            ms = e0.elapsed_time(e1)
            step_times.append((label, ms / 1e3))
            if tracer is not None:
                tracer.complete(label, "plan", h0, h1, trace_id=trace_id)

    def execution_report(self, outputs: Dict[str, torch.Tensor],
                         n: int = 1) -> ExecutionReport:
        """An :class:`~repro_torch.core.executor.ExecutionReport` for one
        plan replay.  ``ticks``/``ddr_bytes`` are the schedule's modeled
        **per-request** quantities — a batch-N replay does not multiply
        them, so DDR columns stay comparable across executors."""
        return ExecutionReport(outputs, 0.0, self.ticks,
                               self.ddr_bytes_per_request,
                               batch=int(n), engine="plan")

    # -- reporting ----------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        return {
            "semantics": self.semantics.name,
            "granularity": self.granularity,
            "capacity": self.capacity,
            "kernels": len(self.steps),
            "tensors": len(self.ids),
            "arena_bytes": int(self.arena_bytes),
            "arena_total_bytes": int(self.arena_bytes * self.capacity),
            "build_s": self.build_s,
            "ddr_bytes_per_request": (
                None if self.ddr_bytes_per_request is None
                else int(self.ddr_bytes_per_request)),
        }

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


# --------------------------------------------------------------------------
# float32 lowering — one batch-vectorized step per op
# --------------------------------------------------------------------------


def taps(xp: torch.Tensor, fh: int, fw: int, s: int, oh: int, ow: int):
    """The (i, j) windows of a padded (n, H, W, C) tensor, row-major."""
    for i in range(fh):
        for j in range(fw):
            yield i * fw + j, xp[:, i:i + oh * s:s, j:j + ow * s:s, :]


def pad_hw(x: torch.Tensor, pt: int, pb: int, pl: int, pr: int, value):
    """``x`` (n, H, W, C) padded along H and W with ``value``."""
    if (pt, pb, pl, pr) == (0, 0, 0, 0):
        return x
    return F.pad(x, (0, 0, pl, pr, pt, pb), value=value)


def im2col(x: torch.Tensor, pad, fh: int, fw: int, s: int, oh: int,
           ow: int, value) -> torch.Tensor:
    """The columns (n, oh * ow, fh * fw * C) of a conv over ``x`` (n, H,
    W, C) in the (i, j, c) order of a weight ``w.reshape(outC, -1)``,
    padded with ``value``."""
    n, C = x.shape[0], x.shape[-1]
    xp = pad_hw(x, *pad, value=value)
    cols = torch.empty((n, oh, ow, fh * fw, C), dtype=x.dtype,
                       device=x.device)
    for t, win in taps(xp, fh, fw, s, oh, ow):
        cols[:, :, :, t, :] = win
    return cols.view(n, oh * ow, fh * fw * C)


# --------------------------------------------------------------------------
# The causal kinds (LM decode path), shared by both lowerings
# --------------------------------------------------------------------------


def pos_rows(pos: torch.Tensor, smax: int, s: int) -> torch.Tensor:
    """``core/ir.py:_pos_index`` per lane, on the positions' device: the
    (n, 1, 1, 1) float positions as int64 (n,) row offsets, rounded half
    to even (as Python's ``round``) and clamped so that ``s`` new rows fit
    a cache of ``smax`` rows.  Nothing is read back to the host."""
    return torch.round(pos.reshape(-1)).clamp_(0, max(smax - s, 0)) \
        .to(torch.int64)


def attend(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
           p0: torch.Tensor, attrs: Dict) -> torch.Tensor:
    """The IR attention (``core/ir.py:_attention_ref``) of float32 queries
    (n, s, 1, C) against caches (n, kv, 1, C) for lanes at row offsets
    ``p0`` (n,), as (n, s, heads, head_dim) float32: one query row on K3
    (``kv_len = p0 + 1``), more on K2 (``q_offset = p0``), one launch for
    the batch.  The head-major views of the arena slots are copied by the
    kernels' wrappers (they take contiguous operands)."""
    n, s = q.shape[:2]
    kv = kc.shape[1]
    H, hd = attrs["heads"], attrs["head_dim"]
    k = kc.view(n, kv, H, hd).transpose(1, 2)
    v = vc.view(n, kv, H, hd).transpose(1, 2)
    if s == 1:      # j < p0 + 1, causal or not
        o = ops.flash_decode(q.view(n, H, hd), k, v, kv_len=p0 + 1,
                             sm_scale=attrs["scale"])
        return o.view(n, 1, H, hd)
    o = ops.flash_attention(q.view(n, s, H, hd).transpose(1, 2), k, v,
                            causal=attrs.get("causal", True),
                            sm_scale=attrs["scale"], q_offset=p0)
    return o.transpose(1, 2)


def kv_append(out: torch.Tensor, cache: torch.Tensor, new: torch.Tensor,
              p0: torch.Tensor) -> None:
    """``core/ir.py:_kvappend_ref`` per lane, in place: ``out`` (n, kv, 1,
    C) takes ``cache`` with rows [p0, p0 + s) of each lane replaced by
    ``new`` (n, s, 1, C), scattered at offsets read on the device."""
    n, kv, _, C = cache.shape
    s = new.shape[1]
    out.copy_(cache)        # live at once, so never the same arena slot
    idx = p0[:, None] + torch.arange(s, device=p0.device)
    out.view(n, kv, C).scatter_(1, idx[:, :, None].expand(n, s, C),
                                new.reshape(n, s, C))


def layernorm_t(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                eps: float) -> torch.Tensor:
    """``core/ir.py:_layernorm_ref`` in float32 over the last axis."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * gamma + beta


def softmax_t(x: torch.Tensor) -> torch.Tensor:
    """``core/ir.py:_softmax_ref`` in float32 over the last axis."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def lower_float_steps(g: Graph, tiling, program,
                      weights: Dict[str, np.ndarray],
                      ids: Dict[str, int],
                      consts: Optional[PlanConsts] = None, device=None
                      ) -> Tuple[List[PlanStep], str]:
    """One batch-vectorized float32 step per op, in topological order, on
    ``device`` (CUDA unless the caller asks for the CPU).

    conv, fc and matmul run on K1 in its Pallas contract (``act(x @ w +
    bias)``, float32 operands, ``ops.neutron_matmul_nk``): a 1x1 conv
    without padding and a matmul read their input slot in place, any
    other conv lays out its columns first (:func:`im2col`), and K1 writes
    the output slot in place.  The (N, K) weight and the bias are derived
    once here, on the host, through ``consts``, and moved to the device
    once.  dwconv
    accumulates tap by tap; the pools, resize and the elementwise kinds
    are plain torch work (nothing reaches cuBLAS or cuDNN, whose float32
    paths may run in TF32), and so are layernorm and softmax.  attention
    runs on K3 (one query row) or K2 (:func:`attend`) and kvappend
    scatters the new rows (:func:`kv_append`), both at the per-lane
    offsets :func:`pos_rows` derives on the device.  ``tiling`` and
    ``program`` are not read."""
    from repro_torch.kernels.ref import ir_activation

    cs = consts if consts is not None else PlanConsts()
    device = resolve_device(device)
    f32 = torch.float32
    steps: List[PlanStep] = []

    def const(label: str, name: str, build) -> torch.Tensor:
        arr = cs.get(f"{label}/{name}", build)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    def param(name: str) -> np.ndarray:
        return np.asarray(weights[name], dtype=np.float32)

    def bias_of(op, label: str) -> Optional[torch.Tensor]:
        if len(op.inputs) < 3:
            return None
        return const(label, "bias", lambda: param(op.inputs[2]))

    def scalar(v) -> torch.Tensor:
        return torch.tensor(float(v), dtype=f32, device=device)

    for op in g.topo_ops():
        _trace.progress()
        a = op.attrs
        k = op.kind
        oid = ids[op.outputs[0]]
        label = f"{op.name}@f32"
        act = a.get("act", "none")

        if k in ("conv", "fc", "matmul"):
            x = g.act_inputs(op)[0]
            xid = ids[x.name]
            # (N, K): conv weights (outC, fh, fw, inC) in the (i, j, c)
            # order of im2col's columns; fc and matmul weights (N, 1, 1, K)
            wt = const(label, "wt", lambda op=op: param(
                op.inputs[1]).reshape(g.tensors[op.inputs[1]].shape[0], -1))
            bias = bias_of(op, label)
            # K1 fuses every activation of the IR (its codes are
            # ref.IR_ACTIVATIONS, the IR's list), so none runs after it
            if k != "conv":
                # a matmul's rows are its sequence; an fc has one
                rows = g.tensors[op.outputs[0]].shape[0] \
                    if k == "matmul" else 1

                def run(bufs, n, xid=xid, oid=oid, wt=wt, bias=bias,
                        act=act, rows=rows):
                    ops.neutron_matmul_nk(bufs[xid][:n].view(n, rows, -1),
                                          wt, bias, act,
                                          bufs[oid][:n].view(n, rows, -1))
            else:
                s = a["stride"]
                pad = tuple(a["pad"])
                fh, fw = a["k"]
                oh, ow, oc = g.tensors[op.outputs[0]].shape
                H, W, C = x.shape
                pointwise = (fh, fw) == (1, 1) and pad == (0, 0, 0, 0)

                def run(bufs, n, xid=xid, oid=oid, wt=wt, bias=bias,
                        act=act, s=s, pad=pad, fh=fh, fw=fw, oh=oh, ow=ow,
                        oc=oc, H=H, W=W, C=C, pointwise=pointwise):
                    xv = bufs[xid][:n]
                    if pointwise:
                        # 1x1 stride-s conv == strided gemm, read in place
                        xin = xv[:, ::s, ::s, :] if s != 1 \
                            else xv.view(n, H * W, C)
                    else:
                        xin = im2col(xv, pad, fh, fw, s, oh, ow, 0.0)
                    ops.neutron_matmul_nk(xin, wt, bias, act,
                                          bufs[oid][:n].view(n, oh * ow, oc))
            reads = (xid,)
        elif k == "dwconv":
            x = g.act_inputs(op)[0]
            xid = ids[x.name]
            fh, fw = a["k"]
            ker = const(label, "ker", lambda op=op, fh=fh, fw=fw:
                        np.transpose(param(op.inputs[1])[:, :, :, 0],
                                     (1, 2, 0)).reshape(fh * fw, -1))
            bias = bias_of(op, label)
            oh, ow = g.tensors[op.outputs[0]].shape[:2]

            def run(bufs, n, xid=xid, oid=oid, ker=ker, bias=bias, act=act,
                    s=a["stride"], pad=tuple(a["pad"]), fh=fh, fw=fw, oh=oh,
                    ow=ow):
                # tap-by-tap f32 accumulation off the zero-padded input
                xp = pad_hw(bufs[xid][:n], *pad, value=0.0)
                acc = None
                for t, win in taps(xp, fh, fw, s, oh, ow):
                    acc = win * ker[t] if acc is None else acc + win * ker[t]
                if bias is not None:
                    acc = acc + bias
                bufs[oid][:n].copy_(ir_activation(acc, act))
            reads = (xid,)
        elif k in ("add", "mul"):
            xs = g.act_inputs(op)
            i0, i1 = ids[xs[0].name], ids[xs[1].name]

            def run(bufs, n, i0=i0, i1=i1, act=act, is_add=k == "add",
                    oid=oid):
                a0, a1 = bufs[i0][:n], bufs[i1][:n]
                y = ir_activation(a0 + a1, act) if is_add else a0 * a1
                bufs[oid][:n].copy_(y)
            reads = (i0, i1)
        elif k == "scalar":
            xid = ids[g.act_inputs(op)[0].name]
            fn = {"add": torch.add, "mul": torch.mul,
                  "div": torch.div}[a["op"]]

            def run(bufs, n, xid=xid, fn=fn, v=scalar(a["value"]), oid=oid):
                bufs[oid][:n].copy_(fn(bufs[xid][:n], v))
            reads = (xid,)
        elif k == "act":
            xid = ids[g.act_inputs(op)[0].name]

            def run(bufs, n, xid=xid, act=a["act"], oid=oid):
                bufs[oid][:n].copy_(ir_activation(bufs[xid][:n], act))
            reads = (xid,)
        elif k == "maxpool":
            xid = ids[g.act_inputs(op)[0].name]
            oh, ow = g.tensors[op.outputs[0]].shape[:2]

            def run(bufs, n, xid=xid, kk=a["k"], s=a["stride"],
                    pad=tuple(a["pad"]), oh=oh, ow=ow, oid=oid):
                xp = pad_hw(bufs[xid][:n], *pad, value=-math.inf)
                y = None
                for _, win in taps(xp, kk, kk, s, oh, ow):
                    y = win if y is None else torch.maximum(y, win)
                bufs[oid][:n].copy_(y)
            reads = (xid,)
        elif k == "avgpool":
            xid = ids[g.act_inputs(op)[0].name]
            if a["k"] == 0:
                def run(bufs, n, xid=xid, oid=oid):
                    bufs[oid][:n].copy_(
                        bufs[xid][:n].mean(dim=(1, 2), keepdim=True))
            else:
                kk = a["k"]
                oh, ow = g.tensors[op.outputs[0]].shape[:2]

                def run(bufs, n, xid=xid, kk=kk, s=a["stride"],
                        pad=tuple(a["pad"]), oh=oh, ow=ow,
                        area=scalar(kk * kk), oid=oid):
                    xp = pad_hw(bufs[xid][:n], *pad, value=0.0)
                    acc = None
                    for _, win in taps(xp, kk, kk, s, oh, ow):
                        acc = win.clone() if acc is None else acc + win
                    bufs[oid][:n].copy_(acc / area)
            reads = (xid,)
        elif k == "resize":
            xid = ids[g.act_inputs(op)[0].name]

            def run(bufs, n, xid=xid, f=a["factor"], oid=oid):
                bufs[oid][:n].copy_(bufs[xid][:n].repeat_interleave(f, dim=1)
                                    .repeat_interleave(f, dim=2))
            reads = (xid,)
        elif k == "concat":
            xids = tuple(ids[x.name] for x in g.act_inputs(op))

            def run(bufs, n, xids=xids, oid=oid):
                bufs[oid][:n].copy_(torch.cat([bufs[i][:n] for i in xids],
                                              dim=-1))
            reads = xids
        elif k == "split":
            x = g.act_inputs(op)[0]
            xid = ids[x.name]
            oids = tuple(ids[o] for o in op.outputs)

            def run(bufs, n, xid=xid, oids=oids,
                    width=x.shape[-1] // a["sections"]):
                parts = torch.split(bufs[xid][:n], width, dim=-1)
                for o, p in zip(oids, parts):
                    bufs[o][:n].copy_(p)
            steps.append(PlanStep(label, (xid,), oids, run))
            continue
        elif k == "layernorm":
            xid = ids[g.act_inputs(op)[0].name]
            gamma = const(label, "gamma", lambda op=op: param(op.inputs[1]))
            beta = const(label, "beta", lambda op=op: param(op.inputs[2]))

            def run(bufs, n, xid=xid, oid=oid, gamma=gamma, beta=beta,
                    eps=a["eps"]):
                bufs[oid][:n].copy_(layernorm_t(bufs[xid][:n], gamma, beta,
                                                eps))
            reads = (xid,)
        elif k == "softmax":
            xid = ids[g.act_inputs(op)[0].name]

            def run(bufs, n, xid=xid, oid=oid):
                bufs[oid][:n].copy_(softmax_t(bufs[xid][:n]))
            reads = (xid,)
        elif k == "attention":
            q, kc, vc, ps = g.act_inputs(op)
            qid, kid, vid, pid = (ids[t.name] for t in (q, kc, vc, ps))

            def run(bufs, n, qid=qid, kid=kid, vid=vid, pid=pid, oid=oid,
                    attrs=dict(a), smax=kc.shape[0], s=q.shape[0]):
                p0 = pos_rows(bufs[pid][:n], smax, s)
                y = attend(bufs[qid][:n], bufs[kid][:n], bufs[vid][:n], p0,
                           attrs)
                bufs[oid][:n].view(y.shape).copy_(y)
            reads = (qid, kid, vid, pid)
        elif k == "kvappend":
            cache, new, ps = g.act_inputs(op)
            cid, nid, pid = ids[cache.name], ids[new.name], ids[ps.name]

            def run(bufs, n, cid=cid, nid=nid, pid=pid, oid=oid,
                    smax=cache.shape[0], s=new.shape[0]):
                kv_append(bufs[oid][:n], bufs[cid][:n], bufs[nid][:n],
                          pos_rows(bufs[pid][:n], smax, s))
            reads = (cid, nid, pid)
        else:
            raise NotImplementedError(
                f"{op.name}: op kind {k!r} has no float32 plan kernel")

        steps.append(PlanStep(label, reads, (oid,), run))

    return steps, "op"
