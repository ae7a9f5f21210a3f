"""Functional banked-TCM simulator.

Replays a compiled :class:`NPUProgram` tick by tick against real tensor
data and asserts that the compiler's output is *correct*, not just fast:

  * every compute input is resident in TCM when used (Eq. 2),
  * tiles only enter TCM via fetch/compute and leave via push/death
    (Eq. 1 persistency),
  * banks are never double-held (allocation property d),
  * model outputs land in DRAM bit-identical (float32 tolerance) to the
    pure-numpy :func:`repro_torch.core.ir.reference_execute` oracle.

This is the repro analogue of running the compiled binary on silicon.

It is the *validating* replay and the oracle the deployment-speed
engine is checked against: :mod:`repro_torch.core.execplan` lowers the same
program once into a batch-vectorized :class:`ExecPlan` (no per-request
bookkeeping) whose outputs must match this executor bit for bit
(float32) or to the stored integer (int8/int4).

Copy of the JAX package's ``core/executor.py``.  It is the validating
oracle of the modeled NPU, in numpy on the host, as in the reference:
not a GPU path.  The port reaches it only when the caller asks
(``CompiledModel(..., engine="interp")``, ``check=True``, ``verify()``);
requests are served by the device plan of :mod:`repro_torch.core.execplan`.
The plan hooks of :class:`ExecSemantics` (``plan_dtype``,
``encode_input``) speak torch, since the port's plan lives on the device;
``encode_input`` and ``decode`` also take the interpreter's numpy arrays.
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from .ir import (Graph, Op, _apply_act, _attention_ref, _conv2d_ref,
                 _kvappend_ref, _layernorm_ref, _matmul_ref, _softmax_ref,
                 reference_execute)
from .program import NPUProgram, TileRef
from .tiling import TilingResult, in_row_range


class ExecutionError(RuntimeError):
    pass


@dataclass
class ExecutionReport:
    """Outcome of one replay.

    ``ticks`` and ``ddr_bytes`` are **per-request** modeled quantities:
    a batched plan execution (``batch > 1``) reports the schedule's
    fetch/push bytes for *one* request, not the batch aggregate, so
    DDR columns stay comparable across executors and batch sizes."""

    outputs: Dict[str, np.ndarray]
    max_err: float
    ticks: int
    ddr_bytes: int
    ok: bool = True
    batch: int = 1
    engine: str = "interp"            # "interp" | "plan"


# --------------------------------------------------------------------------
# Row/channel gathering from resident tiles
# --------------------------------------------------------------------------


class _TcmState:
    """Resident-tile store with indexed gathers.

    Tile lists are produced in ascending [r0, r1) order by the tiler, so
    the tiles covering a row/channel range form a contiguous slice found
    by bisection on cached boundary arrays — the replay's hottest path no
    longer scans every tile of a tensor per gather.

    Consecutive steps of the same op request heavily overlapping input
    row windows (stride < kernel height), so assembled windows are
    cached per tensor: a request fully inside the last window is a pure
    slice (no concat), and a request extending it assembles only the new
    rows.  The cache is versioned — any ``put``/``drop`` touching a
    tensor invalidates its window — and residency of the covering tiles
    is still asserted on every gather, so the validator's Eq.-2 check is
    as strict as the uncached path."""

    def __init__(self, g: Graph):
        self.g = g
        self.data: Dict[Tuple[str, int], np.ndarray] = {}
        self.resident: set = set()
        self._bounds: Dict[str, Tuple[List[int], List[int]]] = {}
        #: tensor -> (version, lo, hi, assembled rows [lo, hi))
        self._win: Dict[str, Tuple[int, int, int, np.ndarray]] = {}
        self._ver: Dict[str, int] = {}

    def put(self, tl: TileRef, arr: np.ndarray) -> None:
        self.data[tl.key] = arr
        self.resident.add(tl.key)
        self._ver[tl.tensor] = self._ver.get(tl.tensor, 0) + 1
        self._win.pop(tl.tensor, None)

    def drop(self, key: Tuple[str, int]) -> None:
        self.resident.discard(key)
        self.data.pop(key, None)
        self._ver[key[0]] = self._ver.get(key[0], 0) + 1
        self._win.pop(key[0], None)

    def _covering(self, tt, a: int, b: int) -> List[TileRef]:
        """Tiles (ascending) overlapping [a, b) on the tiled axis."""
        bounds = self._bounds.get(tt.tensor)
        if bounds is None:
            bounds = ([t.r0 for t in tt.tiles], [t.r1 for t in tt.tiles])
            self._bounds[tt.tensor] = bounds
        starts, ends = bounds
        i0 = bisect.bisect_right(ends, a)
        i1 = bisect.bisect_left(starts, b)
        return tt.tiles[i0:i1]

    def _assemble(self, tt, tensor: str, a: int, b: int) -> np.ndarray:
        """Concatenate rows [a, b) from resident tiles (uncached path)."""
        parts = []
        covered = a
        for tl in self._covering(tt, a, b):
            arr = self.data[tl.key]
            lo = max(a, tl.r0)
            hi = min(b, tl.r1)
            if lo != covered:
                raise ExecutionError(
                    f"gap gathering {tensor}[{a}:{b}) at row {covered}")
            parts.append(arr[lo - tl.r0: hi - tl.r0])
            covered = hi
        if covered < b:
            raise ExecutionError(
                f"rows {covered}:{b} of {tensor} missing from TCM")
        return np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]

    def gather_rows(self, tiling: TilingResult, tensor: str,
                    a: int, b: int) -> np.ndarray:
        """Assemble rows [a, b) of `tensor` from resident tiles."""
        tt = tiling.tiles[tensor]
        shape = self.g.tensors[tensor].shape
        if tt.axis == "chan":
            for tl in tt.tiles:
                if tl.key not in self.resident:
                    raise ExecutionError(f"{tl} not resident")
            ver = self._ver.get(tensor, 0)
            cached = self._win.get(tensor)
            if cached is not None and cached[0] == ver:
                full = cached[3]
            else:
                parts = [self.data[tl.key] for tl in tt.tiles]
                full = np.concatenate(parts, axis=-1) if len(parts) > 1 \
                    else parts[0]
                H = shape[0] if len(shape) == 3 else 1
                self._win[tensor] = (ver, 0, H, full)
            return full[a:b] if len(shape) == 3 else full
        # residency is asserted against the *current* tile set even when
        # the window data comes from the cache
        for tl in self._covering(tt, a, b):
            if tl.key not in self.resident:
                raise ExecutionError(f"{tl} not resident")
        ver = self._ver.get(tensor, 0)
        cached = self._win.get(tensor)
        if cached is not None and cached[0] == ver:
            _, lo, hi, arr = cached
            if lo <= a and b <= hi:
                return arr[a - lo: b - lo]
            if lo <= a < hi < b:
                # forward extension: assemble only the new rows
                ext = self._assemble(tt, tensor, hi, b)
                arr = np.concatenate([arr[a - lo:], ext], axis=0)
                self._win[tensor] = (ver, a, b, arr)
                return arr
        arr = self._assemble(tt, tensor, a, b)
        self._win[tensor] = (ver, a, b, arr)
        return arr

    def gather_param(self, tiling: TilingResult, tensor: str,
                     c0: int, c1: int) -> np.ndarray:
        tt = tiling.tiles[tensor]
        if tt.axis != "chan":
            tiles = list(tt.tiles)
        else:
            tiles = self._covering(tt, c0, c1)
        parts = []
        for tl in tiles:
            if tl.key not in self.resident:
                raise ExecutionError(f"param {tl} not resident")
            arr = self.data[tl.key]
            lo, hi = max(c0, tl.r0), min(c1, tl.r1)
            parts.append(arr[lo - tl.r0: hi - tl.r0])
        out = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        if out.shape[0] != c1 - c0:
            raise ExecutionError(f"param {tensor}[{c0}:{c1}) incomplete")
        return out


# --------------------------------------------------------------------------
# Per-step computation (mirrors ir.reference_execute on a row window)
# --------------------------------------------------------------------------


def gather_window(tcm: _TcmState, tiling: TilingResult, x, rr0: int,
                  rr1: int, kh: int, s: int, pt: int
                  ) -> Tuple[np.ndarray, int, int]:
    """Gather the input rows a kh-tall stride-s windowed op (conv/pool)
    needs to produce output rows [rr0, rr1), clipped to the valid input
    range.  Returns (window, top_pad, bottom_pad) — the receptive-field
    math shared by the float and quantized replay paths."""
    ih = x.shape[0]
    u0 = rr0 * s - pt
    u1 = (rr1 - 1) * s - pt + kh
    lo, hi = max(0, u0), min(ih, u1)
    win = tcm.gather_rows(tiling, x.name, lo, hi)
    return win, max(0, -u0), max(0, u1 - ih)


def _run_step(g: Graph, tiling: TilingResult, tcm: _TcmState, op: Op,
              r0: int, r1: int, axis: str) -> Dict[str, np.ndarray]:
    a = op.attrs
    k = op.kind
    out0 = g.tensors[op.outputs[0]]
    H = out0.shape[0] if len(out0.shape) == 3 else 1

    if axis == "chan":
        c0, c1 = r0, r1
        rr0, rr1 = 0, H
    else:
        c0 = 0
        c1 = out0.shape[-1]
        rr0, rr1 = r0, r1

    def rows_of(x, lo, hi):
        return tcm.gather_rows(tiling, x.name, lo, hi)

    if k in ("conv", "dwconv"):
        x = g.act_inputs(op)[0]
        kh = a["k"][0]
        s = a["stride"]
        pt, pb, pl, pr = a["pad"]
        win, top, bot = gather_window(tcm, tiling, x, rr0, rr1, kh, s, pt)
        w = tcm.gather_param(tiling, op.inputs[1], c0, c1)
        if k == "dwconv" and axis == "chan":
            win = win[:, :, c0:c1]
        y = _conv2d_ref(win, w, s, (top, bot, pl, pr), k == "dwconv")
        if len(op.inputs) > 2:
            y = y + tcm.gather_param(tiling, op.inputs[2], c0, c1)
        y = _apply_act(y, a.get("act", "none"))
    elif k == "fc":
        x = g.act_inputs(op)[0]
        xin = rows_of(x, 0, x.shape[0] if len(x.shape) == 3 else 1)
        w = tcm.gather_param(tiling, op.inputs[1], c0, c1)[:, 0, 0, :]
        y = (w @ xin.reshape(-1))
        if len(op.inputs) > 2:
            y = y + tcm.gather_param(tiling, op.inputs[2], c0, c1)
        y = _apply_act(y, a.get("act", "none")).reshape(1, 1, -1)
    elif k == "add":
        xs = [rows_of(x, *in_row_range(op, rr0, rr1,
                                       x.shape[0] if len(x.shape) == 3
                                       else 1))
              for x in g.act_inputs(op)]
        y = _apply_act(xs[0] + xs[1], a.get("act", "none"))
    elif k == "mul":
        xs = []
        for x in g.act_inputs(op):
            ih = x.shape[0] if len(x.shape) == 3 else 1
            lo, hi = in_row_range(op, rr0, rr1, ih)
            xs.append(rows_of(x, lo, hi))
        y = xs[0] * xs[1]
    elif k == "scalar":
        x = rows_of(g.act_inputs(op)[0], rr0, rr1)
        v = a["value"]
        y = {"add": x + v, "mul": x * v, "div": x / v}[a["op"]]
    elif k == "act":
        y = _apply_act(rows_of(g.act_inputs(op)[0], rr0, rr1), a["act"])
    elif k == "maxpool":
        x = g.act_inputs(op)[0]
        kk, s = a["k"], a["stride"]
        pt, pb, pl, pr = a["pad"]
        win, top, bot = gather_window(tcm, tiling, x, rr0, rr1, kk, s, pt)
        xp = np.pad(win, ((top, bot), (pl, pr), (0, 0)),
                    constant_values=-np.inf)
        # batched window reduction (one strided view, no Python loop)
        wins = sliding_window_view(xp, (kk, kk), axis=(0, 1))
        y = wins[::s, ::s].max(axis=(-2, -1))
    elif k == "avgpool":
        x = g.act_inputs(op)[0]
        ih = x.shape[0]
        if a["k"] == 0:
            # canonical layout before the reduction: numpy's pairwise
            # summation blocking follows the array's strides, and a
            # gathered window may be a transposed einsum-output view —
            # the mean must not depend on which tiles the window came
            # from (the compiled replay plan reduces contiguous
            # buffers and is asserted bit-exact against this path)
            win = np.ascontiguousarray(rows_of(x, 0, ih))
            y = win.mean(axis=(0, 1), keepdims=True)
        else:
            kk, s = a["k"], a["stride"]
            pt, pb, pl, pr = a["pad"]
            win, top, bot = gather_window(tcm, tiling, x, rr0, rr1,
                                          kk, s, pt)
            xp = np.pad(win, ((top, bot), (pl, pr), (0, 0)))
            wins = sliding_window_view(xp, (kk, kk), axis=(0, 1))
            y = wins[::s, ::s].sum(axis=(-2, -1), dtype=np.float32) \
                / (kk * kk)
    elif k == "resize":
        f = a["factor"]
        lo, hi = rr0 // f, (rr1 + f - 1) // f
        win = rows_of(g.act_inputs(op)[0], lo, hi)
        y = np.repeat(np.repeat(win, f, axis=0), f, axis=1)
        y = y[rr0 - lo * f: rr1 - lo * f]
    elif k == "concat":
        xs = [rows_of(x, rr0, rr1) for x in g.act_inputs(op)]
        y = np.concatenate(xs, axis=2)
    elif k == "split":
        xin = rows_of(g.act_inputs(op)[0], rr0, rr1)
        parts = np.split(xin, a["sections"], axis=2)
        return {o: p for o, p in zip(op.outputs, parts)}
    elif k == "matmul":
        xin = rows_of(g.act_inputs(op)[0], rr0, rr1)
        w = tcm.gather_param(tiling, op.inputs[1], c0, c1)[:, 0, 0, :]
        b = tcm.gather_param(tiling, op.inputs[2], c0, c1) \
            if len(op.inputs) > 2 else None
        y = _matmul_ref(xin, w, b, a.get("act", "none"))
    elif k == "layernorm":
        xin = rows_of(g.act_inputs(op)[0], rr0, rr1)
        cc = g.tensors[op.inputs[1]].shape[0]
        gamma = tcm.gather_param(tiling, op.inputs[1], 0, cc)
        beta = tcm.gather_param(tiling, op.inputs[2], 0, cc)
        y = _layernorm_ref(xin, gamma, beta, a["eps"])
    elif k == "softmax":
        y = _softmax_ref(rows_of(g.act_inputs(op)[0], rr0, rr1))
    elif k == "attention":
        q, kc, vc, ps = g.act_inputs(op)
        qin = rows_of(q, rr0, rr1)
        kin = rows_of(kc, 0, kc.shape[0])
        vin = rows_of(vc, 0, vc.shape[0])
        pin = rows_of(ps, 0, 1)
        y = _attention_ref(qin, kin, vin, pin, a,
                           q0=rr0, s_total=q.shape[0])
    elif k == "kvappend":
        cache, new, ps = g.act_inputs(op)
        cin = rows_of(cache, 0, cache.shape[0])
        nin = rows_of(new, 0, new.shape[0])
        pin = rows_of(ps, 0, 1)
        y = _kvappend_ref(cin, nin, pin)[rr0:rr1]
    else:  # pragma: no cover
        raise NotImplementedError(k)
    return {op.outputs[0]: y}


# --------------------------------------------------------------------------
# Execution semantics — float32 replay vs quantized replay
# --------------------------------------------------------------------------


#: the float32 plan's tolerance against the interpreter (and against the
#: reference's plan), relative to max(1, max|want|) per output: the plan
#: sums in another order than numpy (K1's f32 FMAs, torch), so it is not
#: bit-exact; PERF.md records the margins measured against this
FLOAT_PLAN_RTOL = 1e-4


def float_plan_tol(want) -> float:
    """Accepted max|got - want| of one float32 plan output, ``want``
    being the interpreter's (or the reference's) values."""
    w = np.abs(np.asarray(want, dtype=np.float64))
    return FLOAT_PLAN_RTOL * max(1.0, float(w.max()) if w.size else 0.0)


class ExecSemantics:
    """Value semantics of one program replay.

    The replay loop (DMA residency, bank ledger, tile gathers) is
    precision-agnostic; this object decides what the *bytes* mean: how
    DRAM is initialized, how one compute step is evaluated on a row
    window, what the functional oracle is, and how outputs are compared
    against it.  The default instance is the float32 path; the int8/int4
    quantized path lives in :mod:`repro_torch.quant.executor`."""

    name = "float32"

    def dram_init(self, g: Graph, inputs: Dict[str, np.ndarray],
                  weights: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        dram: Dict[str, np.ndarray] = {}
        for t in g.tensors.values():
            if t.kind == "input":
                dram[t.name] = np.asarray(inputs[t.name], dtype=np.float32)
            elif t.is_param:
                dram[t.name] = np.asarray(weights[t.name], dtype=np.float32)
        return dram

    def run_step(self, g: Graph, tiling: TilingResult, tcm: "_TcmState",
                 op: Op, r0: int, r1: int, axis: str
                 ) -> Dict[str, np.ndarray]:
        return _run_step(g, tiling, tcm, op, r0, r1, axis)

    def reference(self, g: Graph, inputs: Dict[str, np.ndarray],
                  weights: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return reference_execute(g, inputs, weights)

    def decode(self, tensor: str, arr: np.ndarray) -> np.ndarray:
        """Model-output DRAM bytes -> comparable float values."""
        return arr

    def tolerance(self, tensor: str, want: np.ndarray,
                  atol: float) -> float:
        """Max |got - want| accepted for one output tensor."""
        scale = float(np.max(np.abs(want)) + 1e-6) if want.size else 1.0
        return atol * max(1.0, scale)

    # -- plan lowering hooks (repro_torch.core.execplan) --------------------
    def plan_lowerer(self):
        """Step-lowering function for :func:`repro_torch.core.execplan.
        lower_plan`: one batch-vectorized float32 step per op, conv and
        fc on K1 (:func:`repro_torch.core.execplan.lower_float_steps`)."""
        from .execplan import lower_float_steps
        return lower_float_steps

    def plan_dtype(self, tensor) -> torch.dtype:
        """Stored dtype of one tensor's arena buffer."""
        return torch.float32

    def encode_input(self, name: str, arr):
        """Request values -> stored values (may be batched): a tensor on
        its device for the plan, a numpy array for the interpreter."""
        if isinstance(arr, torch.Tensor):
            return arr.to(torch.float32)
        return np.asarray(arr, dtype=np.float32)

    def plan_parity_tol(self, tensor: str, want=None) -> float:
        """Accepted |plan - interpreter| on one decoded output, whose
        interpreter values are ``want``: :func:`float_plan_tol` (taken
        with max|want| = 1 when ``want`` is None).  Quantized semantics
        allow one step of the output quantization grid instead."""
        return float_plan_tol(1.0 if want is None else want)


FLOAT_SEMANTICS = ExecSemantics()


# --------------------------------------------------------------------------
# Program replay
# --------------------------------------------------------------------------


def execute(prog: NPUProgram, g: Graph, tiling: TilingResult,
            inputs: Dict[str, np.ndarray],
            weights: Dict[str, np.ndarray],
            check: bool = True, atol: float = 1e-4,
            semantics: Optional[ExecSemantics] = None) -> ExecutionReport:
    sem = semantics or FLOAT_SEMANTICS
    written: Dict[str, np.ndarray] = {}
    dram = sem.dram_init(g, inputs, weights)

    tcm = _TcmState(g)
    dead_after = prog.meta.get("dead_after_tick", {})
    ddr = 0

    def tile_slice(tl: TileRef, arr: np.ndarray) -> np.ndarray:
        t = g.tensors[tl.tensor]
        if t.is_param:
            return arr[tl.r0:tl.r1]
        if tl.axis == "chan":
            return arr[..., tl.r0:tl.r1]
        return arr[tl.r0:tl.r1]

    for tick in prog.ticks:
        for j in tick.dma:
            if j.kind in ("fetch", "lfetch"):
                src = dram.get(j.tile.tensor)
                if src is None:
                    raise ExecutionError(
                        f"tick {tick.index}: fetch of {j.tile} but tensor "
                        f"not in DRAM (never pushed?)")
                tcm.put(j.tile, tile_slice(j.tile, src))
                ddr += j.nbytes
            elif j.kind == "lcopy":
                pass  # halo duplication — layout-only, no data change
        if tick.compute:
            cj = tick.compute
            op = g.op(cj.op_name)
            if cj.r0 is not None:
                r0, r1, axis = cj.r0, cj.r1, cj.axis
            else:  # legacy program: derive the range from the out tiles
                axis = cj.out_tiles[0].axis
                r0 = min(tl.r0 for tl in cj.out_tiles
                         if tl.tensor == op.outputs[0])
                r1 = max(tl.r1 for tl in cj.out_tiles
                         if tl.tensor == op.outputs[0])
            results = sem.run_step(g, tiling, tcm, op, r0, r1, axis)
            for tl in cj.out_tiles:
                y = results[tl.tensor]
                if axis == "chan":
                    if tl.r0 < r0 or tl.r1 > r1:
                        # channel-split step writing a slice of a wider
                        # (bank-granular) output tile: read-modify-write
                        buf = tcm.data.get(tl.key)
                        if buf is None:
                            shape = y.shape[:-1] + (tl.r1 - tl.r0,)
                            buf = np.zeros(shape, dtype=y.dtype)
                        lo, hi = max(r0, tl.r0), min(r1, tl.r1)
                        buf[..., lo - tl.r0: hi - tl.r0] = \
                            y[..., lo - r0: hi - r0]
                        tcm.put(tl, buf)
                    else:
                        tcm.put(tl, y[..., tl.r0 - r0: tl.r1 - r0])
                else:
                    tcm.put(tl, y[tl.r0 - r0: tl.r1 - r0])
        for j in tick.dma:
            if j.kind == "push":
                t = g.tensors[j.tile.tensor]
                if j.tile.key not in tcm.resident:
                    raise ExecutionError(
                        f"tick {tick.index}: push of non-resident {j.tile}")
                arr = tcm.data[j.tile.key]
                if t.name not in dram:
                    dram[t.name] = np.zeros(t.shape, dtype=arr.dtype)
                    written[t.name] = np.zeros(t.shape, dtype=bool)
                if t.is_param:
                    dram[t.name][j.tile.r0:j.tile.r1] = arr
                elif j.tile.axis == "chan":
                    dram[t.name][..., j.tile.r0:j.tile.r1] = arr
                    if t.name in written:
                        written[t.name][..., j.tile.r0:j.tile.r1] = True
                else:
                    dram[t.name][j.tile.r0:j.tile.r1] = arr
                    if t.name in written:
                        written[t.name][j.tile.r0:j.tile.r1] = True
                tcm.drop(j.tile.key)
                ddr += j.nbytes
        for key in dead_after.get(tick.index, []):
            tcm.drop(tuple(key))

    max_err = 0.0
    outputs: Dict[str, np.ndarray] = {}
    if check:
        ref = sem.reference(g, inputs, weights)
        for t in g.outputs:
            if t.name not in dram:
                raise ExecutionError(f"output {t.name} never pushed to DRAM")
            if t.name in written and not written[t.name].all():
                raise ExecutionError(f"output {t.name} partially written")
            got = sem.decode(t.name, dram[t.name])
            want = ref[t.name]  # reference() returns decoded float values
            err = float(np.max(np.abs(got - want))) if got.size else 0.0
            tol = sem.tolerance(t.name, want, atol)
            if err > tol:
                raise ExecutionError(
                    f"output {t.name} mismatch ({sem.name}): "
                    f"max|err|={err:.3e} (tol {tol:.3e})")
            max_err = max(max_err, err)
            outputs[t.name] = got
    else:
        outputs = {t.name: dram.get(t.name) for t in g.outputs}

    return ExecutionReport(outputs, max_err, len(prog.ticks), ddr)
