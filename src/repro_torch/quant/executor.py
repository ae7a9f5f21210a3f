"""Quantized program replay of the port: int8/int4 execution semantics.

Counterpart of ``repro/quant/executor.py``.  :class:`QuantSemantics`
plugs a :class:`QuantizedModel` into both engines of the port:

  * the **device plan** (:mod:`repro_torch.core.execplan`, lowered by
    :mod:`repro_torch.quant.execplan`): activations stored int8 in the
    device arena, inputs quantized and outputs decoded there, every conv
    and fc on the hand-written K1 kernel;
  * the **interpretive replay** (:func:`repro_torch.core.executor.execute`,
    the host's validating oracle in numpy): DRAM holds the stored integer
    values, each compute step runs the integer kernels of
    :mod:`repro_torch.quant.ptq` on its row/channel window, and outputs
    are checked against :func:`quantized_reference_execute` to within
    ``atol_steps`` output quantization steps.

``encode_input`` and ``decode`` serve both: a torch tensor is quantized
or decoded on its device (``quantize_t``/``dequantize_t``), a numpy
array on the host (``quantize``/``dequantize``); neither goes through
the other's memory.  The tolerances (one output step against the plan,
the calibrated band against the float oracle) are the reference's.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.executor import ExecSemantics, _TcmState, gather_window
from repro_torch.core.ir import (Graph, Op, _apply_act, _attention_ref,
                                 _kvappend_ref, _layernorm_ref, _softmax_ref)
from repro_torch.core.tiling import TilingResult, in_row_range

from .ptq import (QuantizedModel, q_avgpool, q_conv, q_fc,
                  q_global_avgpool, q_matmul, q_maxpool,
                  quantized_reference_execute)
from .qparams import dequantize, dequantize_t, quantize, quantize_t


class QuantSemantics(ExecSemantics):
    """Integer execution semantics for a :class:`QuantizedModel`."""

    name = "int8"

    def __init__(self, qm: QuantizedModel, atol_steps: float = 1.5,
                 float_atol_steps: float = 4.0):
        self.qm = qm
        self.atol_steps = atol_steps          # vs the quantized oracle
        # vs the float oracle: int4 weights carry 16x the quantization
        # granularity of int8, so the calibrated band widens accordingly
        if qm.weight_dtype == "int4":
            float_atol_steps *= 16.0
        self.float_atol_steps = float_atol_steps
        self._qref: Optional[Dict[str, np.ndarray]] = None

    # -- artifact metadata round trip ---------------------------------------
    def meta(self) -> Dict[str, object]:
        """Everything a persisted artifact needs to rebuild *these*
        semantics (tolerances included) next to the stored qparams."""
        return {"precision": self.name,
                "weight_dtype": self.qm.weight_dtype,
                "atol_steps": self.atol_steps,
                "float_atol_steps": self.float_atol_steps}

    @classmethod
    def from_meta(cls, qm: QuantizedModel,
                  meta: Dict[str, object]) -> "QuantSemantics":
        sem = cls(qm, atol_steps=float(meta.get("atol_steps", 1.5)))
        # float_atol_steps was already widened for int4 at save time;
        # restore it verbatim rather than re-deriving
        if "float_atol_steps" in meta:
            sem.float_atol_steps = float(meta["float_atol_steps"])
        return sem

    # -- plan lowering hooks (repro_torch.core.execplan) --------------------
    def plan_lowerer(self):
        """One fused kernel per op; conv and fc on K1."""
        import functools

        from .execplan import lower_quant_steps
        return functools.partial(lower_quant_steps, self.qm)

    def plan_dtype(self, tensor) -> torch.dtype:
        # activations are stored int8; quantization-exempt tensors
        # (sequence-position operands) stay float32
        if tensor.qparams is None:
            return torch.float32
        return torch.int8

    def encode_input(self, name: str, arr):
        """Request values -> stored values: on the tensor's device for
        the plan, in numpy for the interpreter."""
        qp = self.qm.graph.tensors[name].qparams
        if isinstance(arr, torch.Tensor):
            arr = arr.to(torch.float32)
            return arr if qp is None else quantize_t(arr, qp)
        arr = np.asarray(arr, np.float32)
        return arr if qp is None else quantize(arr, qp)

    def decode(self, tensor: str, arr):
        """Stored values -> float32, on the tensor's device or in numpy."""
        if isinstance(arr, torch.Tensor):
            return dequantize_t(arr, self.qm.qp(tensor))
        return dequantize(arr, self.qm.qp(tensor))

    def plan_parity_tol(self, tensor: str, want=None) -> float:
        if self.qm.graph.tensors[tensor].qparams is None:
            return 1e-6
        return self._scale(tensor) + 1e-7   # one output quant step

    # -- replay hooks (the interpretive executor, host) ---------------------
    def dram_init(self, g: Graph, inputs, weights) -> Dict[str, np.ndarray]:
        dram: Dict[str, np.ndarray] = {}
        for t in g.tensors.values():
            if t.kind == "input":
                dram[t.name] = self.encode_input(
                    t.name, np.asarray(inputs[t.name], np.float32))
            elif t.is_param:
                dram[t.name] = self.qm.qweights[t.name]
        return dram

    def run_step(self, g: Graph, tiling: TilingResult, tcm: _TcmState,
                 op: Op, r0: int, r1: int, axis: str
                 ) -> Dict[str, np.ndarray]:
        return _run_qstep(self.qm, g, tiling, tcm, op, r0, r1, axis)

    def reference(self, g: Graph, inputs, weights) -> Dict[str, np.ndarray]:
        self._qref = quantized_reference_execute(self.qm, inputs)
        return {t.name: dequantize(self._qref[t.name], self.qm.qp(t.name))
                for t in g.outputs}

    def tolerance(self, tensor: str, want, atol: float) -> float:
        return self.atol_steps * self._scale(tensor) + 1e-7

    # -- calibrated tolerance vs the float oracle ---------------------------
    def _scale(self, tensor: str) -> float:
        return float(np.max(np.atleast_1d(self.qm.qp(tensor).scale)))

    def float_tolerance(self, tensor: str) -> float:
        """Accepted |dequantized - float oracle| for one model output:
        2x the worst error of this PTQ on its own calibration set, with
        a floor of a few output quantization steps."""
        floor = self.float_atol_steps * self._scale(tensor) + 1e-6
        cal = self.qm.calib_error.get(tensor)
        if cal is not None and cal > 0:
            return max(floor, 2.0 * cal)
        return floor


# --------------------------------------------------------------------------
# Per-step integer computation (mirrors core executor._run_step)
# --------------------------------------------------------------------------


def _run_qstep(qm: QuantizedModel, g: Graph, tiling: TilingResult,
               tcm: _TcmState, op: Op, r0: int, r1: int, axis: str
               ) -> Dict[str, np.ndarray]:
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

    def deq(x, arr):
        return dequantize(arr, qm.qp(x.name))

    out_qp = qm.qp(op.outputs[0])

    if k in ("conv", "dwconv"):
        x = g.act_inputs(op)[0]
        kh = a["k"][0]
        s = a["stride"]
        pt, pb, pl, pr = a["pad"]
        win, top, bot = gather_window(tcm, tiling, x, rr0, rr1, kh, s, pt)
        w_q = tcm.gather_param(tiling, op.inputs[1], c0, c1)
        w_qp = qm.qp(op.inputs[1])
        if w_qp.per_channel and axis == "chan":
            w_qp = _slice_qp(w_qp, c0, c1)
        if k == "dwconv" and axis == "chan":
            win = win[:, :, c0:c1]
        bias_q = None
        if len(op.inputs) > 2:
            bias_q = tcm.gather_param(tiling, op.inputs[2], c0, c1)
        y = q_conv(win, qm.qp(x.name), w_q, w_qp, bias_q, s,
                   (top, bot, pl, pr), k == "dwconv",
                   a.get("act", "none"), out_qp)
    elif k == "fc":
        x = g.act_inputs(op)[0]
        xin = rows_of(x, 0, x.shape[0] if len(x.shape) == 3 else 1)
        w_q = tcm.gather_param(tiling, op.inputs[1], c0, c1)[:, 0, 0, :]
        w_qp = qm.qp(op.inputs[1])
        if w_qp.per_channel and axis == "chan":
            w_qp = _slice_qp(w_qp, c0, c1)
        bias_q = None
        if len(op.inputs) > 2:
            bias_q = tcm.gather_param(tiling, op.inputs[2], c0, c1)
        y = q_fc(xin, qm.qp(x.name), w_q, w_qp, bias_q,
                 a.get("act", "none"), out_qp).reshape(1, 1, -1)
    elif k == "add":
        xs = []
        for x in g.act_inputs(op):
            ih = x.shape[0] if len(x.shape) == 3 else 1
            lo, hi = in_row_range(op, rr0, rr1, ih)
            xs.append(deq(x, rows_of(x, lo, hi)))
        y = quantize(_apply_act(xs[0] + xs[1], a.get("act", "none")),
                     out_qp)
    elif k == "mul":
        xs = []
        for x in g.act_inputs(op):
            ih = x.shape[0] if len(x.shape) == 3 else 1
            lo, hi = in_row_range(op, rr0, rr1, ih)
            xs.append(deq(x, rows_of(x, lo, hi)))
        y = quantize(xs[0] * xs[1], out_qp)
    elif k == "scalar":
        x = g.act_inputs(op)[0]
        xv = deq(x, rows_of(x, rr0, rr1))
        v = a["value"]
        y = quantize({"add": xv + v, "mul": xv * v,
                      "div": xv / v}[a["op"]], out_qp)
    elif k == "act":
        x = g.act_inputs(op)[0]
        y = quantize(_apply_act(deq(x, rows_of(x, rr0, rr1)), a["act"]),
                     out_qp)
    elif k in ("maxpool", "avgpool"):
        x = g.act_inputs(op)[0]
        ih = x.shape[0]
        if k == "avgpool" and a["k"] == 0:
            win = rows_of(x, 0, ih)
            y = q_global_avgpool(win, qm.qp(x.name), out_qp)
        else:
            kk, s = a["k"], a["stride"]
            pt, pb, pl, pr = a["pad"]
            win, top, bot = gather_window(tcm, tiling, x, rr0, rr1,
                                          kk, s, pt)
            fn = q_maxpool if k == "maxpool" else q_avgpool
            y = fn(win, kk, s, (top, bot, pl, pr), qm.qp(x.name), out_qp)
    elif k == "resize":
        f = a["factor"]
        lo, hi = rr0 // f, (rr1 + f - 1) // f
        x = g.act_inputs(op)[0]
        win = rows_of(x, lo, hi)
        rep = np.repeat(np.repeat(win, f, axis=0), f, axis=1)
        rep = rep[rr0 - lo * f: rr1 - lo * f]
        y = quantize(deq(x, rep), out_qp)
    elif k == "concat":
        xs = [deq(x, rows_of(x, rr0, rr1)) for x in g.act_inputs(op)]
        y = quantize(np.concatenate(xs, axis=2), out_qp)
    elif k == "split":
        x = g.act_inputs(op)[0]
        xin = deq(x, rows_of(x, rr0, rr1))
        parts = np.split(xin, a["sections"], axis=2)
        return {o: quantize(p, qm.qp(o))
                for o, p in zip(op.outputs, parts)}
    elif k == "matmul":
        x = g.act_inputs(op)[0]
        xin = rows_of(x, rr0, rr1)
        w_q = tcm.gather_param(tiling, op.inputs[1], c0, c1)[:, 0, 0, :]
        w_qp = qm.qp(op.inputs[1])
        if w_qp.per_channel and axis == "chan":
            w_qp = _slice_qp(w_qp, c0, c1)
        bias_q = None
        if len(op.inputs) > 2:
            bias_q = tcm.gather_param(tiling, op.inputs[2], c0, c1)
        y = q_matmul(xin, qm.qp(x.name), w_q, w_qp, bias_q,
                     a.get("act", "none"), out_qp)
    elif k == "layernorm":
        x = g.act_inputs(op)[0]
        xv = deq(x, rows_of(x, rr0, rr1))
        nc = g.tensors[op.inputs[1]].shape[0]
        gam = tcm.gather_param(tiling, op.inputs[1], 0, nc)
        bet = tcm.gather_param(tiling, op.inputs[2], 0, nc)
        y = quantize(_layernorm_ref(xv, gam, bet, a["eps"]), out_qp)
    elif k == "softmax":
        x = g.act_inputs(op)[0]
        y = quantize(_softmax_ref(deq(x, rows_of(x, rr0, rr1))), out_qp)
    elif k == "attention":
        qx, kc, vc, ps = g.act_inputs(op)
        qin = deq(qx, rows_of(qx, rr0, rr1))
        kin = deq(kc, rows_of(kc, 0, kc.shape[0]))
        vin = deq(vc, rows_of(vc, 0, vc.shape[0]))
        pin = rows_of(ps, 0, 1)          # float32, quantization-exempt
        y = quantize(_attention_ref(qin, kin, vin, pin, a,
                                    q0=rr0, s_total=qx.shape[0]), out_qp)
    elif k == "kvappend":
        cx, nx, ps = g.act_inputs(op)
        cin = deq(cx, rows_of(cx, 0, cx.shape[0]))
        nin = deq(nx, rows_of(nx, 0, nx.shape[0]))
        pin = rows_of(ps, 0, 1)
        y = quantize(_kvappend_ref(cin, nin, pin), out_qp)[rr0:rr1]
    else:  # pragma: no cover
        raise NotImplementedError(k)
    return {op.outputs[0]: y}


def _slice_qp(qp, c0: int, c1: int):
    from repro_torch.core.ir import QParams
    return QParams(np.atleast_1d(qp.scale)[c0:c1],
                   np.atleast_1d(qp.zero_point)[c0:c1],
                   bits=qp.bits, axis=qp.axis)
