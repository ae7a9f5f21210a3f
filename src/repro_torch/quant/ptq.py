"""Post-training quantization pass + quantized functional reference.

The PTQ flow (the paper's INT8 deployment path, §II/§V):

  1. :func:`calibrate` runs the float32 reference executor over a small
     sample set and feeds every activation through a range observer
     (min-max or percentile, per-tensor);
  2. :func:`quantize_graph` annotates the IR in place — activations
     become int8 with per-tensor affine qparams, conv/fc/dwconv weights
     become int8 (or nibble-packed int4) with per-channel symmetric
     qparams, biases become int32 at scale ``s_x * s_w[c]`` — and
     returns a :class:`QuantizedModel` bundling the integer weights;
  3. :func:`quantized_reference_execute` is the *quantized* functional
     oracle: integer conv/fc/dwconv accumulation in int32 with a fused
     float rescale+activation epilogue (the NPU's rescale unit), and
     dequant->float->requant for the vector ops.  The plan replay
     (:mod:`repro_torch.quant.execplan`) reproduces its stored integers.

Because dtype + qparams enter :meth:`Graph.fingerprint`, quantizing a
graph changes its fingerprint — the compiled-program cache can never
serve a stale float32 program for a quantized request (and vice versa).

:func:`cast_graph` is the cost-model-only variant: it sets dtypes
without qparams so latency/tiling experiments can price a precision
without running calibration (not executable on the quantized path).

Copy of the JAX package's ``quant/ptq.py`` (numpy only; the port imports
nothing of that package and keeps its own copy).  The tests hold it
equal to the original.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.ir import (Graph, QParams, _apply_act, _attention_ref,
                           _kvappend_ref, _layernorm_ref, _softmax_ref,
                           cached_einsum, reference_execute)

from .observers import PerChannelMinMaxObserver, make_observer
from .qparams import (dequantize, pack_int4, qparams_from_range,
                      qparams_per_channel, quantize, unpack_int4)

#: int-domain sentinel standing in for -inf under maxpool padding.
_NEG_SENTINEL = np.int32(-(1 << 30))


# --------------------------------------------------------------------------
# Calibration
# --------------------------------------------------------------------------


CalibrationTable = Dict[str, object]  # tensor name -> observer


def synthetic_calibration(g: Graph, samples: int = 4, seed: int = 0
                          ) -> List[Dict[str, np.ndarray]]:
    """Deterministic synthetic calibration set: normal inputs for every
    graph input.  The repro's graphs carry deterministic pseudo-random
    weights, so synthetic activations exercise the same dynamic range a
    real input pipeline would here (and PTQ stays reproducible without
    external data)."""
    rng = np.random.default_rng(seed)
    return [{t.name: rng.normal(size=t.shape).astype(np.float32)
             for t in g.inputs}
            for _ in range(max(1, samples))]


def calibrate(g: Graph, weights: Dict[str, np.ndarray],
              sample_inputs: List[Dict[str, np.ndarray]],
              method: str = "minmax",
              percentile: float = 99.9) -> CalibrationTable:
    """Observe every activation range over the calibration samples."""
    if not sample_inputs:
        raise ValueError("calibration needs at least one sample input")
    obs: CalibrationTable = {
        t.name: make_observer(method, percentile)
        for t in g.tensors.values() if not t.is_param}
    for inp in sample_inputs:
        vals = reference_execute(g, inp, weights)
        for name, ob in obs.items():
            ob.update(vals[name])
    return obs


# --------------------------------------------------------------------------
# The PTQ pass
# --------------------------------------------------------------------------


@dataclass
class QuantizedModel:
    """A quantized graph plus everything needed to execute it.

    ``qweights`` holds the stored integer parameter values (int8 arrays;
    int32 for biases; int4 weights are kept *unpacked* one-per-int8 for
    compute, with the packed byte streams in ``packed``).  ``weights_f``
    keeps the float originals for the float-oracle comparison."""

    graph: Graph
    qweights: Dict[str, np.ndarray]
    packed: Dict[str, np.ndarray] = field(default_factory=dict)
    weights_f: Dict[str, np.ndarray] = field(default_factory=dict)
    weight_dtype: str = "int8"
    #: per-output max |quantized - float| observed on the calibration
    #: set (measure_quant_error); the basis of the calibrated tolerance.
    calib_error: Dict[str, float] = field(default_factory=dict)

    def qp(self, name: str) -> QParams:
        qp = self.graph.tensors[name].qparams
        if qp is None:
            raise ValueError(f"tensor {name} has no qparams")
        return qp


def _pos_tensors(g: Graph) -> set:
    """Names of tensors used *only* as sequence-position operands
    (attention input 3 / kvappend input 2).  Positions are integer
    indices, not signal: quantizing one to the calibration range would
    clamp decode at runtime positions the calibration never saw, so
    they stay float32 end to end."""
    pos = set()
    for op in g.ops:
        if op.kind == "attention":
            pos.add(op.inputs[3])
        elif op.kind == "kvappend":
            pos.add(op.inputs[2])
    for op in g.ops:
        for i, nm in enumerate(op.inputs):
            if nm not in pos:
                continue
            if not ((op.kind == "attention" and i == 3)
                    or (op.kind == "kvappend" and i == 2)):
                pos.discard(nm)   # also consumed as a value: quantize it
    return pos


def quantize_graph(g: Graph, weights: Dict[str, np.ndarray],
                   calib: CalibrationTable,
                   weight_dtype: str = "int8") -> QuantizedModel:
    """Annotate ``g`` in place with int8 activation qparams and
    int8/int4 weight qparams; returns the integer-weight bundle."""
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"weight_dtype must be int8/int4, {weight_dtype!r}")
    wbits = 8 if weight_dtype == "int8" else 4

    pos_names = _pos_tensors(g)
    for t in g.tensors.values():
        if t.is_param or t.name in pos_names:
            continue
        lo, hi = calib[t.name].range()
        t.qparams = qparams_from_range(float(lo), float(hi), bits=8,
                                       symmetric=False)
        t.dtype = "int8"

    # Tie each KV cache's in/out qparams to the union of their observed
    # ranges: pass-through rows then requantize exactly, and feeding a
    # decode step's cache output back as the next step's input is a
    # fixed point (no drift on rows the step didn't write).
    for op in g.ops:
        if op.kind != "kvappend":
            continue
        lo0, hi0 = calib[op.inputs[0]].range()
        lo1, hi1 = calib[op.outputs[0]].range()
        qp = qparams_from_range(float(min(lo0, lo1)), float(max(hi0, hi1)),
                                bits=8, symmetric=False)
        g.tensors[op.inputs[0]].qparams = qp
        g.tensors[op.outputs[0]].qparams = qp

    qweights: Dict[str, np.ndarray] = {}
    packed: Dict[str, np.ndarray] = {}
    for op in g.ops:
        params = g.param_inputs(op)
        if not params:
            continue
        if op.kind == "layernorm":
            # gamma/beta stay float32: layernorm re-normalizes every
            # row, so integer params buy no bandwidth worth the error;
            # the op executes dequant -> float LN -> requant.
            for pt_ in params:
                qweights[pt_.name] = np.asarray(weights[pt_.name],
                                                np.float32)
            continue
        if op.kind not in ("conv", "dwconv", "fc",
                           "matmul"):  # pragma: no cover
            raise NotImplementedError(
                f"op kind {op.kind} with parameters")
        wt = params[0]
        if len(wt.consumers) != 1:  # bias scale is tied to one consumer
            raise ValueError(f"weight {wt.name} has multiple consumers")
        wobs = PerChannelMinMaxObserver(axis=0)
        wobs.update(weights[wt.name])
        lo, hi = wobs.range()
        wqp = qparams_per_channel(lo, hi, bits=wbits, symmetric=True,
                                  axis=0)
        wt.qparams = wqp
        wt.dtype = weight_dtype
        qw = quantize(weights[wt.name], wqp)
        qweights[wt.name] = qw
        if weight_dtype == "int4":
            packed[wt.name] = pack_int4(qw)
            # the packed stream is the storage of record: compute reads
            # it back through unpack (keeps the format honest end-to-end)
            qweights[wt.name] = unpack_int4(packed[wt.name], qw.size,
                                            qw.shape)
        if len(params) > 1:
            bt = params[1]
            s_x = float(np.atleast_1d(g.tensors[op.inputs[0]].qparams
                                      .scale)[0])
            s_b = (s_x * np.atleast_1d(wqp.scale)).astype(np.float32)
            bqp = QParams(s_b, np.zeros(s_b.shape, dtype=np.int64),
                          bits=32, axis=0)
            bt.qparams = bqp
            bt.dtype = "int32"
            qweights[bt.name] = np.clip(
                np.round(np.asarray(weights[bt.name], np.float64) / s_b),
                bqp.qmin, bqp.qmax).astype(np.int32)
    return QuantizedModel(g, qweights, packed, dict(weights), weight_dtype)


def measure_quant_error(qm: QuantizedModel,
                        sample_inputs: List[Dict[str, np.ndarray]]
                        ) -> Dict[str, float]:
    """Per-output worst |dequantized quantized-oracle - float oracle|
    over the calibration samples.  Stored on the model; the replay's
    *calibrated tolerance* (QuantSemantics.float_tolerance) is a small
    multiple of this — quantization noise accumulates with depth, so an
    output-scale-only bound would be wrong for deep networks."""
    errs: Dict[str, float] = {t.name: 0.0 for t in qm.graph.outputs}
    for inp in sample_inputs:
        ref = reference_execute(qm.graph, inp, qm.weights_f)
        qref = quantized_reference_execute(qm, inp)
        for t in qm.graph.outputs:
            got = dequantize(qref[t.name], qm.qp(t.name))
            errs[t.name] = max(errs[t.name],
                               float(np.max(np.abs(got - ref[t.name]))))
    qm.calib_error = errs
    return errs


def cast_graph(g: Graph, act_dtype: str = "int8",
               weight_dtype: str = "int8",
               bias_dtype: str = "int32") -> Graph:
    """Cost-model-only precision annotation: set dtypes (no qparams) so
    compile_graph prices tiles/DMA/MACs at the target precision without
    calibration.  Not executable on the quantized replay path."""
    for t in g.tensors.values():
        if t.is_param:
            t.dtype = bias_dtype if len(t.shape) == 1 else weight_dtype
        else:
            t.dtype = act_dtype
    return g


# --------------------------------------------------------------------------
# Integer kernels (shared by the quantized reference and program replay)
# --------------------------------------------------------------------------


def _conv2d_int(xi: np.ndarray, w: np.ndarray, stride: int,
                pad: Tuple[int, int, int, int], depthwise: bool
                ) -> np.ndarray:
    """Integer conv: xi (H,W,C) zero-point-subtracted int32, w int
    (outC,fh,fw,inC) -> int64 accumulators (int32-representable: worst
    case sum of |q8*q8| over the benchmark dot lengths < 2^31)."""
    pt, pb, pl, pr = pad
    xp = np.pad(xi, ((pt, pb), (pl, pr), (0, 0)))
    H, W, C = xp.shape
    oc, fh, fw, ic = w.shape
    oh = (H - fh) // stride + 1
    ow = (W - fw) // stride + 1
    cols = np.empty((oh, ow, fh, fw, C), dtype=np.int64)
    for i in range(fh):
        for j in range(fw):
            cols[:, :, i, j, :] = xp[i:i + oh * stride:stride,
                                     j:j + ow * stride:stride, :]
    if depthwise:
        ker = np.transpose(w[:, :, :, 0], (1, 2, 0)).astype(np.int64)
        return cached_einsum("hwijc,ijc->hwc", cols, ker)
    return cached_einsum("hwijc,oijc->hwo",
                         cols.reshape(oh, ow, fh, fw, ic),
                         w.astype(np.int64))


def q_conv(xq: np.ndarray, in_qp: QParams, w_q: np.ndarray,
           w_qp: QParams, bias_q: Optional[np.ndarray], stride: int,
           pad: Tuple[int, int, int, int], depthwise: bool, act: str,
           out_qp: QParams) -> np.ndarray:
    """int8 conv/dwconv: int32 accumulate + fused rescale/act epilogue."""
    zp = int(np.atleast_1d(in_qp.zero_point)[0])
    xi = xq.astype(np.int32) - zp
    acc = _conv2d_int(xi, w_q, stride, pad, depthwise)
    if bias_q is not None:
        acc = acc + bias_q.astype(np.int64)
    s_x = float(np.atleast_1d(in_qp.scale)[0])
    s_w = np.atleast_1d(w_qp.scale).astype(np.float32)
    y = acc.astype(np.float32) * (s_x * s_w)
    return quantize(_apply_act(y, act), out_qp)


def q_fc(xq_flat: np.ndarray, in_qp: QParams, w_q: np.ndarray,
         w_qp: QParams, bias_q: Optional[np.ndarray], act: str,
         out_qp: QParams) -> np.ndarray:
    """int8 fully connected on a flattened (C,) input -> (outC,) int8."""
    zp = int(np.atleast_1d(in_qp.zero_point)[0])
    xi = xq_flat.reshape(-1).astype(np.int64) - zp
    acc = w_q.astype(np.int64) @ xi
    if bias_q is not None:
        acc = acc + bias_q.astype(np.int64)
    s_x = float(np.atleast_1d(in_qp.scale)[0])
    s_w = np.atleast_1d(w_qp.scale).astype(np.float32)
    y = acc.astype(np.float32) * (s_x * s_w)
    return quantize(_apply_act(y, act), out_qp)


def q_matmul(xq: np.ndarray, in_qp: QParams, w_q: np.ndarray,
             w_qp: QParams, bias_q: Optional[np.ndarray], act: str,
             out_qp: QParams) -> np.ndarray:
    """int8 row-wise linear on (S,W,C) token activations -> (S,W,outC)
    int8.  Same integer contract as :func:`q_fc`, kept per-row so the
    sequence axis survives (LM activations put tokens on rows)."""
    zp = int(np.atleast_1d(in_qp.zero_point)[0])
    xi = xq.astype(np.int64) - zp
    acc = cached_einsum("swc,oc->swo", xi, w_q.astype(np.int64))
    if bias_q is not None:
        acc = acc + bias_q.astype(np.int64)
    s_x = float(np.atleast_1d(in_qp.scale)[0])
    s_w = np.atleast_1d(w_qp.scale).astype(np.float32)
    y = acc.astype(np.float32) * (s_x * s_w)
    return quantize(_apply_act(y, act), out_qp)


def q_maxpool(xq: np.ndarray, k: int, s: int,
              pad: Tuple[int, int, int, int], in_qp: QParams,
              out_qp: QParams) -> np.ndarray:
    """Max pool in the int domain (max commutes with the affine map);
    a single dequant->requant maps onto the output grid."""
    pt, pb, pl, pr = pad
    xp = np.pad(xq.astype(np.int32), ((pt, pb), (pl, pr), (0, 0)),
                constant_values=_NEG_SENTINEL)
    H, W, C = xp.shape
    oh = (H - k) // s + 1
    ow = (W - k) // s + 1
    y = np.full((oh, ow, C), _NEG_SENTINEL, dtype=np.int32)
    for i in range(k):
        for j in range(k):
            y = np.maximum(y, xp[i:i + oh * s:s, j:j + ow * s:s, :])
    return quantize(dequantize(y, in_qp), out_qp)


def q_avgpool(xq: np.ndarray, k: int, s: int,
              pad: Tuple[int, int, int, int], in_qp: QParams,
              out_qp: QParams) -> np.ndarray:
    """Average pool: int window sums (exact), one rescale at the end."""
    pt, pb, pl, pr = pad
    zp = int(np.atleast_1d(in_qp.zero_point)[0])
    xi = xq.astype(np.int64) - zp
    xp = np.pad(xi, ((pt, pb), (pl, pr), (0, 0)))
    H, W, C = xp.shape
    oh = (H - k) // s + 1
    ow = (W - k) // s + 1
    acc = np.zeros((oh, ow, C), dtype=np.int64)
    for i in range(k):
        for j in range(k):
            acc += xp[i:i + oh * s:s, j:j + ow * s:s, :]
    s_x = float(np.atleast_1d(in_qp.scale)[0])
    return quantize(acc.astype(np.float32) * (s_x / (k * k)), out_qp)


def q_global_avgpool(xq: np.ndarray, in_qp: QParams,
                     out_qp: QParams) -> np.ndarray:
    zp = int(np.atleast_1d(in_qp.zero_point)[0])
    acc = (xq.astype(np.int64) - zp).sum(axis=(0, 1), keepdims=True)
    n = xq.shape[0] * xq.shape[1]
    s_x = float(np.atleast_1d(in_qp.scale)[0])
    return quantize(acc.astype(np.float32) * (s_x / n), out_qp)


# --------------------------------------------------------------------------
# Quantized functional reference (the oracle the replay must match)
# --------------------------------------------------------------------------


def quantized_reference_execute(qm: QuantizedModel,
                                inputs: Dict[str, np.ndarray]
                                ) -> Dict[str, np.ndarray]:
    """Execute the quantized graph tensor-by-tensor; returns the stored
    integer value of every non-parameter tensor."""
    g = qm.graph
    vals: Dict[str, np.ndarray] = {}
    for t in g.tensors.values():
        if t.kind == "input":
            arr = np.asarray(inputs[t.name], np.float32)
            vals[t.name] = (quantize(arr, qm.qp(t.name))
                            if t.qparams is not None else arr)
        elif t.is_param:
            vals[t.name] = qm.qweights[t.name]

    def deq(name: str) -> np.ndarray:
        if g.tensors[name].qparams is None:   # float32 pos operands
            return vals[name]
        return dequantize(vals[name], qm.qp(name))

    for op in g.topo_ops():
        k = op.kind
        a = op.attrs
        out = op.output
        out_qp = qm.qp(out)
        if k in ("conv", "dwconv"):
            bias = vals[op.inputs[2]] if len(op.inputs) > 2 else None
            vals[out] = q_conv(vals[op.inputs[0]], qm.qp(op.inputs[0]),
                               vals[op.inputs[1]], qm.qp(op.inputs[1]),
                               bias, a["stride"], a["pad"], k == "dwconv",
                               a.get("act", "none"), out_qp)
        elif k == "fc":
            bias = vals[op.inputs[2]] if len(op.inputs) > 2 else None
            w = vals[op.inputs[1]][:, 0, 0, :]
            vals[out] = q_fc(vals[op.inputs[0]], qm.qp(op.inputs[0]),
                             w, qm.qp(op.inputs[1]), bias,
                             a.get("act", "none"), out_qp
                             ).reshape(1, 1, -1)
        elif k == "add":
            y = _apply_act(deq(op.inputs[0]) + deq(op.inputs[1]),
                           a.get("act", "none"))
            vals[out] = quantize(y, out_qp)
        elif k == "mul":
            vals[out] = quantize(deq(op.inputs[0]) * deq(op.inputs[1]),
                                 out_qp)
        elif k == "scalar":
            x = deq(op.inputs[0])
            v = a["value"]
            vals[out] = quantize({"add": x + v, "mul": x * v,
                                  "div": x / v}[a["op"]], out_qp)
        elif k == "act":
            vals[out] = quantize(_apply_act(deq(op.inputs[0]), a["act"]),
                                 out_qp)
        elif k == "maxpool":
            vals[out] = q_maxpool(vals[op.inputs[0]], a["k"], a["stride"],
                                  a["pad"], qm.qp(op.inputs[0]), out_qp)
        elif k == "avgpool":
            if a["k"] == 0:
                vals[out] = q_global_avgpool(vals[op.inputs[0]],
                                             qm.qp(op.inputs[0]), out_qp)
            else:
                vals[out] = q_avgpool(vals[op.inputs[0]], a["k"],
                                      a["stride"], a["pad"],
                                      qm.qp(op.inputs[0]), out_qp)
        elif k == "resize":
            f = a["factor"]
            rep = np.repeat(np.repeat(vals[op.inputs[0]], f, axis=0),
                            f, axis=1)
            vals[out] = quantize(dequantize(rep, qm.qp(op.inputs[0])),
                                 out_qp)
        elif k == "matmul":
            bias = vals[op.inputs[2]] if len(op.inputs) > 2 else None
            w = vals[op.inputs[1]][:, 0, 0, :]
            vals[out] = q_matmul(vals[op.inputs[0]], qm.qp(op.inputs[0]),
                                 w, qm.qp(op.inputs[1]), bias,
                                 a.get("act", "none"), out_qp)
        elif k == "layernorm":
            y = _layernorm_ref(deq(op.inputs[0]), vals[op.inputs[1]],
                               vals[op.inputs[2]], a["eps"])
            vals[out] = quantize(y, out_qp)
        elif k == "softmax":
            vals[out] = quantize(_softmax_ref(deq(op.inputs[0])), out_qp)
        elif k == "attention":
            y = _attention_ref(deq(op.inputs[0]), deq(op.inputs[1]),
                               deq(op.inputs[2]), deq(op.inputs[3]), a)
            vals[out] = quantize(y, out_qp)
        elif k == "kvappend":
            y = _kvappend_ref(deq(op.inputs[0]), deq(op.inputs[1]),
                              deq(op.inputs[2]))
            vals[out] = quantize(y, out_qp)
        elif k == "concat":
            y = np.concatenate([deq(i) for i in op.inputs], axis=2)
            vals[out] = quantize(y, out_qp)
        elif k == "split":
            parts = np.split(deq(op.inputs[0]), a["sections"], axis=2)
            for o, p in zip(op.outputs, parts):
                vals[o] = quantize(p, qm.qp(o))
        else:  # pragma: no cover
            raise NotImplementedError(k)
    return vals
