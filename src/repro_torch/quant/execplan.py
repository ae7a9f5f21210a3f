"""Quantized plan lowering on the device: one kernel per op.

Counterpart of ``repro/quant/execplan.py``.  The int8/int4 replay lowers
through the port's :class:`~repro_torch.core.execplan.ExecPlan`, one
fused kernel per op in topological order, the batch dimension through
every kernel:

  * **conv, fc and matmul run on K1** (``kernels/neutron_matmul.py``,
    the plan contract): a 1x1 conv without padding and a matmul read
    their input slot in place
    (through a strided view when its stride is above 1); any other conv
    first lays out its columns (im2col) in the (i, j, c) order of the
    weight ``w_q.reshape(outC, -1)``, padding the stored int8 with the
    input zero point.  K1 writes the output slot in place.
  * dwconv accumulates tap by tap in int32; add, mul, scalar, act,
    maxpool, avgpool, resize, concat and split are torch ops with the
    reference's arithmetic (``qparams.quantize_t``/``dequantize_t``,
    ``kernels/ref.py:ir_activation``).

The weight constants are derived on the host in numpy exactly as the
reference derives them (zero point folded into the bias, fused rescale
``sc = s_x * s_w``) and moved to the device once: int8 (N, K) weights for
K1, int32 depthwise taps, int32 biases, float32 ``sc``.  Integer
accumulation is exact in both engines (the reference accumulates in
float64 below 2^53, K1 in int32, whose range lowering checks), and the
float32 epilogue is the reference's operation for operation, so the
stored integers equal the reference plan's wherever the activations are
piecewise linear.

The causal kinds of the LM decode path: matmul on K1 as fc is; layernorm
(gamma and beta float32, as PTQ keeps them) and softmax dequantize,
compute in float32 and quantize; attention dequantizes q and the caches
and runs K3 or K2 in float32 (the reference computes it in float32 too);
kvappend copies the cache's stored ints (its input and output qparams are
tied by PTQ) and requantizes the new rows into them.  The ``pos`` operand
stays float32 (PTQ exempts it), and each lane's offset is derived from it
on the device (``core.execplan.pos_rows``).  layernorm, softmax, gelu and
attention are not piecewise linear, and torch and the kernels sum in
another order than numpy, so their stored ints may differ from the
reference plan's by one step where a value lies at a rounding boundary.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.execplan import (PlanConsts, PlanStep, attend,
                                       im2col, kv_append, layernorm_t,
                                       pad_hw, pos_rows, softmax_t, taps)
from repro_torch.core.ir import Graph
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ir_activation
from repro_torch.obs import trace as _trace

from .ptq import _NEG_SENTINEL, QuantizedModel
from .qparams import dequantize_t, device_scalar, quantize_t


def _gemm_consts(qm: QuantizedModel, op, zp: int,
                 in_qp) -> Dict[str, np.ndarray]:
    """Derived fc constants (the reference's ``_gemm_consts``): float64
    weight (K, N), zero-point-folded bias, fused rescale vector."""
    wT = np.ascontiguousarray(
        qm.qweights[op.inputs[1]][:, 0, 0, :].astype(np.float64).T)
    biasf = qm.qweights[op.inputs[2]].astype(np.float64) \
        if len(op.inputs) > 2 else np.float64(0.0)
    biasf = biasf - zp * wT.sum(axis=0)   # zp folded (exact ints)
    s_x = float(np.atleast_1d(in_qp.scale)[0])
    s_w = np.atleast_1d(qm.qp(op.inputs[1]).scale).astype(np.float32)
    return {"wT": wT, "biasf": np.asarray(biasf), "sc": s_x * s_w}


def _conv_consts(qm: QuantizedModel, op, dw: bool, fh: int, fw: int,
                 zp: int, in_qp) -> Dict[str, np.ndarray]:
    """Derived conv/dwconv constants (the reference's closure of the same
    name): kernel (fh*fw, C) for dwconv or (K, N) for conv, the
    zero-point-folded bias and the fused rescale vector.  Stored as the
    reference stores them: float32 where every partial sum of the dot
    stays below 2^24, else float64 (both hold the same integers), so
    that an artifact holds the same constant bytes whichever package
    saved it."""
    w_q = qm.qweights[op.inputs[1]]
    if dw:
        kerf = np.ascontiguousarray(
            np.transpose(w_q[:, :, :, 0], (1, 2, 0))
            .astype(np.float64).reshape(fh * fw, -1))
    else:
        kerf = np.ascontiguousarray(
            w_q.astype(np.float64).reshape(w_q.shape[0], -1).T)
    wsum = kerf.sum(axis=0)
    biasf = qm.qweights[op.inputs[2]].astype(np.float64) \
        if len(op.inputs) > 2 else np.float64(0.0)
    biasf = biasf - zp * wsum
    max_bias = float(np.max(np.abs(np.atleast_1d(biasf))))
    fdt = np.float32 if kerf.shape[0] * 255 * 127 + max_bias < 2.0 ** 24 \
        else np.float64
    s_x = float(np.atleast_1d(in_qp.scale)[0])
    s_w = np.atleast_1d(qm.qp(op.inputs[1]).scale).astype(np.float32)
    return {"kerf": kerf.astype(fdt), "biasf": np.asarray(biasf, dtype=fdt),
            "sc": s_x * s_w}


def _int32(a: np.ndarray, label: str, what: str) -> np.ndarray:
    a = np.asarray(a, dtype=np.float64)
    if not np.array_equal(a, np.round(a)) or np.abs(a).max(initial=0) \
            >= 2.0 ** 31:
        raise ValueError(f"{label}: {what} is not an int32 integer array")
    return a.astype(np.int32)


def _device_consts(kerf: np.ndarray, biasf: np.ndarray, sc: np.ndarray,
                   label: str, device, transpose: bool):
    """Move one op's constants to the device: the integer kernel (as
    int8 (N, K) for K1 with ``transpose``, else int32 as it is), the
    int32 bias and the float32 rescale.  Raises when the int32
    accumulator could overflow: K * 128 * 127 + max|bias| must stay
    below 2^31."""
    dot_len = kerf.shape[0]
    bias = _int32(biasf, label, "the folded bias")
    if dot_len * 128 * 127 + float(np.abs(bias).max(initial=0)) \
            >= 2.0 ** 31:
        raise ValueError(f"{label}: a dot of length {dot_len} with bias "
                         f"up to {np.abs(bias).max()} could overflow the "
                         f"int32 accumulator")
    ker = _int32(kerf, label, "the weight")
    if transpose:
        ker = np.ascontiguousarray(ker.T).astype(np.int8)   # (N, K)
    to = dict(device=device)
    return (torch.from_numpy(ker).to(**to),
            torch.from_numpy(np.ascontiguousarray(bias)).to(**to),
            torch.from_numpy(np.ascontiguousarray(
                np.atleast_1d(sc), dtype=np.float32)).to(**to))


def _out_params(qp) -> Tuple[float, int, int, int]:
    return (float(np.atleast_1d(qp.scale)[0]),
            int(np.atleast_1d(qp.zero_point)[0]), qp.qmin, qp.qmax)


def lower_quant_steps(qm: QuantizedModel, g: Graph, tiling, program,
                      weights: Dict[str, np.ndarray],
                      ids: Dict[str, int],
                      consts: Optional[PlanConsts] = None,
                      device=None) -> Tuple[List[PlanStep], str]:
    """One fused kernel per op, in topological order, on ``device``
    (CUDA unless the caller asks for the CPU).  ``tiling``, ``program``
    and ``weights`` are not read (the integer weights come from
    ``qm``)."""
    cs = consts if consts is not None else PlanConsts()
    device = resolve_device(device)
    steps: List[PlanStep] = []

    for op in g.topo_ops():
        _trace.progress()
        a = op.attrs
        k = op.kind
        oid = ids[op.outputs[0]]
        out_qp = qm.qp(op.outputs[0])
        label = f"{op.name}@op"

        if k in ("conv", "dwconv"):
            x = g.act_inputs(op)[0]
            xid = ids[x.name]
            s = a["stride"]
            pt, pb, pl, pr = a["pad"]
            fh, fw = a["k"]
            dw = k == "dwconv"
            in_qp = qm.qp(x.name)
            zp = int(np.atleast_1d(in_qp.zero_point)[0])
            got = cs.group(label, ("kerf", "biasf", "sc"),
                           lambda op=op, dw=dw, fh=fh, fw=fw, zp=zp,
                           in_qp=in_qp: _conv_consts(qm, op, dw, fh, fw, zp,
                                                     in_qp))
            ker, bias, sc = _device_consts(got["kerf"], got["biasf"],
                                           got["sc"], label, device,
                                           transpose=not dw)
            act = a.get("act", "none")
            oh, ow, oc = g.tensors[op.outputs[0]].shape
            H, W, C = x.shape
            outp = _out_params(out_qp)
            pointwise = fh == 1 and fw == 1 and not dw \
                and (pt, pb, pl, pr) == (0, 0, 0, 0)

            if dw:
                def run(bufs, n, xid=xid, oid=oid, zp=zp, pad=(pt, pb, pl, pr),
                        fh=fh, fw=fw, s=s, oh=oh, ow=ow, ker=ker, bias=bias,
                        sc=sc, act=act, out_qp=out_qp):
                    # tap-by-tap int32 accumulation off the padded input
                    xp = pad_hw(bufs[xid][:n], *pad,
                                value=zp).to(torch.int32)
                    acc = torch.zeros((n, oh, ow, ker.shape[1]),
                                      dtype=torch.int32, device=xp.device)
                    for t, win in taps(xp, fh, fw, s, oh, ow):
                        acc += win * ker[t]
                    acc += bias
                    y = acc.to(torch.float32) * sc
                    bufs[oid][:n].copy_(quantize_t(ir_activation(y, act),
                                                   out_qp))
            else:
                def run(bufs, n, xid=xid, oid=oid, zp=zp, pad=(pt, pb, pl, pr),
                        fh=fh, fw=fw, s=s, oh=oh, ow=ow, oc=oc, H=H, W=W,
                        C=C, ker=ker, bias=bias, sc=sc, act=act, outp=outp,
                        pointwise=pointwise):
                    xq = bufs[xid][:n]
                    if pointwise:
                        # 1x1 stride-s conv == strided gemm, read in place
                        xin = xq[:, ::s, ::s, :] if s != 1 \
                            else xq.view(n, H * W, C)
                    else:
                        xin = im2col(xq, pad, fh, fw, s, oh, ow, zp)
                    ops.neutron_matmul_plan(
                        xin, ker, bias, sc, act, *outp,
                        out=bufs[oid][:n].view(n, oh * ow, oc))
            reads = (xid,)
        elif k in ("fc", "matmul"):
            x = g.act_inputs(op)[0]
            xid = ids[x.name]
            in_qp = qm.qp(x.name)
            zp = int(np.atleast_1d(in_qp.zero_point)[0])
            got = cs.group(label, ("wT", "biasf", "sc"),
                           lambda op=op, zp=zp, in_qp=in_qp:
                           _gemm_consts(qm, op, zp, in_qp))
            ker, bias, sc = _device_consts(got["wT"], got["biasf"],
                                           got["sc"], label, device,
                                           transpose=True)
            act = a.get("act", "none")
            outp = _out_params(out_qp)
            rows = g.tensors[op.outputs[0]].shape[0] if k == "matmul" else 1

            def run(bufs, n, xid=xid, oid=oid, ker=ker, bias=bias, sc=sc,
                    act=act, outp=outp, rows=rows):
                ops.neutron_matmul_plan(
                    bufs[xid][:n].view(n, rows, -1), ker, bias, sc, act,
                    *outp, out=bufs[oid][:n].view(n, rows, -1))
            reads = (xid,)
        elif k in ("add", "mul"):
            xs = g.act_inputs(op)
            i0, i1 = ids[xs[0].name], ids[xs[1].name]
            qp0, qp1 = qm.qp(xs[0].name), qm.qp(xs[1].name)
            act = a.get("act", "none")
            is_add = k == "add"

            def run(bufs, n, i0=i0, i1=i1, qp0=qp0, qp1=qp1, act=act,
                    is_add=is_add, oid=oid, out_qp=out_qp):
                a0 = dequantize_t(bufs[i0][:n], qp0)
                a1 = dequantize_t(bufs[i1][:n], qp1)
                y = ir_activation(a0 + a1, act) if is_add else a0 * a1
                bufs[oid][:n].copy_(quantize_t(y, out_qp))
            reads = (i0, i1)
        elif k == "scalar":
            x = g.act_inputs(op)[0]
            xid = ids[x.name]
            in_qp = qm.qp(x.name)
            v = a["value"]
            sop = a["op"]

            def run(bufs, n, xid=xid, in_qp=in_qp, v=v, sop=sop,
                    oid=oid, out_qp=out_qp):
                xv = dequantize_t(bufs[xid][:n], in_qp)
                vt = device_scalar(v, xv)
                y = {"add": torch.add, "mul": torch.mul,
                     "div": torch.div}[sop](xv, vt)
                bufs[oid][:n].copy_(quantize_t(y, out_qp))
            reads = (xid,)
        elif k == "act":
            x = g.act_inputs(op)[0]
            xid = ids[x.name]
            in_qp = qm.qp(x.name)
            act = a["act"]

            def run(bufs, n, xid=xid, in_qp=in_qp, act=act, oid=oid,
                    out_qp=out_qp):
                y = ir_activation(dequantize_t(bufs[xid][:n], in_qp), act)
                bufs[oid][:n].copy_(quantize_t(y, out_qp))
            reads = (xid,)
        elif k == "maxpool":
            x = g.act_inputs(op)[0]
            xid = ids[x.name]
            in_qp = qm.qp(x.name)
            kk, s = a["k"], a["stride"]
            oh, ow = g.tensors[op.outputs[0]].shape[:2]

            def run(bufs, n, xid=xid, in_qp=in_qp, kk=kk, s=s,
                    pad=tuple(a["pad"]), oh=oh, ow=ow, oid=oid,
                    out_qp=out_qp):
                # max in the int domain, sentinel padding, one requant
                xp = pad_hw(bufs[xid][:n].to(torch.int32), *pad,
                          value=int(_NEG_SENTINEL))
                y = None
                for _, win in taps(xp, kk, kk, s, oh, ow):
                    y = win if y is None else torch.maximum(y, win)
                bufs[oid][:n].copy_(quantize_t(dequantize_t(y, in_qp),
                                               out_qp))
            reads = (xid,)
        elif k == "avgpool":
            x = g.act_inputs(op)[0]
            xid = ids[x.name]
            in_qp = qm.qp(x.name)
            zp = int(np.atleast_1d(in_qp.zero_point)[0])
            s_x = float(np.atleast_1d(in_qp.scale)[0])
            if a["k"] == 0:
                m = x.shape[0] * x.shape[1]

                def run(bufs, n, xid=xid, zp=zp, r=s_x / m, oid=oid,
                        out_qp=out_qp):
                    acc = (bufs[xid][:n].to(torch.int32) - zp).sum(
                        dim=(1, 2), keepdim=True)
                    y = acc.to(torch.float32) * device_scalar(r, acc)
                    bufs[oid][:n].copy_(quantize_t(y, out_qp))
            else:
                kk, s = a["k"], a["stride"]
                oh, ow = g.tensors[op.outputs[0]].shape[:2]

                def run(bufs, n, xid=xid, zp=zp, r=s_x / (kk * kk), kk=kk,
                        s=s, pad=tuple(a["pad"]), oh=oh, ow=ow, oid=oid,
                        out_qp=out_qp):
                    xi = bufs[xid][:n].to(torch.int32) - zp
                    xp = pad_hw(xi, *pad, value=0)
                    acc = torch.zeros((n, oh, ow, xp.shape[-1]),
                                      dtype=torch.int32, device=xp.device)
                    for _, win in taps(xp, kk, kk, s, oh, ow):
                        acc += win
                    y = acc.to(torch.float32) * device_scalar(r, acc)
                    bufs[oid][:n].copy_(quantize_t(y, out_qp))
            reads = (xid,)
        elif k == "resize":
            x = g.act_inputs(op)[0]
            xid = ids[x.name]
            in_qp = qm.qp(x.name)
            f = a["factor"]

            def run(bufs, n, xid=xid, in_qp=in_qp, f=f, oid=oid,
                    out_qp=out_qp):
                rep = bufs[xid][:n].repeat_interleave(f, dim=1) \
                    .repeat_interleave(f, dim=2)
                bufs[oid][:n].copy_(quantize_t(dequantize_t(rep, in_qp),
                                               out_qp))
            reads = (xid,)
        elif k == "concat":
            xs = g.act_inputs(op)
            xids = tuple(ids[x.name] for x in xs)
            qps = tuple(qm.qp(x.name) for x in xs)

            def run(bufs, n, xids=xids, qps=qps, oid=oid, out_qp=out_qp):
                y = torch.cat([dequantize_t(bufs[i][:n], qp)
                               for i, qp in zip(xids, qps)], dim=-1)
                bufs[oid][:n].copy_(quantize_t(y, out_qp))
            reads = xids
        elif k == "split":
            x = g.act_inputs(op)[0]
            xid = ids[x.name]
            in_qp = qm.qp(x.name)
            oids = tuple(ids[o] for o in op.outputs)
            oqps = tuple(qm.qp(o) for o in op.outputs)
            width = x.shape[-1] // a["sections"]

            def run(bufs, n, xid=xid, in_qp=in_qp, oids=oids, oqps=oqps,
                    width=width):
                parts = torch.split(dequantize_t(bufs[xid][:n], in_qp),
                                    width, dim=-1)
                for o, qp, p in zip(oids, oqps, parts):
                    bufs[o][:n].copy_(quantize_t(p, qp))
            steps.append(PlanStep(label, (xid,), oids, run))
            continue
        elif k == "layernorm":
            x = g.act_inputs(op)[0]
            xid = ids[x.name]
            to = dict(device=device, dtype=torch.float32)
            gam = torch.as_tensor(qm.qweights[op.inputs[1]], **to)
            bet = torch.as_tensor(qm.qweights[op.inputs[2]], **to)

            def run(bufs, n, xid=xid, in_qp=qm.qp(x.name), gam=gam, bet=bet,
                    eps=a["eps"], oid=oid, out_qp=out_qp):
                y = layernorm_t(dequantize_t(bufs[xid][:n], in_qp), gam, bet,
                                eps)
                bufs[oid][:n].copy_(quantize_t(y, out_qp))
            reads = (xid,)
        elif k == "softmax":
            x = g.act_inputs(op)[0]
            xid = ids[x.name]

            def run(bufs, n, xid=xid, in_qp=qm.qp(x.name), oid=oid,
                    out_qp=out_qp):
                y = softmax_t(dequantize_t(bufs[xid][:n], in_qp))
                bufs[oid][:n].copy_(quantize_t(y, out_qp))
            reads = (xid,)
        elif k == "attention":
            q, kc, vc, ps = g.act_inputs(op)
            qid, kid, vid, pid = (ids[t.name] for t in (q, kc, vc, ps))
            qps = tuple(qm.qp(t.name) for t in (q, kc, vc))

            def run(bufs, n, qid=qid, kid=kid, vid=vid, pid=pid, qps=qps,
                    attrs=dict(a), smax=kc.shape[0], s=q.shape[0], oid=oid,
                    out_qp=out_qp):
                qf, kf, vf = (dequantize_t(bufs[i][:n], qp)
                              for i, qp in zip((qid, kid, vid), qps))
                y = attend(qf, kf, vf, pos_rows(bufs[pid][:n], smax, s),
                           attrs)
                out = bufs[oid][:n]
                out.copy_(quantize_t(y.reshape(out.shape), out_qp))
            reads = (qid, kid, vid, pid)
        elif k == "kvappend":
            cx, nx, ps = g.act_inputs(op)
            cid, nid, pid = ids[cx.name], ids[nx.name], ids[ps.name]
            qpc = qm.qp(cx.name)
            # tied qparams (quantize_graph ties every cache's): the rows
            # kept are the stored ints as they are
            tied = _out_params(qpc) == _out_params(out_qp) \
                and qpc.axis is None and out_qp.axis is None

            def run(bufs, n, cid=cid, nid=nid, pid=pid, qpc=qpc,
                    qpn=qm.qp(nx.name), tied=tied, smax=cx.shape[0],
                    s=nx.shape[0], oid=oid, out_qp=out_qp):
                cache = bufs[cid][:n]
                if not tied:
                    cache = quantize_t(dequantize_t(cache, qpc), out_qp)
                new = quantize_t(dequantize_t(bufs[nid][:n], qpn), out_qp)
                kv_append(bufs[oid][:n], cache, new,
                          pos_rows(bufs[pid][:n], smax, s))
            reads = (cid, nid, pid)
        else:
            raise NotImplementedError(
                f"{op.name}: op kind {k!r} has no int8 plan kernel")

        steps.append(PlanStep(label, reads, (oid,), run))

    return steps, "op"
