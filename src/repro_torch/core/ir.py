"""Graph IR for the eIQ-Neutron compiler mid-end.

The paper's compiler front-end ingests a LiteRT model and lowers it to an
internal IR of *tensors* and *operators* (paper §IV).  This module is that
IR: a static, batch-1, HWC-layout dataflow graph with

  * shape inference for every operator the vision benchmarks need,
  * MAC/byte accounting (drives the cost model and Table IV checks),
  * a pure-numpy reference executor (the functional oracle every compiled
    NPU program is validated against),
  * topological utilities used by the tiling / fusion / scheduling passes.

Activations use (H, W, C) layout; parameters use (outC, fH, fW, inC) — the
exact layouts of paper Algorithm 1.  Batch is always 1 (edge inference).

Tensors carry an explicit ``dtype`` (float32 by default) plus optional
affine quantization parameters (:class:`QParams`).  A freshly built graph
is float32 end to end; the PTQ pass in :mod:`repro_torch.quant` annotates it
with int8/int4 dtypes and qparams, which changes every byte-accounted
quantity downstream (tile sizes, DMA volume, TCM occupancy) and the MAC
throughput of the cost model — the paper's INT8 deployment.  Both dtype
and qparams are part of :meth:`Graph.fingerprint`, so quantized and float
variants of a model never alias in the compiled-program cache.

Copy of the JAX package's ``core/ir.py`` (numpy only; the port imports
nothing of that package and keeps its own copy).  The tests hold it
equal to the original.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------------
# Tensors
# --------------------------------------------------------------------------

ACT_KINDS = ("input", "activation", "output")

#: storage bytes per element; int4 is nibble-packed (2 values/byte).
DTYPE_BYTES = {"int4": 0.5, "int8": 1.0, "int16": 2.0,
               "int32": 4.0, "float32": 4.0}


@dataclass
class QParams:
    """Affine quantization parameters: ``float = scale * (q - zero_point)``.

    ``scale``/``zero_point`` are scalars for per-tensor quantization or
    1-D arrays for per-channel quantization along ``axis`` (axis 0 ==
    outC for conv/fc weights).  ``bits`` is the integer width of the
    stored values (8 for int8, 4 for nibble-packed int4, 32 for the
    int32 bias convention).  Attached to :class:`Tensor` by the PTQ pass
    in :mod:`repro_torch.quant`; participates in :meth:`Graph.fingerprint`.
    """

    scale: np.ndarray
    zero_point: np.ndarray
    bits: int = 8
    axis: Optional[int] = None

    @property
    def per_channel(self) -> bool:
        return self.axis is not None

    @property
    def qmin(self) -> int:
        return -(1 << (self.bits - 1))

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    def payload(self) -> list:
        """Canonical JSON-serializable form for graph fingerprinting."""
        return [self.bits, self.axis,
                [float(s) for s in np.atleast_1d(self.scale)],
                [int(z) for z in np.atleast_1d(self.zero_point)]]


@dataclass
class Tensor:
    """A logical tensor in the graph.

    kind:
      - "input":      model input (starts in DRAM, paper Fig. 5)
      - "activation": intermediate feature map (starts N/E)
      - "output":     model output (must end in DRAM)
      - "parameter":  weights/bias (starts in DRAM)
    shape: activations (H, W, C); parameters (outC, fH, fW, inC) or (C,) bias.
    """

    name: str
    shape: Tuple[int, ...]
    kind: str = "activation"
    dtype: str = "float32"
    producer: Optional[str] = None          # op name, None for inputs/params
    consumers: List[str] = field(default_factory=list)
    scale: float = 1.0                      # legacy scalar scale (float ref)
    qparams: Optional[QParams] = None       # set by the PTQ pass

    @property
    def elems(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def bytes(self) -> int:
        return int(math.ceil(self.elems * DTYPE_BYTES[self.dtype]))

    @property
    def is_param(self) -> bool:
        return self.kind == "parameter"

    @property
    def hwc(self) -> Tuple[int, int, int]:
        assert self.kind in ACT_KINDS and len(self.shape) == 3, self
        return self.shape  # type: ignore[return-value]


# --------------------------------------------------------------------------
# Operators
# --------------------------------------------------------------------------

#: op kinds understood by the lowering / cost model.
OP_KINDS = (
    "conv",        # conv2d; attrs: stride, pad (explicit 4-tuple), act
    "dwconv",      # depthwise conv2d (groups == C)
    "fc",          # fully connected == 1x1 conv on (1,1,C) (paper §IV-A)
    "add",         # elementwise add (paired depthwise, paper §IV-A)
    "mul",         # Hadamard
    "scalar",      # op with a constant scalar (1x1 depthwise, paper §IV-A)
    "act",         # standalone activation
    "maxpool",     # attrs: k, stride, pad
    "avgpool",     # attrs: k, stride, pad (k == 0 -> global)
    "resize",      # nearest-neighbour upsample; attrs: factor
    "concat",      # channel concat
    "split",       # channel split; attrs: sections -> multiple outputs
    "pad",         # spatial zero-pad
    "format",      # TCM format conversion (inserted by the compiler)
    "reshape",     # logical reshape (free at runtime, kept for heads)
    # ---- causal / transformer operators (LM decode path) --------------
    # LM activations are (S, 1, d_model): the sequence axis maps onto the
    # H (row) axis, so the row-tiling machinery tiles over tokens.
    "matmul",      # row-wise linear: y[s] = W @ x[s] (+ b); W (outC,1,1,inC)
    "layernorm",   # per-token layer norm over channels; params gamma, beta
    "softmax",     # per-token softmax over channels
    "attention",   # fused QK^T -> softmax -> V against a KV cache;
                   # inputs [q, k_cache, v_cache, pos]; attrs heads,
                   # head_dim, scale, causal, kv_len (static cache bucket
                   # — the context-length-aware cost-model knob)
    "kvappend",    # write S new rows into a KV cache at dynamic offset
                   # pos; inputs [cache, new, pos]
)

ACTIVATIONS = ("none", "relu", "relu6", "hswish", "hsigmoid", "silu",
               "sigmoid", "gelu", "mish", "sqrelu", "leaky")


@dataclass
class Op:
    name: str
    kind: str
    inputs: List[str]                 # tensor names (activations first)
    outputs: List[str]                # tensor names
    attrs: Dict = field(default_factory=dict)

    @property
    def output(self) -> str:
        return self.outputs[0]


# --------------------------------------------------------------------------
# Graph
# --------------------------------------------------------------------------


class Graph:
    def __init__(self, name: str):
        self.name = name
        self.tensors: Dict[str, Tensor] = {}
        self.ops: List[Op] = []
        self._op_index: Dict[str, Op] = {}

    # -- construction -------------------------------------------------------
    def add_tensor(self, t: Tensor) -> Tensor:
        if t.name in self.tensors:
            raise ValueError(f"duplicate tensor {t.name}")
        self.tensors[t.name] = t
        return t

    def add_op(self, op: Op) -> Op:
        if op.name in self._op_index:
            raise ValueError(f"duplicate op {op.name}")
        for i in op.inputs:
            self.tensors[i].consumers.append(op.name)
        for o in op.outputs:
            self.tensors[o].producer = op.name
        self.ops.append(op)
        self._op_index[op.name] = op
        return op

    def op(self, name: str) -> Op:
        return self._op_index[name]

    # -- queries ------------------------------------------------------------
    @property
    def inputs(self) -> List[Tensor]:
        return [t for t in self.tensors.values() if t.kind == "input"]

    @property
    def outputs(self) -> List[Tensor]:
        return [t for t in self.tensors.values() if t.kind == "output"]

    @property
    def params(self) -> List[Tensor]:
        return [t for t in self.tensors.values() if t.is_param]

    def act_inputs(self, op: Op) -> List[Tensor]:
        return [self.tensors[i] for i in op.inputs
                if not self.tensors[i].is_param]

    def param_inputs(self, op: Op) -> List[Tensor]:
        return [self.tensors[i] for i in op.inputs if self.tensors[i].is_param]

    def topo_ops(self) -> List[Op]:
        """Topologically ordered ops (graph build order is already topo,
        but verify — the passes rely on it)."""
        ready: set = {t.name for t in self.tensors.values()
                      if t.producer is None}
        out: List[Op] = []
        pending = list(self.ops)
        guard = 0
        while pending:
            guard += 1
            if guard > len(self.ops) + 2:
                raise RuntimeError(f"graph {self.name} has a cycle")
            rest = []
            for op in pending:
                if all(i in ready for i in op.inputs):
                    out.append(op)
                    ready.update(op.outputs)
                else:
                    rest.append(op)
            pending = rest
        return out

    # -- accounting ---------------------------------------------------------
    def op_macs(self, op: Op) -> int:
        """Multiply-accumulate count of one op (for Table IV / cost model)."""
        k = op.kind
        if k in ("conv", "fc"):
            w = self.param_inputs(op)[0]
            oh, ow, oc = self.tensors[op.output].hwc
            outc, fh, fw, inc = w.shape
            return oh * ow * oc * fh * fw * inc
        if k == "dwconv":
            w = self.param_inputs(op)[0]
            oh, ow, oc = self.tensors[op.output].hwc
            _, fh, fw, _ = w.shape
            return oh * ow * oc * fh * fw
        if k in ("add", "mul", "scalar", "act"):
            return self.tensors[op.output].elems
        if k in ("maxpool", "avgpool"):
            kk = op.attrs.get("k", 2) or 2
            return self.tensors[op.output].elems * kk * kk
        if k == "matmul":
            w = self.param_inputs(op)[0]
            s, _, oc = self.tensors[op.output].hwc
            return s * oc * w.shape[-1]
        if k in ("layernorm", "softmax"):
            # multi-pass normalization: ~2 flops/element dominate
            return 2 * self.tensors[op.output].elems
        if k == "attention":
            # context-length-aware: QK^T and PV both scale with the KV
            # bucket (arxiv 2509.25155), not with a fixed operand shape
            s = self.tensors[op.output].hwc[0]
            kv = int(op.attrs["kv_len"])
            return 2 * s * op.attrs["heads"] * op.attrs["head_dim"] * kv
        return 0

    def total_macs(self) -> int:
        return sum(self.op_macs(op) for op in self.ops)

    def total_param_bytes(self) -> int:
        return sum(t.bytes for t in self.params)

    def stats(self) -> Dict[str, float]:
        return {
            "ops": len(self.ops),
            "gmacs": self.total_macs() / 1e9,
            "params_m": sum(t.elems for t in self.params) / 1e6,
            "param_bytes": self.total_param_bytes(),
        }

    def fingerprint(self) -> str:
        """Canonical content hash of the graph *structure* — everything
        the compiler reads (tensor shapes/kinds/dtypes, op topology and
        attributes), nothing it doesn't (weight values).  Two graphs with
        equal fingerprints compile to identical programs under identical
        (NPUConfig, CompilerOptions), which is what keys the
        compiled-program cache in pipeline.py."""
        import hashlib
        import json
        payload = {
            "name": self.name,
            "tensors": [
                [t.name, list(t.shape), t.kind, t.dtype, t.producer,
                 list(t.consumers), t.scale,
                 t.qparams.payload() if t.qparams is not None else None]
                for t in sorted(self.tensors.values(),
                                key=lambda t: t.name)],
            "ops": [[op.name, op.kind, list(op.inputs), list(op.outputs),
                     op.attrs] for op in self.ops],
        }
        blob = json.dumps(payload, sort_keys=True, default=list)
        return hashlib.sha256(blob.encode()).hexdigest()

    def __repr__(self) -> str:  # pragma: no cover
        s = self.stats()
        return (f"Graph({self.name}: {s['ops']} ops, {s['gmacs']:.2f} GMACs,"
                f" {s['params_m']:.1f}M params)")


def graph_precision(g: Graph) -> str:
    """Activation precision of a graph: 'float32', 'int8', or 'mixed'."""
    dts = {t.dtype for t in g.tensors.values() if not t.is_param}
    if dts == {"int8"}:
        return "int8"
    if dts == {"float32"}:
        return "float32"
    return "mixed"


# --------------------------------------------------------------------------
# Builder — shape-inferring convenience layer
# --------------------------------------------------------------------------


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)  # type: ignore


def conv_out_dim(inp: int, k: int, s: int, p0: int, p1: int) -> int:
    return (inp + p0 + p1 - k) // s + 1


def same_pad(inp: int, k: int, s: int) -> Tuple[int, int]:
    """TF 'SAME' padding split (left/top gets the smaller half)."""
    out = math.ceil(inp / s)
    total = max(0, (out - 1) * s + k - inp)
    return total // 2, total - total // 2


class GraphBuilder:
    """Fluent builder; returns tensor names.  Weights are created as
    deterministic pseudo-random parameters so the reference executor is
    reproducible without any external data."""

    def __init__(self, name: str, seed: int = 0):
        self.g = Graph(name)
        self._ctr = 0
        self._rng = np.random.default_rng(seed)
        self._weights: Dict[str, np.ndarray] = {}

    # ---- naming ----
    def _n(self, prefix: str) -> str:
        self._ctr += 1
        return f"{prefix}_{self._ctr}"

    # ---- tensors ----
    def input(self, shape: Tuple[int, int, int], name: str = "input") -> str:
        self.g.add_tensor(Tensor(name, shape, kind="input"))
        return name

    def mark_output(self, name: str) -> str:
        self.g.tensors[name].kind = "output"
        return name

    def _act_tensor(self, shape, prefix="t") -> str:
        nm = self._n(prefix)
        self.g.add_tensor(Tensor(nm, tuple(int(x) for x in shape)))
        return nm

    def _param(self, shape, prefix="w") -> str:
        nm = self._n(prefix)
        self.g.add_tensor(Tensor(nm, tuple(int(x) for x in shape),
                                 kind="parameter"))
        # deterministic small-int weights (int8-representable)
        self._weights[nm] = (
            self._rng.integers(-4, 5, size=shape).astype(np.float32) / 16.0)
        return nm

    def weight_array(self, name: str) -> np.ndarray:
        return self._weights[name]

    # ---- ops ----
    def conv(self, x: str, out_c: int, k: int = 3, s: int = 1,
             act: str = "none", pad: str = "same", bias: bool = True,
             groups: int = 1) -> str:
        h, w, c = self.g.tensors[x].hwc
        kh, kw = _pair(k)
        if pad == "same":
            pt, pb = same_pad(h, kh, s)
            pl, pr = same_pad(w, kw, s)
        elif pad == "valid":
            pt = pb = pl = pr = 0
        else:
            pt, pb, pl, pr = pad  # explicit
        oh = conv_out_dim(h, kh, s, pt, pb)
        ow = conv_out_dim(w, kw, s, pl, pr)
        if groups == c and out_c == c:
            wshape = (out_c, kh, kw, 1)
            kind = "dwconv"
        elif groups == 1:
            wshape = (out_c, kh, kw, c)
            kind = "conv"
        else:
            raise NotImplementedError("only dense or depthwise groups")
        wt = self._param(wshape)
        ins = [x, wt]
        if bias:
            ins.append(self._param((out_c,), prefix="b"))
        out = self._act_tensor((oh, ow, out_c))
        self.g.add_op(Op(self._n(kind), kind, ins, [out], {
            "stride": s, "k": (kh, kw), "pad": (pt, pb, pl, pr), "act": act,
        }))
        return out

    def dwconv(self, x: str, k: int = 3, s: int = 1, act: str = "none",
               pad: str = "same", bias: bool = True) -> str:
        c = self.g.tensors[x].hwc[2]
        return self.conv(x, c, k=k, s=s, act=act, pad=pad, bias=bias,
                         groups=c)

    def fc(self, x: str, out_c: int, act: str = "none",
           bias: bool = True) -> str:
        shp = self.g.tensors[x].shape
        c = shp[-1] if len(shp) == 1 else shp[2]
        if len(shp) == 3 and shp[:2] != (1, 1):
            raise ValueError("fc expects (1,1,C) — use global pool first")
        wt = self._param((out_c, 1, 1, c))
        ins = [x, wt]
        if bias:
            ins.append(self._param((out_c,), prefix="b"))
        out = self._act_tensor((1, 1, out_c))
        self.g.add_op(Op(self._n("fc"), "fc", ins, [out], {"act": act}))
        return out

    def add(self, a: str, b: str, act: str = "none") -> str:
        sa = self.g.tensors[a].hwc
        assert sa == self.g.tensors[b].hwc, (sa, self.g.tensors[b].hwc)
        out = self._act_tensor(sa)
        self.g.add_op(Op(self._n("add"), "add", [a, b], [out], {"act": act}))
        return out

    def mul(self, a: str, b: str) -> str:
        sa = self.g.tensors[a].hwc
        sb = self.g.tensors[b].hwc
        # broadcast (1,1,C) * (H,W,C) for SE blocks
        out_shape = tuple(max(x, y) for x, y in zip(sa, sb))
        out = self._act_tensor(out_shape)
        self.g.add_op(Op(self._n("mul"), "mul", [a, b], [out], {}))
        return out

    def activation(self, x: str, act: str) -> str:
        assert act in ACTIVATIONS, act
        out = self._act_tensor(self.g.tensors[x].hwc)
        self.g.add_op(Op(self._n("act"), "act", [x], [out], {"act": act}))
        return out

    def maxpool(self, x: str, k: int = 2, s: Optional[int] = None,
                pad: str = "valid") -> str:
        s = s or k
        h, w, c = self.g.tensors[x].hwc
        if pad == "same":
            pt, pb = same_pad(h, k, s)
            pl, pr = same_pad(w, k, s)
        else:
            pt = pb = pl = pr = 0
        oh = conv_out_dim(h, k, s, pt, pb)
        ow = conv_out_dim(w, k, s, pl, pr)
        out = self._act_tensor((oh, ow, c))
        self.g.add_op(Op(self._n("maxpool"), "maxpool", [x], [out],
                         {"k": k, "stride": s, "pad": (pt, pb, pl, pr)}))
        return out

    def global_avgpool(self, x: str) -> str:
        c = self.g.tensors[x].hwc[2]
        out = self._act_tensor((1, 1, c))
        self.g.add_op(Op(self._n("gap"), "avgpool", [x], [out],
                         {"k": 0, "stride": 1, "pad": (0, 0, 0, 0)}))
        return out

    def resize(self, x: str, factor: int = 2) -> str:
        h, w, c = self.g.tensors[x].hwc
        out = self._act_tensor((h * factor, w * factor, c))
        self.g.add_op(Op(self._n("resize"), "resize", [x], [out],
                         {"factor": factor}))
        return out

    def concat(self, xs: Sequence[str]) -> str:
        shapes = [self.g.tensors[x].hwc for x in xs]
        h, w = shapes[0][:2]
        assert all(s[:2] == (h, w) for s in shapes), shapes
        out = self._act_tensor((h, w, sum(s[2] for s in shapes)))
        self.g.add_op(Op(self._n("concat"), "concat", list(xs), [out], {}))
        return out

    def split(self, x: str, sections: int) -> List[str]:
        h, w, c = self.g.tensors[x].hwc
        assert c % sections == 0
        outs = [self._act_tensor((h, w, c // sections))
                for _ in range(sections)]
        self.g.add_op(Op(self._n("split"), "split", [x], outs,
                         {"sections": sections}))
        return outs

    def scalar(self, x: str, op: str, value: float) -> str:
        out = self._act_tensor(self.g.tensors[x].hwc)
        self.g.add_op(Op(self._n("scalar"), "scalar", [x], [out],
                         {"op": op, "value": value}))
        return out

    # ---- causal / transformer ops (LM decode path) ----
    def matmul(self, x: str, out_c: int, act: str = "none",
               bias: bool = True) -> str:
        """Row-wise linear over a (S, 1, C) sequence activation."""
        s, w, c = self.g.tensors[x].hwc
        wt = self._param((out_c, 1, 1, c))
        ins = [x, wt]
        if bias:
            ins.append(self._param((out_c,), prefix="b"))
        out = self._act_tensor((s, w, out_c))
        self.g.add_op(Op(self._n("matmul"), "matmul", ins, [out],
                         {"act": act}))
        return out

    def layernorm(self, x: str, eps: float = 1e-5) -> str:
        shp = self.g.tensors[x].hwc
        gamma = self._param((shp[2],), prefix="g")
        beta = self._param((shp[2],), prefix="b")
        # center the random gamma around 1 (a zero-mean gain would
        # collapse the signal the downstream layers see)
        self._weights[gamma] = self._weights[gamma] + 1.0
        out = self._act_tensor(shp)
        self.g.add_op(Op(self._n("layernorm"), "layernorm",
                         [x, gamma, beta], [out], {"eps": float(eps)}))
        return out

    def softmax(self, x: str) -> str:
        out = self._act_tensor(self.g.tensors[x].hwc)
        self.g.add_op(Op(self._n("softmax"), "softmax", [x], [out], {}))
        return out

    def kvappend(self, cache: str, new: str, pos: str) -> str:
        """Write the S rows of ``new`` into ``cache`` at the dynamic row
        offset held by the (1,1,1) ``pos`` tensor; returns the updated
        cache (same shape) so caches thread through the static graph."""
        cs = self.g.tensors[cache].hwc
        ns = self.g.tensors[new].hwc
        assert cs[1:] == ns[1:] and ns[0] <= cs[0], (cs, ns)
        out = self._act_tensor(cs, prefix="kv")
        self.g.add_op(Op(self._n("kvappend"), "kvappend",
                         [cache, new, pos], [out], {"rows": ns[0]}))
        return out

    def attention(self, q: str, k: str, v: str, pos: str, heads: int,
                  causal: bool = True,
                  scale: Optional[float] = None) -> str:
        """Fused QK^T -> softmax -> V against KV caches.  Query row i
        (global position pos+i) attends cache rows j < pos+S and, when
        causal, j <= pos+i — one definition covers prefill (pos=0) and
        single-token decode (S=1)."""
        qs = self.g.tensors[q].hwc
        ks = self.g.tensors[k].hwc
        assert ks == self.g.tensors[v].hwc, (ks, self.g.tensors[v].hwc)
        assert qs[2] == ks[2] and qs[2] % heads == 0, (qs, ks, heads)
        hd = qs[2] // heads
        out = self._act_tensor(qs, prefix="attn")
        self.g.add_op(Op(self._n("attention"), "attention",
                         [q, k, v, pos], [out],
                         {"heads": int(heads), "head_dim": int(hd),
                          "scale": float(scale or 1.0 / math.sqrt(hd)),
                          "causal": bool(causal),
                          "kv_len": int(ks[0])}))
        return out

    def build(self) -> "Graph":
        # verify topological consistency once at build time
        self.g.topo_ops()
        return self.g


# --------------------------------------------------------------------------
# Reference executor (numpy, float32) — the functional oracle
# --------------------------------------------------------------------------


def _apply_act(x: np.ndarray, act: str) -> np.ndarray:
    if act in ("none", None):
        return x
    if act == "relu":
        return np.maximum(x, 0)
    if act == "relu6":
        return np.clip(x, 0, 6)
    if act == "hswish":
        return x * np.clip(x + 3, 0, 6) / 6
    if act == "hsigmoid":
        return np.clip(x + 3, 0, 6) / 6
    if act == "silu":
        return x / (1 + np.exp(-np.clip(x, -30, 30)))
    if act == "sigmoid":
        return 1 / (1 + np.exp(-np.clip(x, -30, 30)))
    if act == "gelu":
        return 0.5 * x * (1 + np.tanh(np.sqrt(2 / np.pi)
                                      * (x + 0.044715 * x ** 3)))
    if act == "mish":
        sp = np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0)  # softplus
        return x * np.tanh(sp)
    if act == "sqrelu":
        r = np.maximum(x, 0)
        return r * r
    if act == "leaky":
        return np.where(x > 0, x, 0.1 * x)
    raise ValueError(act)


#: memoized einsum contraction paths.  ``np.einsum(optimize=True)``
#: re-derives the path on *every* call (~0.1 ms of pure Python) — the
#: path depends only on the subscripts and operand shapes, and passing
#: the precomputed path back executes the identical contraction, so the
#: numerical result is bit-for-bit unchanged.
_EINSUM_PATHS: Dict[tuple, list] = {}


def cached_einsum(subs: str, *ops: np.ndarray) -> np.ndarray:
    key = (subs,) + tuple(op.shape for op in ops)
    path = _EINSUM_PATHS.get(key)
    if path is None:
        path = np.einsum_path(subs, *ops, optimize=True)[0]
        _EINSUM_PATHS[key] = path
    return np.einsum(subs, *ops, optimize=path)


def _conv2d_ref(x: np.ndarray, w: np.ndarray, stride: int,
                pad: Tuple[int, int, int, int], depthwise: bool
                ) -> np.ndarray:
    """x (H,W,C); w (outC,fh,fw,inC).  Straight sliding-window conv."""
    pt, pb, pl, pr = pad
    xp = np.pad(x, ((pt, pb), (pl, pr), (0, 0)))
    H, W, C = xp.shape
    oc, fh, fw, ic = w.shape
    oh = (H - fh) // stride + 1
    ow = (W - fw) // stride + 1
    # im2col
    cols = np.empty((oh, ow, fh, fw, C), dtype=np.float32)
    for i in range(fh):
        for j in range(fw):
            cols[:, :, i, j, :] = xp[i:i + oh * stride:stride,
                                     j:j + ow * stride:stride, :]
    if depthwise:
        # w (C, fh, fw, 1)
        ker = np.transpose(w[:, :, :, 0], (1, 2, 0))  # (fh, fw, C)
        return cached_einsum("hwijc,ijc->hwc", cols, ker)
    return cached_einsum("hwijc,oijc->hwo",
                         cols.reshape(oh, ow, fh, fw, ic), w)


#: attention mask fill — finite (exp() underflows to exactly 0) so fully
#: masked columns never produce NaNs, matching kernels/flash_attention.py
NEG_INF = np.float32(-1e30)


def _pos_index(pos, smax: int, s: int) -> int:
    """Decode the dynamic (1,1,1) position tensor into a row offset,
    clamped so the S new rows always fit the cache bucket (random
    calibration feeds therefore stay well-defined)."""
    v = int(round(float(np.asarray(pos).reshape(-1)[0])))
    return min(max(v, 0), max(smax - s, 0))


def _c32(x: np.ndarray) -> np.ndarray:
    """Contiguous float32 canonical form.  The interpreter hands these
    helpers strided TCM views while the plan hands contiguous arena
    slices — BLAS/einsum summation order depends on layout, so both
    engines canonicalize before computing (this is what makes the
    engines bit-identical, not merely close)."""
    return np.ascontiguousarray(x, dtype=np.float32)


def _matmul_ref(x: np.ndarray, w: np.ndarray,
                b: Optional[np.ndarray], act: str) -> np.ndarray:
    """x (s,1,inC) row slice; w (outC,inC).  Row-independent, so tiled
    replays of any row range are bit-identical to the full pass."""
    y = cached_einsum("swc,oc->swo", _c32(x), _c32(w))
    if b is not None:
        y = y + b
    return _apply_act(y, act).astype(np.float32)


def _layernorm_ref(x: np.ndarray, gamma: np.ndarray, beta: np.ndarray,
                   eps: float) -> np.ndarray:
    x = _c32(x)
    mu = x.mean(axis=-1, keepdims=True)
    var = ((x - mu) ** 2).mean(axis=-1, keepdims=True)
    return ((x - mu) / np.sqrt(var + eps) * gamma
            + beta).astype(np.float32)


def _softmax_ref(x: np.ndarray) -> np.ndarray:
    x = _c32(x)
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)


def _attention_ref(q: np.ndarray, kc: np.ndarray, vc: np.ndarray,
                   pos, attrs: Dict, q0: int = 0,
                   s_total: Optional[int] = None) -> np.ndarray:
    """Fused QK^T -> softmax -> V.  ``q`` may be a row slice starting at
    global query row ``q0`` of an op with ``s_total`` query rows; the
    mask uses global positions so tiled replays match the full pass."""
    s, _, c = q.shape
    smax = kc.shape[0]
    heads, hd = attrs["heads"], attrs["head_dim"]
    s_total = s if s_total is None else s_total
    p0 = _pos_index(pos, smax, s_total)
    qh = _c32(q).reshape(s, heads, hd).transpose(1, 0, 2)
    kh = _c32(kc).reshape(smax, heads, hd).transpose(1, 0, 2)
    vh = _c32(vc).reshape(smax, heads, hd).transpose(1, 0, 2)
    sc = cached_einsum("hsd,htd->hst", qh, kh) * np.float32(attrs["scale"])
    j = np.arange(smax)[None, None, :]
    valid = j < p0 + s_total
    if attrs.get("causal", True):
        gi = (q0 + np.arange(s))[None, :, None]
        valid = valid & (j <= p0 + gi)
    sc = np.where(valid, sc, NEG_INF)
    e = np.exp(sc - sc.max(axis=-1, keepdims=True))
    p = e / e.sum(axis=-1, keepdims=True)
    y = cached_einsum("hst,htd->hsd", p, vh)
    return y.transpose(1, 0, 2).reshape(s, 1, c).astype(np.float32)


def _kvappend_ref(cache: np.ndarray, new: np.ndarray, pos) -> np.ndarray:
    smax, s = cache.shape[0], new.shape[0]
    p0 = _pos_index(pos, smax, s)
    out = cache.astype(np.float32).copy()
    out[p0:p0 + s] = new
    return out


def reference_execute(g: Graph, inputs: Dict[str, np.ndarray],
                      weights: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
    """Execute the graph in float32.  Returns every tensor's value."""
    vals: Dict[str, np.ndarray] = {}
    for t in g.tensors.values():
        if t.kind == "input":
            vals[t.name] = np.asarray(inputs[t.name], dtype=np.float32)
        elif t.is_param:
            vals[t.name] = np.asarray(weights[t.name], dtype=np.float32)
    for op in g.topo_ops():
        k = op.kind
        a = op.attrs
        if k in ("conv", "dwconv"):
            x = vals[op.inputs[0]]
            w = vals[op.inputs[1]]
            y = _conv2d_ref(x, w, a["stride"], a["pad"], k == "dwconv")
            if len(op.inputs) > 2:
                y = y + vals[op.inputs[2]]
            vals[op.output] = _apply_act(y, a.get("act", "none"))
        elif k == "fc":
            x = vals[op.inputs[0]].reshape(-1)
            w = vals[op.inputs[1]][:, 0, 0, :]
            y = w @ x
            if len(op.inputs) > 2:
                y = y + vals[op.inputs[2]]
            vals[op.output] = _apply_act(y, a.get("act", "none")
                                         ).reshape(1, 1, -1)
        elif k == "add":
            vals[op.output] = _apply_act(
                vals[op.inputs[0]] + vals[op.inputs[1]], a.get("act", "none"))
        elif k == "mul":
            vals[op.output] = vals[op.inputs[0]] * vals[op.inputs[1]]
        elif k == "scalar":
            x = vals[op.inputs[0]]
            v = a["value"]
            vals[op.output] = {"add": x + v, "mul": x * v,
                               "div": x / v}[a["op"]]
        elif k == "act":
            vals[op.output] = _apply_act(vals[op.inputs[0]], a["act"])
        elif k == "maxpool":
            x = vals[op.inputs[0]]
            pt, pb, pl, pr = a["pad"]
            xp = np.pad(x, ((pt, pb), (pl, pr), (0, 0)),
                        constant_values=-np.inf)
            kk, s = a["k"], a["stride"]
            H, W, C = xp.shape
            oh = (H - kk) // s + 1
            ow = (W - kk) // s + 1
            y = np.full((oh, ow, C), -np.inf, dtype=np.float32)
            for i in range(kk):
                for j in range(kk):
                    y = np.maximum(y, xp[i:i + oh * s:s, j:j + ow * s:s, :])
            vals[op.output] = y
        elif k == "avgpool":
            x = vals[op.inputs[0]]
            if a["k"] == 0:  # global
                vals[op.output] = x.mean(axis=(0, 1), keepdims=True)
            else:
                kk, s = a["k"], a["stride"]
                pt, pb, pl, pr = a["pad"]
                xp = np.pad(x, ((pt, pb), (pl, pr), (0, 0)))
                H, W, C = xp.shape
                oh = (H - kk) // s + 1
                ow = (W - kk) // s + 1
                y = np.zeros((oh, ow, C), dtype=np.float32)
                for i in range(kk):
                    for j in range(kk):
                        y += xp[i:i + oh * s:s, j:j + ow * s:s, :]
                vals[op.output] = y / (kk * kk)
        elif k == "resize":
            f = a["factor"]
            vals[op.output] = np.repeat(np.repeat(vals[op.inputs[0]], f,
                                                  axis=0), f, axis=1)
        elif k == "concat":
            vals[op.output] = np.concatenate([vals[i] for i in op.inputs],
                                             axis=2)
        elif k == "split":
            parts = np.split(vals[op.inputs[0]], a["sections"], axis=2)
            for o, p in zip(op.outputs, parts):
                vals[o] = p
        elif k == "matmul":
            b = vals[op.inputs[2]] if len(op.inputs) > 2 else None
            vals[op.output] = _matmul_ref(
                vals[op.inputs[0]], vals[op.inputs[1]][:, 0, 0, :],
                b, a.get("act", "none"))
        elif k == "layernorm":
            vals[op.output] = _layernorm_ref(
                vals[op.inputs[0]], vals[op.inputs[1]],
                vals[op.inputs[2]], a["eps"])
        elif k == "softmax":
            vals[op.output] = _softmax_ref(vals[op.inputs[0]])
        elif k == "attention":
            vals[op.output] = _attention_ref(
                vals[op.inputs[0]], vals[op.inputs[1]],
                vals[op.inputs[2]], vals[op.inputs[3]], a)
        elif k == "kvappend":
            vals[op.output] = _kvappend_ref(
                vals[op.inputs[0]], vals[op.inputs[1]],
                vals[op.inputs[2]])
        else:
            raise NotImplementedError(k)
    return vals
