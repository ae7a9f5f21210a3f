"""Plain PyTorch int8 forward of a vision network, with the post-training
quantization that gives its integers.

A network is one function, ``forward(net, x)``, written against the few
layer calls of :class:`Net` (``conv``, ``dwconv``, ``fc``, ``add``,
``maxpool``, ``gap``, ``concat``, ``split``, ``resize``), that returns the
list of its outputs in the network's output order (a list of one for a
classifier).  :class:`Net` runs it three ways:

* ``spec``: on the meta device, to list the layers with their weight
  shapes (outC, kh, kw, inC; a depthwise conv (C, kh, kw, 1), an fc
  (N, 1, 1, K)) in call order;
* ``float``: float32 (TF32 off), recording the range of every tensor,
  the input included, in call order (each part of a split in turn): the
  calibration;
* ``int8``: the integers of the quantized network.

The quantization is the deployment the configurations state: every
activation int8 per tensor, asymmetric, from its min-max range over the
calibration images; every weight int8 per output channel, symmetric;
biases int32 at the scale ``s_x * s_w``.  Integer sums are exact (float64
holds them), and each float32 step rounds where a float32 deployment
rounds: ``float32(acc) * (s_x * s_w)``, the activation, ``round(y / s) +
z`` clipped to the int8 range (half to even), and ``(q - z) * s`` where a
value is dequantized (add, concat, split, resize, max pool's
requantization, the outputs).  SiLU is ``x * sigmoid(x)`` in float32 from
its definition; the deployment evaluates its own float32 formula, so, as
with any activation that is not piecewise linear, a stored code may differ
by one step where a value lies at a rounding boundary.
Padding is TensorFlow's ``SAME`` (the smaller half before), as the
networks are deployed.

This file imports neither the program under test nor JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

#: the int8 range of every activation and weight
QMIN, QMAX = -128, 127
#: the least scale a constant tensor gets
MIN_SCALE = 1e-12


def same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """TensorFlow ``SAME`` padding of one axis: (before, after)."""
    out = -(-n // s)
    total = max(0, (out - 1) * s + k - n)
    return total // 2, total - total // 2


def activation(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "none":
        return x
    if act == "relu":
        return torch.clamp_min(x, 0)
    if act == "relu6":
        return torch.clamp(x, 0, 6)
    if act == "silu":
        return x * torch.sigmoid(x)
    raise ValueError(f"activation {act!r}")


@dataclass
class Layer:
    """One weighted layer: its kind, weight shape (outC, kh, kw, inC) and
    what it does."""
    name: str
    kind: str                  # "conv" | "dwconv" | "fc"
    wshape: Tuple[int, ...]
    act: str
    stride: int = 1

    @property
    def fan_in(self) -> int:
        return int(np.prod(self.wshape[1:]))


def act_qparams(lo: float, hi: float) -> Tuple[float, int]:
    """(scale, zero point) of an activation observed over [lo, hi]: the
    range widened to hold 0, spread over the 256 int8 codes; the scale is
    computed in float64 and kept as float32, the zero point from the
    float64 scale."""
    lo, hi = min(float(lo), 0.0), max(float(hi), 0.0)
    scale = max((hi - lo) / (QMAX - QMIN), MIN_SCALE)
    zp = int(np.clip(np.round(QMIN - lo / scale), QMIN, QMAX))
    return float(np.float32(scale)), zp


def weight_scales(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Symmetric per-output-channel scales (float32) of a weight whose
    first axis is the output channel."""
    flat = w.detach().to(torch.float64).reshape(w.shape[0], -1)
    lo = torch.clamp_max(flat.amin(dim=1), 0.0)
    hi = torch.clamp_min(flat.amax(dim=1), 0.0)
    amax = torch.maximum(lo.abs(), hi.abs())
    qmax = (1 << (bits - 1)) - 1
    return torch.clamp_min(amax / qmax, MIN_SCALE).to(torch.float32)


def quantize(y: torch.Tensor, qp: Tuple[float, int]) -> torch.Tensor:
    """float32 -> int8 codes (held as int32): ``round(y / s) + z``,
    clipped; the division by a float32 device scalar."""
    s = torch.tensor(qp[0], dtype=torch.float32, device=y.device)
    q = torch.round(y.to(torch.float32) / s) + qp[1]
    return q.clamp_(QMIN, QMAX).to(torch.int32)


def dequantize(q: torch.Tensor, qp: Tuple[float, int]) -> torch.Tensor:
    s = torch.tensor(qp[0], dtype=torch.float32, device=q.device)
    return (q - qp[1]).to(torch.float32) * s


@dataclass
class QLayer:
    """A layer's integer constants: weights as float64 (exact), int32 bias
    as float64, and the float32 rescale ``s_x * s_w``."""
    w: torch.Tensor            # (outC, inC / groups, kh, kw) float64 ints
    bias: torch.Tensor         # (outC,) float64 ints
    sc: torch.Tensor           # (outC,) float32


def _flat(t: torch.Tensor) -> torch.Tensor:
    """(n, C, H, W) -> (n, H * W * C), in the (H, W, C) order of the
    program's tensors."""
    return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1)


class Net:
    """Runs ``forward(net, x)`` in the mode given (see the module's
    docstring).  ``x``: (n, H, W, C) float32 images; ``forward`` returns
    the list of its output tensors in the mode (float32 logits, int codes
    with their qparams)."""

    def __init__(self, mode: str, params: Optional[Dict] = None,
                 qparams: Optional[List[Tuple[float, int]]] = None,
                 qlayers: Optional[Dict[str, QLayer]] = None):
        assert mode in ("spec", "float", "int8"), mode
        self.mode = mode
        self.params = params or {}
        self.qparams = qparams
        self.qlayers = qlayers
        self.layers: List[Layer] = []
        self.ranges: List[Tuple[float, float]] = []
        self._li = 0
        self._ti = 0

    # -- bookkeeping ------------------------------------------------------
    def _layer(self, kind: str, wshape, act: str, stride: int) -> Layer:
        if self.mode == "spec":
            layer = Layer(f"L{len(self.layers)}", kind, tuple(wshape), act,
                          stride)
            self.layers.append(layer)
        else:
            layer = Layer(f"L{self._li}", kind, tuple(wshape), act, stride)
        self._li += 1
        return layer

    def _out(self, t: torch.Tensor):
        """Record a new tensor: its range (float) or its qparams (int8)."""
        i = self._ti
        self._ti += 1
        if self.mode == "float":
            self.ranges.append((float(t.amin()), float(t.amax())))
            return t
        if self.mode == "int8":
            return quantize(t, self.qparams[i]), self.qparams[i]
        return t

    def input(self, x: torch.Tensor):
        """(n, H, W, C) images -> the network's first tensor (NCHW)."""
        x = x.permute(0, 3, 1, 2).to(torch.float32)
        return self._out(x)

    # -- layers ------------------------------------------------------------
    def _weighted(self, x, kind: str, out_c: int, k: int, s: int, act: str):
        if self.mode == "int8":
            xq, xqp = x
            c, h, w = xq.shape[1:]
        else:
            c, h, w = x.shape[1:]
        if kind == "dwconv":
            wshape = (c, k, k, 1)
        elif kind == "conv":
            wshape = (out_c, k, k, c)
        else:
            wshape = (out_c, 1, 1, c)
        layer = self._layer(kind, wshape, act, s)
        groups = c if kind == "dwconv" else 1
        pt, pb = same_pad(h, k, s)
        pl, pr = same_pad(w, k, s)
        if self.mode == "spec":
            wt = torch.empty((wshape[0], wshape[3]) + wshape[1:3],
                             device="meta")
            y = F.conv2d(F.pad(x, (pl, pr, pt, pb)), wt, stride=s,
                         groups=groups)
            return self._out(y)
        if self.mode == "float":
            wt, b = self.params[layer.name]
            wt = wt.permute(0, 3, 1, 2).contiguous()
            y = F.conv2d(F.pad(x, (pl, pr, pt, pb)), wt, b, stride=s,
                         groups=groups)
            return self._out(activation(y, act))
        ql = self.qlayers[layer.name]
        xi = F.pad(xq.to(torch.float64) - xqp[1], (pl, pr, pt, pb))
        acc = F.conv2d(xi, ql.w, ql.bias, stride=s, groups=groups)
        y = acc.to(torch.float32) * ql.sc[None, :, None, None]
        return self._out(activation(y, act))

    def conv(self, x, out_c: int, k: int = 1, s: int = 1,
             act: str = "none"):
        return self._weighted(x, "conv", out_c, k, s, act)

    def dwconv(self, x, k: int = 3, s: int = 1, act: str = "none"):
        return self._weighted(x, "dwconv", 0, k, s, act)

    def fc(self, x, out_c: int, act: str = "none"):
        return self._weighted(x, "fc", out_c, 1, 1, act)

    def add(self, a, b, act: str = "none"):
        if self.mode == "int8":
            y = dequantize(*a) + dequantize(*b)
        else:
            y = a + b
        return self._out(activation(y, act))

    def maxpool(self, x, k: int, s: int):
        """Max pool with ``SAME`` padding: in the int domain the max of
        the codes (padding never wins), then one requantization."""
        if self.mode == "int8":
            xq, xqp = x
            h, w = xq.shape[2:]
            src = xq.to(torch.float64)
        else:
            h, w = x.shape[2:]
            src = x
        pt, pb = same_pad(h, k, s)
        pl, pr = same_pad(w, k, s)
        y = F.max_pool2d(F.pad(src, (pl, pr, pt, pb), value=-float("inf")),
                         k, s)
        if self.mode == "int8":
            y = dequantize(y.to(torch.int32), xqp)
        return self._out(y)

    def concat(self, xs):
        """Channel concatenation: in the int domain each input dequantized
        with its own qparams, then one quantization with the concat's."""
        if self.mode == "int8":
            y = torch.cat([dequantize(*x) for x in xs], dim=1)
        else:
            y = torch.cat(list(xs), dim=1)
        return self._out(y)

    def split(self, x, sections: int) -> list:
        """``sections`` equal channel parts, each a new tensor with its
        own qparams, recorded in order (int domain: dequantized, then each
        part quantized with its own)."""
        y = dequantize(*x) if self.mode == "int8" else x
        c = y.shape[1]
        if c % sections:
            raise ValueError(f"split of {c} channels into {sections}")
        return [self._out(p) for p in torch.split(y, c // sections, dim=1)]

    def resize(self, x, factor: int):
        """Nearest upsampling by an integer factor: each pixel repeated
        ``factor`` x ``factor`` times (int domain: dequantized, repeated,
        quantized with the output's qparams)."""
        y = dequantize(*x) if self.mode == "int8" else x
        y = y.repeat_interleave(factor, dim=2)
        return self._out(y.repeat_interleave(factor, dim=3))

    def gap(self, x):
        """Global average pool: in the int domain the exact sum of ``q -
        z``, times ``s / (H W)`` rounded to float32."""
        if self.mode != "int8":
            return self._out(x.mean(dim=(2, 3), keepdim=True))
        xq, xqp = x
        h, w = xq.shape[2:]
        acc = (xq.to(torch.float64) - xqp[1]).sum(dim=(2, 3), keepdim=True)
        r = torch.tensor(xqp[0] / (h * w), dtype=torch.float32,
                         device=xq.device)
        return self._out(acc.to(torch.float32) * r)


def layer_specs(forward: Callable, resolution: int) -> List[Layer]:
    """The weighted layers of ``forward`` at ``resolution``, in call
    order."""
    net = Net("spec")
    forward(net, torch.empty((1, resolution, resolution, 3), device="meta"))
    return net.layers


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@torch.no_grad()
def calibrate(forward: Callable, params: Dict, images: torch.Tensor
              ) -> List[Tuple[float, int]]:
    """Activation qparams of every tensor, in call order, from the
    min-max ranges of a float32 forward over ``images``."""
    _no_tf32()
    net = Net("float", params=params)
    forward(net, images)
    return [act_qparams(lo, hi) for lo, hi in net.ranges]


def quantize_layers(specs: List[Layer], params: Dict,
                    qparams: List[Tuple[float, int]], input_of: Dict[str, int],
                    weight_bits: int = 8) -> Dict[str, QLayer]:
    """Each layer's integer weights, int32 bias and rescale, from its
    float weights and the scale of its input (``input_of``: layer name ->
    index of its input tensor)."""
    qmin, qmax = -(1 << (weight_bits - 1)), (1 << (weight_bits - 1)) - 1
    out = {}
    for layer in specs:
        w, b = params[layer.name]
        s_w = weight_scales(w, weight_bits).to(w.device)
        wq = torch.round(w.to(torch.float32)
                         / s_w.view(-1, *([1] * (w.dim() - 1))))
        wq = wq.clamp_(qmin, qmax).to(torch.float64)
        s_x = torch.tensor(qparams[input_of[layer.name]][0],
                           dtype=torch.float32, device=w.device)
        sc = s_x * s_w                        # float32, as deployed
        bq = torch.round(b.to(torch.float64) / sc.to(torch.float64))
        bq = bq.clamp_(-2.0 ** 31, 2.0 ** 31 - 1)
        out[layer.name] = QLayer(wq.permute(0, 3, 1, 2).contiguous(), bq, sc)
    return out


class _InputTracker(Net):
    """Spec mode that also notes which tensor each layer reads (by index
    in call order, :meth:`index`)."""

    def __init__(self):
        super().__init__("spec")
        self.input_of: Dict[str, int] = {}
        self._ids: Dict[int, int] = {}

    def _out(self, t):
        self._ids[id(t)] = self._ti
        return super()._out(t)

    def index(self, t) -> int:
        return self._ids[id(t)]

    def _weighted(self, x, kind, out_c, k, s, act):
        self.input_of[f"L{self._li}"] = self.index(x)
        return super()._weighted(x, kind, out_c, k, s, act)


class Reference:
    """One configuration's quantized reference: ``forward`` with the
    float weights ``params`` (layer name -> (w, b), w in (outC, kh, kw,
    inC)), calibrated on ``calib`` images."""

    def __init__(self, forward: Callable, resolution: int, params: Dict,
                 calib: torch.Tensor, weight_bits: int = 8):
        self.forward = forward
        spec = _InputTracker()
        outs = forward(spec, torch.empty((1, resolution, resolution, 3),
                                         device="meta"))
        if not isinstance(outs, list):
            raise TypeError("forward returns the list of its outputs, "
                            f"not {type(outs).__name__}")
        self.specs = spec.layers
        #: layer name -> index (in call order) of the tensor it reads
        self.input_of = spec.input_of
        #: index (in call order) of each output tensor, in output order
        self.out_index = [spec.index(t) for t in outs]
        #: (H, W, C) of each output
        self.out_shapes = [(int(t.shape[2]), int(t.shape[3]),
                            int(t.shape[1])) for t in outs]
        self.qparams = calibrate(forward, params, calib)
        self.qlayers = quantize_layers(self.specs, params, self.qparams,
                                       self.input_of, weight_bits)

    @property
    def out_qparams(self) -> List[Tuple[float, int]]:
        """(scale, zero point) of each output, in output order."""
        return [self.qparams[i] for i in self.out_index]

    @torch.no_grad()
    def logits(self, images: torch.Tensor) -> List[torch.Tensor]:
        """Decoded float32 outputs of the int8 network: one (n, N_k) per
        output, in output order, each in (H, W, C) order."""
        _no_tf32()
        net = Net("int8", qparams=self.qparams, qlayers=self.qlayers)
        return [_flat(dequantize(q, qp))
                for q, qp in self.forward(net, images)]

    @torch.no_grad()
    def float_logits(self, params: Dict, images: torch.Tensor
                     ) -> List[torch.Tensor]:
        """The float32 network's outputs, one (n, N_k) per output as
        :meth:`logits` gives them, for tests."""
        _no_tf32()
        net = Net("float", params=params)
        return [_flat(t) for t in self.forward(net, images)]
