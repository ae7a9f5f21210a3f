"""Vision-model frontends — the paper's benchmark suite (Table IV).

Builds every model of paper §V as a :class:`repro_torch.core.ir.Graph`:
MobileNetV1/V2/V3-minimalistic, ResNet50V1, EfficientNet-Lite0,
EfficientDet-Lite0, YOLOv8n (det + seg), YOLOv8s, MobileNetV1/V2-SSD and a
DAMO-YOLO-NL-class model.  BatchNorm is folded into the convolutions
(the INT8 deployment the paper measures).  MAC counts are validated
against Table IV in ``tests/test_vision.py``.

``build(name, res_scale=1.0)`` returns ``(graph, builder)``; res_scale
shrinks the input resolution for fast functional tests (the topology and
channel counts are unchanged).  Built graphs are memoized per
``(name, resolution)`` — repeated builder calls (benchmarks, serving
compiles, quantize-then-compare flows) get a cheap structural clone
instead of re-deriving every shape (~10% of a cache-miss compile on the
YOLO-class models).  ``build_quantized`` runs the int8/int4 PTQ flow of
:mod:`repro_torch.quant` over a built graph with synthetic calibration data.

Copy of the JAX package's ``frontends/vision.py`` (numpy only; the port imports
nothing of that package and keeps its own copy).  The tests hold it
equal to the original.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core.ir import Graph, GraphBuilder, Op, Tensor

# --------------------------------------------------------------------------
# Shared blocks
# --------------------------------------------------------------------------


def _dw_sep(b: GraphBuilder, x: str, out_c: int, s: int = 1,
            act: str = "relu6", k: int = 3) -> str:
    """Depthwise-separable conv (MobileNetV1 block)."""
    x = b.dwconv(x, k=k, s=s, act=act)
    return b.conv(x, out_c, k=1, act=act)


def _inv_res(b: GraphBuilder, x: str, exp: int, out_c: int, s: int = 1,
             k: int = 3, act: str = "relu6") -> str:
    """MobileNetV2 inverted residual (expand -> dw -> project-linear)."""
    in_c = b.g.tensors[x].hwc[2]
    h = x
    if exp != in_c:
        h = b.conv(h, exp, k=1, act=act)
    h = b.dwconv(h, k=k, s=s, act=act)
    h = b.conv(h, out_c, k=1, act="none")
    if s == 1 and in_c == out_c:
        h = b.add(x, h)
    return h


def _res_bottleneck(b: GraphBuilder, x: str, c: int, s: int = 1,
                    first: bool = False) -> str:
    """ResNet50V1 bottleneck: 1x1(c, stride s) -> 3x3(c) -> 1x1(4c)."""
    in_c = b.g.tensors[x].hwc[2]
    h = b.conv(x, c, k=1, s=s, act="relu")        # v1: stride on first 1x1
    h = b.conv(h, c, k=3, s=1, act="relu")
    h = b.conv(h, 4 * c, k=1, act="none")
    if first or s != 1 or in_c != 4 * c:
        sc = b.conv(x, 4 * c, k=1, s=s, act="none")
    else:
        sc = x
    return b.add(h, sc, act="relu")


def _cbs(b: GraphBuilder, x: str, c: int, k: int = 3, s: int = 1) -> str:
    """YOLOv8 Conv-BN-SiLU."""
    return b.conv(x, c, k=k, s=s, act="silu")


def _c2f(b: GraphBuilder, x: str, c: int, n: int,
         shortcut: bool = True) -> str:
    """YOLOv8 C2f: split + n bottlenecks + concat + 1x1 fuse."""
    h = c // 2
    y = _cbs(b, x, 2 * h, k=1)
    parts = b.split(y, 2)
    feats = [parts[0], parts[1]]
    cur = parts[1]
    for _ in range(n):
        z = _cbs(b, cur, h, k=3)
        z = _cbs(b, z, h, k=3)
        cur = b.add(cur, z) if shortcut else z
        feats.append(cur)
    return _cbs(b, b.concat(feats), c, k=1)


def _sppf(b: GraphBuilder, x: str, c: int) -> str:
    h = c // 2
    y = _cbs(b, x, h, k=1)
    p1 = b.maxpool(y, k=5, s=1, pad="same")
    p2 = b.maxpool(p1, k=5, s=1, pad="same")
    p3 = b.maxpool(p2, k=5, s=1, pad="same")
    return _cbs(b, b.concat([y, p1, p2, p3]), c, k=1)


# --------------------------------------------------------------------------
# Classification models
# --------------------------------------------------------------------------


def mobilenet_v1(res: int = 224) -> Tuple[Graph, GraphBuilder]:
    b = GraphBuilder("mobilenet_v1")
    x = b.input((res, res, 3))
    x = b.conv(x, 32, k=3, s=2, act="relu6")
    cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
           (1024, 1)]
    for c, s in cfg:
        x = _dw_sep(b, x, c, s=s)
    x = b.global_avgpool(x)
    x = b.fc(x, 1000)
    b.mark_output(x)
    return b.build(), b


def mobilenet_v2(res: int = 224) -> Tuple[Graph, GraphBuilder]:
    b = GraphBuilder("mobilenet_v2")
    x = b.input((res, res, 3))
    x = b.conv(x, 32, k=3, s=2, act="relu6")
    # (t, c, n, s)
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    for t, c, n, s in cfg:
        for i in range(n):
            in_c = b.g.tensors[x].hwc[2]
            x = _inv_res(b, x, exp=in_c * t, out_c=c, s=s if i == 0 else 1)
    x = b.conv(x, 1280, k=1, act="relu6")
    x = b.global_avgpool(x)
    x = b.fc(x, 1000)
    b.mark_output(x)
    return b.build(), b


def mobilenet_v3_min(res: int = 224) -> Tuple[Graph, GraphBuilder]:
    """MobileNetV3-Large *minimalistic*: no SE, no h-swish, 3x3 only."""
    b = GraphBuilder("mobilenet_v3_min")
    x = b.input((res, res, 3))
    x = b.conv(x, 16, k=3, s=2, act="relu")
    # (exp, out, s) — large config with k=3/RE/no-SE (minimalistic)
    cfg = [(16, 16, 1), (64, 24, 2), (72, 24, 1), (72, 40, 2), (120, 40, 1),
           (120, 40, 1), (240, 80, 2), (200, 80, 1), (184, 80, 1),
           (184, 80, 1), (480, 112, 1), (672, 112, 1), (672, 160, 2),
           (960, 160, 1), (960, 160, 1)]
    for exp, c, s in cfg:
        x = _inv_res(b, x, exp=exp, out_c=c, s=s, act="relu")
    x = b.conv(x, 960, k=1, act="relu")
    x = b.global_avgpool(x)
    x = b.conv(x, 1280, k=1, act="relu")
    x = b.fc(x, 1000)
    b.mark_output(x)
    return b.build(), b


def resnet50_v1(res: int = 224) -> Tuple[Graph, GraphBuilder]:
    b = GraphBuilder("resnet50_v1")
    x = b.input((res, res, 3))
    x = b.conv(x, 64, k=7, s=2, act="relu")
    x = b.maxpool(x, k=3, s=2, pad="same")
    for stage, (c, n) in enumerate([(64, 3), (128, 4), (256, 6), (512, 3)]):
        for i in range(n):
            s = 2 if (i == 0 and stage > 0) else 1
            x = _res_bottleneck(b, x, c, s=s, first=(i == 0))
    x = b.global_avgpool(x)
    x = b.fc(x, 1000)
    b.mark_output(x)
    return b.build(), b


def efficientnet_lite0(res: int = 224) -> Tuple[Graph, GraphBuilder]:
    b = GraphBuilder("efficientnet_lite0")
    x = b.input((res, res, 3))
    x = b.conv(x, 32, k=3, s=2, act="relu6")
    # (t, k, c, n, s) — lite0: no SE, relu6
    cfg = [(1, 3, 16, 1, 1), (6, 3, 24, 2, 2), (6, 5, 40, 2, 2),
           (6, 3, 80, 3, 2), (6, 5, 112, 3, 1), (6, 5, 192, 4, 2),
           (6, 3, 320, 1, 1)]
    for t, k, c, n, s in cfg:
        for i in range(n):
            in_c = b.g.tensors[x].hwc[2]
            x = _inv_res(b, x, exp=in_c * t, out_c=c,
                         s=s if i == 0 else 1, k=k)
    x = b.conv(x, 1280, k=1, act="relu6")
    x = b.global_avgpool(x)
    x = b.fc(x, 1000)
    b.mark_output(x)
    return b.build(), b


# --------------------------------------------------------------------------
# SSD detectors
# --------------------------------------------------------------------------


def _ssd_heads(b: GraphBuilder, feats: List[str], anchors: List[int],
               n_classes: int = 91, lite: bool = False) -> List[str]:
    """1x1 box predictors (the TF-OD 'reduced' BoxPredictor used by the
    deployed TFLite SSD models); SSDLite uses dw-separable 3x3 heads."""
    outs = []
    for f, a in zip(feats, anchors):
        if lite:
            loc = b.dwconv(f, k=3, act="relu6")
            loc = b.conv(loc, a * 4, k=1)
            cls = b.dwconv(f, k=3, act="relu6")
            cls = b.conv(cls, a * n_classes, k=1)
        else:
            loc = b.conv(f, a * 4, k=1)
            cls = b.conv(f, a * n_classes, k=1)
        outs += [b.mark_output(loc), b.mark_output(cls)]
    return outs


def mobilenet_v1_ssd(res: int = 300) -> Tuple[Graph, GraphBuilder]:
    b = GraphBuilder("mobilenet_v1_ssd")
    x = b.input((res, res, 3))
    x = b.conv(x, 32, k=3, s=2, act="relu6")
    cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1)]
    feats = []
    for c, s in cfg:
        x = _dw_sep(b, x, c, s=s)
    feats.append(x)                                   # 19x19x512
    x = _dw_sep(b, x, 1024, s=2)
    x = _dw_sep(b, x, 1024, s=1)
    feats.append(x)                                   # 10x10x1024
    for c in (256, 256, 128, 128):                    # extra feature layers
        x = b.conv(x, c // 2, k=1, act="relu6")
        x = b.conv(x, c, k=3, s=2, act="relu6")
        feats.append(x)
    _ssd_heads(b, feats, anchors=[3, 6, 6, 6, 6, 6])
    return b.build(), b


def mobilenet_v2_ssd(res: int = 300) -> Tuple[Graph, GraphBuilder]:
    """MobileNetV2 + SSDLite (dw-separable heads and extras)."""
    b = GraphBuilder("mobilenet_v2_ssd")
    x = b.input((res, res, 3))
    x = b.conv(x, 32, k=3, s=2, act="relu6")
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1)]
    feats = []
    for t, c, n, s in cfg:
        for i in range(n):
            in_c = b.g.tensors[x].hwc[2]
            x = _inv_res(b, x, exp=in_c * t, out_c=c, s=s if i == 0 else 1)
    # expansion of the first 160-block is SSD feature 1 (19x19x576)
    f1 = b.conv(x, 576, k=1, act="relu6")
    feats.append(f1)
    h = b.dwconv(f1, k=3, s=2, act="relu6")
    x = b.conv(h, 160, k=1, act="none")
    for i in range(2):
        x = _inv_res(b, x, exp=960, out_c=160, s=1)
    x = _inv_res(b, x, exp=960, out_c=320, s=1)
    x = b.conv(x, 1280, k=1, act="relu6")
    feats.append(x)                                   # 10x10x1280
    for c in (512, 256, 256, 128):
        h = b.conv(x, c // 2, k=1, act="relu6")
        h = b.dwconv(h, k=3, s=2, act="relu6")
        x = b.conv(h, c, k=1, act="relu6")
        feats.append(x)
    _ssd_heads(b, feats, anchors=[3, 6, 6, 6, 6, 6], lite=True)
    return b.build(), b


# --------------------------------------------------------------------------
# EfficientDet-Lite0
# --------------------------------------------------------------------------


def _bifpn_fuse(b: GraphBuilder, xs: List[str], act: str = "relu6") -> str:
    y = xs[0]
    for x in xs[1:]:
        y = b.add(y, x)
    y = b.dwconv(y, k=3, act=act)
    return b.conv(y, b.g.tensors[y].hwc[2], k=1, act="none")


def efficientdet_lite0(res: int = 320) -> Tuple[Graph, GraphBuilder]:
    b = GraphBuilder("efficientdet_lite0")
    x = b.input((res, res, 3))
    x = b.conv(x, 32, k=3, s=2, act="relu6")
    cfg = [(1, 3, 16, 1, 1), (6, 3, 24, 2, 2), (6, 5, 40, 2, 2),
           (6, 3, 80, 3, 2), (6, 5, 112, 3, 1), (6, 5, 192, 4, 2),
           (6, 3, 320, 1, 1)]
    taps = {}
    for bi, (t, k, c, n, s) in enumerate(cfg):
        for i in range(n):
            in_c = b.g.tensors[x].hwc[2]
            x = _inv_res(b, x, exp=in_c * t, out_c=c,
                         s=s if i == 0 else 1, k=k)
        taps[bi] = x
    W = 64                                            # BiFPN width (lite0)
    p3 = b.conv(taps[2], W, k=1)                      # 40x40
    p4 = b.conv(taps[4], W, k=1)                      # 20x20
    p5 = b.conv(taps[6], W, k=1)                      # 10x10
    p6 = b.maxpool(b.conv(taps[6], W, k=1), k=3, s=2, pad="same")  # 5x5
    p7 = b.maxpool(p6, k=3, s=2, pad="same")          # 3x3
    levels = [p3, p4, p5, p6, p7]
    for _ in range(3):                                # BiFPN repeats
        # top-down
        td = [levels[-1]]
        for i in range(len(levels) - 2, -1, -1):
            up = b.resize(td[-1], 2)
            h, w, _ = b.g.tensors[levels[i]].hwc
            uh, uw, _ = b.g.tensors[up].hwc
            if (uh, uw) != (h, w):                    # odd-size crop via pool
                up = b.maxpool(up, k=(uh - h + 1), s=1, pad="valid")
            td.append(_bifpn_fuse(b, [levels[i], up]))
        td = td[::-1]
        # bottom-up
        out = [td[0]]
        for i in range(1, len(levels)):
            down = b.maxpool(out[-1], k=3, s=2, pad="same")
            ins = [td[i], down] + ([levels[i]] if i < len(levels) - 1 else [])
            out.append(_bifpn_fuse(b, ins))
        levels = out
    # class / box nets: 3 dw-sep convs + head, shared structure per level
    n_anchor, n_cls = 9, 90
    for lv in levels:
        h = lv
        for _ in range(3):
            h = b.dwconv(h, k=3, act="relu6")
            h = b.conv(h, W, k=1, act="none")
        b.mark_output(b.conv(b.dwconv(h, k=3), n_anchor * n_cls, k=1))
        h2 = lv
        for _ in range(3):
            h2 = b.dwconv(h2, k=3, act="relu6")
            h2 = b.conv(h2, W, k=1, act="none")
        b.mark_output(b.conv(b.dwconv(h2, k=3), n_anchor * 4, k=1))
    return b.build(), b


# --------------------------------------------------------------------------
# YOLOv8
# --------------------------------------------------------------------------


def _yolov8(name: str, width: float, depth: float, res: int,
            seg: bool = False) -> Tuple[Graph, GraphBuilder]:
    b = GraphBuilder(name)

    def W(c):
        return max(8, int(round(c * width / 8)) * 8)

    def D(n):
        return max(1, round(n * depth))

    x = b.input((res, res, 3))
    x = _cbs(b, x, W(64), k=3, s=2)                   # P1
    x = _cbs(b, x, W(128), k=3, s=2)                  # P2
    x = _c2f(b, x, W(128), D(3))
    x = _cbs(b, x, W(256), k=3, s=2)                  # P3
    p3 = _c2f(b, x, W(256), D(6))
    x = _cbs(b, p3, W(512), k=3, s=2)                 # P4
    p4 = _c2f(b, x, W(512), D(6))
    x = _cbs(b, p4, W(1024), k=3, s=2)                # P5
    x = _c2f(b, x, W(1024), D(3))
    p5 = _sppf(b, x, W(1024))
    # PAN-FPN neck
    u = b.resize(p5, 2)
    n4 = _c2f(b, b.concat([u, p4]), W(512), D(3), shortcut=False)
    u = b.resize(n4, 2)
    n3 = _c2f(b, b.concat([u, p3]), W(256), D(3), shortcut=False)   # out P3
    d = _cbs(b, n3, W(256), k=3, s=2)
    n4o = _c2f(b, b.concat([d, n4]), W(512), D(3), shortcut=False)  # out P4
    d = _cbs(b, n4o, W(512), k=3, s=2)
    n5o = _c2f(b, b.concat([d, p5]), W(1024), D(3), shortcut=False)  # out P5
    outs = [n3, n4o, n5o]
    # detect head
    nc, reg = 80, 16
    c2 = max(16, W(256) // 4, reg * 4)
    c3 = max(W(256), min(nc, 100))
    for f in outs:
        h = _cbs(b, f, c2, k=3)
        h = _cbs(b, h, c2, k=3)
        b.mark_output(b.conv(h, 4 * reg, k=1))
        h = _cbs(b, f, c3, k=3)
        h = _cbs(b, h, c3, k=3)
        b.mark_output(b.conv(h, nc, k=1))
    if seg:
        nm = 32
        c4 = max(W(256) // 4, nm)
        for f in outs:                                # mask coefficients
            h = _cbs(b, f, c4, k=3)
            h = _cbs(b, h, c4, k=3)
            b.mark_output(b.conv(h, nm, k=1))
        # proto net on P3
        cp = max(W(256), nm * 2)
        h = _cbs(b, n3, cp, k=3)
        h = b.resize(h, 2)
        h = _cbs(b, h, cp, k=3)
        b.mark_output(_cbs(b, h, nm, k=1))
    return b.build(), b


def yolov8n_det(res: int = 640) -> Tuple[Graph, GraphBuilder]:
    return _yolov8("yolov8n_det", width=0.25, depth=1 / 3, res=res)


def yolov8n_seg(res: int = 640) -> Tuple[Graph, GraphBuilder]:
    return _yolov8("yolov8n_seg", width=0.25, depth=1 / 3, res=res,
                   seg=True)


def yolov8s_det(res: int = 640) -> Tuple[Graph, GraphBuilder]:
    return _yolov8("yolov8s_det", width=0.50, depth=1 / 3, res=res)


# --------------------------------------------------------------------------
# DAMO-YOLO-NL class model (CSP backbone + GFPN-style neck, ZeroHead)
# --------------------------------------------------------------------------


def damo_yolo_nl(res: int = 640) -> Tuple[Graph, GraphBuilder]:
    """DAMO-YOLO Nano-Large class: TinyNAS-style light CSP backbone with a
    parameter-heavy (but low-resolution) RepGFPN neck and ZeroHead — the
    published Nl operating point is 3.05 GMACs / 5.69 M params @640."""
    b = GraphBuilder("damo_yolo_nl")
    x = b.input((res, res, 3))
    x = _cbs(b, x, 12, k=3, s=2)
    x = _cbs(b, x, 24, k=3, s=2)
    x = _c2f(b, x, 24, 1)
    x = _cbs(b, x, 48, k=3, s=2)
    p3 = _c2f(b, x, 48, 2)                            # 80x80x48
    x = _cbs(b, p3, 96, k=3, s=2)
    p4 = _c2f(b, x, 96, 2)                            # 40x40x96
    x = _cbs(b, p4, 192, k=3, s=2)
    x = _c2f(b, x, 192, 1)
    p5 = _sppf(b, x, 192)                             # 20x20x192
    # RepGFPN-style neck: params concentrated at low-res fused scales
    u = b.resize(p5, 2)
    m4 = _c2f(b, b.concat([u, p4]), 128, 1, shortcut=False)
    u = b.resize(m4, 2)
    m3 = _c2f(b, b.concat([u, p3]), 64, 1, shortcut=False)   # 80x80x64
    d = _cbs(b, m3, 128, k=3, s=2)
    m4o = _c2f(b, b.concat([d, m4, p4]), 160, 1, shortcut=False)
    d = _cbs(b, m4o, 256, k=3, s=2)
    m5o = _c2f(b, b.concat([d, p5]), 512, 2, shortcut=False)  # 20x20x512
    # ZeroHead: 1x1 projection + predictors per scale
    nc, reg = 80, 16
    for f, c in [(m3, 64), (m4o, 128), (m5o, 256)]:
        h = _cbs(b, f, c, k=1)
        b.mark_output(b.conv(h, 4 * reg, k=1))
        b.mark_output(b.conv(h, nc, k=1))
    return b.build(), b


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

#: name -> (builder, native resolution, Table-IV GMACs, Table-IV Mparams)
VISION_MODELS: Dict[str, Tuple[Callable[..., Tuple[Graph, GraphBuilder]],
                               int, float, float]] = {
    "mobilenet_v1": (mobilenet_v1, 224, 0.57, 4.2),
    "mobilenet_v2": (mobilenet_v2, 224, 0.30, 3.4),
    "mobilenet_v3_min": (mobilenet_v3_min, 224, 0.21, 3.9),
    "resnet50_v1": (resnet50_v1, 224, 2.0, 25.6),
    "efficientnet_lite0": (efficientnet_lite0, 224, 0.41, 4.7),
    "efficientdet_lite0": (efficientdet_lite0, 320, 1.27, 3.9),
    "yolov8n_det": (yolov8n_det, 640, 4.35, 3.2),
    "yolov8s_det": (yolov8s_det, 640, 14.3, 11.2),
    "yolov8n_seg": (yolov8n_seg, 640, 6.3, 3.4),
    "mobilenet_v1_ssd": (mobilenet_v1_ssd, 300, 1.3, 5.1),
    "mobilenet_v2_ssd": (mobilenet_v2_ssd, 300, 0.8, 4.3),
    "damo_yolo_nl": (damo_yolo_nl, 640, 3.0, 5.7),
}


#: (name, resolution) -> pristine (graph, builder) template.  Templates
#: are never handed out (callers mutate graphs: PTQ dtype/qparams
#: annotation, mark_output) — build() returns structural clones sharing
#: only the read-only weight arrays.
_BUILD_CACHE: Dict[Tuple[str, int], Tuple[Graph, GraphBuilder]] = {}


def _clone_graph(g: Graph) -> Graph:
    ng = Graph(g.name)
    for t in g.tensors.values():
        ng.tensors[t.name] = Tensor(t.name, t.shape, t.kind, t.dtype,
                                    t.producer, list(t.consumers),
                                    t.scale, t.qparams)
    for op in g.ops:
        nop = Op(op.name, op.kind, list(op.inputs), list(op.outputs),
                 dict(op.attrs))
        ng.ops.append(nop)
        ng._op_index[nop.name] = nop
    return ng


def _clone_built(tpl: Tuple[Graph, GraphBuilder]
                 ) -> Tuple[Graph, GraphBuilder]:
    g, b = tpl
    ng = _clone_graph(g)
    nb = GraphBuilder.__new__(GraphBuilder)
    nb.g = ng
    nb._ctr = b._ctr
    # replicate the template rng's advanced state so building further
    # ops on a clone draws the same weights the memo=False path would
    nb._rng = np.random.default_rng(0)
    nb._rng.bit_generator.state = b._rng.bit_generator.state
    nb._weights = dict(b._weights)    # arrays shared, treated read-only
    return ng, nb


def build_cache_clear() -> None:
    _BUILD_CACHE.clear()


def build(name: str, res_scale: float = 1.0, memo: bool = True
          ) -> Tuple[Graph, GraphBuilder]:
    fn, res, _, _ = VISION_MODELS[name]
    r = int(res * res_scale)
    r = max(32, (r // 32) * 32)                       # keep strides clean
    if not memo:
        return fn(r)
    key = (name, r)
    tpl = _BUILD_CACHE.get(key)
    if tpl is None:
        tpl = _BUILD_CACHE[key] = fn(r)
    return _clone_built(tpl)


def build_quantized(name: str, res_scale: float = 1.0, samples: int = 4,
                    method: str = "minmax", percentile: float = 99.9,
                    weight_dtype: str = "int8", seed: int = 0):
    """Build + calibrate + PTQ-quantize one benchmark model.

    Calibration uses `samples` synthetic normal inputs (the graphs carry
    deterministic pseudo-random weights, so synthetic activations
    exercise the same dynamic range a real input pipeline would here).
    Returns ``(graph, builder, QuantizedModel)`` — the graph is the
    quantized (annotated) one."""
    from repro_torch import quant

    g, b = build(name, res_scale=res_scale)
    cal = quant.synthetic_calibration(g, samples=samples, seed=seed)
    calib = quant.calibrate(g, b._weights, cal, method=method,
                            percentile=percentile)
    qm = quant.quantize_graph(g, b._weights, calib,
                              weight_dtype=weight_dtype)
    quant.measure_quant_error(qm, cal)   # basis of the calibrated tol
    return g, b, qm


def table4_targets(name: str) -> Tuple[float, float]:
    _, _, gmacs, mparams = VISION_MODELS[name]
    return gmacs, mparams
