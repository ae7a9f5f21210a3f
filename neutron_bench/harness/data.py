"""The data the benchmark makes and hands to both sides: a configuration's
float weights and calibration images (from its ``weight_seed``), and a
run's request images (from ``--seed``), each drawn on the device with a
``torch.Generator`` in one call."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

#: the weight variance a layer's fan-in is scaled by: He et al. 2015's
#: 1 / E[f(z)^2] for a unit normal z, which keeps a layer's output at unit
#: variance (ReLU's E[f(z)^2] is 1/2; relu6 clips too rarely to differ;
#: 1 for the linear ones)
GAIN = {"relu": 2.0, "relu6": 2.0, "none": 1.0,
        # E[silu(z)^2] = 0.355776 (quadrature of z^2 sigmoid(z)^2 phi(z))
        "silu": 1 / 0.355776}
#: standard deviation of the folded biases
BIAS_STD = 0.05


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def draw_params(specs, seed: int, device: torch.device
                ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Float32 weights (outC, kh, kw, inC) and biases of every layer in
    ``specs`` (``reference.qnet.Layer``): one normal draw, each weight
    scaled by sqrt(gain / fan-in)."""
    sizes = [(int(np.prod(l.wshape)), l.wshape[0]) for l in specs]
    flat = torch.randn(sum(a + b for a, b in sizes), generator=generator(
        seed, device), device=device, dtype=torch.float32)
    out, o = {}, 0
    for layer, (nw, nb) in zip(specs, sizes):
        w = flat[o:o + nw].view(layer.wshape) \
            * math.sqrt(GAIN[layer.act] / layer.fan_in)
        b = flat[o + nw:o + nw + nb] * BIAS_STD
        out[layer.name] = (w, b)
        o += nw + nb
    return out


def draw_images(seed: int, n: int, resolution: int, device: torch.device,
                stream: int = 0) -> torch.Tensor:
    """``n`` images (n, H, W, 3) float32, standard normal, on ``device``.
    ``stream`` separates draws made from one seed."""
    g = generator(int(seed) * 7919 + stream, device)
    return torch.randn((n, resolution, resolution, 3), generator=g,
                       device=device, dtype=torch.float32)


def bind_params(graph, params: Dict, specs) -> Dict[str, np.ndarray]:
    """The program's weight arrays from the benchmark's layers: the
    graph's conv, dwconv and fc ops in build order take the layers in
    call order, each shape checked.  Returns {parameter name: float32
    array}."""
    ops = [op for op in graph.ops if op.kind in ("conv", "dwconv", "fc")]
    if len(ops) != len(specs):
        raise ValueError(f"{graph.name}: {len(ops)} weighted ops, the "
                         f"reference has {len(specs)} layers")
    out: Dict[str, np.ndarray] = {}
    for op, layer in zip(ops, specs):
        w, b = params[layer.name]
        wname = op.inputs[1]
        want = tuple(graph.tensors[wname].shape)
        if op.kind != layer.kind or want != tuple(w.shape):
            raise ValueError(f"{op.name}: {op.kind} {want} against layer "
                             f"{layer.name} {layer.kind} {tuple(w.shape)}")
        out[wname] = w.detach().cpu().numpy().astype(np.float32)
        if len(op.inputs) > 2:
            out[op.inputs[2]] = b.detach().cpu().numpy().astype(np.float32)
    return out


def image_order(seed: int, count: int, pool: int) -> np.ndarray:
    """Which pooled image each of ``count`` requests sends: every image
    equally often, in an order drawn from the seed."""
    rng = np.random.default_rng([int(seed), 1])
    reps = -(-count // pool)
    return np.concatenate([rng.permutation(pool) for _ in range(reps)])[
        :count]


def macs_per_image(forward, resolution: int) -> int:
    """Multiply-adds of one image through the weighted layers, from the
    layer shapes and the output sizes a spec run gives."""
    from neutron_bench.reference.qnet import Net

    class _Count(Net):
        def __init__(self):
            super().__init__("spec")
            self.macs = 0

        def _weighted(self, x, kind, out_c, k, s, act):
            y = super()._weighted(x, kind, out_c, k, s, act)
            layer = self.layers[-1]
            self.macs += int(np.prod(y.shape[2:])) * layer.wshape[0] \
                * layer.fan_in
            return y

    net = _Count()
    forward(net, torch.empty((1, resolution, resolution, 3), device="meta"))
    return net.macs
