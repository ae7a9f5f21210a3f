"""Vision serving entry point of the port: the int8 plan replay.

    PYTHONPATH=src python -m repro_torch.launch.serve_vision \
        --name mobilenet_v2 --batch 8

Build one model of the vision suite (``frontends/vision.py``, weights
drawn from the seed), calibrate it on synthetic inputs and quantize it
on the host (int8 per-tensor activations, per-channel int8 or int4
weights), lower the plan onto the device, and replay a batch of images
drawn from the seed.  Every conv and fc runs on the hand-written K1
kernel.  Runs on CUDA unless ``--device`` says otherwise; without a GPU
and without ``--device`` it raises.  ``--profile`` then prints one JSON
line: wall and device-busy ms per warm replay, the device's idle share,
K1's device ms and the top kernels.

This is the plan replay alone, without the compiler: the int8 lowering
reads no program.  The product path, ``repro_torch.api.compile(name,
precision="int8")`` followed by ``CompiledModel.__call__``, runs the
same PTQ and the same plan after compiling the program for the modeled
NPU, and adds its artifact (``save``/``load``) and the host interpreter
(``verify``).
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.execplan import ExecPlan, lower_plan
from repro_torch.core.ir import Graph, reference_execute
from repro_torch.frontends import vision
from repro_torch.kernels import neutron_matmul as _k1
from repro_torch.quant import QuantizedModel, QuantSemantics


@dataclass
class VisionServed:
    name: str
    graph: Graph                         # the quantized graph
    qm: QuantizedModel
    plan: ExecPlan
    images: np.ndarray                   # (batch, H, W, C) float32
    outputs: Dict[str, torch.Tensor]     # decoded (batch, ...) on device
    stored: Dict[str, torch.Tensor]      # stored ints (batch, ...)
    ptq_s: float                         # build + calibrate + quantize
    lower_s: float                       # plan lowering onto the device
    replays: int                         # replays run, the first counted
    replay_ms: float                     # median of the warm replays
    images_s: float                      # batch / replay time
    k1_launches: int                     # K1 launches in the first replay

    @property
    def arena_bytes(self) -> int:
        """Bytes of the device arena (all ``capacity`` rows)."""
        return int(self.plan.arena_bytes * self.plan.capacity)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_vision(name: str, batch: int, res_scale: float = 1.0,
                 weight_dtype: str = "int8", device=None, seed: int = 0,
                 capacity: Optional[int] = None, repeats: int = 3,
                 quiet: bool = False) -> VisionServed:
    """Quantize ``name`` on the host, lower its int8 plan (``capacity``
    requests, default ``batch``) onto the device and replay ``batch``
    images ``1 + repeats`` times: the first replay counts the K1
    launches, the warm ones are timed (host clock around a device
    synchronize)."""
    device = resolve_device(device)
    t0 = time.monotonic()
    g, _, qm = vision.build_quantized(name, res_scale=res_scale,
                                      weight_dtype=weight_dtype, seed=seed)
    ptq_s = time.monotonic() - t0

    t0 = time.monotonic()
    plan = lower_plan(None, g, None, qm.weights_f, QuantSemantics(qm),
                      capacity=capacity or batch, device=device)
    _synchronize(device)
    lower_s = time.monotonic() - t0

    inp = g.inputs[0]
    images = np.random.default_rng(seed + 1).normal(
        size=(batch,) + inp.shape).astype(np.float32)
    feed = {inp.name: images}
    n0 = _k1.launches
    stored = plan.run(feed, n=batch, decode=False)
    _synchronize(device)
    k1 = _k1.launches - n0
    times, outputs = [], None
    for _ in range(repeats):
        t0 = time.monotonic()
        outputs = plan.run(feed, n=batch)
        _synchronize(device)
        times.append(time.monotonic() - t0)
    replay_s = statistics.median(times) if times else float("nan")
    if outputs is None:
        outputs = {k: plan.semantics.decode(k, v) for k, v in stored.items()}
    served = VisionServed(name, g, qm, plan, images, outputs, stored, ptq_s,
                          lower_s, 1 + repeats, replay_s * 1e3,
                          batch / replay_s, k1)
    if not quiet:
        print(f"{name} {inp.shape} int8 ({weight_dtype} weights) on "
              f"{device}: PTQ {ptq_s:.2f} s, lowering {lower_s:.2f} s, "
              f"arena {served.arena_bytes} B")
        print(f"replay of {batch} images: {served.replay_ms:.3f} ms "
              f"({served.images_s:.1f} images/s), {len(plan.steps)} "
              f"lowered kernels (one per op) per replay, K1 launched {k1} "
              f"times")
    return served


def float_errors(served: VisionServed) -> Dict[str, tuple]:
    """Per model output: (max |decoded - float32 oracle|, the calibrated
    ``float_tolerance``, max |oracle|), over the served batch.  The oracle
    is the port's float reference executor (numpy, host) on the float
    weights; the error over max |oracle| is what says how close the band
    is where random weights let the outputs grow large."""
    sem = served.plan.semantics
    out = {}
    for name, dec in served.outputs.items():
        dec = dec.float().cpu().numpy()
        err = scale = 0.0
        for b, img in enumerate(served.images):
            ref = reference_execute(
                served.graph, {served.graph.inputs[0].name: img},
                served.qm.weights_f)[name]
            err = max(err, float(np.max(np.abs(dec[b] - ref))))
            scale = max(scale, float(np.max(np.abs(ref))))
        out[name] = (err, sem.float_tolerance(name), scale)
    return out


def profile_replay(served: VisionServed, replays: int = 3) -> dict:
    """Where a warm replay of the served batch spends its time: wall ms
    per replay on the host clock, then as many replays again under
    ``torch.profiler`` with the device time of every kernel summed.
    On the CPU the device numbers are "not measured"."""
    plan, device = served.plan, served.plan.device
    feed = {served.graph.inputs[0].name: served.images}
    n = len(served.images)
    _synchronize(device)
    t0 = time.monotonic()
    for _ in range(replays):
        plan.run(feed, n=n)
    _synchronize(device)
    wall_ms = (time.monotonic() - t0) * 1e3 / replays
    out = {"name": served.name, "batch": n, "replays": replays,
           "device": str(device), "wall_ms_per_replay": wall_ms}
    if device.type != "cuda":
        out.update(device_busy_ms_per_replay="not measured",
                   idle_share="not measured")
        return out
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            plan.run(feed, n=n)
        _synchronize(device)
    by_name = collections.Counter()
    n_kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            n_kernels += 1
    busy_ms = sum(by_name.values()) / 1e3 / replays
    k1_ms = sum(us for name, us in by_name.items()
                if "neutron_matmul" in name) / 1e3 / replays
    out.update(device_name=torch.cuda.get_device_name(device),
               kernels_per_replay=n_kernels / replays,
               device_busy_ms_per_replay=busy_ms,
               k1_ms_per_replay=k1_ms,
               idle_share=1.0 - busy_ms / wall_ms,
               top_kernels_ms_per_replay=[
                   (name[:80], us / 1e3 / replays)
                   for name, us in by_name.most_common(8)])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", required=True,
                    choices=sorted(vision.VISION_MODELS))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--res-scale", type=float, default=1.0)
    ap.add_argument("--weight-dtype", default="int8",
                    choices=("int8", "int4"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--profile", action="store_true",
                    help="then profile warm replays (one JSON line)")
    args = ap.parse_args()
    served = serve_vision(args.name, args.batch, res_scale=args.res_scale,
                          weight_dtype=args.weight_dtype,
                          device=args.device, seed=args.seed)
    for name, (err, tol, scale) in float_errors(served).items():
        print(f"output {name}: max|decoded - float oracle| {err:.4g} "
              f"(calibrated tolerance {tol:.4g}; max|oracle| {scale:.4g})")
    if args.profile:
        print(json.dumps(profile_replay(served)))


if __name__ == "__main__":
    main()
