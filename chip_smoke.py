#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (H100, sm_90a) and nvcc; imports no JAX.  Phases,
each of which ends the run with a nonzero exit and no result on failure:

1. the card's name and power limit, torch and CUDA versions, the build
   of every CUDA kernel from the sources in this checkout (ptxas
   registers and spills), and the count of tensor-core instructions
   (HMMA/HGMMA, IMMA/IGMMA) in each library's SASS, which must not be 0
   in any instance of the bf16 flash_attention and ssd_chunk kernels or
   of the int8 neutron_matmul kernel;
2. every kernel on the card against its plain PyTorch version, at the
   shapes each serving path gives it (bf16; int8 for K1 at the vision
   plans' shapes, compared for equality) and at small ragged cases (f32;
   K4 also bf16 with N, P not multiples of 16; K1 also in its Pallas
   contract: f32, bf16, int8 requant, per-channel scale), timed beside its
   plain version, one PyTorch library call for the same function where
   there is one (for K1 `torch._int_mm`, on zero-padded copies where its
   shape rules refuse the shape), and its bound.  `ms` and
   `library_ms` are device time: the CUDA kernels one call launches,
   from torch.profiler; `call_ms` (and `library_call_ms`, `plain_ms`)
   the host-plus-device time of one call between CUDA events;
3. minitron-4b served at full width (32 layers, d_model 3072) through
   ``serve``, then the full-sequence ``prefill`` on the same prompts;
4. zamba2-2.7b at full width (54 SSD layers, d_model 2560, the shared
   attention block 9 times), the same way;
5. mamba2-370m at full width (48 SSD layers, d_model 1024), the same
   way;
6. the int8 vision plan replay of mobilenet_v2 and resnet50_v1 at 224
   through ``serve_vision``: every conv and fc on K1 ``neutron_matmul``
   (exactly 36 and 54 launches per replay), the stored output integers
   equal to the port's plain path on the CPU (batch 1 and a ragged 5 in
   an 8-plan for mobilenet_v2, batch 1 for resnet50_v1; on a mismatch the
   first op whose integers differ is named), and the decoded outputs
   within the calibrated ``float_tolerance`` of the float32 oracle
   (printed beside max|oracle|, which random weights let grow huge);
7. granite-20b at full width (52 layers of MQA: 48 query heads over one
   kv head);
8. granite-moe-1b-a400m at full width (24 MoE layers, 32 experts top 8);
9. deepseek-v3-671b at full width with its depth (only) cut to 4 layers:
   3 dense MLA layers and one MLA layer with 256 experts and a shared
   one (K2 at D = 192, Dv = 128; K3 over 128 kv heads);
10. gemma3-27b at full width and depth (10 groups of 5 local layers,
   window 1024, and a global one, then 2 local layers), with a prompt of
   1040, so that K2 runs its window at S > 1024 and the local layers'
   rings wrap in the decode replay.

For the two SSM paths the prefill-vs-replay agreement is held in
float32 at full width (TF32 off) and reported in bf16, beside how far
bf16 moves each path's logits from float32 (see ``ZAMBA`` below).  The
MoE paths hold it at a capacity that drops nothing (see
``GRANITE_MOE``).

In phases 3-10 the weights are random from the seed.  Each path runs
with the launch counters set to 0 just before it and read just after,
and must launch each kernel exactly as often as its layers say.  The
decode replay and the prefill must agree at the last prompt position,
and a reduced config on the card must agree with the plain path on the
CPU (decode replay, greedy tokens and prefill).  Each phase prints its
wall time.

The last lines are the total wall time, the card's name and power
limit, one JSON line of kernel measurements (one row per kernel and
path), and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np

T0 = time.monotonic()
ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_S = 3.35e12       # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core rate
              "int8": 1979e12,      # dense tensor-core rate (K1's bound)
              "float32": 67e12}     # outside the tensor cores

SEED = 0
TOL = {"float32": (2e-3, 1e-3), "bfloat16": (2e-2, 2e-2)}


class ServingPath(NamedTuple):
    """A serving path at full width: its shapes, the launches of
    (flash_attention, flash_decode, ssd_chunk, neutron_matmul) that
    `serve` and `prefill` must make, the reduced config held against the
    CPU, and the limit on max|d|/max|logit| between prefill and the
    decode replay in bf16; with None, that comparison is held in float32
    at full width instead.  `layers` cuts the depth of the served model
    (None: full depth)."""
    arch: str
    batch: int
    prompt_len: int
    gen: int
    width: Tuple[int, int]
    serve: Tuple[int, int, int, int]
    prefill: Tuple[int, int, int, int]
    small: dict
    bf16_limit: Optional[float] = 5e-2
    layers: Optional[int] = None


# (layers, d_model) and launches follow the configs: minitron-4b runs K3 in
# each of 32 layers at every one of 116 steps and K2 once per layer in
# prefill; zamba2-2.7b runs its shared block (K2/K3) 9 times and K4 in each
# of 54 SSD layers; mamba2-370m runs K4 in each of 48 layers.  Serving
# replays the prompt through decode steps, which run no K2 or K4.
MINITRON = ServingPath("minitron-4b", 4, 100, 16, (32, 3072),
                       serve=(0, 32 * 116, 0, 0), prefill=(32, 0, 0, 0),
                       small=dict(n_heads=3, n_kv_heads=1, d_head=32,
                                  tp_pad=4))
# At 48-54 layers of random weights, bf16 rounding alone moves the logits
# by tens of percent of max|logit| (phases 4 and 5 print bf16 against
# float32), and the bf16 decode state is rounded at other places than the
# chunked scan's; so the two SSM paths hold prefill against the decode
# replay in float32 at full width, and report it in bf16.
ZAMBA = ServingPath("zamba2-2.7b", 4, 200, 16, (54, 2560),
                    serve=(0, 9 * 216, 0, 0), prefill=(9, 0, 54, 0),
                    small={},
                    bf16_limit=None)
MAMBA = ServingPath("mamba2-370m", 4, 200, 8, (48, 1024),
                    serve=(0, 0, 0, 0), prefill=(0, 0, 48, 0), small={},
                    bf16_limit=None)
# granite-20b: 52 layers of MQA (48 query heads over one kv head), K2 and
# K3 once per layer.
GRANITE = ServingPath("granite-20b", 4, 100, 16, (52, 6144),
                      serve=(0, 52 * 116, 0, 0), prefill=(52, 0, 0, 0),
                      small={})
# MoE: a prefill of T = 400 tokens and a decode step of T = 4 get other
# capacities (granite-moe at its factor 1.25: 125 against 2), so they drop
# other assignments, by the reference's design.  `serve` runs at the
# config's own factor and reports its drops; the prefill-vs-replay
# agreement runs at capacity_factor = n_experts / top_k, where cap >= T
# on both sides and nothing is dropped.  granite-moe: 24 MoE layers.
GRANITE_MOE = ServingPath("granite-moe-1b-a400m", 4, 100, 16, (24, 1024),
                          serve=(0, 24 * 116, 0, 0), prefill=(24, 0, 0, 0),
                          small={})
# deepseek-v3 whole is ~1.3 TB in bf16; its depth (only) is cut to 4
# layers: 3 dense MLA layers, then 1 MLA layer with 256 routed experts
# (top 8) and a shared expert, as moe_layer_start = 3 lays them out; no
# mtp block (training only).  MLA runs K2 at D = 192, Dv = 128 and K3
# over H = Hkv = 128.
DEEPSEEK = ServingPath("deepseek-v3-671b", 4, 100, 8, (4, 7168),
                       serve=(0, 4 * 108, 0, 0), prefill=(4, 0, 0, 0),
                       small={}, layers=4)
# gemma3-27b: 10 groups of 5 local layers (window 1024) and 1 global, then
# 2 local layers; a prompt of 1040 runs K2's window at S > 1024 and wraps
# the local layers' rings in the decode replay.
GEMMA = ServingPath("gemma3-27b", 4, 1040, 8, (62, 5376),
                    serve=(0, 62 * 1048, 0, 0), prefill=(62, 0, 0, 0),
                    small={})
LM_PATHS = (MINITRON, ZAMBA, MAMBA, GRANITE, GRANITE_MOE, DEEPSEEK, GEMMA)


class AttnShape(NamedTuple):
    """One shape at which a path runs K2 (a prefill layer's q, k, v) or K3
    (a decode step's q against the cache at the last step, kv_len = S),
    and how many launches of the path's drive (serve, then prefill) the
    config says it takes; the run counts them under the wrapper's
    ``shape_key``."""
    tag: str
    B: int
    H: int
    Hkv: int
    S: int
    D: int
    Dv: int
    window: Optional[int]
    launches: int


def attention_shapes(path: ServingPath, cfg):
    """(K2 shapes, K3 shapes) of `path`, from its config (depth cut to
    path.layers)."""
    B, P, S = path.batch, path.prompt_len, path.prompt_len + path.gen
    L = path.layers or cfg.n_layers
    if cfg.family == "ssm":
        return [], []
    if cfg.mla:
        D, Dv = cfg.d_nope + cfg.d_rope, cfg.d_v
        H = Hkv = cfg.n_heads
        return ([AttnShape(path.arch, B, H, Hkv, P, D, Dv, None, L)],
                [AttnShape(path.arch, B, H, Hkv, S, D, Dv, None, L * S)])
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Hp = cfg.padded_heads
    # prefill expands the kv heads to the padded query heads (group 1)
    H2, Hkv2 = (Hp, Hp) if Hp != H else (H, Hkv)
    if cfg.local_global_ratio:
        R = cfg.local_global_ratio
        G = L // (R + 1)
        n_local = L - G
        W = cfg.sliding_window
        return ([AttnShape(f"{path.arch} local", B, H2, Hkv2, P, hd, hd, W,
                           n_local),
                 AttnShape(f"{path.arch} global", B, H2, Hkv2, P, hd, hd,
                           None, G)],
                [AttnShape(f"{path.arch} local ring", B, H, Hkv, min(W, S),
                           hd, hd, None, n_local * S),
                 AttnShape(f"{path.arch} global", B, H, Hkv, S, hd, hd, None,
                           G * S)])
    n = L // cfg.shared_attn_every if cfg.family == "hybrid" else L
    return ([AttnShape(path.arch, B, H2, Hkv2, P, hd, hd, None, n)],
            [AttnShape(path.arch, B, H, Hkv, S, hd, hd, None, n * S)])


class VisionPath(NamedTuple):
    """An int8 vision plan at 224: K1 launches per replay (one per conv
    and fc) and the batches held against the plain path on the CPU."""
    name: str
    k1_per_replay: int
    cpu_batches: Tuple[int, ...]


# mobilenet_v2: 35 conv + 1 fc; resnet50_v1: 53 conv + 1 fc
MOBILENET = VisionPath("mobilenet_v2", 36, (1, 5))
RESNET = VisionPath("resnet50_v1", 54, (1,))
VISION_BATCH = 8


class K1Shape(NamedTuple):
    """One of K1's GEMMs on a vision path: output rows per image, K, N
    and the activation of its epilogue."""
    path: str
    what: str
    rows: int
    K: int
    N: int
    act: str


K1_SHAPES = (
    K1Shape("mobilenet_v2", "stem 3x3/2 conv (im2col)", 112 * 112, 27, 32,
            "relu6"),
    K1Shape("mobilenet_v2", "last 1x1 conv", 7 * 7, 320, 1280, "relu6"),
    K1Shape("mobilenet_v2", "fc", 1, 1280, 1000, "none"),
    K1Shape("resnet50_v1", "stem 7x7/2 conv (im2col)", 112 * 112, 147, 64,
            "relu"),
    K1Shape("resnet50_v1", "3x3 conv (im2col)", 56 * 56, 576, 64, "relu"),
    K1Shape("resnet50_v1", "fc", 1, 2048, 1000, "none"),
)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------


_FLUSH = []


def _flush(torch):
    """A 64 MB buffer: writing all of it evicts the 50 MB L2 cache (the
    serving path finds it cold: every layer has its own weights and
    cache)."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(64 << 20, dtype=torch.uint8, device="cuda"))
    return _FLUSH[0]


def call_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Median host-plus-device time of one call of `fn` over `iters`
    calls, between two CUDA events, the L2 flushed before each: where
    the host takes longer to enqueue the call than the flush takes to
    run, the enqueue lands in the reading."""
    flush = _flush(torch)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, iters: int = 30, warmup: int = 3,
              attempts: int = 3) -> float:
    """Median over `iters` calls of the device time of the CUDA kernels
    one call of `fn` launches (their durations summed), from
    torch.profiler's kernel events, the L2 flushed before each call.
    The flush is a bitwise_not of the 64 MB buffer, a kernel that no
    timed call launches: in the device's order of kernels on the stream,
    each flush starts the next call's kernels, and is not counted.  A
    profiling session whose events are incomplete (the profiler has been
    seen to return none in a process's first session, or to drop the
    first flush) is run again, up to `attempts` sessions."""
    from torch.profiler import ProfilerActivity, profile
    flush = _flush(torch)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # one call more than is counted: the kernels before the
            # second flush are discarded
            for _ in range(iters + 1):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        kernels = sorted(
            (e.time_range.start, e.name, e.time_range.elapsed_us())
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("Memcpy", "Memset")))
        per_call = []
        for _, name, us in kernels:
            if "bitwise_not" in name:
                per_call.append([])
            elif per_call:
                per_call[-1].append(us)
        per_call = per_call[-iters:]
        if len(per_call) == iters and all(per_call) and \
                len({len(k) for k in per_call}) == 1:
            return statistics.median(sum(k) for k in per_call) / 1e3
    fail(f"the profiler saw {len(per_call)} of {iters} calls in each of "
         f"{attempts} sessions, the last with {[len(k) for k in per_call]} "
         f"kernels after each flush; the first: "
         f"{[n[:60] for _, n, _ in kernels[:4]]}")


def timings(torch, kernel, plain, library=None) -> dict:
    """A kernel row's times: the kernel's device time (`ms`) and call time
    (`call_ms`), the plain version's call time (`plain_ms`) and, where one
    PyTorch call computes the same function, its device and call times."""
    return dict(ms=device_ms(torch, kernel), call_ms=call_ms(torch, kernel),
                plain_ms=call_ms(torch, plain),
                library_ms=None if library is None
                else device_ms(torch, library),
                library_call_ms=None if library is None
                else call_ms(torch, library))


def bound(nbytes: int, flops: int, dtype: str):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# The kernels whose every instance must carry tensor-core instructions of
# the given kinds: (library, mangled-name part, mnemonics, what it is).
TENSOR_CORE_KERNELS = (
    ("flash_attention", "flash_attention_bf16_kernel", ("HMMA", "HGMMA"),
     "the bf16 flash_attention kernel"),
    ("neutron_matmul", "neutron_matmul_i8", ("IMMA", "IGMMA"),
     "the int8 neutron_matmul kernel"),
    ("ssd_chunk", "ssd_chunk_bf16_kernel", ("HMMA", "HGMMA"),
     "the bf16 ssd_chunk kernel"),
)


def phase_sass(_build) -> None:
    """Tensor-core instructions (HMMA/HGMMA, IMMA/IGMMA) in each library's
    SASS; every instance of the bf16 flash_attention and ssd_chunk kernels
    and of the int8 neutron_matmul kernel must have them."""
    counts = {name: _build.tensor_core_ops(name) for name in _build.SOURCES}
    for name, per_fn in counts.items():
        total = {op: sum(c[op] for c in per_fn.values())
                 for op in _build.TENSOR_CORE_OPS}
        print(f"  {name}: {total} tensor-core instructions in "
              f"{len(per_fn)} kernels")
    for name, part, ops, what in TENSOR_CORE_KERNELS:
        found = [sum(c[op] for op in ops)
                 for fn, c in counts[name].items() if part in fn]
        print(f"  {what}: {'/'.join(ops)} per instance {sorted(found)}")
        if not found or not all(found):
            fail(f"{what} has no {'/'.join(ops)} instruction in its SASS")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def check_close(torch, name, got, want, dtype) -> float:
    atol, rtol = TOL[dtype]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    bad = err > atol + rtol * want.abs()
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements off; max |err| "
             f"{float(err.max()):.3g} (atol {atol}, rtol {rtol})")
    return float(err.max())


def ssd_inputs(torch, randn, B, S, H, P, N, dtype, pad=0):
    """K4's inputs as ssm_block gives them: dt in (0.001, 0.1], A < 0, and
    the last `pad` rows zero, as ops.ssd_scan pads a prompt."""
    x, Bm, Cm = (randn(B, S, H, P, dtype=dtype), randn(B, S, N, dtype=dtype),
                 randn(B, S, N, dtype=dtype))
    dt = randn(B, S, H, dtype=torch.float32).abs() * 0.05 + 1e-3
    A = -(randn(H, dtype=torch.float32).abs() + 0.5)
    for t in (x, dt, Bm, Cm):
        t[:, S - pad:] = 0
    return x, dt, A, Bm, Cm


def ssd_flops(B, S, H, P, N, L) -> int:
    """Operations of one ssd_chunk call: per (b, chunk, head) the products
    C.B over s <= t, scores @ x over s <= t, and (w x)^T @ B."""
    tri = L * (L + 1) // 2
    return B * (S // L) * H * (tri * 2 * N + tri * 2 * P + 2 * L * P * N)


def causal_pairs(S: int, window: Optional[int]) -> int:
    """(query, key) pairs a causal attention over S positions scores, each
    query seeing at most `window` keys (itself included)."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


PROBE_EVERY = 256


def k2_boundary_probe(torch, ops, randn, a: AttnShape, S: int) -> float:
    """K2 at a's head shape over S positions, on inputs that make each
    causal and window bound decisive: k = 0, so every key a query sees
    gets the same weight 1/n, and v = 0 except at one key in every
    PROBE_EVERY, where it is c = (a.window or S).  A query that sees its
    full window gets (markers it sees) exactly; a bound one key off moves
    a query at a marker's edge by about 1, far above the bf16 tolerance.
    Held against the plain version."""
    q = randn(a.B, a.H, S, a.D)
    k = torch.zeros((a.B, a.Hkv, S, a.D), dtype=q.dtype, device="cuda")
    v = torch.zeros((a.B, a.Hkv, S, a.Dv), dtype=q.dtype, device="cuda")
    v[:, :, ::PROBE_EVERY] = a.window or S
    return check_close(
        torch, f"flash_attention bf16 {a.tag} boundary probe S={S}",
        ops.flash_attention(q, k, v, causal=True, window=a.window),
        ops.flash_attention(q, k, v, causal=True, window=a.window,
                            impl="ref"), "bfloat16")


def k3_boundary_probe(torch, ops, randn, a: AttnShape) -> float:
    """K3 at a's shape with kv_len (S, S-1, S//2 + 1, 1, ...) over the
    lanes, on inputs that make kv_len decisive: k = 0, and v = 0 except
    1024 at each lane's last valid key and -2048 at the key after it.
    Every output is 1024 / kv_len; a kv_len one key off gives 0 or a
    negative value.  Held against the plain version."""
    q = randn(a.B, a.H, a.D)
    k = torch.zeros((a.B, a.Hkv, a.S, a.D), dtype=q.dtype, device="cuda")
    v = torch.zeros((a.B, a.Hkv, a.S, a.Dv), dtype=q.dtype, device="cuda")
    lens = [(a.S, a.S - 1, a.S // 2 + 1, 1)[b % 4] for b in range(a.B)]
    for b, n in enumerate(lens):
        v[b, :, n - 1] = 1024
        if n < a.S:
            v[b, :, n] = -2048
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = ops.flash_decode(q, k, v, kv_len=kv_len)
    want = torch.tensor([1024 / n for n in lens], device="cuda")
    check_close(torch, f"flash_decode bf16 {a.tag} kv_len probe {lens}",
                got, want[:, None, None].expand_as(got), "bfloat16")
    return check_close(
        torch, f"flash_decode bf16 {a.tag} kv_len probe {lens}", got,
        ops.flash_decode(q, k, v, kv_len=kv_len, impl="ref"), "bfloat16")


def k2_row(torch, F, ops, randn, a: AttnShape) -> dict:
    """K2 at a path's prefill shape (bf16, causal, a.window) against its
    plain version, timed beside SDPA on the same inputs (with the window
    as a boolean mask, made outside the timed call)."""
    from repro_torch.kernels import flash_attention
    q = randn(a.B, a.H, a.S, a.D)
    k, v = randn(a.B, a.Hkv, a.S, a.D), randn(a.B, a.Hkv, a.S, a.Dv)

    def kernel():
        return ops.flash_attention(q, k, v, causal=True, window=a.window)

    def plain():
        return ops.flash_attention(q, k, v, causal=True, window=a.window,
                                   impl="ref")

    got = kernel()
    err = check_close(torch, f"flash_attention bf16 {a.tag}", got, plain(),
                      "bfloat16")
    # the window also at S = 2100, where it hides half of the keys
    for S in (a.S,) + ((2100,) if a.window else ()):
        e = k2_boundary_probe(torch, ops, randn, a, S)
        print(f"  flash_attention [{a.tag}] boundary probe at S={S} "
              f"(k = 0, a marker in v every {PROBE_EVERY} keys): max|err| "
              f"{e:.3g}")
    if a.window is None:
        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
    else:
        i = torch.arange(a.S, device="cuda")
        d = i[:, None] - i[None, :]
        band = (d >= 0) & (d < a.window)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                                  enable_gqa=True)
    pairs = a.B * a.H * causal_pairs(a.S, a.window)
    b_ms, b_by = bound(nbytes(q, k, v, got), 2 * pairs * (a.D + a.Dv),
                       "bfloat16")
    win = "" if a.window is None else f", window {a.window}"
    return dict(
        name="flash_attention", path=a.tag, route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:116",
        shape=f"q ({a.B},{a.H},{a.S},{a.D}), k ({a.B},{a.Hkv},{a.S},"
              f"{a.D}), v Dv {a.Dv} bf16 causal{win}",
        key=flash_attention.shape_key(q, k, v, a.window), expect=a.launches,
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        **timings(torch, kernel, plain, library))


def k3_row(torch, F, ops, randn, a: AttnShape) -> dict:
    """K3 at a path's last decode step (the cache full: kv_len = S)
    against its plain version, timed beside SDPA on the same inputs."""
    from repro_torch.kernels import flash_decode
    q = randn(a.B, a.H, a.D)
    k, v = randn(a.B, a.Hkv, a.S, a.D), randn(a.B, a.Hkv, a.S, a.Dv)
    kv_len = torch.full((a.B,), a.S, dtype=torch.int32, device="cuda")

    def kernel():
        return ops.flash_decode(q, k, v, kv_len=kv_len)

    def plain():
        return ops.flash_decode(q, k, v, kv_len=kv_len, impl="ref")

    got = kernel()
    err = check_close(torch, f"flash_decode bf16 {a.tag}", got, plain(),
                      "bfloat16")
    e = k3_boundary_probe(torch, ops, randn, a)
    print(f"  flash_decode [{a.tag}] kv_len probe (k = 0, markers at the "
          f"last valid key and the one after): max|err| {e:.3g}")
    b_ms, b_by = bound(nbytes(q, k, v, kv_len, got),
                       2 * a.B * a.H * a.S * (a.D + a.Dv), "bfloat16")
    return dict(
        name="flash_decode", path=a.tag, route="cuda",
        source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:96",
        shape=f"q ({a.B},{a.H},{a.D}) x cache ({a.B},{a.Hkv},{a.S},"
              f"{a.D}), v Dv {a.Dv} bf16",
        key=flash_decode.shape_key(q, k, v), expect=a.launches,
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        **timings(torch, kernel, plain,
                  lambda: F.scaled_dot_product_attention(
                      q[:, :, None], k, v, enable_gqa=True)))


def phase_kernels(torch, F, ops):
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan
    from repro_torch.models.registry import get_arch

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # small cases (f32): ragged tails, GQA group > 1, window, Dv != D,
    # varied kv_len >= 1 (at 0 the kernel gives 0, the plain version the
    # mean of v)
    f32 = torch.float32
    for causal, window in ((True, None), (True, 16), (False, None)):
        q, k, v = (randn(2, 6, 77, 32, dtype=f32), randn(2, 2, 77, 32,
                   dtype=f32), randn(2, 2, 77, 24, dtype=f32))
        e = check_close(
            torch, f"flash_attention f32 causal={causal} window={window}",
            ops.flash_attention(q, k, v, causal=causal, window=window),
            ops.flash_attention(q, k, v, causal=causal, window=window,
                                impl="ref"), "float32")
        print(f"  flash_attention f32 (2,6,77,32)x(2,2,77,32|24) "
              f"causal={causal} window={window}: max|err| {e:.3g}")
    q, k, v = randn(3, 6, 32, dtype=f32), randn(3, 2, 77, 32, dtype=f32), \
        randn(3, 2, 77, 24, dtype=f32)
    kv_len = torch.tensor([1, 40, 77], dtype=torch.int32, device="cuda")
    o, lse = ops.flash_decode(q, k, v, kv_len=kv_len, return_lse=True)
    o_ref, lse_ref = ops.flash_decode(q, k, v, kv_len=kv_len,
                                      return_lse=True, impl="ref")
    e = max(check_close(torch, "flash_decode f32", o, o_ref, "float32"),
            check_close(torch, "flash_decode lse", lse, lse_ref, "float32"))
    print(f"  flash_decode f32 (3,6,32)x(3,2,77,32|24) kv_len [1,40,77] "
          f"+lse: max|err| {e:.3g}")

    # ssd_chunk (f32): the sweep of tests/test_kernels.py, zero padded
    # rows, H = 3 with N != P, the largest tile; in bf16 (the tensor-core
    # body, outputs f32) N and P not multiples of 16 and head groups of
    # 3 and 5; ops.ssd_scan at a ragged S
    for B, S, H, P, N, L, pad, dt in ((1, 32, 1, 8, 4, 8, 0, f32),
                                      (2, 128, 3, 16, 8, 32, 28, f32),
                                      (2, 96, 3, 24, 40, 32, 0, f32),
                                      (1, 256, 2, 128, 128, 128, 0, f32),
                                      (2, 96, 3, 24, 40, 32, 0,
                                       torch.bfloat16),
                                      (2, 128, 5, 24, 40, 32, 28,
                                       torch.bfloat16),
                                      (1, 256, 2, 128, 128, 128, 0,
                                       torch.bfloat16)):
        args = ssd_inputs(torch, randn, B, S, H, P, N, dt, pad)
        name = str(dt).replace("torch.", "")
        e = max(check_close(torch, f"ssd_chunk {name} {i}", g, w,
                            "float32")
                for i, (g, w) in enumerate(zip(
                    ssd_scan.ssd_chunk(*args, L),
                    ref.ssd_chunk_ref(*args, L))))
        print(f"  ssd_chunk {name} x ({B},{S},{H},{P}) N={N} chunk={L} "
              f"zero rows {pad}: max|err| {e:.3g}")
    for S, L in ((100, 32), (37, 16)):
        args = ssd_inputs(torch, randn, 2, S, 3, 16, 8, f32)
        s0 = randn(2, 3, 16, 8, dtype=f32)
        e = max(check_close(torch, "ssd_scan f32", g, w, "float32")
                for g, w in zip(ops.ssd_scan(*args, chunk=L, init_state=s0),
                                ops.ssd_scan(*args, chunk=L, init_state=s0,
                                             impl="ref")))
        print(f"  ops.ssd_scan f32 x (2,{S},3,16) N=8 chunk={L} with an "
              f"initial state: max|err| {e:.3g}")

    rows = {}
    # each path's shapes come from its config
    cfgs = {p.arch: get_arch(p.arch) for p in LM_PATHS}
    for path in LM_PATHS:
        k2_shapes, k3_shapes = attention_shapes(path, cfgs[path.arch])
        for a in k2_shapes:
            rows[("flash_attention", a.tag)] = k2_row(torch, F, ops, randn, a)
        for a in k3_shapes:
            rows[("flash_decode", a.tag)] = k3_row(torch, F, ops, randn, a)

    # ssd_chunk at the prefill shapes: the prompt of 200 padded to 256
    print("  ssd_chunk: library_ms is null; no single PyTorch call computes "
          "the gated intra-chunk SSD form with its state contributions")
    for path in (ZAMBA, MAMBA):
        cfg = cfgs[path.arch]
        B, L, P = path.batch, cfg.ssm_chunk, cfg.ssm_head_dim
        H, N = cfg.ssm_heads, cfg.ssm_state
        S = -(-path.prompt_len // L) * L
        args = ssd_inputs(torch, randn, B, S, H, P, N, torch.bfloat16,
                          pad=S - path.prompt_len)
        got = ssd_scan.ssd_chunk(*args, L)
        err = max(check_close(torch, f"ssd_chunk bf16 {path.arch} {i}",
                              g, w, "float32")
                  for i, (g, w) in enumerate(zip(
                      got, ref.ssd_chunk_ref(*args, L))))
        b_ms, b_by = bound(nbytes(*args, *got),
                           ssd_flops(B, S, H, P, N, L), "bfloat16")
        rows[("ssd_chunk", path.arch)] = dict(
            name="ssd_chunk", path=path.arch, route="cuda",
            source="src/repro_torch/csrc/ssd_chunk.cu",
            replaces="src/repro/kernels/ssd_scan.py:93",
            shape=f"x ({B},{S},{H},{P}) bf16, N={N}, chunk {L}, "
                  f"{S - path.prompt_len} zero rows",
            expect=path.prefill[2], max_abs_err=err, bound_ms=b_ms,
            bound_by=b_by,
            **timings(torch, lambda: ssd_scan.ssd_chunk(*args, L),
                      lambda: ref.ssd_chunk_ref(*args, L)))

    phase_k1(torch, ops, rows)

    for r in rows.values():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} (call {r['library_call_ms']:.4f})"
        print(f"  {r['name']} [{r['path']}] {r['shape']}: device "
              f"{r['ms']:.4f} ms, call {r['call_ms']:.4f} (plain "
              f"{r['plain_ms']:.4f}, library {lib}, bound "
              f"{r['bound_ms']:.5f} by {r['bound_by']}), max|err| "
              f"{r['max_abs_err']:.3g}")
    return rows


def int_mm(torch, x2, w):
    """``torch._int_mm`` (cuBLASLt int8 on the tensor cores: the product
    alone, no epilogue) on x2 (M,K) @ w^T, and what it is.  Where its
    shape rules (M > 16; K and N multiples of 8) refuse the shape, it runs
    on copies zero-padded to M >= 32 and K, N multiples of 8, made here,
    outside the timed call, and is labelled "padded"."""
    M, K = x2.shape
    N = w.shape[0]
    if M > 16 and K % 8 == 0 and N % 8 == 0:
        wt = w.t()
        return (lambda: torch._int_mm(x2, wt),
                "torch._int_mm, the product without the epilogue")
    Mp, Kp, Np = max(M, 32), -(-K // 8) * 8, -(-N // 8) * 8
    xp = torch.zeros((Mp, Kp), dtype=torch.int8, device=x2.device)
    wp = torch.zeros((Np, Kp), dtype=torch.int8, device=w.device)
    xp[:M, :K] = x2
    wp[:N, :K] = w
    wpt = wp.t()
    return (lambda: torch._int_mm(xp, wpt),
            f"torch._int_mm padded to ({Mp},{Kp}) x ({Kp},{Np}), the "
            f"product without the epilogue")


def phase_k1(torch, ops, rows):
    """K1 against its plain version: its Pallas contract at small ragged
    cases, then the plan contract at the vision paths' shapes (batch 8),
    where the int8 outputs must be equal."""
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def randint(lo, hi, *shape, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=dtype)

    for (M, K, N), dtype in (((8, 16, 8), "float32"),
                             ((100, 300, 70), "float32"),
                             ((33, 65, 129), "float32"),
                             ((128, 512, 128), "bfloat16")):
        dt = getattr(torch, dtype)
        x, w, b = randn(M, K, dtype=dt), randn(K, N, dtype=dt), randn(N)
        e = check_close(torch, f"neutron_matmul {dtype} ({M},{K},{N})",
                        ops.neutron_matmul(x, w, bias=b, scale=0.5,
                                           act="gelu"),
                        ops.neutron_matmul(x, w, bias=b, scale=0.5,
                                           act="gelu", impl="ref"), dtype)
        print(f"  neutron_matmul (Pallas contract) {dtype} ({M},{K})x"
              f"({K},{N}) scale, bias, gelu: max|err| {e:.3g}")
    x, w = randint(-128, 128, 64, 256), randint(-128, 128, 256, 96)
    got = ops.neutron_matmul(x, w, scale=0.02, act="relu", out_scale=0.7)
    if not torch.equal(got, ops.neutron_matmul(x, w, scale=0.02, act="relu",
                                               out_scale=0.7, impl="ref")):
        fail("neutron_matmul int8 requant differs from its plain version")
    x, w = randint(-64, 64, 16, 128), randint(-64, 64, 128, 32)
    sc = torch.rand(32, generator=gen, device="cuda") * 0.1 + 1e-3
    e = check_close(torch, "neutron_matmul per-channel scale",
                    ops.neutron_matmul(x, w, scale=sc),
                    ops.neutron_matmul(x, w, scale=sc, impl="ref"),
                    "float32")
    print(f"  neutron_matmul (Pallas contract) int8 (64,256)x(256,96) relu "
          f"requant: equal; per-channel scale (16,128)x(128,32): max|err| "
          f"{e:.3g}")

    B = VISION_BATCH
    for shp in K1_SHAPES:
        M = B * shp.rows
        x = randint(-128, 128, B, shp.rows, shp.K)
        w = randint(-127, 128, shp.N, shp.K)
        bias = randint(-20000, 20000, shp.N, dtype=torch.int32)
        # rescale so that act(y) spans a few units: outputs fill the grid
        sc = (torch.rand(shp.N, generator=gen, device="cuda") + 0.5) \
            * (2.0 / (math.sqrt(shp.K) * 5461))
        out = torch.empty((B, shp.rows, shp.N), dtype=torch.int8,
                          device="cuda")
        args = (x, w, bias, sc, shp.act, 0.05, -5, -128, 127)
        ops.neutron_matmul_plan(*args, out)
        want = ref.neutron_matmul_plan_ref(*args)
        err = int((out.int() - want.int()).abs().max())
        if err:
            fail(f"neutron_matmul {shp.path} {shp.what}: the int8 plan "
                 f"epilogue differs from its plain version by {err}")
        lib_fn, lib = int_mm(torch, x.view(M, shp.K), w)
        b_ms, b_by = bound(nbytes(x, w, bias, sc, out),
                           2 * M * shp.N * shp.K, "int8")
        rows[("neutron_matmul", f"{shp.path}: {shp.what}")] = dict(
            name="neutron_matmul", path=shp.path, route="cuda",
            source="src/repro_torch/csrc/neutron_matmul.cu",
            replaces="src/repro/kernels/neutron_matmul.py:137",
            shape=f"{shp.what}: x ({B},{shp.rows},{shp.K}) int8, w "
                  f"({shp.N},{shp.K}), {shp.act}, int8 plan epilogue "
                  f"(library: {lib})",
            max_abs_err=float(err), bound_ms=b_ms, bound_by=b_by,
            **timings(torch, lambda: ops.neutron_matmul_plan(*args, out),
                      lambda: ref.neutron_matmul_plan_ref(*args), lib_fn))


# --------------------------------------------------------------------------
# phases 3-5: the serving paths
# --------------------------------------------------------------------------


LAUNCH_NAMES = ("flash_attention", "flash_decode", "ssd_chunk",
                "neutron_matmul")


def launch_counters():
    from repro_torch.kernels import (flash_attention, flash_decode,
                                     neutron_matmul, ssd_scan)
    return (flash_attention, flash_decode, ssd_scan, neutron_matmul)


def reset_launches() -> None:
    for mod in launch_counters():
        mod.launches = 0
        if hasattr(mod, "launches_by_shape"):
            mod.launches_by_shape.clear()


def read_launches():
    return tuple(mod.launches for mod in launch_counters())


def read_launches_by_shape():
    """{kernel name: Counter of launches by the wrapper's shape key}, for
    the kernels whose wrappers count by shape (K2, K3)."""
    from collections import Counter
    return {name: Counter(mod.launches_by_shape)
            for name, mod in zip(LAUNCH_NAMES, launch_counters())
            if hasattr(mod, "launches_by_shape")}


def agreement(torch, replay, last):
    """max|d|/max|logit| between the decode replay's logits at the last
    prompt position and prefill's, and whether every lane's argmax is
    equal or its top two lie within 1e-2 * max|logit| (a near tie)."""
    a, b = replay.float(), last.float()
    scale = float(torch.maximum(a.abs().max(), b.abs().max()))
    rel = float((a - b).abs().max()) / scale
    top2 = a.topk(2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) < 1e-2 * scale
    same = a.argmax(-1) == b.argmax(-1)
    return rel, same.tolist(), bool((same | tie).all())


def run_prefill(torch, lm, cfg, model, prompts):
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.no_grad():
        out = lm.prefill(cfg, model, {"tokens": prompts})
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def moe_layers(model):
    from repro_torch.models.moe import MoE
    return [m for m in model.modules() if isinstance(m, MoE)]


def phase_path(torch, rows, path, f32_last=None):
    import dataclasses
    from repro_torch.launch.serve import generate, serve
    from repro_torch.models import lm
    from repro_torch.models.registry import get_arch

    names = LAUNCH_NAMES
    reset_launches()
    served = serve(path.arch, batch=path.batch, prompt_len=path.prompt_len,
                   gen=path.gen, smoke=False, seed=SEED, device="cuda",
                   layers=path.layers)
    serve_launches = read_launches()
    serve_shapes = read_launches_by_shape()
    cfg, res = served.cfg, served.result
    if (cfg.n_layers, cfg.d_model) != path.width:
        fail(f"{path.arch}: not the width asked for: {cfg.n_layers} layers, "
             f"d_model {cfg.d_model}")
    if serve_launches != path.serve:
        fail(f"{path.arch}: serve launched {names} = {serve_launches}, "
             f"expected {path.serve}")
    if res.tokens.shape != (path.batch, path.gen) or not res.logits_finite:
        fail(f"{path.arch} serve: tokens {res.tokens.shape}, finite logits "
             f"{res.logits_finite}")
    decode_tok_s = path.gen * path.batch / res.decode_s
    print(f"  serve: prompt replay {res.prefill_s * 1e3:.1f} ms, decode "
          f"{decode_tok_s:.1f} tok/s, launches "
          f"{dict(zip(names, serve_launches))}")
    print(f"  first stream: {res.tokens[0].tolist()}")
    out = dict(prompt_replay_ms=res.prefill_s * 1e3,
               decode_tok_s=decode_tok_s)
    moes = moe_layers(served.model)
    if moes:
        dropped = sum(int(m.dropped) for m in moes)
        routed = (len(moes) * (path.prompt_len + path.gen) * path.batch
                  * cfg.top_k)
        out["serve_dropped_assignments"] = dropped
        print(f"  serve at capacity_factor {cfg.capacity_factor}: "
              f"{dropped} of {routed} routed assignments dropped")

    reset_launches()
    last, prefill_cold_s = run_prefill(torch, lm, cfg, served.model,
                                       served.prompts)
    prefill_launches = read_launches()
    prefill_shapes = read_launches_by_shape()
    _, prefill_s = run_prefill(torch, lm, cfg, served.model,
                               served.prompts)     # warm: timed, not counted
    if prefill_launches != path.prefill:
        fail(f"{path.arch}: prefill launched {names} = {prefill_launches}, "
             f"expected {path.prefill}")
    # the path's rows of phase 2, one per shape at which it runs a kernel:
    # each row's launches are those counted under its shape in this run
    # (K2 and K3 count by shape; K4 runs at one shape per path), and must
    # be what the config says
    mine = [r for r in rows.values() if r["path"].split()[0] == path.arch]
    for name, n_serve, n_prefill in zip(names, serve_launches,
                                        prefill_launches):
        kr = [r for r in mine if r["name"] == name]
        if name in serve_shapes:
            by_shape = serve_shapes[name] + prefill_shapes[name]
            for r in kr:
                r["launches"] = by_shape.pop(r["key"], 0)
            if by_shape:
                fail(f"{path.arch}: {name} launched at shapes that phase 2 "
                     f"does not time: {dict(by_shape)}")
        elif kr:
            (r,) = kr
            r["launches"] = n_serve + n_prefill
        for r in kr:
            print(f"  {name} [{r['path']}]: {r['launches']} launches")
            if r["launches"] != r["expect"]:
                fail(f"{path.arch}: {name} [{r['path']}] launched "
                     f"{r['launches']} times, the config gives "
                     f"{r['expect']}")
    if last.shape != (path.batch, cfg.vocab) or \
            not torch.isfinite(last).all():
        fail(f"{path.arch}: prefill logits {tuple(last.shape)} not finite "
             f"or wrong shape")
    rel, same, ok = agreement(torch, res.prompt_logits, last)
    print(f"  prefill (full sequence): {prefill_cold_s * 1e3:.1f} ms cold, "
          f"{prefill_s * 1e3:.1f} ms warm, launches "
          f"{dict(zip(names, prefill_launches))}; vs decode replay at "
          f"position {path.prompt_len - 1}: max|d|/max|logit| {rel:.3g}, "
          f"argmax equal {same}")
    out.update(prefill_forward_cold_ms=prefill_cold_s * 1e3,
               prefill_forward_ms=prefill_s * 1e3,
               prefill_vs_replay_bf16=rel)
    if cfg.n_experts:
        # the agreement held: at a capacity that drops nothing on either
        # side (see GRANITE_MOE); the figure above is reported, not held
        nd = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                 / cfg.top_k)
        before = sum(int(m.dropped) for m in moes)
        replay = generate(nd, served.model, served.prompts, gen=0)
        with torch.no_grad():
            last_nd = lm.prefill(nd, served.model, {"tokens": served.prompts})
        if sum(int(m.dropped) for m in moes) != before:
            fail(f"{path.arch}: capacity_factor {nd.capacity_factor} "
                 f"dropped assignments")
        rel, same, ok = agreement(torch, replay.prompt_logits, last_nd)
        out["prefill_vs_replay_bf16_no_drops"] = rel
        print(f"  at capacity_factor {nd.capacity_factor} (no drops): "
              f"prefill vs decode replay max|d|/max|logit| {rel:.3g}, "
              f"argmax equal {same}")
        del replay, last_nd
    if path.bf16_limit is None:
        # the same weights in float32 (rounded to bf16 here): how far bf16
        # rounding alone moves each path's logits
        f32_last = f32_last.to(last.device)
        out["bf16_prefill_vs_f32"] = agreement(torch, f32_last, last)[0]
        out["bf16_replay_vs_f32"] = agreement(torch, f32_last,
                                              res.prompt_logits)[0]
        print(f"  bf16 against float32 prefill: prefill "
              f"{out['bf16_prefill_vs_f32']:.3g}, replay "
              f"{out['bf16_replay_vs_f32']:.3g}; the bf16 agreement is "
              f"reported, not held: it is held in float32 at full width")
    elif rel >= path.bf16_limit or not ok:
        fail(f"{path.arch}: prefill and decode replay disagree")
    del served, last, res, moes
    torch.cuda.empty_cache()

    # the whole path on the card against the plain path on the CPU, at a
    # reduced config in float32 (TF32 off): decode replay, greedy tokens
    # and the full-sequence prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    small = get_arch(path.arch).reduced(dtype="float32", **path.small)
    cpu_model = lm.init_params(small, SEED, device="cpu")
    prompts = np.random.default_rng(SEED).integers(
        0, small.vocab, size=(path.batch, 19)).astype(np.int32)
    on_cpu = generate(small, cpu_model, prompts, gen=6)
    with torch.no_grad():
        pre_cpu = lm.prefill(small, cpu_model, {"tokens": prompts})
    gpu_model = cpu_model.to("cuda")
    on_gpu = generate(small, gpu_model, prompts, gen=6)
    with torch.no_grad():
        pre_gpu = lm.prefill(small, gpu_model, {"tokens": prompts})
    err = max(float((on_gpu.prompt_logits.cpu() - on_cpu.prompt_logits)
                    .abs().max()),
              float((pre_gpu.cpu() - pre_cpu).abs().max()))
    equal = bool((on_gpu.tokens == on_cpu.tokens).all())
    print(f"  reduced f32 {small.n_layers} layers, card vs CPU plain path: "
          f"replay and prefill logits max|err| {err:.3g}; tokens equal "
          f"{equal}")
    if err > 2e-3:
        fail(f"{path.arch}: the reduced path on the card disagrees with the "
             f"CPU path")
    return out


def phase_f32_agreement(torch, path):
    """Prefill against the decode replay at full width in float32 (TF32
    off): the same comparison as phase_path's without bf16 rounding of
    activations and of the decode state.  Returns max|d|/max|logit| and
    the float32 prefill logits."""
    import dataclasses
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    from repro_torch.models.registry import get_arch

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(path.arch), dtype="float32")
    model = lm.init_params(cfg, SEED, device="cuda")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, size=(path.batch, path.prompt_len)).astype(np.int32)
    res = generate(cfg, model, prompts, gen=0)
    last, _ = run_prefill(torch, lm, cfg, model, prompts)
    rel, same, ok = agreement(torch, res.prompt_logits, last)
    print(f"  float32 at full width ({cfg.n_layers} layers, "
          f"{sum(p.numel() for p in model.parameters()) * 4 / 1e9:.1f} GB "
          f"of weights): prefill vs decode replay at position "
          f"{path.prompt_len - 1}: max|d|/max|logit| {rel:.3g}, argmax "
          f"equal {same}")
    del model, res
    torch.cuda.empty_cache()
    if rel >= 2e-3 or not ok:
        fail(f"{path.arch}: float32 prefill and decode replay disagree")
    return rel, last.float().cpu()


# --------------------------------------------------------------------------
# phase 6: the int8 vision plans
# --------------------------------------------------------------------------


def first_divergence(torch, card_plan, cpu_plan, feed, n) -> str:
    """The first op whose stored integers differ between the two plans,
    replayed step by step on the same inputs."""
    for (label, got), (_, want) in zip(card_plan.replay_steps(feed, n),
                                       cpu_plan.replay_steps(feed, n)):
        for name, w in want.items():
            g = got[name].cpu()
            if not torch.equal(g, w):
                d = (g.int() - w.int()).abs()
                return (f"{label}: {int((d > 0).sum())} of {d.numel()} "
                        f"integers of {name} differ, by up to "
                        f"{int(d.max())}")
    return "no step differs when replayed step by step"


def phase_vision(torch, rows, path):
    from repro_torch.core.execplan import lower_plan
    from repro_torch.launch.serve_vision import float_errors, serve_vision

    reset_launches()
    served = serve_vision(path.name, VISION_BATCH, device="cuda", seed=SEED,
                          repeats=3)
    launches = read_launches()
    want = (0, 0, 0, path.k1_per_replay * served.replays)
    if launches != want or served.k1_launches != path.k1_per_replay:
        fail(f"{path.name}: launched {LAUNCH_NAMES} = {launches} over "
             f"{served.replays} replays, expected {want}")
    g, plan = served.graph, served.plan
    if g.inputs[0].shape != (224, 224, 3):
        fail(f"{path.name}: input {g.inputs[0].shape}, not 224 x 224")
    for name, out in served.outputs.items():
        if tuple(out.shape) != (VISION_BATCH,) + g.tensors[name].shape or \
                not torch.isfinite(out).all():
            fail(f"{path.name}: output {name} {tuple(out.shape)} not "
                 f"finite or of the wrong shape")
    inp = g.inputs[0].name

    # batch 1 through the same 8-plan (a ragged batch)
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        plan.run({inp: served.images[:1]}, n=1)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    replay1_ms = statistics.median(times[1:]) * 1e3

    # the same quantized model and images through the plain path on the CPU
    cpu_plan = lower_plan(None, g, None, served.qm.weights_f, plan.semantics,
                          capacity=VISION_BATCH, device="cpu")
    for n in path.cpu_batches:
        feed = {inp: served.images[:n]}
        got = plan.run(feed, n=n, decode=False)
        ref = cpu_plan.run(feed, n=n, decode=False)
        for name, w in ref.items():
            if not torch.equal(got[name].cpu(), w):
                fail(f"{path.name} batch {n} in an 8-plan: the card's "
                     f"stored integers differ from the CPU's; first at "
                     f"{first_divergence(torch, plan, cpu_plan, feed, n)}")
    errs = float_errors(served)
    for name, (err, tol, _) in errs.items():
        if not err <= tol:
            fail(f"{path.name}: output {name} is {err:.4g} from the float32 "
                 f"oracle, above the calibrated tolerance {tol:.4g}")
    for r in rows.values():
        if r["name"] == "neutron_matmul" and r["path"] == path.name:
            r["launches"] = launches[3]
    out = dict(ptq_s=served.ptq_s, lower_s=served.lower_s,
               replay_ms_batch8=served.replay_ms,
               images_s_batch8=served.images_s, replay_ms_batch1=replay1_ms,
               images_s_batch1=1e3 / replay1_ms,
               kernels_per_replay=len(plan.steps),
               k1_per_replay=served.k1_launches,
               arena_bytes=served.arena_bytes,
               float_err={k: v[0] for k, v in errs.items()},
               float_tol={k: v[1] for k, v in errs.items()},
               float_err_over_max_oracle={k: v[0] / v[2]
                                          for k, v in errs.items()})
    # with random weights the oracle can grow huge (resnet50_v1's reaches
    # ~1e22), where the raw error says little: err / max|oracle| says how
    # close the band is
    bands = {k: f"err {v[0]:.4g}, tol {v[1]:.4g}, max|oracle| {v[2]:.4g}, "
                f"err/max|oracle| {v[0] / v[2]:.3g}" for k, v in errs.items()}
    print(f"  card ints equal the CPU's at batch {path.cpu_batches} (8-plan);"
          f" decoded within float_tolerance of the float32 oracle "
          f"({bands}); K1 {served.k1_launches} per replay; replay "
          f"{served.replay_ms:.3f} ms at batch 8 ({served.images_s:.1f} "
          f"images/s), {replay1_ms:.3f} ms at batch 1")
    del served, plan, cpu_plan
    torch.cuda.empty_cache()
    return out


def phase_lm(torch, rows, n, path) -> dict:
    """Phase `n`: one LM path (the float32 agreement first, where the
    path holds it there), with its wall time."""
    t = time.monotonic()
    depth = f"{path.layers} layers (depth cut)" if path.layers \
        else "full depth"
    print(f"== phase {n}: {path.arch} at full width, {depth}")
    f32, f32_last = (phase_f32_agreement(torch, path)
                     if path.bf16_limit is None else (None, None))
    out = phase_path(torch, rows, path, f32_last)
    if f32 is not None:
        out["prefill_vs_replay_f32"] = f32
    print(f"  {path.arch}: {json.dumps(out)}")
    print(f"  phase {n} wall time {time.monotonic() - t:.1f} s")
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             "repository")
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ops

    gpu = gpu_line()
    print(f"== phase 1: {gpu}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_build = _build.build_all()
    print(f"  kernels built in {t_build:.1f} s")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    phase_sass(_build)
    print(f"  phase 1 wall time {time.monotonic() - T0:.1f} s")

    print("== phase 2: kernels against their plain versions")
    t = time.monotonic()
    rows = phase_kernels(torch, F, ops)
    print(f"  phase 2 wall time {time.monotonic() - t:.1f} s")
    paths = {}
    for n, path in ((3, MINITRON), (4, ZAMBA), (5, MAMBA)):
        paths[path.arch] = phase_lm(torch, rows, n, path)
    for path in (MOBILENET, RESNET):
        print(f"== phase 6: {path.name} int8 plan at 224, batch "
              f"{VISION_BATCH}")
        t = time.monotonic()
        paths[path.name] = phase_vision(torch, rows, path)
        print(f"  {path.name}: {json.dumps(paths[path.name])}")
        print(f"  phase 6 ({path.name}) wall time "
              f"{time.monotonic() - t:.1f} s")
    for n, path in ((7, GRANITE), (8, GRANITE_MOE), (9, DEEPSEEK),
                    (10, GEMMA)):
        paths[path.arch] = phase_lm(torch, rows, n, path)

    keys = ("name", "path", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_call_ms")
    print(f"total wall time {time.monotonic() - T0:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
