#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (H100, sm_90a) and nvcc; imports no JAX.  Phases,
each of which ends the run with a nonzero exit and no result on failure:

1. the card's name and power limit, torch and CUDA versions, the build
   of every CUDA kernel from the sources in this checkout (ptxas
   registers and spills), and the count of tensor-core instructions
   (HMMA/HGMMA, IMMA/IGMMA) in each library's SASS, which must not be 0
   in any instance of the bf16 flash_attention and ssd_chunk kernels, of
   the bf16 flash_attention_bwd kernels, of the bf16 ssd_chunk_bwd
   kernel and its reduce (3xTF32), or of the int8 and the tiled float
   (3xTF32) neutron_matmul kernels;
2. every kernel on the card against its plain PyTorch version, at the
   shapes each serving path gives it (bf16; int8 for K1 at the vision
   plans' shapes, compared for equality) and at small ragged cases (f32;
   K4 and K4b also bf16 with N, P not multiples of 16; K1 also in its Pallas
   contract: f32, bf16, int8 requant, per-channel scale; K1 at both
   contracts, K2 and K3 in float32 at phase 13's decoder shapes, K2 with
   its query offset, which probes hold at lanes of different offsets;
   ``strided_ms``, the call on the plan's cache-slot views; K2 not causal
   with Sq != Sk at phase 14's shapes, held also on a probe that its key
   tail decides; ``expand_ms``, whisper's cross-attention with the
   cached K/V's expansion to the padded heads), timed beside its
   plain version, one PyTorch library call for the same function where
   there is one (for K1 `torch._int_mm`, on zero-padded copies where its
   shape rules refuse the shape; for K1's float32 rows, at the float32
   plan's shapes, `torch.matmul` with TF32 off; each float32 row names
   the route of K1's ``float_plan`` and is the same bits on a second
   call), and its bound.  `ms` and
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
10. gemma3-27b at full width with its depth cut to 14 layers (2 groups
   of 5 local layers, window 1024, and a global one, then 2 local
   layers), with a prompt of 1040, so that K2 runs its window at
   S > 1024 and the local layers' rings wrap in the decode replay;
11. mobilenet_v2 and resnet50_v1 at 224 through the product path,
   ``repro_torch.api.compile(name, precision="int8")``: PTQ and the NPU
   compile on the host (ticks, DDR bytes, modeled latency and the
   report printed), the compiled model's plan replayed on the card with
   stored ints equal to phase 6's for the same images and K1 launched 36
   / 54 times a replay, its warm replay time beside phase 6's,
   ``verify()`` (the host interpreter against the card plan) and a
   save -> mmap load -> replay round trip with equal ints and no plan
   constant recomputed;
12. ``repro_torch.api.Session`` on the card: the two int8 models of
   phase 11 (not compiled again) and mobilenet_v2 compiled at float32,
   served by 2 worker threads (each on its own CUDA stream), then by 1,
   with ``max_batch=8``: 4 submitter threads send 96 requests per model
   built from phase 6's images.  Every ticket is fulfilled; int8 outputs
   equal ``CompiledModel.__call__``'s at batch 1 bit for bit, float32
   outputs of 8 requests lie within ``float_plan_tol`` of the plain path
   on the CPU; K1 launches 36 / 54 / one per conv and fc of the float32
   model in each batch; no worker is recycled (none is faulted: a batch
   beats from its progress) and the live workers' streams differ.  Then
   the chaos
   ladder on int8 mobilenet_v2: a transient plan fault retried, the
   breaker tripped, requests failed fast with ``BreakerOpen`` while it is
   open (nothing launched, nothing moved to the host), the probe's
   recovery, then equal ints on K1 again, no ticket lost.  Requests/s, p50 / p99
   latency, mean batch size, batch service ms and the float32 replay ms
   at batch 1 and 8 are printed;
13. LM decode on the NPU compile path: ``repro_torch.api.DecodeSession``
   serving the whisper-tiny decoder of ``frontends/lm.py`` at full width
   with its depth cut to 2 of its 4 layers (d_model 384, 6 heads of 64,
   d_ff 1536, vocab 51865) at
   float32 and at int8: its 7 (seq, kv) models compiled (seconds
   printed) and loaded, from their artifacts, into the same session on
   the CPU; request A (prompt 6) and B (prompt 60) alone, every prefill
   and step held teacher-forced against the CPU session (float32 logits
   and caches within ``float_plan_tol``; int8 stored ints within one
   step, the count printed per step), the greedy tokens against the CPU
   session's (equal at float32; the first divergence printed at int8);
   then A and B interleaved step by step with the counters from 0: the
   tokens equal the solo runs, K1 13 a step (by contract), K3 2 a decode
   step and K2 2 a prefill (by shape, at shapes phase 2 times), every
   plan built once.  Prefill ms, decode ms per token, tokens/s, the
   device busy share of a decode step (torch.profiler) and kernels a
   step are printed;
14. whisper-tiny (encoder-decoder) at full width, nothing cut (4 encoder
   layers over 1500 audio frames, 4 decoder layers, d_model 384, 6 heads
   of 64 padded to 16, vocab 51865): ``serve`` runs the encoder and every
   layer's cross K/V once, then each step's cross-attention on K2 (one
   query row against 1500 keys, not causal) and self-attention on K3;
   prefill runs the encoder, the causal self-attention and the
   cross-attention of the prompt on K2.  The encoder's and the cross
   K/V's wall times are printed;
15. qwen2-vl-2b at full width, nothing cut (28 layers, d_model 1536, 12
   heads over 2 padded to 16, M-RoPE), a prompt of its 256 vision tokens
   and 32 text tokens: the vision embeddings replace the first 256
   positions' in ``serve``'s steps and in prefill (which rotates by
   M-RoPE, the steps by RoPE);
16. ``CompiledModel.profile(batch=8)`` on the card, of phase 11's int8
   mobilenet_v2 and resnet50_v1 and phase 12's float32 mobilenet_v2,
   each loaded from the artifact its phase saved: the modeled block, the
   measured block and the top five ops printed; one measured kernel per
   plan step, every step label an op of the graph, the steps' times
   (CUDA events around each step) summing within the replay's wall (CUDA
   events around the replay), the modeled block equal to that of a
   ``device="cpu"`` load of the same artifact, K1 launched once per conv
   and fc of each replay; a device spin added to one step shows in that
   step's time.  Then the whisper-tiny decoder's int8 models of phase 13
   at (seq 1, kv 64) and (64, 64): its ops by device time and by host
   enqueue time (the tracer's spans), K1 with K3 for the step and with
   K2 for the prefill;
17. ``Session(workers=("process", 2))`` on the card, serving phase 11's
   int8 mobilenet_v2 from its artifact: requests/s of the same stream
   of 192 requests through 1 and 2 worker threads and 1 and 2 worker
   processes, side by side; every output equal to phase 6's stored
   ints; the children other processes, ready on cuda, launching K1 36
   times a batch (their counts, read before and after) while the parent
   launches nothing.  Then, on the 2-process pool, a child killed with
   its batch in flight (SIGKILL from the parent, SIGSEGV, the OOM exit)
   and a reply frame bit-flipped: every ticket settles with phase 6's
   ints, the batch is re-dispatched, a replacement child becomes ready
   on the card.  Then ``Session.fleet(replicas=2, workers=2)``: both
   replicas serve, K1 36 times a batch; a replica that corrupts its
   outputs is caught by the auditor (the host interpreter) and
   quarantined; an update whose canary is corrupted raises
   ``UpdateRejected`` and touches no replica; a killed replica's
   requests fail over with no ticket lost.

18. training on the card (``repro_torch.launch.train.train_loop``):
    minitron-4b at full width (32 layers, d_model 3072, 24 query heads
    padded to 32 over 8 kv heads, d_ff 9216, vocab 256000; bf16
    parameters, float32 AdamW moments, remat) for 4 steps of batch 8 x
    128 tokens: losses and grad norms finite, the first step's fused_ce
    loss within 5e-2 of cross_entropy of the full forward's logits, wall
    ms per step, the busy share of the last step and K2b's device time
    in it (torch.profiler; the run fails if it is 0), peak memory, and
    every attention through K2 (64 a step: the forward and the remat
    recompute) and K2b (32 a step), no other kernel; then the
    reduced minitron-4b in float32 for 3 steps on the card against the
    CPU from the same state (loss, grad norm, lr scale within 2e-4
    relative, parameters within 2 lr sum(lr_scale) + 2e-4 relative), a
    restart (8 steps checkpointed every 4, resumed to 12, against 12
    uninterrupted, within 1e-4), and reduced qwen2-vl-2b's loss falling
    over 25 steps.

19. training of the ssm, hybrid, MoE and encoder-decoder families on the
    card through ``make_train_step``: mamba2-370m, zamba2-2.7b,
    granite-moe-1b-a400m and whisper-tiny at full width (bf16 parameters,
    float32 AdamW moments, remat), 4 steps of batch 8 x 128 tokens each
    (whisper's batch also carries audio embeddings (8, 1500, 384) drawn
    from the seed): losses and grad norms finite, wall ms a step (median
    of steps 2-4), the busy share of the last step and the device time
    in it of K2b and K4b where the model runs them (torch.profiler; the
    run fails if one is 0), peak memory, and the launches a step of K2,
    K2b, K4 and K4b, each what the reference's remat gives
    (``TRAIN_PATHS``, as minitron-4b's in phase 18), at the shapes phase
    2 times; then each reduced config in float32 for 3 steps on the card
    against the CPU (phase 18's bounds), and its loss falling over 8
    steps at a constant learning rate.  Then deepseek-v3 reduced in
    float32 with its multi-token-prediction block, 3 steps on the card
    against the CPU, K2 and K2b at its MLA shape counted by shape.

20. distribution on the card: two ranks, one process each, share the
    H100 over a gloo process group (NCCL takes one rank a device), on a
    mesh (data 1, model 2).  granite-moe-1b-a400m at full width, 3 steps
    of 8 x 128 tokens: each rank holds 16 of the 32 experts (moe_a2a's
    all_to_all) and 8 of the 16 query heads; per rank the step walls,
    peak memory, K2 / K2b launches at the shard's shape and the losses,
    which must be the same bits on both ranks.  Then mamba2-370m at full
    width, its depth cut to 4 layers, 2 steps likewise: each rank runs
    the SSD block on 16 of its 32 heads, K4 and K4b at that shard's
    shape (phase 2 times them there).  Then reduced granite-moe,
    deepseek-v3 (MLA on each rank's heads, its mtp block) and mamba2 in
    float32 over the same mesh, 3 steps on the card against the same
    two ranks on the CPU (phase 18's bounds).  Then one granite-20b
    decoder layer at full width (MQA: the cache of 128 positions split
    over the ranks), batch 4, decoded at positions 63 and 64 (one in
    each rank's half) against the same layer's decode on one rank
    without a mesh, within 2e-2 of max|out|; each rank launches K3 with
    its log-sum-exp at each step.  DTensor's own collectives
    (``full_tensor``, ``redistribute``) on CUDA tensors over gloo crash a
    rank on this machine, so the main path runs c10d collectives only
    and no DTensor reaches the card.

For the two SSM paths the prefill-vs-replay agreement is held in
float32 at full width (TF32 off) and reported in bf16, beside how far
bf16 moves each path's logits from float32 (see ``ZAMBA`` below).  The
MoE paths hold it at a capacity that drops nothing (see
``GRANITE_MOE``).

Phase 2 also holds K2's log-sum-exp output (its training forward) at
every serving path's K2 shape (o bit-equal to the call without it, lse
within 1e-2 in bf16), and K2b, flash attention's backward, at shapes
no training path gives it (``BWD_SHAPES``: per gradient max|d|/max|plain|
< 2e-2 in bf16, atol 2e-3 / rtol 1e-3 in float32, and the same bits on a
second call; each row names its route and group split), timed beside
SDPA's backward alone; K2 and K2b also at phases 18 and 19's shapes
(minitron-4b's 24 heads padded to 32; whisper's
encoder over 1500 frames and its cross-attention of 128 rows against
1500 keys, not causal; zamba2's head dim 80; granite-moe's group of 2);
K4 at phase 19's shapes and K4b, the SSD scan's backward, at them and at
the serving prefill shapes (per gradient max|d|/max|plain| < 1e-4 for
bf16 and float32 inputs alike: kernel and plain version do float32
arithmetic on the same bits; and the same bits on a second call);
that a tensor requiring grad that reaches K1, K3 or K2 with a query
offset raises under grad mode and launches nothing; and that one reaching
K4 runs K4 and K4b once each.

In phases 3-10, 14 and 15 the weights are random from the seed.  Each path runs
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
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np

T0 = time.monotonic()
ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_S = 3.35e12       # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core rate
              "int8": 1979e12,      # dense tensor-core rate (K1's bound)
              "tf32": 495e12,       # dense tensor-core rate (3xTF32 issues
                                    # three products for each one)
              "float32": 67e12}     # outside the tensor cores

SEED = 0
TOL = {"float32": (2e-3, 1e-3), "bfloat16": (2e-2, 2e-2)}


class ServingPath(NamedTuple):
    """A serving path at full width: its shapes, the launches of
    (flash_attention, flash_decode, ssd_chunk, neutron_matmul) that
    `serve` and `prefill` must make, the reduced config held against the
    CPU, and the limit on max|d|/max|logit| between prefill and the
    decode replay in bf16; with None, that comparison is held in float32
    at full width instead (with `f32_also`, in both).  `layers` cuts the
    depth of the served model (None: full depth)."""
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
    f32_also: bool = False


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
# gemma3-27b at full width, its depth cut from 62 layers to 14 (to keep
# the script inside its time limit): 2 groups of 5 local layers (window
# 1024) and 1 global, then 2 local layers, as the full model's grouped
# stack and tail lay them out; a prompt of 1040 runs K2's window at
# S > 1024 and wraps the local layers' rings in the decode replay.
GEMMA = ServingPath("gemma3-27b", 4, 1040, 8, (14, 5376),
                    serve=(0, 14 * 1048, 0, 0), prefill=(14, 0, 0, 0),
                    small={}, layers=14)
# whisper-tiny, nothing cut: 4 encoder layers over 1500 audio frames (K2
# not causal, S = Sk = 1500), 4 decoder layers of 6 heads padded to 16.
# serve runs the encoder once (4) and, at each of 48 steps, the
# cross-attention of every decoder layer (K2, one query row against 1500
# keys) and its self-attention (K3); prefill runs the encoder, the causal
# self-attention and the cross-attention of the 16 prompt rows (4 each).
# The reduced config is padded (3 heads over 1, to 4), as at full width.
PADDED_SMALL = dict(n_heads=3, n_kv_heads=1, d_head=32, tp_pad=4)
WHISPER = ServingPath("whisper-tiny", 4, 16, 32, (4, 384),
                      serve=(4 + 4 * 48, 4 * 48, 0, 0),
                      prefill=(12, 0, 0, 0), small=PADDED_SMALL)
# qwen2-vl-2b, nothing cut: 28 layers, 12 query heads over 2 (padded to
# 16), M-RoPE; a prompt of 288 = its 256 vision tokens and 32 text
# tokens, as a user sends an image and a short question.  Its vision
# embeddings (normals, 50 times the token embeddings' scale) make the
# bf16 agreement the loosest of the paths (0.039 of the 5e-2 on an H100
# 80GB HBM3), so it is also held in float32 at full width.
QWEN = ServingPath("qwen2-vl-2b", 4, 288, 16, (28, 1536),
                   serve=(0, 28 * 304, 0, 0), prefill=(28, 0, 0, 0),
                   small=PADDED_SMALL, f32_also=True)
LM_PATHS = (MINITRON, ZAMBA, MAMBA, GRANITE, GRANITE_MOE, DEEPSEEK, GEMMA,
            WHISPER, QWEN)


class AttnShape(NamedTuple):
    """One shape at which a path runs K2 (a prefill layer's q, k, v) or K3
    (a decode step's q against the cache at the last step, kv_len = S),
    and how many launches of the path's drive (serve, then prefill) the
    config says it takes; the run counts them under the wrapper's
    ``shape_key``.  K2 attends to `Sk` keys (0: S), causally or not;
    `expand` (the config's H, Hkv) marks whisper's cross-attention, whose
    cached K/V at Hkv heads are expanded to the padded heads in every
    call; `lse` a K3 call that also returns its log-sum-exp (phase 20's
    sequence-sharded decode).  A tag that starts with "f32" is a float32
    row, any other bf16."""
    tag: str
    B: int
    H: int
    Hkv: int
    S: int
    D: int
    Dv: int
    window: Optional[int]
    launches: int
    Sk: int = 0
    causal: bool = True
    expand: Optional[Tuple[int, int]] = None
    lse: bool = False


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
    if cfg.enc_dec:
        Se, Le = cfg.n_audio_frames, cfg.n_enc_layers
        t = path.arch
        return ([AttnShape(f"{t} encoder", B, H2, Hkv2, Se, hd, hd, None,
                           2 * Le, causal=False),
                 AttnShape(f"{t} self", B, H2, Hkv2, P, hd, hd, None, L),
                 AttnShape(f"{t} cross decode", B, H2, Hkv2, 1, hd, hd,
                           None, L * S, Sk=Se, causal=False,
                           expand=(H, Hkv)),
                 AttnShape(f"{t} cross prefill", B, H2, Hkv2, P, hd, hd,
                           None, L, Sk=Se, causal=False, expand=(H, Hkv))],
                [AttnShape(t, B, H, Hkv, S, hd, hd, None, L * S)])
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
# phase 11 times CompiledModel.__call__ and the bare plan in this many
# pairs of warm replays, in turns
COMPILED_PAIRS = 7
# phase 12: requests per model, submitter threads, the float32 requests
# held against the CPU, and the timed replays of the float32 plan
SESSION_REQUESTS = 96
SESSION_SUBMITTERS = 4
SESSION_F32_SAMPLES = 8
F32_REPLAYS = 7


class K1Shape(NamedTuple):
    """One of K1's GEMMs on a vision path: output rows per image, K, N
    and the activation of its epilogue."""
    path: str
    what: str
    rows: int
    K: int
    N: int
    act: str


# K1's Pallas contract in float32 at the shapes of mobilenet_v2's float32
# plan at 224 (phase 12): (rows per image, K, N, act) of its stem (im2col),
# its last 1x1 conv and its fc
K1_F32_SHAPES = (
    K1Shape("mobilenet_v2 float32", "stem 3x3/2 conv (im2col)", 112 * 112,
            27, 32, "relu6"),
    K1Shape("mobilenet_v2 float32", "last 1x1 conv", 7 * 7, 320, 1280,
            "relu6"),
    K1Shape("mobilenet_v2 float32", "fc", 1, 1280, 1000, "none"),
)

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

# phase 13: the whisper-tiny decoder of the LM decode path at full width
# (src/repro_torch/configs/whisper_tiny.py: d_model 384, 6 heads of 64,
# d_ff 1536, gelu, vocab 51865), its depth cut from 4 layers to 2 to keep
# the script inside its time limit, compiled through DecodeSession at
# float32 and at int8.  Request A's prompt has the length
# of BENCH_decode.json's (6) and crosses kv 8 -> 16 -> 32 -> 64; B's (60)
# prefills at s64/kv64 and grows to kv 128.  Each gets DECODE_NEW tokens:
# the prefill's and DECODE_NEW - 1 decode steps, the fewest that still take
# A into kv 64 (its last step attends to 33 positions).
DECODER = dict(scale=1, n_layers=2, vocab=51865)
DECODER_WIDTH = (2, 384, 6, 64, 1536, 51865)
DECODE_PROMPTS = (6, 60)
DECODE_NEW = 28
DECODE_PRECISIONS = ("float32", "int8")
DECODE_TIMED = 5        # warm prefills timed per request
DECODE_PROFILED = 8     # decode steps under torch.profiler
DECODER_PATH = "whisper-tiny decoder"
# K1 at the decoder's matmuls (one per precision row, batch 1): the logits
# of a decode step and of B's prefill (N = 51865: the int8 output pitch is
# odd), the feed-forward's second matmul (K = 1536) and its first (gelu)
DECODER_K1_SHAPES = (
    K1Shape(DECODER_PATH, "logits, decode step", 1, 384, 51865, "none"),
    K1Shape(DECODER_PATH, "logits, prefill s64", 64, 384, 51865, "none"),
    K1Shape(DECODER_PATH, "ff out (K 1536)", 1, 1536, 384, "none"),
    K1Shape(DECODER_PATH, "ff in (gelu)", 1, 384, 1536, "gelu"),
)

# phase 16: replays timed per profile (after one warm replay), and the
# device spin that shows a step's time is the card's (4e6 cycles is 2 ms
# at the H100's top clock of 1.98 GHz)
PROFILE_RUNS = 3
DECODE_PROFILE_RUNS = 5
SPIN_CYCLES = 4_000_000
SPIN_MIN_MS = 1.0
# phase 17: the request stream of the thread-versus-process comparison,
# its submitter threads, the process pool's children, the heartbeat
# timeout of its sessions and of the fleet's replicas, the requests of
# each chaos case, the fleet's request bursts and the audit's
PROC_REQUESTS = 192
PROC_SUBMITTERS = 4
PROC_WORKERS = 2
PROC_HEARTBEAT_S = 2.0
PROC_CHAOS_REQUESTS = 32
FLEET_REQUESTS = 32
FLEET_AUDIT_BURST = 4
FLEET_AUDIT_BURSTS = 6


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


PROFILE_LEAD = 8


def device_ms(torch, fn, iters: int = 30, warmup: int = 3,
              attempts: int = 3, split=None):
    """Median over `iters` calls of the device time of the CUDA kernels
    one call of `fn` launches (their durations summed), from
    torch.profiler's kernel events, the L2 flushed before each call;
    with `split` (a compiled pattern), also each kernel's median, keyed
    by the pattern's match in its name: (total, {kernel: ms}).
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
            # the device's first microseconds in a session may go
            # unrecorded (a few short calls were seen to vanish there):
            # a pause first, then PROFILE_LEAD calls more than are
            # counted, whose kernels are discarded
            time.sleep(0.01)
            for _ in range(iters + PROFILE_LEAD):
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
                per_call[-1].append((name, us))
        per_call = per_call[-iters:]
        if len(per_call) == iters and all(per_call) and \
                len({len(k) for k in per_call}) == 1:
            total = statistics.median(sum(us for _, us in k)
                                      for k in per_call) / 1e3
            if split is None:
                return total
            parts = {}
            for k in per_call:
                for name, us in k:
                    m = split.search(name)
                    parts.setdefault(m.group(0) if m else name[:40],
                                     []).append(us)
            return total, {n: statistics.median(v) / 1e3
                           for n, v in parts.items()}
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


def bound(nbytes: int, flops, dtype: Optional[str] = None):
    """The larger of the time to move `nbytes` and to do `flops`
    operations at `dtype`'s rate; without `dtype`, `flops` is {dtype:
    operations} for work done at several rates."""
    work = {dtype: flops} if dtype else flops
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = sum(f / PEAK_FLOPS[d] for d, f in work.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# The kernels whose every instance must carry tensor-core instructions of
# the given kinds: (library, mangled-name part, mnemonics, what it is).
TENSOR_CORE_KERNELS = (
    ("flash_attention", "flash_attention_bf16_kernel", ("HMMA", "HGMMA"),
     "the bf16 flash_attention kernel"),
    ("flash_attention_bwd", "dkdv_mma_kernel", ("HMMA", "HGMMA"),
     "the bf16 flash_attention_bwd dK/dV kernel"),
    ("flash_attention_bwd", "dq_mma_kernel", ("HMMA", "HGMMA"),
     "the bf16 flash_attention_bwd dQ kernel"),
    ("neutron_matmul", "neutron_matmul_i8", ("IMMA", "IGMMA"),
     "the int8 neutron_matmul kernel"),
    ("neutron_matmul", "neutron_matmul_tiled", ("HMMA", "HGMMA"),
     "the tiled float neutron_matmul kernel (3xTF32)"),
    ("ssd_chunk", "ssd_chunk_bf16_kernel", ("HMMA", "HGMMA"),
     "the bf16 ssd_chunk kernel"),
    ("ssd_chunk_bwd", "ssd_chunk_bwd_bf16_kernel", ("HMMA", "HGMMA"),
     "the bf16 ssd_chunk_bwd kernel"),
    ("ssd_chunk_bwd", "ssd_chunk_bwd_bf16_reduce_kernel", ("HMMA", "HGMMA"),
     "the bf16 ssd_chunk_bwd reduce kernel (3xTF32)"),
)


def phase_sass(_build) -> None:
    """Tensor-core instructions (HMMA/HGMMA, IMMA/IGMMA) in each library's
    SASS; every instance of the kernels of TENSOR_CORE_KERNELS must have
    them."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        counts = dict(zip(_build.SOURCES,
                          pool.map(_build.tensor_core_ops, _build.SOURCES)))
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


def check_plan_tol(torch, name, got, want) -> float:
    """max|got - want| of a float32 K1 call, held to the float32 plan's
    ``float_plan_tol`` (1e-4 max(1, max|want|)) as well as to TOL: plain
    TF32 products (about 2^-11 each) would break it, 3xTF32 does not."""
    from repro_torch.core.executor import float_plan_tol
    err = float((got.float() - want.float()).abs().max())
    tol = float_plan_tol(want.float().cpu().numpy())
    if not err <= tol:
        fail(f"{name}: max|err| {err:.3g} above float_plan_tol {tol:.3g}")
    return err


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


def k2_tail_probe(torch, ops, a: AttnShape, Sk: int) -> float:
    """K2 not causal at a's shape over Sk keys, on inputs on which the key
    tail decides the output: q = 1 and k = -4, so every real key scores
    -4 sqrt(D) and a key read past Sk (zero-filled, score 0) would take
    nearly all the weight; v = 0 but for markers Sk / 2 at keys 0 and
    Sk - 1.  Every output is (v[0] + v[Sk-1]) / Sk, about 1: a tail read
    one key too far gives about 0, the last key dropped about 0.5.  Held
    against that value and the plain version."""
    q = torch.ones((a.B, a.H, a.S, a.D), dtype=torch.bfloat16,
                   device="cuda")
    k = torch.full((a.B, a.Hkv, Sk, a.D), -4.0, dtype=torch.bfloat16,
                   device="cuda")
    v = torch.zeros((a.B, a.Hkv, Sk, a.Dv), dtype=torch.bfloat16,
                    device="cuda")
    v[:, :, 0] = Sk / 2
    v[:, :, Sk - 1] = Sk / 2
    got = ops.flash_attention(q, k, v, causal=False)
    want = (v[:, :, 0].float() + v[:, :, Sk - 1].float()) / Sk
    want = want.repeat_interleave(a.H // a.Hkv, dim=1)[:, :, None]
    what = f"flash_attention bf16 {a.tag} tail probe Sk={Sk}"
    check_close(torch, what, got, want.expand_as(got), "bfloat16")
    return check_close(torch, what, got,
                       ops.flash_attention(q, k, v, causal=False,
                                           impl="ref"), "bfloat16")


def k2_row(torch, F, ops, randn, a: AttnShape) -> dict:
    """K2 at a path's prefill shape (bf16; causal with a.window, or not
    causal over a.Sk keys) against its plain version, timed beside SDPA
    on the same inputs (with the window as a boolean mask, made outside
    the timed call).  Where the path expands cached K/V to the padded
    heads in every call (a.expand), ``expand_ms`` is the device time of
    that expansion and the kernel together; at one query row not causal,
    ``as_k3_ms`` is K3's time for the same function (kv_len = Sk)."""
    from repro_torch.kernels import flash_attention
    from repro_torch.models.attention import _kv_index
    Sk = a.Sk or a.S
    dname = "float32" if a.tag.startswith("f32") else "bfloat16"
    dtype = getattr(torch, dname)
    q = randn(a.B, a.H, a.S, a.D, dtype=dtype)
    k = randn(a.B, a.Hkv, Sk, a.D, dtype=dtype)
    v = randn(a.B, a.Hkv, Sk, a.Dv, dtype=dtype)

    def kernel():
        return ops.flash_attention(q, k, v, causal=a.causal, window=a.window)

    def plain():
        return ops.flash_attention(q, k, v, causal=a.causal, window=a.window,
                                   impl="ref")

    got = kernel()
    err = check_close(torch, f"flash_attention {dname} {a.tag}", got,
                      plain(), dname)
    lse_err = k2_lse_check(torch, q, k, v, a, got)
    print(f"  flash_attention [{a.tag}] with its lse (the training "
          f"forward): o bit-equal, lse max|err| {lse_err:.3g}")
    if not a.causal:
        e = k2_tail_probe(torch, ops, a, Sk)
        print(f"  flash_attention [{a.tag}] tail probe at Sk={Sk} (q = 1, "
              f"k = -4, markers at the first and last key): max|err| "
              f"{e:.3g}")
    # the window also at S = 2100, where it hides half of the keys
    for S in () if not a.causal else (a.S,) + ((2100,) if a.window
                                              else ()):
        e = k2_boundary_probe(torch, ops, randn, a, S)
        print(f"  flash_attention [{a.tag}] boundary probe at S={S} "
              f"(k = 0, a marker in v every {PROBE_EVERY} keys): max|err| "
              f"{e:.3g}")
    extra = {}
    if a.expand:
        idx = _kv_index(*a.expand, a.H, "cuda")
        kc = randn(a.B, a.expand[1], Sk, a.D)
        vc = randn(a.B, a.expand[1], Sk, a.Dv)
        extra["expand_ms"] = device_ms(
            torch, lambda: ops.flash_attention(
                q, kc.index_select(1, idx), vc.index_select(1, idx),
                causal=False))
    if a.S == 1 and not a.causal:
        extra["as_k3_ms"] = device_ms(
            torch, lambda: ops.flash_decode(q[:, :, 0], k, v))
    if not a.causal:
        def library():
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
    elif a.window is None:
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
    pairs = a.B * a.H * (causal_pairs(a.S, a.window) if a.causal
                         else a.S * Sk)
    b_ms, b_by = bound(nbytes(q, k, v, got), 2 * pairs * (a.D + a.Dv),
                       dname)
    win = "" if a.window is None else f", window {a.window}"
    return dict(
        name="flash_attention", path=a.tag, route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:116",
        shape=f"q ({a.B},{a.H},{a.S},{a.D}), k ({a.B},{a.Hkv},{Sk},"
              f"{a.D}), v Dv {a.Dv} {'f32' if dname == 'float32' else 'bf16'} "
              f"{'causal' if a.causal else 'not causal'}{win}",
        key=flash_attention.shape_key(q, k, v, a.window), expect=a.launches,
        max_abs_err=err, lse_err=lse_err, bound_ms=b_ms, bound_by=b_by,
        **extra, **timings(torch, kernel, plain, library))


# K2's log-sum-exp (its training forward) against the plain version's: the
# bf16 body rounds P to bf16 before summing it, which moves each row sum l
# by at most 2^-8 of itself, log l by at most 0.004
LSE_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def k2_lse_check(torch, q, k, v, a: AttnShape, o) -> float:
    """K2 with ``return_lse`` on a's inputs: its o must be bit-equal to the
    call without (`o`), its lse within LSE_TOL of
    ``flash_attention_fwd_lse_ref``'s.  Returns max|lse error|."""
    from repro_torch.kernels import flash_attention, ref
    o2, lse = flash_attention.flash_attention(q, k, v, causal=a.causal,
                                              window=a.window,
                                              return_lse=True)
    if not torch.equal(o2, o):
        fail(f"flash_attention {a.tag}: o with return_lse differs from o "
             f"without")
    g = a.H // a.Hkv
    _, want = ref.flash_attention_fwd_lse_ref(
        q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
        causal=a.causal, window=a.window)
    err = float((lse - want).abs().max())
    dtype = str(q.dtype).replace("torch.", "")
    if not torch.isfinite(lse).all() or err > LSE_TOL[dtype]:
        fail(f"flash_attention {a.tag}: lse max|err| {err:.3g} above "
             f"{LSE_TOL[dtype]}")
    return err


# phases 18 and 19 train at full width with the batch the reference's
# train_loop defaults to: 8 x 128 tokens, TRAIN_STEPS steps
TRAIN_STEPS = 4
TRAIN_SEQ, TRAIN_BATCH = 128, 8
# K2b (flash attention's backward) at shapes no training path gives it:
# granite-20b's group of 48 over one kv head, gemma3's window of 1024 at
# 1040 positions, MLA's D 192 with Dv 128, and one small float32 case
# (GQA, a window, ragged tiles); the training paths' shapes come from
# TRAIN_PATHS
BWD_SHAPES = (
    AttnShape("granite-20b group", 4, 48, 1, 100, 128, 128, None, 0),
    AttnShape("gemma3-27b window", 1, 32, 16, 1040, 128, 128, 1024, 0),
    AttnShape("D 192 Dv 128", 2, 16, 16, 100, 192, 128, None, 0),
    AttnShape("f32 small", 2, 6, 2, 77, 32, 24, 16, 0),
)


class TrainPath(NamedTuple):
    """A model phases 18 and 19 train at full width: its (layers,
    d_model), the launches a step of (K2, K2b, K4, K4b) that the
    reference's remat gives (a layer under remat runs its forward twice
    and its backward once; zamba2's shared block runs outside remat, as
    the reference's ``group_body``), and whether ``train_loop`` drives it
    (phase 18) or ``make_train_step`` (phase 19)."""
    arch: str
    width: Tuple[int, int]
    per_step: Tuple[int, int, int, int]
    loop: bool = False


TRAIN_PATHS = (
    TrainPath("minitron-4b", (32, 3072), (64, 32, 0, 0), loop=True),
    TrainPath("mamba2-370m", (48, 1024), (0, 0, 96, 48)),
    TrainPath("zamba2-2.7b", (54, 2560), (9, 9, 108, 54)),
    TrainPath("granite-moe-1b-a400m", (24, 1024), (48, 24, 0, 0)),
    # 4 encoder layers (self-attention over 1500 frames) and 4 decoder
    # layers (causal self-attention, cross-attention to the 1500 frames)
    TrainPath("whisper-tiny", (4, 384), (24, 12, 0, 0)),
)


def train_attention_shapes(tp: TrainPath, cfg):
    """[(AttnShape, K2 launches, K2b launches)] of phase 19's run of `tp`
    (TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens), as the model
    gives K2 its operands (kv expanded to padded query heads); the
    AttnShape's launches are K2b's."""
    B, S, n = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS
    if cfg.family == "ssm":
        return []
    H, Hkv, hd, Hp = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.padded_heads
    H2, Hkv2 = (Hp, Hp) if Hp != H else (H, Hkv)
    t = f"train {tp.arch}"
    if cfg.enc_dec:
        Le, L, Se = cfg.n_enc_layers, cfg.n_layers, cfg.n_audio_frames
        return [(AttnShape(f"{t} encoder", B, H2, Hkv2, Se, hd, hd, None,
                           Le * n, causal=False), 2 * Le * n, Le * n),
                (AttnShape(f"{t} self", B, H2, Hkv2, S, hd, hd, None, L * n),
                 2 * L * n, L * n),
                (AttnShape(f"{t} cross", B, H2, Hkv2, S, hd, hd, None, L * n,
                           Sk=Se, causal=False), 2 * L * n, L * n)]
    if cfg.family == "hybrid":
        G = cfg.n_layers // cfg.shared_attn_every
        return [(AttnShape(t, B, H2, Hkv2, S, hd, hd, None, G * n), G * n,
                 G * n)]
    L = cfg.n_layers
    return [(AttnShape(t, B, H2, Hkv2, S, hd, hd, None, L * n), 2 * L * n,
             L * n)]


def k2b_row(torch, F, ops, randn, a: AttnShape) -> dict:
    """K2b at shape a (causal or not, over a.Sk keys) against its plain
    version on the same residuals (K2's o and lse): per gradient max|d| /
    max|plain| < 2e-2 in bf16, atol 2e-3 / rtol 1e-3 in float32; timed
    beside SDPA's backward alone (autograd through SDPA, less SDPA's
    forward)."""
    from repro_torch.kernels import flash_attention, flash_attention_bwd, ref
    f32 = a.tag.startswith("f32")
    dtype = torch.float32 if f32 else torch.bfloat16
    name = "float32" if f32 else "bfloat16"
    Sk = a.Sk or a.S
    q = randn(a.B, a.H, a.S, a.D, dtype=dtype)
    k = randn(a.B, a.Hkv, Sk, a.D, dtype=dtype)
    v = randn(a.B, a.Hkv, Sk, a.Dv, dtype=dtype)
    do = randn(a.B, a.H, a.S, a.Dv, dtype=dtype)
    o, lse = flash_attention.flash_attention(q, k, v, causal=a.causal,
                                             window=a.window,
                                             return_lse=True)
    g = a.H // a.Hkv

    def kernel():
        return flash_attention_bwd.flash_attention_bwd(
            q, k, v, o, lse, do, causal=a.causal, window=a.window)

    def plain():
        dq, dk, dv = ref.flash_attention_bwd_ref(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), o, lse,
            do, causal=a.causal, window=a.window)
        # autograd through the repeat sums the group's gradients
        return (dq, dk.float().reshape(a.B, a.Hkv, g, Sk, a.D).sum(2),
                dv.float().reshape(a.B, a.Hkv, g, Sk, a.Dv).sum(2))

    plan = flash_attention_bwd.bwd_plan(dtype, a.B, a.Hkv, Sk, g, a.D,
                                        a.Dv)
    route = ("mma" if plan.route == flash_attention_bwd.MMA
             else "scalar") + f", G {plan.G}"
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    errs = []
    for gname, x, w in zip(("dq", "dk", "dv"), got, want):
        x, w = x.float(), w.float()
        if x.shape != w.shape or not torch.isfinite(x).all():
            fail(f"flash_attention_bwd {a.tag} {gname}: {tuple(x.shape)} "
                 f"not finite or not {tuple(w.shape)}")
        if f32:
            errs.append(check_close(torch, f"flash_attention_bwd {a.tag} "
                                    f"{gname}", x, w, "float32"))
        else:
            rel = float((x - w).abs().max() / w.abs().max())
            if rel >= 2e-2:
                fail(f"flash_attention_bwd {a.tag} {gname}: max|d| / "
                     f"max|plain| {rel:.3g} >= 2e-2")
            errs.append(float((x - w).abs().max()))
    again = kernel()
    bit_equal = all(torch.equal(x, y) for x, y in zip(got, again))
    if not bit_equal:
        fail(f"flash_attention_bwd {a.tag}: two calls on the same inputs "
             f"differ (the kernel has no atomics)")
    # SDPA's backward alone: fwd+bwd less fwd, on leaf copies of q, k, v
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    if not a.causal:
        sdpa_kw = {}
    elif a.window is None:
        sdpa_kw = dict(is_causal=True)
    else:
        i = torch.arange(a.S, device="cuda")
        d = i[:, None] - i[None, :]
        sdpa_kw = dict(attn_mask=(d >= 0) & (d < a.window))

    def lib_fwd():
        return F.scaled_dot_product_attention(ql, kl, vl, enable_gqa=True,
                                              **sdpa_kw)

    def lib_fwd_bwd():
        return torch.autograd.grad(lib_fwd(), (ql, kl, vl), do)

    t = timings(torch, kernel, plain)
    fwd_ms = device_ms(torch, lib_fwd)
    both_ms = device_ms(torch, lib_fwd_bwd)
    fwd_call = call_ms(torch, lib_fwd)
    both_call = call_ms(torch, lib_fwd_bwd)
    t.update(library_ms=both_ms - fwd_ms,
             library_call_ms=both_call - fwd_call)
    pairs = a.B * a.H * (causal_pairs(a.S, a.window) if a.causal
                         else a.S * Sk)
    b_ms, b_by = bound(nbytes(q, k, v, o, lse, do, *got),
                       int(2.5 * 2 * pairs * (a.D + a.Dv)), name)
    win = "" if a.window is None else f", window {a.window}"
    return dict(
        name="flash_attention_bwd", path=a.tag, route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/ref.py:236 (_faf_bwd, the jnp custom "
                 "VJP of flash_attention_fused)",
        shape=f"q ({a.B},{a.H},{a.S},{a.D}), k ({a.B},{a.Hkv},{Sk},"
              f"{a.D}), v Dv {a.Dv} {name} "
              f"{'causal' if a.causal else 'not causal'}{win} "
              f"[route {route}]",
        key=flash_attention.shape_key(q, k, v, a.window), expect=a.launches,
        launches=0, max_abs_err=max(errs), bound_ms=b_ms, bound_by=b_by,
        bit_equal_rerun=bit_equal, **t)


def guard_check(torch, ops) -> None:
    """Under grad mode, a CUDA tensor that requires grad reaching a kernel
    with no backward (K1, K3, K2 with a query offset) raises, and no
    kernel is launched: a kernel's output carries no gradient.  One that
    reaches K4 runs K4 and, in the backward, K4b once each; under no_grad
    the same call builds no graph."""
    from repro_torch.kernels import ssd_scan, ssd_scan_bwd
    x = torch.zeros(4, 8, device="cuda", requires_grad=True)
    z = torch.zeros

    calls = {
        "neutron_matmul (K1)": lambda: ops.neutron_matmul(
            x, z(8, 3, device="cuda")),
        "flash_decode (K3)": lambda: ops.flash_decode(
            x.reshape(1, 4, 8), z(1, 4, 5, 8, device="cuda"),
            z(1, 4, 5, 8, device="cuda")),
        "flash_attention (K2) with a q_offset": lambda: ops.flash_attention(
            x.reshape(1, 1, 4, 8), z(1, 1, 4, 8, device="cuda"),
            z(1, 1, 4, 8, device="cuda"),
            q_offset=z(1, dtype=torch.int32, device="cuda")),
    }
    before = read_launches()
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "no backward kernel" not in str(e):
                fail(f"{name} under grad raised another error: {e}")
        else:
            fail(f"{name} took a tensor that requires grad under grad mode")
    if read_launches() != before:
        fail("a kernel without a backward launched under grad")
    print(f"  the guard: {', '.join(calls)} raise under grad, no launch")
    x4 = torch.ones(1, 4, 1, 8, device="cuda", requires_grad=True)
    a4 = (torch.ones(1, 4, 1, device="cuda"), -torch.ones(1, device="cuda"),
          torch.ones(1, 4, 2, device="cuda"), torch.ones(1, 4, 2,
                                                         device="cuda"))
    n0 = (ssd_scan.launches, ssd_scan_bwd.launches)
    y, _ = ops.ssd_scan(x4, *a4, chunk=4)
    y.sum().backward()
    torch.cuda.synchronize()
    n1 = (ssd_scan.launches, ssd_scan_bwd.launches)
    if n1 != (n0[0] + 1, n0[1] + 1) or x4.grad is None or \
            not torch.isfinite(x4.grad).all():
        fail(f"ssd_scan under grad launched K4, K4b {n1} after {n0}; "
             f"x.grad {x4.grad}")
    with torch.no_grad():
        y, _ = ops.ssd_scan(x4, *a4, chunk=4)
    if y.grad_fn is not None or ssd_scan_bwd.launches != n1[1]:
        fail("ssd_scan under no_grad built a graph")
    print("  ssd_scan (K4) under grad: K4 and K4b once each, finite "
          "gradient; under no_grad no graph")


def k3_row(torch, F, ops, randn, a: AttnShape) -> dict:
    """K3 at a path's last decode step (the cache full: kv_len = S)
    against its plain version, timed beside SDPA on the same inputs."""
    from repro_torch.kernels import flash_decode
    q = randn(a.B, a.H, a.D)
    k, v = randn(a.B, a.Hkv, a.S, a.D), randn(a.B, a.Hkv, a.S, a.Dv)
    kv_len = torch.full((a.B,), a.S, dtype=torch.int32, device="cuda")

    def kernel():
        return ops.flash_decode(q, k, v, kv_len=kv_len, return_lse=a.lse)

    def plain():
        return ops.flash_decode(q, k, v, kv_len=kv_len, impl="ref",
                                return_lse=a.lse)

    got = kernel()
    if a.lse:
        (got, lse), (want, lse_want) = got, plain()
        err = check_close(torch, f"flash_decode bf16 {a.tag}", got, want,
                          "bfloat16")
        e = check_close(torch, f"flash_decode lse {a.tag}", lse, lse_want,
                        "float32")
        print(f"  flash_decode [{a.tag}] with its lse: lse max|err| "
              f"{e:.3g}")
        got = (got, lse)
    else:
        err = check_close(torch, f"flash_decode bf16 {a.tag}", got,
                          plain(), "bfloat16")
    e = k3_boundary_probe(torch, ops, randn, a)
    print(f"  flash_decode [{a.tag}] kv_len probe (k = 0, markers at the "
          f"last valid key and the one after): max|err| {e:.3g}")
    outs = got if a.lse else (got,)
    b_ms, b_by = bound(nbytes(q, k, v, kv_len, *outs),
                       2 * a.B * a.H * a.S * (a.D + a.Dv), "bfloat16")
    return dict(
        name="flash_decode", path=a.tag, route="cuda",
        source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:96",
        shape=f"q ({a.B},{a.H},{a.D}) x cache ({a.B},{a.Hkv},{a.S},"
              f"{a.D}), v Dv {a.Dv} bf16{' +lse' if a.lse else ''}",
        key=flash_decode.shape_key(q, k, v), expect=a.launches,
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        **timings(torch, kernel, plain,
                  lambda: F.scaled_dot_product_attention(
                      q[:, :, None], k, v, enable_gqa=True)))


def k4_row(torch, randn, tag, B, S, H, P, N, L, pad, expect) -> dict:
    """K4 in bf16 at x (B,S,H,P), N, chunk L, the last `pad` rows zero,
    against its plain version, timed."""
    from repro_torch.kernels import ref, ssd_scan
    args = ssd_inputs(torch, randn, B, S, H, P, N, torch.bfloat16, pad=pad)
    got = ssd_scan.ssd_chunk(*args, L)
    err = max(check_close(torch, f"ssd_chunk bf16 {tag} {i}", g, w,
                          "float32")
              for i, (g, w) in enumerate(zip(got,
                                             ref.ssd_chunk_ref(*args, L))))
    b_ms, b_by = bound(nbytes(*args, *got), ssd_flops(B, S, H, P, N, L),
                       "bfloat16")
    return dict(
        name="ssd_chunk", path=tag, route="cuda",
        source="src/repro_torch/csrc/ssd_chunk.cu",
        replaces="src/repro/kernels/ssd_scan.py:93",
        shape=f"x ({B},{S},{H},{P}) bf16, N={N}, chunk {L}, {pad} zero rows",
        expect=expect, max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        **timings(torch, lambda: ssd_scan.ssd_chunk(*args, L),
                  lambda: ref.ssd_chunk_ref(*args, L)))


def ssd_bwd_flops(B, S, H, P, N, L) -> dict:
    """Operations the function of K4b needs with bf16 x, Bm and Cm, by the
    rate the card has for their operands: per (b, chunk), C B^T over s <=
    t (both bf16) and the products of dCB summed over the heads with B and
    C (dC and dB's second term); per head, dG = dy x^T and G^T dy over
    s <= t, Q = B dcontrib^T and x^T dcontrib.  Every product but C B^T
    has a float32 operand and counts as TF32 work at float32 accuracy:
    three TF32 products where both operands are float32 (G^T dy), two
    where the other operand is bf16 and so exact in TF32 (dC, dB's second
    term, dG, Q, x^T dcontrib)."""
    tri = L * (L + 1) // 2
    nbc = B * (S // L)
    return {"bfloat16": nbc * tri * 2 * N,
            "tf32": nbc * (2 * 2 * tri * 2 * N
                           + H * (2 * 2 * tri * P + 3 * 2 * tri * P
                                  + 2 * 2 * 2 * L * P * N))}


SSD_BWD_GRADS = ("dx", "ddt", "dA", "dBm", "dCm")


def k4b_grads(torch, randn, B, S, H, P, N, L, pad, dtype):
    """K4b and its plain version on K4's inputs (as ``ssd_inputs``), K4's
    own seg and random float32 cotangents: (kernel, plain, got, want, the
    operands)."""
    from repro_torch.kernels import ref, ssd_scan, ssd_scan_bwd
    f32 = torch.float32
    args = ssd_inputs(torch, randn, B, S, H, P, N, dtype, pad=pad)
    seg = ssd_scan.ssd_chunk(*args, L)[3]
    nc = S // L
    cot = (randn(B, S, H, P, dtype=f32), randn(B, nc, H, P, N, dtype=f32),
           randn(B, nc, H, dtype=f32), randn(B, S, H, dtype=f32))

    def kernel():
        return ssd_scan_bwd.ssd_chunk_bwd(*args, seg, *cot, L)

    def plain():
        return ref.ssd_chunk_bwd_ref(*args, seg, *cot, L)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    return kernel, plain, got, want, (*args, seg, *cot)


def k4b_held(torch, tag, kernel, got, want, limit) -> dict:
    """Each gradient of K4b within max|d| / max|plain| < `limit` and a
    second call bit-equal; returns {gradient: max|d| / max|plain|}."""
    rels = {}
    for gname, g, w in zip(SSD_BWD_GRADS, got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"ssd_chunk_bwd {tag} {gname}: {tuple(g.shape)} not finite "
                 f"or not {tuple(w.shape)}")
        rels[gname] = float((g - w).abs().max() / w.abs().max())
        if not rels[gname] < limit:
            fail(f"ssd_chunk_bwd {tag} {gname}: max|d| / max|plain| "
                 f"{rels[gname]:.3g} >= {limit}")
    if not all(torch.equal(g, a) for g, a in zip(got, kernel())):
        fail(f"ssd_chunk_bwd {tag}: two calls on the same inputs differ "
             f"(the kernel has no atomics)")
    return rels


def k4b_row(torch, randn, tag, B, S, H, P, N, L, pad, expect) -> dict:
    """K4b with bf16 x, Bm, Cm at x (B,S,H,P), N, chunk L, the last `pad`
    rows zero, against its plain version (per gradient max|d| /
    max|plain| < 1e-4: both do float32 arithmetic on the same bf16
    inputs and float32 cotangents; a rerun bit-equal), timed; no single
    PyTorch call computes it."""
    kernel, plain, got, want, ops_in = k4b_grads(
        torch, randn, B, S, H, P, N, L, pad, torch.bfloat16)
    rels = k4b_held(torch, tag, kernel, got, want, 1e-4)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    b_ms, b_by = bound(nbytes(*ops_in, *got),
                       ssd_bwd_flops(B, S, H, P, N, L))
    # where the call's device time goes, by kernel (the bf16 body, the
    # sum over head groups, the dC / dB products)
    _, parts = device_ms(torch, kernel, split=re.compile(
        r"ssd_chunk_bwd_\w*kernel"))
    return dict(
        name="ssd_chunk_bwd", path=tag, route="cuda",
        source="src/repro_torch/csrc/ssd_chunk_bwd.cu",
        replaces="none: autodiff of ssd_scan_ref, src/repro/kernels/"
                 "ref.py:331-391 (the backward of K4, src/repro/kernels/"
                 "ssd_scan.py:93)",
        shape=f"x ({B},{S},{H},{P}) bf16, N={N}, chunk {L}, {pad} zero "
              f"rows; max|d|/max|plain| "
              f"{', '.join(f'{k} {v:.2g}' for k, v in rels.items())}; "
              f"kernels ms "
              f"{', '.join(f'{k} {v:.4f}' for k, v in parts.items())}",
        expect=expect, launches=0, max_abs_err=err, rel_err=rels,
        kernels_ms=parts,
        bit_equal_rerun=True, bound_ms=b_ms, bound_by=b_by,
        **timings(torch, kernel, plain))


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
    # ssd_chunk_bwd (K4b) with float32 inputs: the same small cases; in
    # bf16 (the tensor-core body) N and P off 16 and a head group of 4
    # that does not divide H, with zero rows
    bf = torch.bfloat16
    for B, S, H, P, N, L, pad, dt in ((1, 32, 1, 8, 4, 8, 0, f32),
                                      (2, 128, 3, 16, 8, 32, 28, f32),
                                      (2, 96, 3, 24, 40, 32, 0, f32),
                                      (1, 256, 2, 128, 128, 128, 0, f32),
                                      (2, 96, 3, 24, 40, 32, 0, bf),
                                      (100, 32, 5, 24, 40, 32, 20, bf)):
        name = str(dt).replace("torch.", "")
        kernel, _, got, want, _ = k4b_grads(torch, randn, B, S, H, P, N, L,
                                            pad, dt)
        rels = k4b_held(torch, f"{name} ({B},{S},{H},{P})", kernel, got,
                        want, 1e-4)
        print(f"  ssd_chunk_bwd {name} x ({B},{S},{H},{P}) N={N} chunk={L} "
              f"zero rows {pad}: max|d|/max|plain| "
              f"{max(rels.values()):.3g}, rerun bit-equal")

    rows = {}
    # each path's shapes come from its config
    cfgs = {p.arch: get_arch(p.arch) for p in LM_PATHS}
    for path in LM_PATHS:
        k2_shapes, k3_shapes = attention_shapes(path, cfgs[path.arch])
        for a in k2_shapes:
            rows[("flash_attention", a.tag)] = k2_row(torch, F, ops, randn, a)
        for a in k3_shapes:
            rows[("flash_decode", a.tag)] = k3_row(torch, F, ops, randn, a)
    decoder_attention_rows(torch, F, ops, randn, rows)
    for a in BWD_SHAPES:
        rows[("flash_attention_bwd", a.tag)] = k2b_row(torch, F, ops, randn,
                                                       a)
    # phases 18 and 19's training shapes: K2 (its lse checked) and K2b
    for tp in TRAIN_PATHS:
        for a, k2n, _ in train_attention_shapes(tp, cfgs[tp.arch]):
            rows[("flash_attention", a.tag)] = k2_row(
                torch, F, ops, randn, a._replace(launches=k2n))
            rows[("flash_attention_bwd", a.tag)] = k2b_row(torch, F, ops,
                                                           randn, a)
    # phase 20's shards (one rank's heads of granite-moe's training, one
    # rank's positions of granite-20b's decode cache, with the lse) and
    # phase 19's deepseek-v3 training with its mtp block (reduced, f32)
    for a, k2n in dist_attention_shapes():
        if a.lse:
            rows[("flash_decode", a.tag)] = k3_row(torch, F, ops, randn, a)
            continue
        rows[("flash_attention", a.tag)] = k2_row(
            torch, F, ops, randn, a._replace(launches=k2n))
        rows[("flash_attention_bwd", a.tag)] = k2b_row(torch, F, ops, randn,
                                                       a)
    guard_check(torch, ops)

    # ssd_chunk at the prefill shapes: the prompt of 200 padded to 256
    print("  ssd_chunk: library_ms is null; no single PyTorch call computes "
          "the gated intra-chunk SSD form with its state contributions")
    # and K4b, its backward, at them (no serving path trains: 0
    # launches) and at phase 19's training shapes, where K4 runs too
    print("  ssd_chunk_bwd: library_ms is null; no single PyTorch call "
          "computes the gradients of the intra-chunk SSD form")
    for path in (ZAMBA, MAMBA):
        cfg = cfgs[path.arch]
        dims = (path.batch, -(-path.prompt_len // cfg.ssm_chunk)
                * cfg.ssm_chunk, cfg.ssm_heads, cfg.ssm_head_dim,
                cfg.ssm_state, cfg.ssm_chunk)
        pad = dims[1] - path.prompt_len
        rows[("ssd_chunk", path.arch)] = k4_row(
            torch, randn, path.arch, *dims, pad, path.prefill[2])
        rows[("ssd_chunk_bwd", path.arch)] = k4b_row(
            torch, randn, path.arch, *dims, pad, 0)
    for tp in TRAIN_PATHS:
        cfg = cfgs[tp.arch]
        if not tp.per_step[2]:
            continue
        tag = f"train {tp.arch}"
        dims = (TRAIN_BATCH, TRAIN_SEQ, cfg.ssm_heads, cfg.ssm_head_dim,
                cfg.ssm_state, cfg.ssm_chunk)
        rows[("ssd_chunk", tag)] = k4_row(torch, randn, tag, *dims, 0,
                                          tp.per_step[2] * TRAIN_STEPS)
        rows[("ssd_chunk_bwd", tag)] = k4b_row(torch, randn, tag, *dims, 0,
                                               tp.per_step[3] * TRAIN_STEPS)
    # phase 20's SSD shards: one rank's heads
    tag, dims, k4n, k4bn = dist_ssd_dims()
    rows[("ssd_chunk", tag)] = k4_row(torch, randn, tag, *dims, 0, k4n)
    rows[("ssd_chunk_bwd", tag)] = k4b_row(torch, randn, tag, *dims, 0, k4bn)

    phase_k1(torch, ops, rows)

    for r in rows.values():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} (call {r['library_call_ms']:.4f})"
        strided = "" if "strided_ms" not in r else \
            f", {r['strided_ms']:.4f} from the slots' views"
        if "expand_ms" in r:
            strided += (f", {r['expand_ms']:.4f} with the cached K/V's "
                        f"expansion to the padded heads")
        if "as_k3_ms" in r:
            strided += f", K3 on the same inputs {r['as_k3_ms']:.4f}"
        print(f"  {r['name']} [{r['path']}] {r['shape']}: device "
              f"{r['ms']:.4f} ms{strided}, call {r['call_ms']:.4f} (plain "
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
    where the int8 outputs must be equal, the float32 contract at the
    float32 plan's, and both at the decoder's of phase 13."""
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
        name = f"neutron_matmul {dtype} ({M},{K},{N})"
        got = ops.neutron_matmul(x, w, bias=b, scale=0.5, act="gelu")
        want = no_tf32(torch, lambda: ops.neutron_matmul(
            x, w, bias=b, scale=0.5, act="gelu", impl="ref"))
        e = check_close(torch, name, got, want, dtype)
        if dtype == "float32":
            check_plan_tol(torch, name, got, want)
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

    for shp in K1_SHAPES:
        k1_plan_row(torch, ops, rows, randint, gen, shp, VISION_BATCH)
    # the float32 Pallas contract with an (N, K) weight, as the float32
    # plan calls it; the library call is torch.matmul with TF32 off
    for shp in K1_F32_SHAPES:
        k1_f32_row(torch, ops, rows, randn, shp, VISION_BATCH)
    # the decoder of phase 13 at one sequence: a decode step (1 row) and
    # B's prefill (64 rows), whose int8 logits rows lie at an odd pitch
    for shp in DECODER_K1_SHAPES:
        k1_plan_row(torch, ops, rows, randint, gen,
                    shp._replace(path=f"{shp.path} int8"), 1)
        k1_f32_row(torch, ops, rows, randn,
                   shp._replace(path=f"{shp.path} float32"), 1)


def k1_plan_row(torch, ops, rows, randint, gen, shp: K1Shape, B: int):
    """K1's int8 plan contract at one GEMM of a path (batch B) against its
    plain version: equal ints where the activation is piecewise linear,
    within one step elsewhere (gelu: the kernel's tanh is not torch's);
    timed beside ``torch._int_mm``."""
    from repro_torch.kernels import ref
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
    d = (out.int() - want.int()).abs()
    err = int(d.max())
    if err > (shp.act not in ("none", "relu", "relu6")):
        fail(f"neutron_matmul {shp.path} {shp.what}: the int8 plan "
             f"epilogue differs from its plain version by {err}")
    if err:
        print(f"  neutron_matmul {shp.path} {shp.what}: {int((d > 0).sum())}"
              f" of {d.numel()} ints one step from the plain version "
              f"({shp.act})")
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


def k1_f32_row(torch, ops, rows, randn, shp: K1Shape, B: int):
    """K1's float32 Pallas contract with an (N, K) weight, as the float32
    plan calls it, at one GEMM of a path (batch B) against its plain
    version (TOL and ``float_plan_tol``), bit-equal on a rerun; timed
    beside torch.matmul with TF32 off.  Its shape names the route of
    ``float_plan``; the bound counts the tiled route's products at the
    TF32 rate, three for each multiply-add pair."""
    from repro_torch.kernels import neutron_matmul, ref
    M = B * shp.rows
    x = randn(B, shp.rows, shp.K)
    wt = randn(shp.N, shp.K) / math.sqrt(shp.K)
    bias = randn(shp.N)
    out = torch.empty((B, shp.rows, shp.N), device="cuda")
    args = (x, wt, bias, shp.act)
    ops.neutron_matmul_nk(*args, out)
    first = out.clone()
    ops.neutron_matmul_nk(*args, out)
    want = no_tf32(torch, lambda: ref.neutron_matmul_nk_ref(*args))
    err = check_close(torch, f"neutron_matmul f32 {shp.what}", first, want,
                      "float32")
    check_plan_tol(torch, f"neutron_matmul f32 {shp.what}", first, want)
    if not torch.equal(first, out):
        fail(f"neutron_matmul f32 {shp.what}: two calls on the same inputs "
             f"differ (the float body has no atomics)")
    fp = neutron_matmul.float_plan(B, shp.rows, shp.N, shp.K,
                                   (x.stride(0), 0, x.stride(1)),
                                   (x.data_ptr(), wt.data_ptr()))
    skinny = fp.route == neutron_matmul.SKINNY
    route = (f"skinny, {fp.splits} warps on K" if skinny else
             f"tiled 3xTF32, tile N {fp.tile_n}, {fp.splits} splits")
    x2, w_kn = x.view(M, shp.K), wt.t()
    # the skinny route's products are FMAs; the tiled route's are three
    # TF32 products on the tensor cores for each one
    flops = 2 * M * shp.N * shp.K
    b_ms, b_by = (bound(nbytes(x, wt, bias, out), flops, "float32")
                  if skinny else
                  bound(nbytes(x, wt, bias, out), 3 * flops, "tf32"))
    rows[("neutron_matmul", f"{shp.path}: {shp.what}")] = dict(
        name="neutron_matmul", path=shp.path, route="cuda",
        source="src/repro_torch/csrc/neutron_matmul.cu",
        replaces="src/repro/kernels/neutron_matmul.py:137",
        shape=f"{shp.what}: x ({B},{shp.rows},{shp.K}) f32, w "
              f"({shp.N},{shp.K}), bias, {shp.act}, Pallas contract "
              f"(library: torch.matmul, TF32 off, no epilogue) "
              f"[route {route}]",
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by, bit_equal_rerun=True,
        **timings(torch, lambda: ops.neutron_matmul_nk(*args, out),
                  lambda: no_tf32(torch, lambda:
                                  ref.neutron_matmul_nk_ref(*args)),
                  lambda: no_tf32(torch, lambda: torch.matmul(x2, w_kn))))


def no_tf32(torch, fn):
    """``fn()`` with cuBLAS's float32 products held out of TF32 (the flag
    set and restored around the call)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


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
    for mod in launch_counters() + bwd_counters():
        mod.launches = 0
        if hasattr(mod, "lse_launches"):
            mod.lse_launches = 0
        if hasattr(mod, "launches_by_shape"):
            mod.launches_by_shape.clear()
        if hasattr(mod, "launches_by_contract"):
            mod.launches_by_contract.clear()


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


def run_prefill(torch, lm, cfg, model, batch):
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.no_grad():
        out = lm.prefill(cfg, model, batch)
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def moe_layers(model):
    from repro_torch.models.moe import MoE
    return [m for m in model.modules() if isinstance(m, MoE)]


def phase_path(torch, rows, path, f32_last=None):
    import dataclasses
    from repro_torch.launch.serve import (decode_aux, draw_inputs, generate,
                                          serve)
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
    if served.aux_s:        # whisper: the encoder and the cross K/V, once
        out.update({k[:-2] + "_ms": v * 1e3
                    for k, v in served.aux_s.items()})
        print(f"  before the replay: encoder {out['encode_ms']:.1f} ms, "
              f"cross K/V {out['cross_kv_ms']:.1f} ms (wall)")
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
                                       served.batch)
    prefill_launches = read_launches()
    prefill_shapes = read_launches_by_shape()
    _, prefill_s = run_prefill(torch, lm, cfg, served.model,
                               served.batch)       # warm: timed, not counted
    if prefill_launches != path.prefill:
        fail(f"{path.arch}: prefill launched {names} = {prefill_launches}, "
             f"expected {path.prefill}")
    # the path's rows of phase 2, one per shape at which it runs a kernel:
    # each row's launches are those counted under its shape in this run
    # (K2 and K3 count by shape; K4 runs at one shape per path), and must
    # be what the config says (phase 13's decoder rows are its own)
    mine = [r for r in rows.values() if r["path"].split()[0] == path.arch
            and not r["path"].startswith(DECODER_PATH)]
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
            last_nd = lm.prefill(nd, served.model, served.batch)
        if sum(int(m.dropped) for m in moes) != before:
            fail(f"{path.arch}: capacity_factor {nd.capacity_factor} "
                 f"dropped assignments")
        rel, same, ok = agreement(torch, replay.prompt_logits, last_nd)
        out["prefill_vs_replay_bf16_no_drops"] = rel
        print(f"  at capacity_factor {nd.capacity_factor} (no drops): "
              f"prefill vs decode replay max|d|/max|logit| {rel:.3g}, "
              f"argmax equal {same}")
        del replay, last_nd
    if f32_last is not None:
        # the same weights in float32 (rounded to bf16 here): how far bf16
        # rounding alone moves each path's logits
        f32_last = f32_last.to(last.device)
        out["bf16_prefill_vs_f32"] = agreement(torch, f32_last, last)[0]
        out["bf16_replay_vs_f32"] = agreement(torch, f32_last,
                                              res.prompt_logits)[0]
        held = ("held as well" if path.bf16_limit is not None else
                "reported, not held")
        print(f"  bf16 against float32 prefill: prefill "
              f"{out['bf16_prefill_vs_f32']:.3g}, replay "
              f"{out['bf16_replay_vs_f32']:.3g}; the bf16 agreement is "
              f"{held}: it is held in float32 at full width")
    if path.bf16_limit is not None and (rel >= path.bf16_limit or not ok):
        fail(f"{path.arch}: prefill and decode replay disagree")
    del served, last, res, moes
    torch.cuda.empty_cache()

    # the whole path on the card against the plain path on the CPU, at a
    # reduced config in float32 (TF32 off): decode replay, greedy tokens
    # and the full-sequence prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    small = get_arch(path.arch).reduced(dtype="float32", **path.small)
    cpu_model = lm.init_params(small, SEED, device="cpu")
    prompts, extra = draw_inputs(small, np.random.default_rng(SEED),
                                 path.batch, 19)
    batch = {"tokens": prompts, **extra}
    on_cpu = generate(small, cpu_model, prompts, gen=6,
                      aux=decode_aux(small, cpu_model, extra)[0])
    with torch.no_grad():
        pre_cpu = lm.prefill(small, cpu_model, batch)
    gpu_model = cpu_model.to("cuda")
    on_gpu = generate(small, gpu_model, prompts, gen=6,
                      aux=decode_aux(small, gpu_model, extra)[0])
    with torch.no_grad():
        pre_gpu = lm.prefill(small, gpu_model, batch)
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
    from repro_torch.launch.serve import decode_aux, draw_inputs, generate
    from repro_torch.models import lm
    from repro_torch.models.registry import get_arch

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(path.arch), dtype="float32")
    model = lm.init_params(cfg, SEED, device="cuda")
    # serve's inputs for the same seed
    prompts, extra = draw_inputs(cfg, np.random.default_rng(SEED),
                                 path.batch, path.prompt_len)
    res = generate(cfg, model, prompts, gen=0,
                   aux=decode_aux(cfg, model, extra)[0])
    last, _ = run_prefill(torch, lm, cfg, model, {"tokens": prompts,
                                                  **extra})
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
    # what phase 11 holds the compiled model to: the same images, the
    # stored ints of the first replay and the warm replay time
    ref = dict(images=served.images,
               stored={k: v.cpu() for k, v in served.stored.items()},
               replay_ms=served.replay_ms)
    del served, plan, cpu_plan
    torch.cuda.empty_cache()
    return out, ref


# --------------------------------------------------------------------------
# phase 11: the compiled model on the card
# --------------------------------------------------------------------------


def phase_compiled(torch, path, ref):
    """``repro_torch.api.compile`` (PTQ and the CP compile on the host,
    default options), the compiled model's int8 plan replayed on the card
    against phase 6's stored ints for the same images, ``verify()`` (the
    host interpreter against the card plan) and the save -> mmap load ->
    replay round trip.  Returns the figures and the model, which phase 12
    serves."""
    import tempfile
    import threading

    from repro_torch import api
    from repro_torch.core.executor import ExecutionError

    # solve_many forks its pool only while the process has one Python
    # thread; CUDA's and torch's threads are native, so they do not count
    threads = threading.active_count()
    t0 = time.monotonic()
    model = api.compile(path.name, precision="int8", seed=SEED)
    compile_wall_s = time.monotonic() - t0
    if model.device.type != "cuda":
        fail(f"{path.name}: the compiled model replays on {model.device}")
    st = model.program.stats()
    print(f"  api.compile: {compile_wall_s:.2f} s wall (build, PTQ and "
          f"compile; compile_graph {model.compile_s:.2f} s, Python threads "
          f"{threads}); {st['ticks']} ticks, {model.program.ddr_bytes()} "
          f"DDR bytes, {st['latency_ms']:.3f} ms modeled")
    for line in model.report().splitlines():
        print(f"  | {line}")

    images = ref["images"]
    inp = model.graph.inputs[0].name
    feed = {inp: images}
    n = len(images)
    t0 = time.monotonic()
    plan = model.plan_for(n)
    torch.cuda.synchronize()
    lower_s = time.monotonic() - t0
    # warm replays in turns: CompiledModel.__call__ and the bare plan it
    # runs (phase 6's call), so that what the API adds is told apart from
    # the drift of the host between phases
    reset_launches()
    stored = plan.run(feed, n=n, decode=False)
    times = {"call": [], "plan": []}
    for i in range(2 * COMPILED_PAIRS):
        which = ("call", "plan")[(i + i // 2) % 2]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if which == "call":
            outputs = model(images)
        else:
            plan.run(feed, n=n)
        torch.cuda.synchronize()
        times[which].append((time.monotonic() - t0) * 1e3)
    launches = read_launches()
    replays = 1 + 2 * COMPILED_PAIRS
    replay_ms = statistics.median(times["call"])
    plan_ms = statistics.median(times["plan"])
    spread = {k: [round(q, 3) for q in statistics.quantiles(v, n=4)]
              for k, v in times.items()}
    want = (0, 0, 0, replays * path.k1_per_replay)
    if launches != want:
        fail(f"{path.name}: the compiled model launched {LAUNCH_NAMES} = "
             f"{launches} over {replays} replays, expected {want}")
    for name, w in ref["stored"].items():
        if not torch.equal(stored[name].cpu(), w):
            d = (stored[name].cpu().int() - w.int()).abs()
            fail(f"{path.name}: the compiled model's stored ints of {name} "
                 f"differ from phase 6's at {int((d > 0).sum())} of "
                 f"{d.numel()}, by up to {int(d.max())}")
    for name, out in outputs.items():
        if out.device.type != "cuda" or \
                tuple(out.shape) != (n,) + model.graph.tensors[name].shape \
                or not torch.isfinite(out).all():
            fail(f"{path.name}: output {name} {tuple(out.shape)} on "
                 f"{out.device} not finite or of the wrong shape")

    t0 = time.monotonic()
    try:
        rep = model.verify(images[0])
    except ExecutionError as e:
        fail(f"{path.name}: verify() failed: {e}")
    verify_s = time.monotonic() - t0

    with tempfile.TemporaryDirectory() as d:
        p = f"{d}/{path.name}.rpa"
        t0 = time.monotonic()
        model.save(p)
        save_s = time.monotonic() - t0
        rpa_bytes = Path(p).stat().st_size
        t0 = time.monotonic()
        loaded = api.load(p, mmap=True, device="cuda")
        load_s = time.monotonic() - t0
        reset_launches()
        t0 = time.monotonic()
        again = loaded.plan_for(n).run(feed, n=n, decode=False)
        torch.cuda.synchronize()
        loaded_first_s = time.monotonic() - t0
        loaded_launches = read_launches()[3]
        info = loaded.plan_cache_info()
        for name, w in ref["stored"].items():
            if not torch.equal(again[name].cpu(), w):
                fail(f"{path.name}: the loaded model's stored ints of "
                     f"{name} differ from phase 6's")
        if info["consts_computed"] != 0 or not info["consts_served"]:
            fail(f"{path.name}: the loaded model recomputed "
                 f"{info['consts_computed']} plan constants")
        if loaded_launches != path.k1_per_replay:
            fail(f"{path.name}: the loaded model launched K1 "
                 f"{loaded_launches} times in a replay, expected "
                 f"{path.k1_per_replay}")
        del loaded, again
    out = dict(compile_wall_s=compile_wall_s, compile_s=model.compile_s,
               python_threads=threads, ticks=st["ticks"],
               ddr_bytes=model.program.ddr_bytes(),
               modeled_latency_ms=st["latency_ms"], lower_s=lower_s,
               k1_per_replay=launches[3] // replays,
               replay_ms_batch8=replay_ms, plan_run_ms_batch8=plan_ms,
               replay_quartiles_ms=spread,
               phase6_replay_ms_batch8=ref["replay_ms"],
               verify_s=verify_s, verify_max_err=rep.max_err,
               save_s=save_s, rpa_bytes=rpa_bytes, load_mmap_s=load_s,
               loaded_first_replay_s=loaded_first_s,
               loaded_consts_served=info["consts_served"])
    print(f"  stored ints equal phase 6's (batch {n}); K1 "
          f"{launches[3] // replays} per replay; warm replay {replay_ms:.3f}"
          f" ms through __call__, {plan_ms:.3f} ms through the bare plan in "
          f"turns (phase 6: {ref['replay_ms']:.3f} ms); verify() "
          f"{verify_s:.2f} s;"
          f" save {save_s:.2f} s ({rpa_bytes} B), mmap load {load_s:.2f} s, "
          f"loaded replay equal with 0 constants recomputed")
    del plan, stored, outputs
    torch.cuda.empty_cache()
    return out, model


# --------------------------------------------------------------------------
# phase 12: the Session on the card
# --------------------------------------------------------------------------


def _equal_outputs(torch, got, want) -> bool:
    return sorted(got) == sorted(want) and all(
        got[k].device.type == "cpu" and torch.equal(got[k], want[k])
        for k in want)


def _session_warm(torch, api, models, per_batch, images, workers):
    """A session of ``workers`` threads whose workers each serve one
    batch of every model alone, K1 launching ``per_batch`` times in each
    batch; it leaves every worker's arena allocated (the plans are kept
    per model and worker id), so the traffic session after it measures
    warm serving."""
    sess = api.Session(workers=workers, max_batch=VISION_BATCH)
    try:
        for name, m in models.items():
            sess.add(m, name=name)
        for name in models:
            for _ in range(workers):
                b0 = sess.stats()["models"][name]["batches"]
                reset_launches()
                ts = [sess.submit(name, img) for img in images]
                for t in ts:
                    t.result(timeout=600)
                nb = sess.stats()["models"][name]["batches"] - b0
                k1 = read_launches()[3]
                if sess.stats()["pool"]["recycled_workers"]:
                    fail(f"phase 12 warm-up: a worker was recycled with no "
                         f"fault injected: {sess._pool.recycle_log}")
                if k1 != per_batch[name] * nb:
                    fail(f"phase 12 {name}: K1 launched {k1} times in "
                         f"{nb} batches, expected {per_batch[name]} a "
                         f"batch")
    finally:
        sess.close()


def _session_traffic(torch, api, models, per_batch, images, want,
                     want_f32, workers):
    """The traffic: SESSION_SUBMITTERS threads send SESSION_REQUESTS
    requests per model (image j % len(images)), interleaved over the
    models, to a session of ``workers`` threads; every check of phase 12
    on what comes back.  Returns its figures."""
    from repro_torch.core.executor import float_plan_tol
    from repro_torch.kernels import neutron_matmul
    sess = api.Session(workers=workers, max_batch=VISION_BATCH)
    try:
        for name, m in models.items():
            sess.add(m, name=name)
        order = [(name, j) for j in range(SESSION_REQUESTS)
                 for name in models]
        tickets, done_at, errors = {}, {}, []
        lock = threading.Lock()

        def submitter(k):
            try:
                for name, j in order[k::SESSION_SUBMITTERS]:
                    t = sess.submit(name, images[j % len(images)])
                    with lock:
                        tickets[(name, j)] = t
                    t.on_done(lambda t, key=(name, j): done_at.__setitem__(
                        key, time.monotonic()))
            except Exception as e:          # shed, closed: a failed run
                errors.append(e)

        b0 = {n: dict(sess.stats()["models"][n]) for n in models}
        reset_launches()
        t_start = time.monotonic()
        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(SESSION_SUBMITTERS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            fail(f"phase 12 ({workers} workers): a submitter failed: "
                 f"{errors[0]!r}")
        completed = failed = 0
        for t in tickets.values():
            try:
                t.result(timeout=600)
                completed += 1
            except Exception:
                failed += 1
        launches = read_launches()
        by_contract = dict(neutron_matmul.launches_by_contract)
        cancelled = sum(s["cancelled"]
                        for s in sess.stats()["models"].values())
        if completed + failed + cancelled != len(order) or failed:
            fail(f"phase 12 ({workers} workers): of {len(order)} "
                 f"submitted, {completed} completed, {failed} failed, "
                 f"{cancelled} cancelled")
        st = sess.stats()
        # every int8 output equals __call__'s at batch 1, bit for bit;
        # the float32 ones of SESSION_F32_SAMPLES requests lie within
        # float_plan_tol of the plain path on the CPU
        f32_err = []
        for (name, j), t in tickets.items():
            got = t.result()
            i = j % len(images)
            if name in want and not _equal_outputs(torch, got, want[name][i]):
                fail(f"phase 12 ({workers} workers): request {j} of {name} "
                     f"differs from CompiledModel.__call__ at batch 1")
            if name not in want and j < SESSION_F32_SAMPLES:
                for k, w in want_f32[j].items():
                    e = float((got[k] - w).abs().max())
                    tol = float_plan_tol(w.numpy())
                    if not e <= tol:
                        fail(f"phase 12: float32 request {j} output {k} is "
                             f"{e:.3g} from the CPU path (tol {tol:.3g})")
                    f32_err.append(e / tol)
        batches = {n: st["models"][n]["batches"] - b0[n]["batches"]
                   for n in models}
        want_k1 = sum(per_batch[n] * batches[n] for n in models)
        if launches != (0, 0, 0, want_k1) or not all(batches.values()):
            fail(f"phase 12 ({workers} workers): launched {LAUNCH_NAMES} = "
                 f"{launches} over batches {batches}, expected K1 "
                 f"{want_k1}")
        # K1 by contract: the int8 models on the plan contract, the
        # float32 one on the Pallas contract in float32
        want_contract = {}
        for n in models:
            key = "plan int8" if models[n].precision == "int8" \
                else "pallas float32"
            want_contract[key] = want_contract.get(key, 0) \
                + per_batch[n] * batches[n]
        if by_contract != want_contract:
            fail(f"phase 12 ({workers} workers): K1 launched {by_contract} "
                 f"by contract, expected {want_contract}")
        # no fault is injected here: no worker may be recycled (a recycled
        # worker's stream stays in worker_health() beside its
        # replacement's, so the stream check reads the live workers)
        pool = st["pool"]
        if pool["recycled_workers"] or pool["redispatched_batches"]:
            fail(f"phase 12 ({workers} workers): {pool['recycled_workers']}"
                 f" workers recycled with no fault injected: "
                 f"{sess._pool.recycle_log}")
        streams = [h["stream"] for h in st["workers"].values()
                   if not h["abandoned"]]
        if None in streams or len(set(streams)) != workers:
            fail(f"phase 12: the workers' streams are {streams}")
        out = dict(workers=workers, streams=len(set(streams)),
                   wall_s=max(done_at.values()) - t_start,
                   requests_s=len(order) / (max(done_at.values()) - t_start),
                   k1_launches=want_k1, k1_by_contract=by_contract,
                   f32_err_over_tol_max=max(f32_err), models={})
        for n in models:
            m, lat = st["models"][n], st["models"][n]["latency"]
            last = max(v for (nm, _), v in done_at.items() if nm == n)
            svc = sess._m_service.labels(model=n)
            out["models"][n] = dict(
                requests_s=SESSION_REQUESTS / (last - t_start),
                p50_ms=lat["p50_ms"], p99_ms=lat["p99_ms"],
                batches=batches[n],
                mean_batch=(m["batched_requests"]
                            - b0[n]["batched_requests"]) / batches[n],
                service_p50_ms=svc.percentile(50),
                service_p99_ms=svc.percentile(99),
                service_max_ms=svc.snapshot()["max_ms"],
                k1_launches=per_batch[n] * batches[n])
        return out
    finally:
        sess.close()


def _session_chaos(torch, api, model, name, images, want):
    """The degradation ladder on int8 ``name`` on the card: a transient
    plan fault retried and served, 3 failed batches trip the breaker,
    requests while it is open fail fast with ``BreakerOpen`` and a retry
    hint (nothing launched, nothing served from the host), the probe's
    recovery, then the plan on K1 again with equal ints; no ticket
    lost."""
    from repro_torch.runtime import chaos
    sess = api.Session(workers=2, max_batch=VISION_BATCH,
                       breaker_threshold=3, breaker_cooldown_s=2.0,
                       retry_backoff_ms=1.0)
    tickets = []

    def served(i):
        t = sess.submit(name, images[i])
        tickets.append(t)
        got = t.result(timeout=600)
        if not _equal_outputs(torch, got, want[i]):
            fail(f"phase 12 chaos: a served output of image {i} differs "
                 f"from CompiledModel.__call__'s")

    try:
        sess.add(model, name=name)
        with chaos.inject() as c:
            c.poison_plan(name, times=1)
            served(0)
            if sess.stats()["models"][name]["retries"] != 1:
                fail("phase 12 chaos: the transient fault was not retried")
            for i in range(sess.breaker_threshold):
                c.poison_plan(name, times=2)       # the batch and its retry
                t = sess.submit(name, images[i])
                tickets.append(t)
                try:
                    t.result(timeout=600)
                    fail("phase 12 chaos: a poisoned batch was served")
                except chaos.ChaosError:
                    pass
            st = sess.stats()["models"][name]
            if st["breaker"]["state"] != "open" or st["breaker_trips"] != 1:
                fail(f"phase 12 chaos: the breaker is {st['breaker']}")
            reset_launches()
            t0 = time.monotonic()
            hints = []
            for i in (1, 2):
                t = sess.submit(name, images[i])
                tickets.append(t)
                try:
                    t.result(timeout=600)
                    fail("phase 12 chaos: a request was served while the "
                         "breaker was open")
                except api.BreakerOpen as e:
                    hints.append(e.retry_after_ms)
            fast_fail_s = time.monotonic() - t0
            st = sess.stats()["models"][name]
            if read_launches() != (0, 0, 0, 0) or st["breaker_rejects"] != 2 \
                    or st["degraded_requests"] or not all(
                        0 < h <= 2e3 for h in hints):
                fail(f"phase 12 chaos: with the breaker open, launches "
                     f"{read_launches()}, {st['breaker_rejects']} rejected, "
                     f"{st['degraded_requests']} degraded, hints {hints} ms")
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            st = sess.stats()["models"][name]
            if st["breaker"]["state"] == "closed" and st["recoveries"]:
                break
            time.sleep(0.05)
        if st["breaker"]["state"] != "closed" or not st["recoveries"]:
            fail(f"phase 12 chaos: no recovery ({st['breaker']})")
        reset_launches()
        b0 = st["batches"]
        for i in range(len(images)):
            served(i)
        st = sess.stats()["models"][name]
        k1_want = MOBILENET.k1_per_replay * (st["batches"] - b0)
        if read_launches()[3] != k1_want:
            fail("phase 12 chaos: the recovered model did not run on K1")
        done = sum(t.done for t in tickets)
        ok = sum(t.done and t.error is None for t in tickets)
        if done != len(tickets):
            fail(f"phase 12 chaos: {len(tickets) - done} tickets lost")
        return dict(submitted=len(tickets), completed=ok,
                    failed=done - ok, retries=st["retries"],
                    plan_failures=st["plan_failures"],
                    breaker_trips=st["breaker_trips"],
                    breaker_rejects=st["breaker_rejects"],
                    retry_after_ms=hints, fast_fail_s_for_2=fast_fail_s,
                    degraded_requests=st["degraded_requests"],
                    recoveries=st["recoveries"],
                    failed_recoveries=st["failed_recoveries"])
    finally:
        sess.close()


def phase_session(torch, rows, int8_models, images, rpa) -> dict:
    """``repro_torch.api.Session`` on the card (see the module
    docstring): the int8 models of phase 11 and mobilenet_v2 compiled at
    float32, served by 2 worker threads and then by 1, then the chaos
    ladder.  The float32 model's artifact goes into ``rpa["f32"]``."""
    from repro_torch import api

    t0 = time.monotonic()
    f32 = api.compile(MOBILENET.name, precision="float32", seed=SEED)
    compile_s = time.monotonic() - t0
    f32_name = f"{MOBILENET.name}_float32"
    models = {MOBILENET.name: int8_models[MOBILENET.name],
              RESNET.name: int8_models[RESNET.name], f32_name: f32}
    per_batch = {MOBILENET.name: MOBILENET.k1_per_replay,
                 RESNET.name: RESNET.k1_per_replay,
                 f32_name: sum(op.kind in ("conv", "fc")
                               for op in f32.graph.ops)}
    # what each request must give back: int8, CompiledModel.__call__ at
    # batch 1 on the card; float32, the plain path on the CPU (the model
    # saved and loaded there)
    want = {n: [{k: v.cpu() for k, v in models[n](img).items()}
                for img in images] for n in (MOBILENET.name, RESNET.name)}
    rpa["f32"] = f32.save(f"{rpa['dir']}/{f32_name}.rpa")
    cpu_f32 = api.load(rpa["f32"], device="cpu")
    want_f32 = [cpu_f32(images[j % len(images)])
                for j in range(SESSION_F32_SAMPLES)]
    del cpu_f32

    # the float32 plan alone: warm replay ms at batch 1 and 8
    inp = f32.graph.inputs[0].name
    replay_ms = {}
    for n in (1, VISION_BATCH):
        plan = f32.plan_for(n)
        times = []
        for _ in range(F32_REPLAYS + 1):
            torch.cuda.synchronize()
            t = time.monotonic()
            plan.run({inp: images[:n]}, n=n)
            torch.cuda.synchronize()
            times.append((time.monotonic() - t) * 1e3)
        replay_ms[n] = statistics.median(times[1:])

    out = dict(float32_compile_s=compile_s,
               float32_k1_per_batch=per_batch[f32_name],
               float32_replay_ms_batch1=replay_ms[1],
               float32_replay_ms_batch8=replay_ms[VISION_BATCH],
               serving={})
    for workers in (2, 1):
        _session_warm(torch, api, models, per_batch, images, workers)
        res = _session_traffic(torch, api, models, per_batch, images, want,
                               want_f32, workers)
        out["serving"][workers] = res
        for n, m in res["models"].items():
            print(f"  {workers} worker(s) {n}: {m['requests_s']:.1f} "
                  f"requests/s, p50 {m['p50_ms']:.2f} / p99 "
                  f"{m['p99_ms']:.2f} ms, mean batch {m['mean_batch']:.2f},"
                  f" batch service p50 {m['service_p50_ms']:.2f} / max "
                  f"{m['service_max_ms']:.2f} ms (heartbeat timeout 500 ms),"
                  f" K1 "
                  f"{m['k1_launches']} in {m['batches']} batches")
        print(f"  {workers} worker(s): 0 workers recycled; "
              f"{res['requests_s']:.1f} requests/s "
              f"over {3 * SESSION_REQUESTS} requests in {res['wall_s']:.2f}"
              f" s; float32 max err/tol {res['f32_err_over_tol_max']:.3g}")
    for r in rows.values():
        if r["path"] == f"{MOBILENET.name} float32":
            # measured: the float32 contract's own count in the 2-worker
            # run (checked there against the conv and fc ops per batch)
            r["launches"] = out["serving"][2]["k1_by_contract"][
                "pallas float32"]
    out["chaos"] = _session_chaos(torch, api, int8_models[MOBILENET.name],
                                  MOBILENET.name, images,
                                  want[MOBILENET.name])
    print(f"  float32 {MOBILENET.name}: compile {compile_s:.2f} s, K1 "
          f"{per_batch[f32_name]} a batch, replay {replay_ms[1]:.3f} ms at "
          f"batch 1, {replay_ms[VISION_BATCH]:.3f} ms at batch "
          f"{VISION_BATCH}; chaos {out['chaos']}")
    return out

# --------------------------------------------------------------------------
# phase 13 (and its rows of phase 2): LM decode on the NPU compile path
# --------------------------------------------------------------------------


def decoder_spec():
    from repro_torch.frontends import lm
    return lm, lm.tiny_spec(**DECODER)


def decode_launches(lm, spec):
    """What phase 13's traffic launches at one precision: K2 and K3 by the
    wrappers' shape keys (attention runs in float32 at both precisions),
    and K1's count (one per matmul: 6 a layer and the logits, in each
    prefill and each decode step)."""
    from collections import Counter
    H, hd, L = spec.n_heads, spec.head_dim, spec.n_layers
    k2, k3, runs = Counter(), Counter(), 0
    for p in DECODE_PROMPTS:
        k2[(1, H, lm.bucket_for(p), hd, H, lm.bucket_for(p + 1), hd,
            None)] += L
        runs += 1
        for pos in range(p, p + DECODE_NEW - 1):
            k3[(1, H, hd, H, lm.bucket_for(pos + 1), hd)] += L
            runs += 1
    return k2, k3, (6 * L + 1) * runs


def slot_views(torch, randn, kv, H, hd):
    """k and v as the plan hands them to K2/K3: head-major views (1, H,
    kv, hd) of (1, kv, 1, H * hd) cache slots, and contiguous copies."""
    kc = randn(1, kv, 1, H * hd, dtype=torch.float32)
    vc = randn(1, kv, 1, H * hd, dtype=torch.float32)
    k = kc.view(1, kv, H, hd).transpose(1, 2)
    v = vc.view(1, kv, H, hd).transpose(1, 2)
    return k, v, k.contiguous(), v.contiguous()


def k2_offset_probe(torch, ops, randn, H, D, S, Sk, causal, dtype) -> float:
    """K2 over lanes at query offsets (0, 3, Sk - S) on inputs that make
    the offset decisive: k = 0, so every key a query row sees gets the
    same weight, and v = 0 except 1024 at each lane's key o + S - 1 (the
    last its last row sees) and -2048 at the key after it (the first no
    row sees).  Causal, row i of lane o sees keys [0, o + i] and only the
    last row meets the marker: 1024 / (o + S); not causal, every row sees
    [0, o + S): 1024 / (o + S).  A bound one key off moves an output by
    about 1024 / (o + S) or more.  Held against these values and the
    plain version."""
    name = str(dtype).removeprefix("torch.")
    offs = (0, 3, Sk - S)
    B = len(offs)
    q = randn(B, H, S, D, dtype=dtype)
    k = torch.zeros((B, H, Sk, D), dtype=dtype, device="cuda")
    v = torch.zeros((B, H, Sk, D), dtype=dtype, device="cuda")
    want = torch.zeros((B, H, S, D), device="cuda")
    for b, o in enumerate(offs):
        v[b, :, o + S - 1] = 1024
        if o + S < Sk:
            v[b, :, o + S] = -2048
        want[b, :, S - 1 if causal else slice(None)] = 1024 / (o + S)
    off = torch.tensor(offs, dtype=torch.int32, device="cuda")
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=off)
    what = (f"flash_attention {name} q_offset probe {offs} S={S} Sk={Sk} "
            f"causal={causal}")
    check_close(torch, what, got, want.to(dtype), name)
    return check_close(torch, what, got,
                       ops.flash_attention(q, k, v, causal=causal,
                                           q_offset=off, impl="ref"), name)


def decoder_attention_rows(torch, F, ops, randn, rows) -> None:
    """K2 and K3 in float32 at every shape phase 13's traffic runs them at
    (the decoder's 6 heads of 64; K2 at each prefill's (seq, kv), with
    the offset and without; K3 at each kv bucket, with kv_len at the full
    bucket and at 1), each against its plain version and timed beside
    SDPA; ``strided_ms`` is the device time of the same call on the
    head-major views of the cache slots, whose copies the wrappers make
    (the layout the plan hands over).  Then the offset probes, causal and
    not, in float32 and bfloat16."""
    from repro_torch.kernels import flash_attention, flash_decode
    lm, spec = decoder_spec()
    k2, k3, _ = decode_launches(lm, spec)
    H, hd = spec.n_heads, spec.head_dim
    scale = hd ** -0.5                  # the IR attention's
    f32 = torch.float32
    n_prec = len(DECODE_PRECISIONS)
    for key, per in sorted(k2.items()):
        S, kv = key[2], key[5]
        q = randn(1, H, S, hd, dtype=f32)
        k, v, kk, vv = slot_views(torch, randn, kv, H, hd)
        off = torch.zeros(1, dtype=torch.int32, device="cuda")

        def kernel(q=q, kk=kk, vv=vv, off=off):
            return ops.flash_attention(q, kk, vv, causal=True,
                                       sm_scale=scale, q_offset=off)

        def plain(q=q, kk=kk, vv=vv, off=off):
            return ops.flash_attention(q, kk, vv, causal=True,
                                       sm_scale=scale, q_offset=off,
                                       impl="ref")
        got, want = kernel(), plain()
        tag = f"{DECODER_PATH} s{S}/kv{kv}"
        err = max(check_close(torch, f"flash_attention f32 {tag}", got,
                              want, "float32"),
                  check_close(torch, f"flash_attention f32 {tag} no offset",
                              ops.flash_attention(q, kk, vv, causal=True,
                                                  sm_scale=scale),
                              want, "float32"))
        pairs = H * S * (S + 1) // 2
        b_ms, b_by = bound(nbytes(q, kk, vv, off, got), 2 * pairs * 2 * hd,
                           "float32")
        rows[("flash_attention", tag)] = dict(
            name="flash_attention", path=tag, route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:116",
            shape=f"q (1,{H},{S},{hd}), k,v (1,{H},{kv},{hd}) f32 causal, "
                  f"q_offset",
            key=flash_attention.shape_key(q, kk, vv, None),
            expect=per * n_prec, max_abs_err=err, bound_ms=b_ms,
            bound_by=b_by,
            strided_ms=device_ms(torch, lambda q=q, k=k, v=v, off=off:
                                 ops.flash_attention(q, k, v, causal=True,
                                                     sm_scale=scale,
                                                     q_offset=off)),
            **timings(torch, kernel, plain,
                      lambda q=q, kk=kk, vv=vv: F.scaled_dot_product_attention(
                          q, kk, vv, is_causal=True, scale=scale)))
    for S, Sk in ((8, 64), (64, 128)):
        for causal in (True, False):
            for dt in (f32, torch.bfloat16):
                e = k2_offset_probe(torch, ops, randn, H, hd, S, Sk, causal,
                                    dt)
                print(f"  flash_attention q_offset probe S={S} Sk={Sk} "
                      f"causal={causal} {str(dt)[6:]}: max|err| {e:.3g}")
    for key, per in sorted(k3.items()):
        kv = key[4]
        q = randn(1, H, hd, dtype=f32)
        k, v, kk, vv = slot_views(torch, randn, kv, H, hd)
        full = torch.full((1,), kv, dtype=torch.int32, device="cuda")

        def kernel(q=q, kk=kk, vv=vv, n=full):
            return ops.flash_decode(q, kk, vv, kv_len=n, sm_scale=scale)

        def plain(q=q, kk=kk, vv=vv, n=full):
            return ops.flash_decode(q, kk, vv, kv_len=n, sm_scale=scale,
                                    impl="ref")
        got = kernel()
        one = torch.ones(1, dtype=torch.int32, device="cuda")
        tag = f"{DECODER_PATH} kv{kv}"
        err = max(check_close(torch, f"flash_decode f32 {tag}", got, plain(),
                              "float32"),
                  check_close(torch, f"flash_decode f32 {tag} kv_len 1",
                              kernel(n=one), plain(n=one), "float32"))
        b_ms, b_by = bound(nbytes(q, kk, vv, full, got), 2 * H * kv * 2 * hd,
                           "float32")
        rows[("flash_decode", tag)] = dict(
            name="flash_decode", path=tag, route="cuda",
            source="src/repro_torch/csrc/flash_decode.cu",
            replaces="src/repro/kernels/flash_decode.py:96",
            shape=f"q (1,{H},{hd}) x cache (1,{H},{kv},{hd}) f32, kv_len "
                  f"{kv} (and 1)",
            key=flash_decode.shape_key(q, kk, vv), expect=per * n_prec,
            max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
            strided_ms=device_ms(torch, lambda q=q, k=k, v=v, n=full:
                                 ops.flash_decode(q, k, v, kv_len=n,
                                                  sm_scale=scale)),
            **timings(torch, kernel, plain,
                      lambda q=q, kk=kk, vv=vv:
                      F.scaled_dot_product_attention(q[:, :, None], kk, vv,
                                                     scale=scale)))


class _Capture:
    """Wraps a DecodeSession's ``_run`` so that the outputs of its last
    prefill or step can be read."""

    def __init__(self, sess):
        self.out = None
        run = sess._run

        def capture(m, feed):
            self.out = run(m, feed)
            self.m = m
            return self.out
        sess._run = capture


def _hold_step(torch, card_cap, cpu_cap, precision, float_plan_tol):
    """One prefill's or step's outputs (logits and caches) on the card
    against the CPU session's on the same inputs: float32 within
    ``float_plan_tol``; int8 in stored ints, within one output step.
    Returns (worst err / tol, ints that differ)."""
    m = cpu_cap.m
    worst, differ = 0.0, 0
    for name, want in cpu_cap.out.items():
        got = card_cap.out[name].cpu()
        if not torch.isfinite(got).all() or got.shape != want.shape:
            fail(f"phase 13 {precision}: {name} {tuple(got.shape)} is not "
                 f"finite or of the wrong shape")
        if precision == "float32":
            tol = float_plan_tol(want.numpy())
            err = float((got - want).abs().max())
            if err > tol:
                fail(f"phase 13 float32: {name} is {err:.3g} from the CPU "
                     f"session, above float_plan_tol {tol:.3g}")
            worst = max(worst, err / tol)
        else:
            steps = ((got - want).abs()
                     / m.semantics._scale(name)).round().int()
            if int(steps.max()) > 1:
                fail(f"phase 13 int8: {name}'s stored ints differ from the "
                     f"CPU session's by {int(steps.max())} steps")
            differ += int((steps > 0).sum())
    return worst, differ


def _teacher_forced(torch, card, cpu, prompt, precision):
    """One request on the card with every step held against the CPU
    session fed the same inputs: before each step the CPU's request takes
    the card's caches and tokens (teacher forcing), so each step's error
    is its own.  Returns the card's tokens, the ms of each decode step
    (host clock; a step ends in the read of its token), the worst float32
    err / tol, the ints that differ per step at int8 and the steps whose
    tokens differ on the same inputs."""
    from repro_torch.core.executor import float_plan_tol
    cc, pc = _Capture(card), _Capture(cpu)
    rid, tok = card.prefill(prompt)
    prid, ptok = cpu.prefill(prompt)
    worst, differ = _hold_step(torch, cc, pc, precision, float_plan_tol)
    per_step, token_differs, step_ms = [differ], [], []
    toks = [tok]
    for i in range(DECODE_NEW - 1):
        r, pr = card._requests[rid], cpu._requests[prid]
        pr.caches = {k: v.cpu() for k, v in r.caches.items()}
        pr.tokens, pr.pos, pr.bucket = list(r.tokens), r.pos, r.bucket
        t = time.monotonic()
        tok = card.step(rid)
        step_ms.append((time.monotonic() - t) * 1e3)
        if cpu.step(prid) != tok:
            token_differs.append(i + 1)
        w, differ = _hold_step(torch, cc, pc, precision, float_plan_tol)
        worst = max(worst, w)
        per_step.append(differ)
        toks.append(tok)
    card.finish(rid)
    cpu.finish(prid)
    del card._run, cpu._run             # the class's again
    return toks, step_ms, worst, per_step, token_differs


def _decode_profile(torch, card, prompt) -> dict:
    """The device's busy share of a decode step: DECODE_PROFILED steps of
    one request timed on the host, then the same number under
    torch.profiler (CUDA kernel and copy durations summed per step)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile
    rid, _ = card.prefill(prompt)
    card.step(rid)
    torch.cuda.synchronize()
    t = time.monotonic()
    for _ in range(DECODE_PROFILED):
        card.step(rid)
    wall_ms = (time.monotonic() - t) * 1e3 / DECODE_PROFILED
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(DECODE_PROFILED):
            card.step(rid)
        torch.cuda.synchronize()
    card.finish(rid)
    by_name, n = Counter(), 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            n += 1
    busy_ms = sum(by_name.values()) / 1e3 / DECODE_PROFILED
    if busy_ms <= 0:
        fail("phase 13: the profiler saw no device time in a decode step")
    return dict(wall_ms_per_step=wall_ms, busy_ms_per_step=busy_ms,
                busy_share=busy_ms / wall_ms,
                kernels_per_step=n / DECODE_PROFILED,
                top_kernels_ms_per_step=[
                    (name[:60], us / 1e3 / DECODE_PROFILED)
                    for name, us in by_name.most_common(6)])


def phase_decode(torch, rows) -> dict:
    """Phase 13 (see the module docstring): the whisper-tiny decoder at
    full width through ``DecodeSession`` on the card, at float32 and at
    int8, against the same session on the CPU."""
    import tempfile

    from repro_torch import api
    from repro_torch.kernels import neutron_matmul

    lm, spec = decoder_spec()
    width = (spec.n_layers, spec.d_model, spec.n_heads, spec.head_dim,
             spec.d_ff, spec.vocab)
    if width != DECODER_WIDTH:
        fail(f"phase 13: the decoder is {width}, not {DECODER_WIDTH}")
    k2_want, k3_want, k1_want = decode_launches(lm, spec)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, spec.vocab, size=p).tolist()
               for p in DECODE_PROMPTS]
    shapes = sorted({(lm.bucket_for(p), lm.bucket_for(p + 1))
                     for p in DECODE_PROMPTS}
                    | {(1, lm.bucket_for(pos + 1)) for p in DECODE_PROMPTS
                       for pos in range(p, p + DECODE_NEW - 1)})
    out = {}
    for precision in DECODE_PRECISIONS:
        t_phase = time.monotonic()
        card = api.DecodeSession(spec=spec, precision=precision, seed=SEED,
                                 device="cuda")
        cpu = api.DecodeSession(spec=spec, precision=precision, seed=SEED,
                                device="cpu")
        compile_s = {}
        with tempfile.TemporaryDirectory() as d:
            for sq, kv in shapes:
                t = time.monotonic()
                m = card.model(sq, kv)
                compile_s[f"s{sq}/kv{kv}"] = time.monotonic() - t
                # the CPU session serves the same compiled model (the
                # artifact), with the plain versions
                cpu._models[(sq, kv)] = api.load(
                    m.save(f"{d}/s{sq}-kv{kv}.rpa"), device="cpu")
        print(f"  {precision}: compiled {len(shapes)} models, s: "
              f"{json.dumps({k: round(v, 2) for k, v in compile_s.items()})}")

        # each request alone, every step held against the CPU session
        solo = [_teacher_forced(torch, card, cpu, p, precision)
                for p in prompts]
        for (toks, _, worst, per_step, tok_diff), p in zip(solo, prompts):
            print(f"  {precision} prompt {len(p)}: teacher-forced against "
                  f"the CPU session: " + (
                      f"worst err/float_plan_tol {worst:.3g}"
                      if precision == "float32" else
                      f"ints differing per step {per_step}") +
                  f"; steps whose token differs on the same inputs "
                  f"{tok_diff}")
        # the CPU session free-running: its greedy tokens
        for (toks, *_), p in zip(solo, prompts):
            want = cpu.generate(p, max_new_tokens=DECODE_NEW)
            first = next((i for i, (a, b) in enumerate(zip(toks, want))
                          if a != b), None)
            if precision == "float32" and first is not None:
                fail(f"phase 13 float32: the card's greedy tokens leave the "
                     f"CPU session's at token {first}")
            print(f"  {precision} prompt {len(p)}: greedy tokens against "
                  f"the CPU session's: " + (
                      "equal" if first is None else
                      f"first differ at token {first} of {DECODE_NEW}"))

        # the main path: A and B interleaved step by step, counters from 0
        reset_launches()
        t = time.monotonic()
        rids, toks = [], []
        for p in prompts:
            rid, tok = card.prefill(p)
            rids.append(rid)
            toks.append([tok])
        for _ in range(DECODE_NEW - 1):
            for rid, tl in zip(rids, toks):
                tl.append(card.step(rid))
        torch.cuda.synchronize()
        wall = time.monotonic() - t
        launches = read_launches()
        by_shape = read_launches_by_shape()
        by_contract = dict(neutron_matmul.launches_by_contract)
        for rid in rids:
            card.finish(rid)
        contract = "plan int8" if precision == "int8" else "pallas float32"
        if [s[0] for s in solo] != toks:
            fail(f"phase 13 {precision}: interleaved tokens differ from "
                 f"each request's solo run")
        if launches != (sum(k2_want.values()), sum(k3_want.values()), 0,
                        k1_want) or by_contract != {contract: k1_want}:
            fail(f"phase 13 {precision}: launched {LAUNCH_NAMES} = "
                 f"{launches}, K1 {by_contract}; expected K2 "
                 f"{sum(k2_want.values())}, K3 {sum(k3_want.values())}, "
                 f"K1 {k1_want} ({contract})")
        if by_shape["flash_attention"] != k2_want or \
                by_shape["flash_decode"] != k3_want:
            fail(f"phase 13 {precision}: K2/K3 launched by shape "
                 f"{by_shape}, expected {k2_want} / {k3_want}")
        builds = {k: v["plan"]["builds"] for k, v in card.stats().items()}
        if set(builds.values()) != {1}:
            fail(f"phase 13 {precision}: plan builds {builds}, not 1 each")
        for r in rows.values():
            if r["path"].startswith(DECODER_PATH):
                if r["name"] == "neutron_matmul":
                    if r["path"] == f"{DECODER_PATH} {precision}":
                        r["launches"] = by_contract[contract]
                else:
                    name = r["name"]
                    r["launches"] = r.get("launches", 0) + \
                        by_shape[name][r["key"]]

        # timing: warm prefills, decode steps, the profiler
        prefill_ms = []
        for p in prompts:
            times = []
            for _ in range(DECODE_TIMED):
                torch.cuda.synchronize()
                t = time.monotonic()
                rid, _ = card.prefill(p)
                times.append((time.monotonic() - t) * 1e3)
                card.finish(rid)
            prefill_ms.append(statistics.median(times))
        step_ms = [statistics.median(s[1]) for s in solo]
        prof = _decode_profile(torch, card, prompts[0])
        # the weights a decode step reads: every matmul's and layernorm's
        m = card.model(1, lm.bucket_for(DECODE_PROMPTS[0] + 1))
        weights = m.qm.qweights if precision == "int8" else m.weights
        prof["weight_bytes_per_step"] = int(sum(
            np.asarray(w).nbytes for w in weights.values()))
        prof["weight_bound_ms_per_step"] = \
            prof["weight_bytes_per_step"] / HBM_BYTES_S * 1e3
        steps = len(prompts) * (DECODE_NEW - 1)
        res = dict(
            compile_s=compile_s,
            prefill_ms={len(p): v for p, v in zip(prompts, prefill_ms)},
            decode_ms_per_token={len(p): v for p, v in zip(prompts,
                                                           step_ms)},
            tokens_s_one_request={len(p): 1e3 / v
                                  for p, v in zip(prompts, step_ms)},
            interleaved_tokens_s=len(prompts) * DECODE_NEW / wall,
            k1_per_step=k1_want // (steps + len(prompts)),
            k3_per_decode_step=sum(k3_want.values()) // steps,
            k2_per_prefill=sum(k2_want.values()) // len(prompts),
            worst_err_over_tol=max(s[2] for s in solo),
            ints_differing_per_step={len(p): s[3]
                                     for p, s in zip(prompts, solo)},
            **prof)
        out[precision] = res
        print(f"  {precision}: prefill ms {res['prefill_ms']}, decode ms "
              f"per token {res['decode_ms_per_token']} (tokens/s "
              f"{res['tokens_s_one_request']}), interleaved "
              f"{res['interleaved_tokens_s']:.1f} tokens/s; decode step "
              f"{prof['wall_ms_per_step']:.3f} ms wall, "
              f"{prof['busy_ms_per_step']:.3f} ms busy (share "
              f"{prof['busy_share']:.3f}), {prof['kernels_per_step']:.0f} "
              f"kernels, weights {prof['weight_bytes_per_step']} bytes "
              f"(bound {prof['weight_bound_ms_per_step']:.4f} ms); top {prof['top_kernels_ms_per_step'][:3]}; K1 "
              f"{res['k1_per_step']} a step, K3 "
              f"{res['k3_per_decode_step']} a decode step, K2 "
              f"{res['k2_per_prefill']} a prefill; builds {builds}")
        print(f"  phase 13 {precision} wall time "
              f"{time.monotonic() - t_phase:.1f} s")
        del card, cpu
        torch.cuda.empty_cache()
    for r in rows.values():
        if r["path"].startswith(DECODER_PATH) and "expect" in r:
            print(f"  {r['name']} [{r['path']}]: {r['launches']} launches")
            if r["launches"] != r["expect"]:
                fail(f"phase 13: {r['name']} [{r['path']}] launched "
                     f"{r['launches']} times, the traffic gives "
                     f"{r['expect']}")
    return out



def phase_lm(torch, rows, n, path) -> dict:
    """Phase `n`: one LM path (the float32 agreement first, where the
    path holds it there), with its wall time."""
    t = time.monotonic()
    depth = f"{path.layers} layers (depth cut)" if path.layers \
        else "full depth"
    print(f"== phase {n}: {path.arch} at full width, {depth}")
    f32, f32_last = (phase_f32_agreement(torch, path)
                     if path.bf16_limit is None or path.f32_also
                     else (None, None))
    out = phase_path(torch, rows, path, f32_last)
    if f32 is not None:
        out["prefill_vs_replay_f32"] = f32
    print(f"  {path.arch}: {json.dumps(out)}")
    print(f"  phase {n} wall time {time.monotonic() - t:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 16: the profiler on the card
# --------------------------------------------------------------------------


def _profile_checks(torch, name, model, cpu_model, rep, batch) -> dict:
    """What phase 16 holds a profile of ``model`` to: one measured kernel
    per plan step, every step label an op of the graph, the step times
    (CUDA events) summing within the replay's wall (CUDA events), and the
    modeled block equal to the CPU load's of the same artifact.  Returns
    the figures it prints."""
    from repro_torch.obs.profile import _op_of_label, profile_model
    steps = model.plan_for(batch).steps
    ops = {op.name for op in model.graph.ops}
    if rep.measured["kernels"] != len(steps):
        fail(f"phase 16 {name}: {rep.measured['kernels']:.0f} kernels "
             f"measured, the plan has {len(steps)} steps")
    stray = [st.label for st in steps if _op_of_label(st.label) not in ops]
    if stray:
        fail(f"phase 16 {name}: step labels {stray[:3]} map to no op")
    step_ms, wall_ms = (rep.measured["kernel_ms_per_request"],
                        rep.measured["wall_ms_per_request"])
    if not 0 < step_ms <= wall_ms:
        fail(f"phase 16 {name}: the steps took {step_ms:.4f} ms a request, "
             f"the replay {wall_ms:.4f} ms")
    cpu_rep = profile_model(cpu_model, batch=1, runs=1, warmup=0)
    if cpu_rep.modeled != rep.modeled:
        fail(f"phase 16 {name}: the modeled block {rep.modeled} differs "
             f"from the CPU load's {cpu_rep.modeled}")
    print("\n".join(f"  | {line}" for line in rep.render(top=5)
                    .splitlines()))
    return dict(kernels=len(steps), wall_ms_per_request=wall_ms,
                step_ms_per_request=step_ms,
                step_share_of_wall=step_ms / wall_ms,
                modeled_latency_ms=rep.modeled["latency_ms"],
                model_vs_actual=rep.measured["model_vs_actual"],
                top5=[(o.op, o.kind, round(o.measured_ms, 5))
                      for o in rep.ops[:5]])


def _spin_probe(torch, model, batch) -> float:
    """A step's time is the card's, not the host's: with a device spin of
    SPIN_CYCLES added to the plan's first step (its host enqueue takes
    microseconds), the profile must give that step at least SPIN_MIN_MS.
    Returns the step's ms."""
    from repro_torch.obs.profile import profile_model
    st = model.plan_for(batch).steps[0]
    orig = st.run

    def spun(bufs, n):
        torch.cuda._sleep(SPIN_CYCLES)
        orig(bufs, n)
    st.run = spun
    try:
        rep = profile_model(model, batch=batch, runs=1, warmup=0)
    finally:
        st.run = orig
    first = next(o for o in rep.ops
                 if o.op == st.label.split("@", 1)[0])
    ms = first.measured_ms * batch
    if ms < SPIN_MIN_MS:
        fail(f"phase 16: a step with a device spin of {SPIN_CYCLES} cycles "
             f"measured {ms:.3f} ms: its time is not the card's")
    return ms


def _decoder_profile(torch, seq: int, pos: int) -> dict:
    """The (seq, kv 64) int8 model of phase 13's DecodeSession (the
    whisper-tiny decoder at full width) profiled on the card at batch 1,
    at position ``pos`` of a request, with the tracer armed: the step's
    ops by device time (CUDA events) and by host enqueue time (the
    spans).  One query row runs attention on K3, more on K2."""
    import numpy as np

    from repro_torch.api import DecodeSession
    from repro_torch.frontends import lm
    from repro_torch.obs import trace
    from repro_torch.obs.profile import _op_of_label, profile_model

    ds = DecodeSession(spec=lm.tiny_spec(**DECODER), precision="int8",
                       seed=SEED)
    m = ds.model(seq, 64)
    rng = np.random.default_rng(SEED)
    feed = {t.name: (rng.normal(size=t.shape) * 0.5).astype(np.float32)
            for t in m.graph.inputs}
    feed["pos"] = np.full(m.graph.tensors["pos"].shape, float(pos),
                          np.float32)
    for _ in range(2):          # first runs: allocations, library loads
        m(feed)
    torch.cuda.synchronize()
    reset_launches()
    tr = trace.enable()
    try:
        rep = profile_model(m, feed, batch=1, runs=DECODE_PROFILE_RUNS)
    finally:
        trace.disable()
    launches = read_launches()
    replays = 1 + DECODE_PROFILE_RUNS
    steps = m.plan_for(1).steps
    where = f"phase 16 decoder (seq {seq}, kv 64)"
    if rep.measured["kernels"] != len(steps) or \
            rep.measured["kernel_ms_per_request"] > \
            rep.measured["wall_ms_per_request"]:
        fail(f"{where}: {rep.measured}")
    attn = (1, 0) if seq == 1 else (0, 1)    # K3 for one row, else K2
    if (bool(launches[1]), bool(launches[0])) != (bool(attn[0]),
                                                   bool(attn[1])) \
            or not launches[3] or launches[2]:
        fail(f"{where}: launched {LAUNCH_NAMES} = {launches}")
    host = {}
    for e in tr.events():
        if e[1] == "plan":
            op = _op_of_label(e[0])
            host[op] = host.get(op, 0.0) + (e[3] - e[2]) * 1e3 / replays
    kinds = {op.name: op.kind for op in m.graph.ops}
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:6]
    host_by_kind = {}
    for op, ms in host.items():
        host_by_kind[kinds[op]] = host_by_kind.get(kinds[op], 0.0) + ms
    print("\n".join(f"  | {line}" for line in rep.render(top=6)
                    .splitlines()))
    print(f"  {where}: host enqueue {sum(host.values()):.3f} ms over "
          f"{len(steps)} steps; top host ops "
          + ", ".join(f"{op} ({kinds[op]}) {ms:.3f}" for op, ms in top_host)
          + "; by kind " + ", ".join(
              f"{k} {ms:.3f}" for k, ms in sorted(
                  host_by_kind.items(), key=lambda kv: -kv[1])))
    return dict(kernels=len(steps),
                wall_ms=rep.measured["wall_ms_per_request"],
                step_ms=rep.measured["kernel_ms_per_request"],
                host_enqueue_ms=sum(host.values()),
                launches_per_replay=[n // replays for n in launches],
                top_device=[(o.op, o.kind, round(o.measured_ms, 5))
                            for o in rep.ops[:6]],
                top_host=[(op, kinds[op], round(ms, 5))
                          for op, ms in top_host],
                device_by_kind=[(k.op, round(k.measured_ms, 5))
                                for k in rep.kinds],
                host_by_kind=sorted(((k, round(ms, 5)) for k, ms in
                                     host_by_kind.items()),
                                    key=lambda kv: -kv[1]))


def phase_profile(torch, rpa) -> dict:
    """Phase 16 (see the module docstring)."""
    from repro_torch import api
    out = {}
    for name, key, k1 in ((MOBILENET.name, MOBILENET.name,
                           MOBILENET.k1_per_replay),
                          (RESNET.name, RESNET.name, RESNET.k1_per_replay),
                          (f"{MOBILENET.name} float32", "f32", None)):
        model = api.load(rpa[key], mmap=True, device="cuda")
        cpu_model = api.load(rpa[key], mmap=True, device="cpu")
        if k1 is None:
            k1 = sum(op.kind in ("conv", "fc") for op in model.graph.ops)
        reset_launches()
        rep = model.profile(batch=VISION_BATCH, runs=PROFILE_RUNS)
        launches = read_launches()
        want = (0, 0, 0, k1 * (1 + PROFILE_RUNS))
        if launches != want:
            fail(f"phase 16 {name}: launched {LAUNCH_NAMES} = {launches}, "
                 f"expected {want}")
        out[name] = _profile_checks(torch, name, model, cpu_model, rep,
                                    VISION_BATCH)
        out[name]["k1_launches"] = launches[3]
        if key == MOBILENET.name:
            out[name]["spin_probe_ms"] = _spin_probe(torch, model,
                                                     VISION_BATCH)
        del model, cpu_model
    out["decoder int8 (1, 64)"] = _decoder_profile(torch, 1, 40)
    out["decoder int8 (64, 64)"] = _decoder_profile(torch, 64, 0)
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 17: the process pool and the fleet on the card
# --------------------------------------------------------------------------


def _served_all(torch, sess, name, images, n, want, where):
    """``n`` requests (image j % len(images)) from PROC_SUBMITTERS
    threads; every ticket must settle with ``want``'s outputs for its
    image.  Returns the seconds from the first submit to the last
    settlement."""
    tickets, errors = {}, []
    lock = threading.Lock()

    def submitter(k):
        try:
            for j in range(k, n, PROC_SUBMITTERS):
                t = sess.submit(name, images[j % len(images)])
                with lock:
                    tickets[j] = t
        except Exception as e:               # shed, closed: a failed run
            errors.append(e)

    t0 = time.monotonic()
    threads = [threading.Thread(target=submitter, args=(k,))
               for k in range(PROC_SUBMITTERS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    results = {}
    for j, t in sorted(tickets.items()):
        try:
            results[j] = t.result(timeout=600)
        except Exception as e:
            errors.append(e)
    wall = time.monotonic() - t0
    if errors or len(results) != n:
        fail(f"phase 17 {where}: {len(results)} of {n} tickets served; "
             f"{errors[:1]!r}")
    for j, got in results.items():
        if not _equal_outputs(torch, got, want[j % len(images)]):
            fail(f"phase 17 {where}: request {j} differs from the stored "
                 f"ints of phase 6")
    return wall


def _no_failures(sess, name, where):
    """No batch of ``name`` failed or was retried in ``sess``: a plan
    failure would also wake the breaker's probe, whose replay on the card
    runs in the background."""
    st = sess.stats()["models"][name]
    bad = {k: st[k] for k in ("plan_failures", "retries", "breaker_trips")
           if st[k]}
    if bad:
        fail(f"phase 17 {where}: {bad}")


def _children(sess):
    return {wid: h for wid, h in sess._pool.worker_health().items()
            if h.get("ready") and not h["abandoned"]}


def _wait_replaced(torch, sess, recycled0, where):
    """Wait for the supervisor to recycle the dead child's lanes and for
    its replacement to report ready on the card."""
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        ready = _children(sess)
        if sess.stats()["pool"]["recycled_workers"] > recycled0 and \
                len(ready) >= 2 * PROC_WORKERS:
            break
        time.sleep(0.1)
    ready = _children(sess)
    if sess.stats()["pool"]["recycled_workers"] <= recycled0 or \
            len(ready) < 2 * PROC_WORKERS or \
            {h["device"] for h in ready.values()} != {"cuda"}:
        fail(f"phase 17 {where}: no replacement child ready on the card: "
             f"{ready}")
    return len({h["pid"] for h in ready.values()})


def _proc_chaos(torch, sess, name, images, want) -> dict:
    """The process pool's fault cases on the card: a worker killed
    (SIGKILL from the parent, SIGSEGV, the OOM exit) with its batch in
    flight, then a bit-flipped reply frame.  Every ticket settles with
    phase 6's ints; the batch in flight is re-dispatched; a replacement
    child becomes ready on the card."""
    from repro_torch.runtime import chaos
    out = {}
    for mode in ("kill", "segv", "oom"):
        st0 = sess.stats()
        crash0 = st0["models"][name]["crash_redispatches"]
        rec0 = st0["pool"]["recycled_workers"]
        t0 = time.monotonic()
        with chaos.inject() as c:
            c.kill_worker(-1, mode=mode)
            _served_all(torch, sess, name, images, PROC_CHAOS_REQUESTS,
                        want, f"kill_worker({mode!r})")
            kills = c.stats()["kills"]
        crashes = sess.stats()["models"][name]["crash_redispatches"] - crash0
        if kills != 1 or crashes < 1:
            fail(f"phase 17 kill_worker({mode!r}): {kills} kills, "
                 f"{crashes} crash re-dispatches")
        pids = _wait_replaced(torch, sess, rec0, f"kill_worker({mode!r})")
        out[mode] = dict(crash_redispatches=crashes,
                         recycled_workers=sess.stats()["pool"][
                             "recycled_workers"] - rec0,
                         live_children=pids,
                         recovery_s=time.monotonic() - t0)
    st0 = sess.stats()
    rec0 = st0["pool"]["recycled_workers"]
    with chaos.inject() as c:
        c.corrupt_frames(1)
        _served_all(torch, sess, name, images, PROC_CHAOS_REQUESTS, want,
                    "corrupt_frames")
        flips = c.stats()["frame_flips"]
    st = sess.stats()
    corrupt = st["models"][name]["frame_corrupt"] - \
        st0["models"][name]["frame_corrupt"]
    if flips != 1 or corrupt < 1 or \
            st["pool"]["recycled_workers"] != rec0:
        fail(f"phase 17 corrupt_frames: {flips} flips, {corrupt} batches "
             f"re-dispatched, {st['pool']['recycled_workers'] - rec0} "
             f"workers recycled")
    out["corrupt_frames"] = dict(frame_corrupt=corrupt)
    _no_failures(sess, name, "chaos")
    out["crash_redispatches"] = st["models"][name]["crash_redispatches"]
    out["recycled_workers"] = st["pool"]["recycled_workers"]
    return out


def _fleet_phase(torch, api, path, name, images, want) -> dict:
    """``Session.fleet(replicas=2, workers=2)`` on the card: balanced
    routing; a replica that corrupts its outputs caught by the auditor
    (the host interpreter) and quarantined; an update whose canary is
    corrupted rejected with no replica touched; a replica's pool killed
    with no ticket lost."""
    from repro_torch.runtime import chaos
    fleet = api.Session.fleet(replicas=2, workers=2,
                              max_batch=VISION_BATCH, hedge=False,
                              audit_fraction=0.0, audit_threshold=2,
                              heartbeat_timeout_s=PROC_HEARTBEAT_S)
    out = {}
    try:
        fleet.load(path, name=name)
        # a first round allocates every worker's arena (a first batch
        # that outlasts the heartbeat would be run twice)
        _served_all(torch, fleet, name, images, FLEET_REQUESTS, want,
                    "fleet warm")
        reset_launches()
        b0 = sum(r.session.stats()["models"][name]["batches"]
                 for r in fleet._replicas.values())
        _served_all(torch, fleet, name, images, FLEET_REQUESTS, want,
                    "fleet routing")
        st = fleet.stats()
        served = [r["served"] for r in st["replicas"].values()]
        batches = sum(r.session.stats()["models"][name]["batches"]
                      for r in fleet._replicas.values()) - b0
        k1 = read_launches()
        if min(served) == 0 or st["failed"] or \
                k1 != (0, 0, 0, MOBILENET.k1_per_replay * batches):
            detail = {rid: (r.session.stats()["models"][name],
                            r.session.stats()["pool"])
                      for rid, r in fleet._replicas.items()}
            fail(f"phase 17 fleet: served {served}, failed {st['failed']},"
                 f" launched {LAUNCH_NAMES} = {k1} in {batches} batches;"
                 f" replicas {detail}")
        for r in fleet._replicas.values():
            _no_failures(r.session, name, "fleet routing")
        out["routing"] = dict(served=served, batches=batches,
                              k1_launches=k1[3])

        # every response audited on the host interpreter while replica 1
        # corrupts its outputs; bursts of FLEET_AUDIT_BURST, each waited
        # for until audited, until the auditor quarantines replica 1
        def audited():
            st = fleet.stats()
            return st["audit_ok"] + st["audit_mismatch"] + \
                st["audit_error"]

        fleet.audit_fraction = 1.0
        t0 = time.monotonic()
        sent, base = 0, audited()
        with chaos.inject() as c:
            c.corrupt_output(name, times=10 ** 6, tag="r1")
            for _ in range(FLEET_AUDIT_BURSTS):
                ts = [fleet.submit(name, img)
                      for img in images[:FLEET_AUDIT_BURST]]
                for t in ts:
                    t.result(timeout=600)
                sent += len(ts)
                deadline = time.monotonic() + 300
                while time.monotonic() < deadline and \
                        not fleet.stats()["quarantines"] and \
                        audited() - base < sent:
                    time.sleep(0.05)
                if fleet.stats()["quarantines"]:
                    break
        fleet.audit_fraction = 0.0
        st = fleet.stats()
        if st["quarantines"] < 1 or st["replicas"][1]["quarantines"] < 1 \
                or st["replicas"][0]["quarantines"]:
            fail(f"phase 17 fleet audit: {st}")
        _fleet_live(fleet, "audit")
        out["audit"] = dict(audit_mismatch=st["audit_mismatch"],
                            audit_ok=st["audit_ok"],
                            quarantines=st["quarantines"],
                            seconds=time.monotonic() - t0)

        sessions = {rid: r.session for rid, r in fleet._replicas.items()}
        with chaos.inject() as c:
            c.corrupt_canary(name, times=1)
            try:
                fleet.update(name, path)
                fail("phase 17 fleet: a corrupted canary was accepted")
            except api.UpdateRejected:
                pass
        st = fleet.stats()
        if st["updates_rolled_back"] != 1 or st["updates_ok"] or \
                any(fleet._replicas[rid].session is not s
                    for rid, s in sessions.items()) or \
                set(fleet.replicas().values()) != {"live"}:
            fail(f"phase 17 fleet update: {st}")
        _served_all(torch, fleet, name, images, len(images), want,
                    "fleet after the rejected update")
        out["update"] = dict(rolled_back=st["updates_rolled_back"])
        with chaos.inject() as c:
            t0 = time.monotonic()
            tickets = [fleet.submit(name, images[j % len(images)])
                       for j in range(FLEET_REQUESTS)]
            c.kill_pool(0)
            for j, t in enumerate(tickets):
                if not _equal_outputs(torch, t.result(timeout=600),
                                      want[j % len(images)]):
                    fail(f"phase 17 fleet kill_pool: request {j} differs")
        st = fleet.stats()
        if st["pool_deaths"] != 1 or st["failed"]:
            fail(f"phase 17 fleet kill_pool: {st['pool_deaths']} deaths, "
                 f"{st['failed']} failed")
        _fleet_live(fleet, "kill_pool")
        out["kill_pool"] = dict(redispatches=st["redispatches"],
                                recycles=st["recycles"],
                                recovery_s=time.monotonic() - t0)

        out["requests"] = st["requests"]
    finally:
        fleet.close()
    return out


def _fleet_live(fleet, where):
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        if set(fleet.replicas().values()) == {"live"}:
            return
        time.sleep(0.1)
    fail(f"phase 17 fleet {where}: replicas {fleet.replicas()}")


def phase_procpool(torch, rpa, images, stored) -> dict:
    """Phase 17 (see the module docstring)."""
    from repro_torch import api
    name = MOBILENET.name
    model = api.load(rpa[name], mmap=True, device="cuda")
    sem = model.semantics
    # phase 6's stored ints of each image, decoded on the host
    want = [{k: sem.decode(k, v[i]) for k, v in stored.items()}
            for i in range(len(images))]
    del model
    rates, out = {}, {}
    for workers in (1, 2):
        sess = api.Session(workers=workers, max_batch=VISION_BATCH)
        try:
            sess.load(rpa[name], name=name)
            for _ in range(workers):       # every worker's arena, warm
                _served_all(torch, sess, name, images, len(images), want,
                            f"thread {workers} warm")
            wall = _served_all(torch, sess, name, images, PROC_REQUESTS,
                               want, f"thread {workers}")
            _no_failures(sess, name, f"thread {workers}")
            rates[f"thread {workers}"] = PROC_REQUESTS / wall
        finally:
            sess.close()
    # both process sessions boot their children side by side
    procs = {n: api.Session(workers=("process", n), max_batch=VISION_BATCH,
                            heartbeat_timeout_s=PROC_HEARTBEAT_S)
             for n in (1, PROC_WORKERS)}
    try:
        t0 = time.monotonic()
        for sess in procs.values():
            sess.load(rpa[name], name=name)
        out["boot_and_load_s"] = time.monotonic() - t0
        for n, sess in procs.items():
            ready = _children(sess)
            pids = {h["pid"] for h in ready.values()}
            if len(pids) != n or os.getpid() in pids or \
                    {h["device"] for h in ready.values()} != {"cuda"}:
                fail(f"phase 17: process {n}'s children are {ready}")
            # the children's counts, read before and after the run (they
            # include each child's warm batch); the parent's from 0
            k0 = sess._pool.child_launches().get("neutron_matmul", 0)
            b0 = sess.stats()["models"][name]["batches"]
            reset_launches()
            wall = _served_all(torch, sess, name, images, PROC_REQUESTS,
                               want, f"process {n}")
            batches = sess.stats()["models"][name]["batches"] - b0
            k1 = sess._pool.child_launches().get("neutron_matmul", 0) - k0
            _no_failures(sess, name, f"process {n}")
            if k1 != MOBILENET.k1_per_replay * batches or \
                    read_launches()[3]:
                fail(f"phase 17 process {n}: the children launched K1 {k1} "
                     f"times in {batches} batches, the parent "
                     f"{read_launches()[3]}")
            rates[f"process {n}"] = PROC_REQUESTS / wall
            out[f"process {n}"] = dict(children=len(pids), batches=batches,
                                       k1_launches=k1)
        procs[1].close()
        print("  requests/s, " + str(PROC_REQUESTS) + " requests of "
              + name + " int8 from " + str(PROC_SUBMITTERS)
              + " submitters: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in rates.items()))
        out["chaos"] = _proc_chaos(torch, procs[PROC_WORKERS], name, images,
                                   want)
    finally:
        for sess in procs.values():
            sess.close()
    out["requests_s"] = rates
    out["fleet"] = _fleet_phase(torch, api, rpa[name], name, images, want)
    return out


def run_compiled_phases(torch, rows, vision_ref, images, rpa):
    """Phases 11, 12 and 13: the compiled vision models, their Session
    and the decoder.  Phases 11 and 12 save their models' artifacts into
    ``rpa``, which phases 16 and 17 load."""
    compiled = {}
    for path in (MOBILENET, RESNET):
        print(f"== phase 11: {path.name} through repro_torch.api.compile at "
              f"224, int8, batch {VISION_BATCH}")
        t = time.monotonic()
        out, compiled[path.name] = phase_compiled(
            torch, path, vision_ref.pop(path.name))
        rpa[path.name] = compiled[path.name].save(
            f"{rpa['dir']}/{path.name}.rpa")
        print(f"  {path.name} compiled: {json.dumps(out)}")
        print(f"  phase 11 ({path.name}) wall time "
              f"{time.monotonic() - t:.1f} s")
    print(f"== phase 12: Session on the card, {MOBILENET.name} and "
          f"{RESNET.name} int8 and {MOBILENET.name} float32 at 224")
    t = time.monotonic()
    out = phase_session(torch, rows, compiled, images, rpa)
    print(f"  session: {json.dumps(out)}")
    print(f"  phase 12 wall time {time.monotonic() - t:.1f} s")
    del compiled
    print(f"== phase 13: {DECODER_PATH} ({DECODER}) through "
          f"DecodeSession, float32 and int8")
    t = time.monotonic()
    out = phase_decode(torch, rows)
    print(f"  decode: {json.dumps(out)}")
    print(f"  phase 13 wall time {time.monotonic() - t:.1f} s")


# --------------------------------------------------------------------------
# phase 18: training on the card
# --------------------------------------------------------------------------

# phase 18's reduced card-vs-CPU, restart and loss-decrease runs are sized
# as tests/test_train_e2e.py sizes them
LR = 3e-4                           # AdamWConfig().lr


# K2b's kernels (csrc/flash_attention_bwd.cu) as torch.profiler names them
K2B_KERNEL_NAME = re.compile(r"\(anonymous namespace\)::(?:delta|dkdv|dq|"
                             r"dkdv_mma|dq_mma|group_sum)_kernel\b")


def bwd_counters():
    """The backward kernels' wrappers: K2b, K4b."""
    from repro_torch.kernels import flash_attention_bwd, ssd_scan_bwd
    return (flash_attention_bwd, ssd_scan_bwd)


# the backward kernels as torch.profiler names them: K4b's
# (csrc/ssd_chunk_bwd.cu) and K2b's (above), by their place in
# TrainPath.per_step
BWD_KERNEL_NAMES = {
    1: ("K2b", K2B_KERNEL_NAME),
    3: ("K4b", re.compile(r"\(anonymous namespace\)::ssd_chunk_bwd_"
                          r"(?:bf16_)?(?:reduce_|sum_)?kernel\b"))}


def _steps_through_loop(torch, tp: TrainPath, cfg, on_step) -> dict:
    """Phase 18's drive: the first step's loss recomputed through the
    plain logits (cross_entropy of forward) on the initial state, then
    TRAIN_STEPS steps through ``train_loop``, whose first loss must lie
    within 5e-2 of it."""
    import gc

    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch.train import train_loop
    from repro_torch.models import lm
    from repro_torch.models.layers import cross_entropy
    from repro_torch.models.train import init_train_state
    state = init_train_state(cfg, SEED, "cuda")
    n_params = sum(p.numel() for p in state.params.parameters())
    b0 = batch_for_step(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH,
                                   seed=SEED), 0)
    labels = torch.from_numpy(b0["labels"]).long().cuda()
    with torch.no_grad():
        ce0 = float(cross_entropy(lm.forward(cfg, state.params, b0)[:, :-1],
                                  labels[:, 1:]))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses = train_loop(tp.arch, steps=TRAIN_STEPS, smoke=False,
                        seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        log_every=1, seed=SEED, on_step=on_step)
    rel = abs(losses[0] - ce0) / abs(ce0)
    if rel > 5e-2:
        fail(f"phase 18: the first step's fused_ce loss {losses[0]:.5f} is "
             f"not within 5e-2 of cross_entropy(forward) {ce0:.5f}")
    print(f"  {tp.arch}: first loss {losses[0]:.5f} vs cross_entropy("
          f"forward) {ce0:.5f}: rel {rel:.3g} (limit 5e-2)")
    return dict(params=n_params, first_loss_vs_cross_entropy=rel,
                cross_entropy=ce0)


def _steps_through_step_fn(torch, tp: TrainPath, cfg, on_step) -> dict:
    """Phase 19's drive: TRAIN_STEPS steps of ``make_train_step``, each
    reported to `on_step` as ``train_loop`` reports it, its clock
    running from the call to the read of its loss (the batch is made
    before it)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.train import (TrainOptions, init_train_state,
                                          make_train_step)
    opts = TrainOptions(total_steps=TRAIN_STEPS)      # as train_loop's
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, SEED, "cuda", opts=opts)
    n_params = sum(p.numel() for p in state.params.parameters())
    step = make_train_step(cfg, opts=opts)
    dcfg = DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    for i in range(TRAIN_STEPS):
        b = train_batch(cfg, dcfg, i)
        t = time.monotonic()
        state, m = step(state, b)
        float(m["loss"])
        on_step(i, m, time.monotonic() - t)
    return dict(params=n_params)


def _train_full(torch, rows, tp: TrainPath, phase: int) -> dict:
    """Phases 18.1 and 19.1: `tp` at full width (bf16 parameters, float32
    AdamW moments, remat), TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ
    tokens, the last under torch.profiler: losses and grad norms finite;
    the launches of K2, K2b, K4 and K4b ``tp.per_step`` a step, at the
    shapes phase 2 times, and no other kernel; device time in the
    profiled step in each backward kernel the path launches."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention_bwd, ssd_scan_bwd
    from repro_torch.models.registry import get_arch
    cfg = get_arch(tp.arch)
    if (cfg.n_layers, cfg.d_model) != tp.width or not cfg.remat:
        fail(f"phase {phase}: {tp.arch} is not {tp.width} with remat")
    steps = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def on_step(i, metrics, dt):
        steps.append(dict(loss=float(metrics["loss"]),
                          grad_norm=float(metrics["grad_norm"]),
                          wall_ms=dt * 1e3))
        # the last step runs under the profiler
        if i == TRAIN_STEPS - 2:
            torch.cuda.synchronize()
            prof.__enter__()
        elif i == TRAIN_STEPS - 1:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)

    # each drive sets the launch counts to 0 just before its steps
    drive = _steps_through_loop if tp.loop else _steps_through_step_fn
    try:
        out = drive(torch, tp, cfg, on_step)
    except torch.cuda.OutOfMemoryError:
        print(torch.cuda.memory_summary())
        fail(f"phase {phase}: {tp.arch} does not train at full width in "
             f"the card's memory (summary above)")
    peak = torch.cuda.max_memory_allocated()
    k = read_launches()
    got = (k[0], flash_attention_bwd.launches, k[2], ssd_scan_bwd.launches)
    want = tuple(n * TRAIN_STEPS for n in tp.per_step)
    names = ("K2", "K2b", "K4", "K4b")
    if got != want or k[1] or k[3]:
        fail(f"phase {phase}: {tp.arch} launched {dict(zip(names, got))}, "
             f"K3 {k[1]}, K1 {k[3]}; expected {dict(zip(names, want))} and "
             f"no other kernel")
    if len(steps) != TRAIN_STEPS or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
            for r in steps):
        fail(f"phase {phase}: {tp.arch} steps not all finite: {steps}")
    # each phase-2 row of this run: its launches, counted by shape
    shapes = {"flash_attention":
              read_launches_by_shape()["flash_attention"],
              "flash_attention_bwd": Counter(
                  flash_attention_bwd.launches_by_shape)}
    for a, _, _ in train_attention_shapes(tp, cfg):
        for name in shapes:
            r = rows[(name, a.tag)]
            r["launches"] = shapes[name].pop(r["key"], 0)
            if r["launches"] != r["expect"]:
                fail(f"phase {phase}: {name} [{a.tag}] launched "
                     f"{r['launches']} times, expected {r['expect']}")
    if any(shapes.values()):
        fail(f"phase {phase}: {tp.arch} launched attention at shapes "
             f"phase 2 does not time: {shapes}")
    for name, n in (("ssd_chunk", got[2]), ("ssd_chunk_bwd", got[3])):
        if n:
            r = rows[(name, f"train {tp.arch}")]
            r["launches"] = n
            if n != r["expect"]:
                fail(f"phase {phase}: {name} launched {n}, expected "
                     f"{r['expect']}")
    busy_us, kernels, n_kernels = 0.0, {}, 0
    bwd_us = {name: 0.0 for j, (name, _) in BWD_KERNEL_NAMES.items()
              if tp.per_step[j]}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            n_kernels += 1
            kernels[e.name[:60]] = kernels.get(e.name[:60], 0.0) + us
            for name, pattern in BWD_KERNEL_NAMES.values():
                if name in bwd_us and pattern.search(e.name):
                    bwd_us[name] += us
    if busy_us <= 0 or not all(bwd_us.values()):
        fail(f"phase {phase}: the profiler saw {busy_us:.1f} us of device "
             f"time in {tp.arch}'s step, of it {bwd_us} us in its backward "
             f"kernels")
    step_ms = statistics.median(r["wall_ms"] for r in steps[1:])
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    out.update(losses=[r["loss"] for r in steps],
               grad_norms=[r["grad_norm"] for r in steps],
               wall_ms_per_step=[r["wall_ms"] for r in steps],
               step_ms_median_2_4=step_ms,
               busy_ms_profiled_step=busy_us / 1e3,
               busy_share=busy_us / 1e3 / steps[-1]["wall_ms"],
               kernels_profiled_step=n_kernels,
               **{f"{n.lower()}_ms_profiled_step": us / 1e3
                  for n, us in bwd_us.items()},
               top_kernels_ms=[(n, us / 1e3) for n, us in top],
               peak_memory_bytes=peak,
               launches_per_step=dict(zip(names, (n / TRAIN_STEPS
                                                  for n in got))))
    bwd = ", ".join(f"{n} {us / 1e3:.3f} ms" for n, us in bwd_us.items())
    print(f"  {tp.arch} full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {out['params'] / 1e9:.3f} B parameters, bf16, "
          f"remat), batch {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
          f"{out['losses']}, grad norms {out['grad_norms']}; wall ms per "
          f"step {out['wall_ms_per_step']} (median of steps 2-4 "
          f"{step_ms:.1f}); busy {busy_us / 1e3:.1f} ms of the profiled "
          f"step (share {out['busy_share']:.3f}, {n_kernels} kernels; "
          f"{bwd}); peak {peak / 2**30:.2f} GiB; launches a step "
          f"{out['launches_per_step']}; top {top[:4]}")
    del prof
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_batch(cfg, dcfg, step: int) -> dict:
    """``batch_for_step``'s tokens and labels and, for an encoder-decoder
    config, audio embeddings (B, n_audio_frames, d) float32 drawn from
    (seed, step): the log-mel frontend is a stub, as in phase 14."""
    from repro_torch.data.pipeline import batch_for_step
    b = batch_for_step(dcfg, step)
    if cfg.enc_dec:
        b["audio_embed"] = np.random.default_rng((dcfg.seed, step)).normal(
            size=(dcfg.global_batch, cfg.n_audio_frames, cfg.d_model)
        ).astype(np.float32)
    return b


def _train_card_vs_cpu(torch, arch: str, phase: int) -> dict:
    """Phase 18.2 / 19: reduced `arch` in float32, 3 steps on the card and
    on the CPU from the same state and batches."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.convert import (train_state_from_numpy,
                                            train_state_to_host)
    from repro_torch.models.registry import get_arch
    from repro_torch.models.train import init_train_state, make_train_step
    cfg = get_arch(arch).reduced(dtype="float32")
    host = train_state_to_host(cfg, init_train_state(cfg, SEED, "cpu"))
    states = {d: train_state_from_numpy(cfg, host, d)
              for d in ("cuda", "cpu")}
    step = make_train_step(cfg)
    dcfg = DataConfig(cfg.vocab, 32, 4, seed=SEED)
    worst, lr_sum = 0.0, 0.0
    for i in range(3):
        b = train_batch(cfg, dcfg, i)
        m = {}
        for d in ("cuda", "cpu"):
            states[d], m[d] = no_tf32(torch,
                                      lambda: step(states[d], b))
        for key in ("loss", "grad_norm", "lr_scale"):
            a, c = float(m["cuda"][key]), float(m["cpu"][key])
            r = abs(a - c) / max(abs(c), 1e-30)
            worst = max(worst, r)
            if r > 2e-4:
                fail(f"phase {phase}: {arch} card vs CPU step {i} {key} "
                     f"{a} vs {c}")
        lr_sum += float(m["cpu"]["lr_scale"])
    atol = 2 * LR * lr_sum
    p_worst = 0.0
    for a, c in zip(states["cuda"].params.parameters(),
                    states["cpu"].params.parameters()):
        d = (a.detach().cpu() - c.detach()).abs()
        bad = d > atol + 2e-4 * c.detach().abs()
        if bad.any():
            fail(f"phase {phase}: {arch} card vs CPU parameters: "
                 f"{int(bad.sum())} elements beyond {atol:.3g} + 2e-4 "
                 f"relative")
        p_worst = max(p_worst, float(d.max()))
    print(f"  card vs CPU, reduced {arch} float32, 3 steps: loss / grad "
          f"norm / lr scale max rel {worst:.3g} (limit 2e-4); parameters "
          f"max|d| {p_worst:.3g} (limit {atol:.3g} + 2e-4 rel)")
    return dict(metrics_max_rel=worst, params_max_abs=p_worst,
                params_atol=atol)


def _train_restart(torch) -> dict:
    """Phase 18.3: reduced minitron-4b, 8 steps checkpointed every 4,
    resumed to 12, against 12 uninterrupted."""
    from repro_torch.launch.train import train_loop
    d = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        kw = dict(seq_len=32, global_batch=4, log_every=100, seed=SEED)
        train_loop("minitron-4b", steps=8, ckpt_dir=d, ckpt_every=4, **kw)
        b = train_loop("minitron-4b", steps=12, ckpt_dir=d, ckpt_every=4,
                       **kw)
        c = train_loop("minitron-4b", steps=12, **kw)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    diff = max(abs(x - y) for x, y in zip(b, c[-4:]))
    if len(b) != 4 or diff > 1e-4:
        fail(f"phase 18: resumed steps 8-11 {b} vs uninterrupted {c[-4:]}")
    print(f"  restart: resumed steps 8-11 {b}, uninterrupted {c[-4:]}: "
          f"max|d| {diff:.3g} (limit 1e-4), bit-equal {b == c[-4:]}")
    return dict(resumed=b, uninterrupted=c[-4:], max_abs=diff,
                bit_equal=b == c[-4:])


def _train_loss_decreases(torch) -> dict:
    """Phase 18.4: reduced qwen2-vl-2b, 25 steps, seq 64, batch 8."""
    from repro_torch.launch.train import train_loop
    losses = train_loop("qwen2-vl-2b", steps=25, seq_len=64, global_batch=8,
                        log_every=100, seed=SEED)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not np.isfinite(losses).all() or not last < first:
        fail(f"phase 18: reduced qwen2-vl-2b's loss did not decrease: "
             f"{losses}")
    print(f"  loss decreases, reduced qwen2-vl-2b: mean of the first 5 "
          f"{first:.4f}, of the last 5 {last:.4f}")
    return dict(first5=first, last5=last)


def phase_train(torch, rows) -> dict:
    out = dict(full=_train_full(torch, rows, TRAIN_PATHS[0], 18))
    torch.cuda.empty_cache()
    out.update(card_vs_cpu=_train_card_vs_cpu(torch, "minitron-4b", 18),
               restart=_train_restart(torch),
               loss_decreases=_train_loss_decreases(torch))
    return out


def _train19_loss_falls(torch, arch: str) -> dict:
    """Phase 19.3: reduced `arch` in float32 on the card, 8 steps at a
    constant learning rate: the mean loss of the last 3 below that of
    the first 3."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.registry import get_arch
    from repro_torch.models.train import (TrainOptions, init_train_state,
                                          make_train_step)
    cfg = get_arch(arch).reduced(dtype="float32")
    opts = TrainOptions(lr_schedule="constant")
    state = init_train_state(cfg, SEED, "cuda", opts=opts)
    step = make_train_step(cfg, opts=opts)
    dcfg = DataConfig(cfg.vocab, 32, 4, seed=SEED)
    losses = []
    for i in range(8):
        state, m = step(state, train_batch(cfg, dcfg, i))
        losses.append(float(m["loss"]))
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    if not np.isfinite(losses).all() or not last < first:
        fail(f"phase 19: reduced {arch}'s loss did not fall: {losses}")
    print(f"  loss falls, reduced {arch}: {[round(x, 4) for x in losses]}")
    return dict(first3=first, last3=last)


def _train_mtp(torch, rows) -> dict:
    """Phase 19.4: deepseek-v3 reduced in float32 with its
    multi-token-prediction block (the loss adds 0.3 x the CE of token
    t+2 through one more MLA + MoE layer), 3 steps on the card against
    the CPU as the other families; every MLA layer's attention on K2 and
    K2b at D = d_nope + d_rope, Dv = d_v (counted by shape: the
    counters from 0 just before the card-vs-CPU run)."""
    from repro_torch.kernels import flash_attention_bwd
    reset_launches()
    out = _train_card_vs_cpu(torch, MTP_ARCH, 19)
    shapes = {"flash_attention":
              read_launches_by_shape()["flash_attention"],
              "flash_attention_bwd": Counter(
                  flash_attention_bwd.launches_by_shape)}
    for name, by_shape in shapes.items():
        r = rows[(name, MTP_TAG)]
        r["launches"] = by_shape.pop(r["key"], 0)
        if r["launches"] != r["expect"] or any(by_shape.values()):
            fail(f"phase 19: {MTP_ARCH} reduced launched {name} "
                 f"{r['launches']} times at its shape (expected "
                 f"{r['expect']}), and at others {dict(by_shape)}")
    out["launches"] = {n: rows[(n, MTP_TAG)]["launches"] for n in shapes}
    print(f"  {MTP_ARCH} reduced with mtp: K2 / K2b "
          f"{out['launches']} in 3 steps on the card")
    return out


def phase_train19(torch, rows) -> dict:
    out = {}
    for tp in TRAIN_PATHS[1:]:
        out[tp.arch] = dict(full=_train_full(torch, rows, tp, 19))
    for tp in TRAIN_PATHS[1:]:
        out[tp.arch].update(
            card_vs_cpu=_train_card_vs_cpu(torch, tp.arch, 19),
            loss_falls=_train19_loss_falls(torch, tp.arch))
    out[MTP_ARCH] = dict(card_vs_cpu=_train_mtp(torch, rows))
    return out


# --------------------------------------------------------------------------
# phase 20: distribution on the card
# --------------------------------------------------------------------------

# phase 19's deepseek-v3 run with its multi-token-prediction block: the
# config reduced (2 layers and the mtp layer, 4 MLA heads of D 32, Dv 16)
# and trained in float32 on batches of 4 x 32, as _train_card_vs_cpu's
MTP_ARCH = "deepseek-v3-671b"
MTP_TAG = f"f32 train {MTP_ARCH} reduced"
# phase 20: DIST_WORLD ranks share the one H100, one process each, over a
# gloo process group (NCCL takes one rank a device); the mesh is
# (data 1, model DIST_WORLD)
DIST_WORLD = 2
DIST_TRAIN_ARCH = "granite-moe-1b-a400m"
DIST_TRAIN_STEPS = 3
DIST_DECODE_ARCH = "granite-20b"
DIST_DECODE_BATCH, DIST_DECODE_CACHE = 4, 128
# one decode step at the last position of rank 0's half of the cache,
# one at the first of rank 1's
DIST_DECODE_POS = (DIST_DECODE_CACHE // 2 - 1, DIST_DECODE_CACHE // 2)
# the SSD block's shards: mamba2-370m at full width (d 1024, 32 SSD heads
# of 64, N 128), its depth cut from 48 layers to DIST_SSM_LAYERS, each
# rank on 16 of the 32 heads
DIST_SSM_ARCH = "mamba2-370m"
DIST_SSM_LAYERS = 4
DIST_SSM_STEPS = 2
# phase 20.2 holds these reduced configs on the mesh, card against CPU:
# attention and moe_a2a; MLA, the MoE stack and the mtp block; the SSD
# block
DIST_REDUCED = (DIST_TRAIN_ARCH, "deepseek-v3-671b", DIST_SSM_ARCH)
DIST_TIMEOUT_S = 420
#: the ranks' device (the CPU only in a rehearsal of the phase's code)
DIST_DEVICE = "cuda"


def dist_attention_shapes():
    """[(AttnShape, K2 launches)]: phase 20's K2/K2b shape (one rank's 8 of
    granite-moe's 16 query heads over its 4 of 8 kv heads, remat: K2
    twice a layer a step, K2b once; launches summed over the ranks), its
    K3 shape (one rank's half of granite-20b's decode cache, with the
    lse; the 48 query heads computed on every rank) and the deepseek-v3
    mtp run's K2/K2b shape (3 layers, no remat, 3 steps)."""
    from repro_torch.models.registry import get_arch
    n = DIST_WORLD
    cfg = get_arch(DIST_TRAIN_ARCH)
    L, hd = cfg.n_layers, cfg.head_dim
    per = L * DIST_TRAIN_STEPS * n
    train = AttnShape(f"dist {DIST_TRAIN_ARCH} rank of {n}", TRAIN_BATCH,
                      cfg.padded_heads // n, cfg.n_kv_heads // n, TRAIN_SEQ,
                      hd, hd, None, per)
    g = get_arch(DIST_DECODE_ARCH)
    decode = AttnShape(f"dist {DIST_DECODE_ARCH} rank of {n}",
                       DIST_DECODE_BATCH, g.n_heads, g.n_kv_heads,
                       DIST_DECODE_CACHE // n, g.head_dim, g.head_dim, None,
                       len(DIST_DECODE_POS) * n, lse=True)
    m = get_arch(MTP_ARCH).reduced(dtype="float32")
    layers = (m.n_layers + 1) * 3
    mtp = AttnShape(MTP_TAG, 4, m.n_heads, m.n_heads, 32, m.d_nope + m.d_rope,
                    m.d_v, None, layers)
    return [(train, 2 * per), (decode, 0), (mtp, layers)]


def dist_ssd_dims():
    """(tag, (B, S, H, P, N, chunk), K4 launches, K4b launches) of phase
    20's SSD shards: one rank's half of mamba2-370m's heads, remat (K4
    twice a layer a step, K4b once), launches summed over the ranks."""
    from repro_torch.models.registry import get_arch
    n = DIST_WORLD
    cfg = get_arch(DIST_SSM_ARCH)
    per = DIST_SSM_LAYERS * DIST_SSM_STEPS * n
    return (f"dist {DIST_SSM_ARCH} rank of {n}",
            (TRAIN_BATCH, TRAIN_SEQ, cfg.ssm_heads // n, cfg.ssm_head_dim,
             cfg.ssm_state, cfg.ssm_chunk), 2 * per, per)


def _layer_specs(cfg, layer):
    """{parameter name: spec} of one decoder layer, as the reference's
    rules lay out that layer of a stack."""
    from types import SimpleNamespace

    from repro_torch.models import sharding
    tree = {}
    for name, p in layer.named_parameters():
        sub = tree
        *path, key = ("layers", *name.split("."))
        for k in path:
            sub = sub.setdefault(k, {})
        sub[key] = SimpleNamespace(shape=(1, *p.shape))
    specs = sharding.tree_partition_specs(tree)
    out = {}
    for name, _ in layer.named_parameters():
        sub = specs["layers"]
        for k in name.split("."):
            sub = sub[k]
        out[name] = sub[1:]
    return out


def _dist_train_full(torch, mesh, arch, steps, layers=None) -> dict:
    """Phase 20.1 on this rank: `arch` at full width (its depth cut to
    `layers`) over the mesh's `model` axis, `steps` steps of TRAIN_BATCH
    x TRAIN_SEQ tokens: granite-moe-1b-a400m on this rank's 16 of 32
    experts through moe_a2a and its 8 of 16 query heads, mamba2-370m on
    its 16 of 32 SSD heads; wall per step, peak memory, K2 / K2b
    launches by shape, K4 / K4b launches, losses."""
    import dataclasses
    import gc

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import (flash_attention, flash_attention_bwd,
                                     ssd_scan, ssd_scan_bwd)
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import sharding
    from repro_torch.models.registry import get_arch
    from repro_torch.models.train import (TrainOptions, init_train_state,
                                          make_train_step)
    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    opts = TrainOptions(total_steps=steps)
    with use_mesh(mesh):
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(cfg, SEED, DIST_DEVICE, opts=opts)
        first = state.params.layers[0]
        if cfg.family == "ssm":
            experts, heads = 0, first.ssm.A_log.shape[0]
        else:
            experts = first.moe.experts.w_in.shape[0]
            heads = first.attn.wq.shape[1] // cfg.head_dim
        local = sum(p.numel() for p in state.params.parameters())
        step = make_train_step(cfg, opts=opts)
        dcfg = DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
        losses, norms, walls = [], [], []
        for i in range(steps):
            b = train_batch(cfg, dcfg, i)
            torch.cuda.synchronize()
            t = time.monotonic()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            walls.append((time.monotonic() - t) * 1e3)
            norms.append(float(m["grad_norm"]))
        out = dict(losses=losses, grad_norms=norms, wall_ms=walls,
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   local_params=local, experts=experts, heads=heads,
                   model_rank=sharding.axis_rank("model"),
                   k2=flash_attention.launches,
                   k2b=flash_attention_bwd.launches,
                   k4=ssd_scan.launches, k4b=ssd_scan_bwd.launches,
                   k2_shapes=dict(flash_attention.launches_by_shape),
                   k2b_shapes=dict(flash_attention_bwd.launches_by_shape))
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _dist_card_vs_cpu(torch, mesh, arch) -> dict:
    """Phase 20.2 on this rank: reduced `arch` in float32 over the same
    mesh, 3 steps on the card and 3 on the CPU (gloo carries both) from
    the same state; every rank's metrics and its gathered parameters."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models.convert import (train_state_from_numpy,
                                            train_state_to_host)
    from repro_torch.models.registry import get_arch
    from repro_torch.models.train import init_train_state, make_train_step
    cfg = get_arch(arch).reduced(dtype="float32")
    host = train_state_to_host(cfg, init_train_state(cfg, SEED, "cpu"))
    dcfg = DataConfig(cfg.vocab, 32, 4, seed=SEED)
    out = {}
    with use_mesh(mesh):
        step = make_train_step(cfg)
        for d in (DIST_DEVICE, "cpu"):
            state = train_state_from_numpy(cfg, host, d)
            ms = []
            for i in range(3):
                state, m = no_tf32(torch, lambda: step(
                    state, train_batch(cfg, dcfg, i)))
                ms.append({k: float(v) for k, v in m.items()})
            params = train_state_to_host(cfg, state).params
            out["card" if d == DIST_DEVICE else "cpu"] = (ms, params)
    return out


def _dist_decode(torch, mesh) -> dict:
    """Phase 20.3 on this rank: one granite-20b decoder layer at full
    width (48 query heads over one kv head, so the cache is split by
    positions), batch DIST_DECODE_BATCH against a cache of
    DIST_DECODE_CACHE, decoded at DIST_DECODE_POS: first with no mesh on
    the whole cache (the one-rank reference, on the card), then with the
    layer cut by its specs and this rank's half of the cache; K3's
    launches (with the lse) counted from 0 over the mesh's steps."""
    from repro_torch.kernels import flash_decode
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import lm, sharding
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.registry import get_arch
    cfg = get_arch(DIST_DECODE_ARCH)
    dt = dtype_of(cfg.dtype)
    B, S, hd = DIST_DECODE_BATCH, DIST_DECODE_CACHE, cfg.head_dim
    gen = torch.Generator(device=DIST_DEVICE).manual_seed(SEED)
    layer = lm.DecoderLayer(cfg, dt, DIST_DEVICE)
    with torch.no_grad():
        lm._init_decoder_layer(gen, layer)
    ck = torch.randn((B, cfg.n_kv_heads, S, hd), generator=gen,
                     device=DIST_DEVICE).to(dt)
    cv = torch.randn((B, cfg.n_kv_heads, S, hd), generator=gen,
                     device=DIST_DEVICE).to(dt)
    xs = [torch.randn((B, 1, cfg.d_model), generator=gen,
                      device=DIST_DEVICE).to(dt) for _ in DIST_DECODE_POS]

    def run(kc, vc):
        outs, walls = [], []
        for x, pos in zip(xs, DIST_DECODE_POS):
            torch.cuda.synchronize()
            t = time.monotonic()
            h, _ = lm._decoder_layer(
                layer, x, cfg, torch.full((B, 1), pos, device=DIST_DEVICE),
                kv_cache=(kc, vc), cache_pos=pos)
            torch.cuda.synchronize()
            walls.append((time.monotonic() - t) * 1e3)
            outs.append(h.float().cpu())
        return outs, walls

    with torch.no_grad():
        ref_k, ref_v = ck.clone(), cv.clone()
        ref_outs, ref_walls = run(ref_k, ref_v)
        with use_mesh(mesh):
            specs = _layer_specs(cfg, layer)
            for name, p in layer.named_parameters():
                sharding.shard_tensor(p, specs[name])
            i, n = sharding.axis_rank("model"), \
                sharding.mesh_axis_size("model")
            cols = slice(i * S // n, (i + 1) * S // n)
            kc, vc = ck[:, :, cols].clone(), cv[:, :, cols].clone()
            reset_launches()
            outs, walls = run(kc, vc)
            k3 = dict(launches=flash_decode.launches,
                      lse=flash_decode.lse_launches,
                      shapes=dict(flash_decode.launches_by_shape))
    rel = max(float((o - r).abs().max() / r.abs().max())
              for o, r in zip(outs, ref_outs))
    cache = max(float((a.float() - b.float()).abs().max() / b.abs().max())
                for a, b in ((kc, ref_k[:, :, cols]), (vc, ref_v[:, :, cols])))
    return dict(rel=rel, cache_max_abs=cache, wall_ms=walls,
                ref_wall_ms=ref_walls, k3=k3,
                sharded={n: tuple(p.shape) for n, p in layer.named_parameters()
                         if getattr(p, "_tp_dim", None) is not None})


def _dist_rank(rank, world, store, out_dir):
    """One rank of phase 20 (a spawned process on the shared H100): the
    three parts in turn, its results (or its traceback) pickled to
    ``out_dir``."""
    import datetime
    import pickle
    import traceback

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    res = {}
    try:
        from repro_torch.kernels import _build
        from repro_torch.launch.mesh import make_mesh
        _build.build_all()          # loads what the parent built
        mesh = make_mesh(1, world, device=DIST_DEVICE)
        res["train"] = _dist_train_full(torch, mesh, DIST_TRAIN_ARCH,
                                        DIST_TRAIN_STEPS)
        res["ssm"] = _dist_train_full(torch, mesh, DIST_SSM_ARCH,
                                      DIST_SSM_STEPS, DIST_SSM_LAYERS)
        res["card_vs_cpu"] = {a: _dist_card_vs_cpu(torch, mesh, a)
                              for a in DIST_REDUCED}
        res["decode"] = _dist_decode(torch, mesh)
    except BaseException:
        res["error"] = traceback.format_exc()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        dist.destroy_process_group()


def phase_dist(torch, rows) -> dict:
    """Phase 20 (see the module docstring): DIST_WORLD ranks, one process
    each, spawned on the one H100 with a gloo group."""
    import pickle

    import torch.multiprocessing as mp
    n = DIST_WORLD
    d = tempfile.mkdtemp(prefix="chip-smoke-dist-")
    try:
        ctx = mp.spawn(_dist_rank, args=(n, os.path.join(d, "store"), d),
                       nprocs=n, join=False)
        deadline = time.monotonic() + DIST_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    fail(f"phase 20: the ranks did not end within "
                         f"{DIST_TIMEOUT_S} s")
        except Exception as e:          # a rank died (or raised)
            fail(f"phase 20: a rank died: {e!r}")
        res = []
        for r in range(n):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for r, x in enumerate(res):
        if "error" in x:
            fail(f"phase 20 rank {r}:\n{x['error']}")
    (train_shape, _), (decode_shape, _), _ = dist_attention_shapes()
    # 20.1: the same loss bits on every rank, each rank its half
    tr = [x["train"] for x in res]
    if len({tuple(t["losses"]) for t in tr}) != 1 or not all(
            math.isfinite(v) for v in tr[0]["losses"] + tr[0]["grad_norms"]):
        fail(f"phase 20: the ranks' losses differ or are not finite: "
             f"{[t['losses'] for t in tr]}")
    if {(t["experts"], t["heads"]) for t in tr} != {(16, 8)}:
        fail(f"phase 20: the ranks hold (experts, heads) "
             f"{[(t['experts'], t['heads']) for t in tr]}, not (16, 8)")
    for name, key in (("flash_attention", "k2_shapes"),
                      ("flash_attention_bwd", "k2b_shapes")):
        r = rows[(name, train_shape.tag)]
        got = Counter()
        for t in tr:
            got.update(t[key])
        r["launches"] = got.pop(r["key"], 0)
        if r["launches"] != r["expect"] or any(got.values()):
            fail(f"phase 20: {name} launched {r['launches']} times at the "
                 f"shard's shape (expected {r['expect']}), and at others "
                 f"{dict(got)}")
    for r, t in enumerate(tr):
        print(f"  rank {r} ({t['experts']} experts, {t['heads']} heads, "
              f"{t['local_params'] / 1e9:.3f} B parameters): step wall ms "
              f"{[round(w, 1) for w in t['wall_ms']]}, peak "
              f"{t['peak_bytes'] / 2**30:.2f} GiB, K2 {t['k2']} / K2b "
              f"{t['k2b']}, losses {t['losses']}")
    # 20.1 for the SSD block: the same loss bits, each rank 16 heads,
    # K4 and K4b at the shard's shape as often as the layers say
    sm = [x["ssm"] for x in res]
    if len({tuple(t["losses"]) for t in sm}) != 1 or not all(
            math.isfinite(v) for v in sm[0]["losses"] + sm[0]["grad_norms"]):
        fail(f"phase 20: the ranks' {DIST_SSM_ARCH} losses differ or are not "
             f"finite: {[t['losses'] for t in sm]}")
    tag, dims, k4n, k4bn = dist_ssd_dims()
    if {t["heads"] for t in sm} != {dims[2]}:
        fail(f"phase 20: the ranks hold {[t['heads'] for t in sm]} SSD "
             f"heads, not {dims[2]}")
    for name, key, want in (("ssd_chunk", "k4", k4n),
                            ("ssd_chunk_bwd", "k4b", k4bn)):
        rows[(name, tag)]["launches"] = got = sum(t[key] for t in sm)
        if got != want:
            fail(f"phase 20: {name} launched {got} times over the ranks "
                 f"(expected {want})")
    for r, t in enumerate(sm):
        print(f"  {DIST_SSM_ARCH} ({DIST_SSM_LAYERS} layers) rank {r} "
              f"({t['heads']} SSD heads, {t['local_params'] / 1e9:.3f} B "
              f"parameters): step wall ms "
              f"{[round(w, 1) for w in t['wall_ms']]}, peak "
              f"{t['peak_bytes'] / 2**30:.2f} GiB, K4 {t['k4']} / K4b "
              f"{t['k4b']}, losses {t['losses']}")
    # 20.2: card against CPU, every rank, each reduced config
    cvc = {}
    for arch in DIST_REDUCED:
        worst, p_worst, atol = 0.0, 0.0, 0.0
        for r, x in enumerate(res):
            (mc, pc), (mh, ph) = (x["card_vs_cpu"][arch]["card"],
                                  x["card_vs_cpu"][arch]["cpu"])
            for i, (a, c) in enumerate(zip(mc, mh)):
                for key in ("loss", "grad_norm", "lr_scale"):
                    rel = abs(a[key] - c[key]) / max(abs(c[key]), 1e-30)
                    worst = max(worst, rel)
                    if rel > 2e-4:
                        fail(f"phase 20 rank {r}: {arch} card vs CPU step "
                             f"{i} {key} {a[key]} vs {c[key]}")
            atol = 2 * LR * sum(m["lr_scale"] for m in mh)
            flat = _flat_tensors(pc), _flat_tensors(ph)
            for (k, a), (_, c) in zip(*flat):
                dd = (a.float() - c.float()).abs()
                if (dd > atol + 2e-4 * c.float().abs()).any():
                    fail(f"phase 20 rank {r}: {arch} card vs CPU "
                         f"parameter {k}")
                p_worst = max(p_worst, float(dd.max()))
        print(f"  card vs CPU, reduced {arch} float32 on the (1, {n}) mesh, "
              f"3 steps: metrics max rel {worst:.3g} (limit 2e-4), "
              f"parameters max|d| {p_worst:.3g} (limit {atol:.3g} + 2e-4 "
              f"rel)")
        cvc[arch] = dict(metrics_max_rel=worst, params_max_abs=p_worst,
                         params_atol=atol)
    # 20.3: the sequence-sharded decode
    dec = [x["decode"] for x in res]
    r = rows[("flash_decode", decode_shape.tag)]
    got = Counter()
    for x in dec:
        got.update(x["k3"]["shapes"])
    r["launches"] = got.pop(r["key"], 0)
    if r["launches"] != r["expect"] or any(got.values()) or any(
            x["k3"]["lse"] != len(DIST_DECODE_POS) for x in dec):
        fail(f"phase 20: K3 launched {[x['k3'] for x in dec]}; expected "
             f"{len(DIST_DECODE_POS)} with the lse on each rank")
    for rk, x in enumerate(dec):
        if not (x["rel"] < 2e-2 and x["cache_max_abs"] < 2e-2):
            fail(f"phase 20 rank {rk}: the sequence-sharded decode is "
                 f"{x['rel']:.3g} of max|out| from the one-rank decode "
                 f"(limit 2e-2), its cache half {x['cache_max_abs']:.3g}")
        print(f"  decode rank {rk}: max|d|/max|one rank| {x['rel']:.3g} "
              f"(limit 2e-2), its cache half {x['cache_max_abs']:.3g} of "
              f"max|cache|; step wall ms "
              f"{[round(w, 2) for w in x['wall_ms']]} (one rank, no mesh: "
              f"{[round(w, 2) for w in x['ref_wall_ms']]}); K3 "
              f"{x['k3']['launches']}, with the lse {x['k3']['lse']}; "
              f"sharded {x['sharded']}")
    print("  gloo carried this phase's collectives on CUDA tensors: "
          "all_gather_into_tensor (every gather and rank-order sum) and "
          "all_to_all_single (moe_a2a); DTensor's own collectives are not "
          "run on the card (full_tensor crashes a rank there: ROADMAP.md)")
    return dict(train=[{k: v for k, v in t.items() if "shapes" not in k}
                       for t in tr],
                ssm=[{k: v for k, v in t.items() if "shapes" not in k}
                     for t in sm],
                card_vs_cpu=cvc,
                decode=[dict(rel=x["rel"], cache_max_abs=x["cache_max_abs"],
                             wall_ms=x["wall_ms"], ref_wall_ms=x["ref_wall_ms"],
                             k3_launches=x["k3"]["launches"],
                             k3_lse_launches=x["k3"]["lse"]) for x in dec])


def _flat_tensors(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _flat_tensors(v, f"{prefix}{k}.")
        else:
            out.append((prefix + k, v))
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
    vision_ref = {}
    for path in (MOBILENET, RESNET):
        print(f"== phase 6: {path.name} int8 plan at 224, batch "
              f"{VISION_BATCH}")
        t = time.monotonic()
        paths[path.name], vision_ref[path.name] = phase_vision(torch, rows,
                                                               path)
        print(f"  {path.name}: {json.dumps(paths[path.name])}")
        print(f"  phase 6 ({path.name}) wall time "
              f"{time.monotonic() - t:.1f} s")
    for n, path in ((7, GRANITE), (8, GRANITE_MOE), (9, DEEPSEEK),
                    (10, GEMMA)):
        paths[path.arch] = phase_lm(torch, rows, n, path)
    images = vision_ref[MOBILENET.name]["images"]
    stored = vision_ref[MOBILENET.name]["stored"]
    # the artifacts of phases 11 and 12, which phases 16 and 17 load
    rpa = {"dir": tempfile.mkdtemp(prefix="chip-smoke-rpa-")}
    try:
        run_compiled_phases(torch, rows, vision_ref, images, rpa)
        for n, path in ((14, WHISPER), (15, QWEN)):
            paths[path.arch] = phase_lm(torch, rows, n, path)
        print(f"== phase 16: CompiledModel.profile on the card, "
              f"{MOBILENET.name} and {RESNET.name} int8 and "
              f"{MOBILENET.name} float32 at 224, batch {VISION_BATCH}; the "
              f"{DECODER_PATH} int8 at (1, 64) and (64, 64)")
        t = time.monotonic()
        out = phase_profile(torch, rpa)
        print(f"  profile: {json.dumps(out)}")
        print(f"  phase 16 wall time {time.monotonic() - t:.1f} s")
        print(f"== phase 17: Session(workers=(\"process\", "
              f"{PROC_WORKERS})) and Session.fleet on the card, "
              f"{MOBILENET.name} int8 at 224")
        t = time.monotonic()
        out = phase_procpool(torch, rpa, images, stored)
        print(f"  process pool and fleet: {json.dumps(out)}")
        print(f"  phase 17 wall time {time.monotonic() - t:.1f} s")
    finally:
        shutil.rmtree(rpa["dir"], ignore_errors=True)
    print(f"== phase 18: training on the card: minitron-4b at full width, "
          f"{TRAIN_STEPS} steps; card vs CPU, restart and loss decrease at "
          f"reduced configs")
    t = time.monotonic()
    out = phase_train(torch, rows)
    print(f"  training: {json.dumps(out)}")
    print(f"  phase 18 wall time {time.monotonic() - t:.1f} s")
    print(f"== phase 19: training on the card: "
          f"{', '.join(tp.arch for tp in TRAIN_PATHS[1:])} at full "
          f"width, "
          f"{TRAIN_STEPS} steps each; card vs CPU and loss falling at "
          f"reduced configs")
    t = time.monotonic()
    out = phase_train19(torch, rows)
    print(f"  training: {json.dumps(out)}")
    print(f"  phase 19 wall time {time.monotonic() - t:.1f} s")
    print(f"== phase 20: distribution on the card: {DIST_WORLD} ranks over "
          f"gloo on the one card, mesh (data 1, model {DIST_WORLD}): "
          f"{DIST_TRAIN_ARCH} at full width, {DIST_TRAIN_STEPS} steps; "
          f"reduced card vs CPU; {DIST_DECODE_ARCH}'s sequence-sharded "
          f"decode")
    t = time.monotonic()
    out = phase_dist(torch, rows)
    print(f"  distribution: {json.dumps(out)}")
    print(f"  phase 20 wall time {time.monotonic() - t:.1f} s")

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
