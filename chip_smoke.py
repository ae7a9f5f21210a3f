#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (H100, sm_90a) and nvcc; imports no JAX.  Phases,
each of which ends the run with a nonzero exit and no result on failure:

1. the card's name and power limit, torch and CUDA versions, and the
   build of every CUDA kernel from the sources in this checkout;
2. every kernel on the card against its plain PyTorch version, at the
   shapes the serving path gives it (bf16) and at a small ragged case
   (f32), timed with CUDA events beside its plain version, one PyTorch
   library call for the same function, and its bound;
3. the slice: minitron-4b served at full width (32 layers, d_model
   3072; random weights from the seed) through ``serve``, then the
   full-sequence ``prefill`` on the same prompts.  Each path runs with
   the launch counters set to 0 just before it and read just after.
   The decode replay and the prefill must agree at the last prompt
   position, and a reduced config served on the card must agree with
   the plain path on the CPU.

The last lines are the card's name and power limit, one JSON line of
kernel measurements, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_S = 3.35e12       # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core rate
              "float32": 67e12}     # outside the tensor cores

ARCH, BATCH, PROMPT_LEN, GEN, SEED = "minitron-4b", 4, 100, 16, 0
TOL = {"float32": (2e-3, 1e-3), "bfloat16": (2e-2, 2e-2)}


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


def time_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of `fn` over `iters` launches, with the 50 MB
    L2 cache flushed before each (the serving path finds it cold: every
    layer has its own weights and cache)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
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


def bound(nbytes: int, flops: int, dtype: str):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


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


def phase_kernels(torch, F, ops):
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

    rows = {}
    # flash_attention at the prefill shapes of minitron-4b: the kv heads
    # are already expanded to the 32 padded query heads (group 1)
    Hp, hd, S = 32, 128, PROMPT_LEN
    q, k, v = (randn(BATCH, Hp, S, hd) for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=True)
    err = check_close(torch, "flash_attention bf16", got,
                      ops.flash_attention(q, k, v, causal=True, impl="ref"),
                      "bfloat16")
    pairs = BATCH * Hp * S * (S + 1) // 2
    b_ms, b_by = bound(nbytes(q, k, v, got), 2 * pairs * (hd + hd),
                       "bfloat16")
    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:116",
        shape=f"q,k,v ({BATCH},{Hp},{S},{hd}) bf16 causal",
        max_abs_err=err,
        ms=time_ms(torch, lambda: ops.flash_attention(q, k, v)),
        plain_ms=time_ms(torch, lambda: ops.flash_attention(
            q, k, v, impl="ref")),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)))

    # flash_decode at the decode shapes of minitron-4b: 24 query heads
    # against 8 kv heads (group 3), the cache at its last step
    H, Hkv, S = 24, 8, PROMPT_LEN + GEN
    q, k, v = randn(BATCH, H, hd), randn(BATCH, Hkv, S, hd), \
        randn(BATCH, Hkv, S, hd)
    kv_len = torch.full((BATCH,), S, dtype=torch.int32, device="cuda")
    got = ops.flash_decode(q, k, v, kv_len=kv_len)
    err = check_close(torch, "flash_decode bf16", got,
                      ops.flash_decode(q, k, v, kv_len=kv_len, impl="ref"),
                      "bfloat16")
    b_ms, b_by = bound(nbytes(q, k, v, kv_len, got),
                       2 * BATCH * H * S * (hd + hd), "bfloat16")
    rows["flash_decode"] = dict(
        name="flash_decode", route="cuda",
        source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:96",
        shape=f"q ({BATCH},{H},{hd}) x cache ({BATCH},{Hkv},{S},{hd}) bf16",
        max_abs_err=err,
        ms=time_ms(torch, lambda: ops.flash_decode(q, k, v, kv_len=kv_len)),
        plain_ms=time_ms(torch, lambda: ops.flash_decode(
            q, k, v, kv_len=kv_len, impl="ref")),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, enable_gqa=True)))
    for r in rows.values():
        print(f"  {r['name']} {r['shape']}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.5f} by {r['bound_by']}), max|err| "
              f"{r['max_abs_err']:.3g}")
    return rows


# --------------------------------------------------------------------------
# phase 3: the slice
# --------------------------------------------------------------------------


def phase_slice(torch, rows):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.serve import generate, serve
    from repro_torch.models import lm
    from repro_torch.models.registry import get_arch

    fa.launches = fd.launches = 0
    served = serve(ARCH, batch=BATCH, prompt_len=PROMPT_LEN, gen=GEN,
                   smoke=False, seed=SEED, device="cuda")
    serve_launches = (fa.launches, fd.launches)
    cfg, res = served.cfg, served.result
    if (cfg.n_layers, cfg.d_model) != (32, 3072):
        fail(f"not the full width: {cfg.n_layers} layers, d_model "
             f"{cfg.d_model}")
    want = cfg.n_layers * (PROMPT_LEN + GEN)
    if serve_launches != (0, want):
        fail(f"serve launched (flash_attention, flash_decode) = "
             f"{serve_launches}, expected (0, {want})")
    if res.tokens.shape != (BATCH, GEN) or not res.logits_finite:
        fail(f"serve: tokens {res.tokens.shape}, finite logits "
             f"{res.logits_finite}")
    decode_tok_s = GEN * BATCH / res.decode_s
    print(f"  serve: prefill (replay) {res.prefill_s * 1e3:.1f} ms, decode "
          f"{decode_tok_s:.1f} tok/s, flash_decode launches "
          f"{serve_launches[1]}")
    print(f"  first stream: {res.tokens[0].tolist()}")

    def run_prefill():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with torch.no_grad():
            out = lm.prefill(cfg, served.model, {"tokens": served.prompts})
        torch.cuda.synchronize()
        return out, time.monotonic() - t0

    fa.launches = fd.launches = 0
    last, prefill_cold_s = run_prefill()
    prefill_launches = (fa.launches, fd.launches)
    _, prefill_s = run_prefill()          # warm: timed, not counted
    if prefill_launches != (cfg.n_layers, 0):
        fail(f"prefill launched (flash_attention, flash_decode) = "
             f"{prefill_launches}, expected ({cfg.n_layers}, 0)")
    rows["flash_attention"]["launches"] = prefill_launches[0]
    rows["flash_decode"]["launches"] = serve_launches[1]

    a, b = res.prompt_logits.float(), last.float()
    if a.shape != (BATCH, cfg.vocab) or not torch.isfinite(b).all():
        fail(f"prefill logits {tuple(b.shape)} not finite or wrong shape")
    scale = float(torch.maximum(a.abs().max(), b.abs().max()))
    rel = float((a - b).abs().max()) / scale
    top2 = a.topk(2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) < 1e-2 * scale
    same = a.argmax(-1) == b.argmax(-1)
    print(f"  prefill (full sequence): {prefill_cold_s * 1e3:.1f} ms cold, "
          f"{prefill_s * 1e3:.1f} ms warm; vs decode "
          f"replay at position {PROMPT_LEN - 1}: max|d|/max|logit| "
          f"{rel:.3g}, argmax equal {same.tolist()}")
    if rel >= 5e-2 or not bool((same | tie).all()):
        fail("prefill and decode replay disagree")

    # the whole slice on the card against the plain path on the CPU, at a
    # reduced config in float32 (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    small = get_arch(ARCH).reduced(n_heads=3, n_kv_heads=1, d_head=32,
                                   tp_pad=4, dtype="float32")
    cpu_model = lm.init_params(small, SEED, device="cpu")
    prompts = served.prompts[:, :12] % small.vocab
    on_cpu = generate(small, cpu_model, prompts, gen=6)
    on_gpu = generate(small, cpu_model.to("cuda"), prompts, gen=6)
    err = float((on_gpu.prompt_logits.cpu() - on_cpu.prompt_logits).abs()
                .max())
    print(f"  reduced f32 slice, card vs CPU plain path: logits max|err| "
          f"{err:.3g}; tokens equal "
          f"{bool((on_gpu.tokens == on_cpu.tokens).all())}")
    if err > 2e-3:
        fail("the reduced slice on the card disagrees with the CPU path")
    return dict(prefill_replay_ms=res.prefill_s * 1e3,
                decode_tok_s=decode_tok_s,
                prefill_forward_cold_ms=prefill_cold_s * 1e3,
                prefill_forward_ms=prefill_s * 1e3)


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

    print("== phase 2: kernels against their plain versions")
    rows = phase_kernels(torch, F, ops)
    print("== phase 3: minitron-4b at full width")
    slice_ = phase_slice(torch, rows)
    print(f"  slice: {json.dumps(slice_)}")

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(gpu)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
