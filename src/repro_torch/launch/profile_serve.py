"""Where a decode step of the serving slice spends its time.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch zamba2-2.7b --no-smoke --batch 4 --prompt-len 200

Every arch that ``launch/serve.py`` serves runs here; ``--layers N``
cuts the depth (deepseek-v3-671b at full width fits one card at 4).
whisper-tiny's encoder and cross K/V, and qwen2-vl-2b's vision
embeddings, are made as ``serve`` makes them (``serve.decode_aux``),
outside the timed steps.

Replays a random prompt through ``decode_step`` (warm-up), times
``--steps`` further steps on the host clock around
``torch.cuda.synchronize()``, then runs as many steps again under
``torch.profiler`` and sums the device time of every kernel.  Prints one
JSON line: wall ms per step, kernels per step, device-busy ms per step,
the device's idle share, the weight bytes a step reads with their bound
at the H100's memory rate, and the kernels that take the most device
time.
On the CPU (``--device cpu``) the device numbers are "not measured".
"""
from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.launch.serve import (arch_config, decode_aux, draw_inputs,
                                     synchronize)
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig

HBM_BYTES_S = 3.35e12          # H100 SXM device memory, published peak


@torch.no_grad()
def profile_decode(cfg: ArchConfig, model: lm.LM, batch: int,
                   prompt_len: int, steps: int, seed: int = 0) -> dict:
    device = model.device
    prompts, extra = draw_inputs(cfg, np.random.default_rng(seed), batch,
                                 prompt_len)
    aux, _ = decode_aux(cfg, model, extra)
    cache = lm.init_cache(cfg, batch, prompt_len + 2 * steps, device=device)
    for t in range(prompt_len):
        logits, cache = lm.decode_step(cfg, model, cache, prompts[:, t], t,
                                       aux=aux)
    tok = lm.greedy(cfg, logits)
    pos = prompt_len

    synchronize(device)
    t0 = time.monotonic()
    for _ in range(steps):
        logits, cache = lm.decode_step(cfg, model, cache, tok, pos,
                                       aux=aux)
        tok = lm.greedy(cfg, logits)
        pos += 1
    synchronize(device)
    wall_ms = (time.monotonic() - t0) * 1e3 / steps

    out = {"arch": cfg.name, "batch": batch, "kv_len_at_start": prompt_len,
           "steps": steps, "device": str(device),
           "wall_ms_per_step": wall_ms}
    if device.type != "cuda":
        out.update(device_busy_ms_per_step="not measured",
                   idle_share="not measured")
        return out
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            logits, cache = lm.decode_step(cfg, model, cache, tok, pos,
                                           aux=aux)
            tok = lm.greedy(cfg, logits)
            pos += 1
        synchronize(device)
    by_name = collections.Counter()
    n_kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            n_kernels += 1
    busy_ms = sum(by_name.values()) / 1e3 / steps
    # Weights a step must read: all but the embedding table, of which it
    # gathers `batch` rows (unless the table is also the LM head), and
    # whisper's encoder (`enc_*`), which runs once before the steps.
    weight_bytes = sum(p.numel() * p.element_size()
                       for n, p in model.named_parameters()
                       if (n != "embed" or model.lm_head is None)
                       and not n.startswith("enc_"))
    if cfg.enc_dec:     # the cross K/V every step reads besides
        out["cross_kv_bytes_per_step"] = sum(
            t.numel() * t.element_size() for t in aux["cross_kv"].values())
    out.update(
        device_name=torch.cuda.get_device_name(device),
        weight_bytes_per_step=weight_bytes,
        weight_bound_ms_per_step=weight_bytes / HBM_BYTES_S * 1e3,
        kernels_per_step=n_kernels / steps,
        device_busy_ms_per_step=busy_ms,
        idle_share=1.0 - busy_ms / wall_ms,
        top_kernels_ms_per_step=[
            (name[:80], us / 1e3 / steps)
            for name, us in by_name.most_common(10)])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=100)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args()
    device = resolve_device(args.device)
    cfg = arch_config(args.arch, args.smoke, args.layers)
    model = lm.init_params(cfg, args.seed, device=device)
    print(json.dumps(profile_decode(cfg, model, args.batch, args.prompt_len,
                                    args.steps, seed=args.seed)))


if __name__ == "__main__":
    main()
