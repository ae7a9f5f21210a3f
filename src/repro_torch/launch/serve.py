"""Serving entry point of the port: batched prompt replay + greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \
        --no-smoke --batch 4 --prompt-len 100 --gen 16

Counterpart of ``repro/launch/serve.py``: random prompts from
``np.random.default_rng(seed)``, random weights from the seed, prefill by
replaying the prompt through decode steps (one token for the whole batch
against the decode caches: the KV cache through the flash-decode kernel,
the SSM state through ``ssd_step``), then greedy decoding.  Every family
of ``lm.check_supported`` is served: dense (minitron-4b), ssm
(mamba2-370m) and hybrid (zamba2-2.7b).  ``--smoke`` (the default) serves the reduced config;
``--no-smoke`` serves the full width.  Runs on CUDA unless ``--device``
says otherwise.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import get_arch


@dataclass
class Generation:
    tokens: np.ndarray              # (B, gen) int32 greedy tokens
    prompt_logits: torch.Tensor     # (B, V) logits after the last prompt
    #                                 token (position prompt_len - 1)
    logits_finite: bool             # every step's logits were finite
    prefill_s: float                # prompt replay, wall clock
    decode_s: float                 # greedy decode, wall clock


def synchronize(device: torch.device) -> None:
    """Wait for the device, so a host clock around it times the work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(cfg: ArchConfig, model: lm.LM, prompts: np.ndarray, gen: int,
             max_len: Optional[int] = None) -> Generation:
    """Replay `prompts` (B, P) through decode steps, then decode `gen`
    tokens greedily (the loop of ``repro/launch/serve.py:65-80``)."""
    batch, prompt_len = prompts.shape
    max_len = max_len or (prompt_len + gen)
    device = model.device
    cache = lm.init_cache(cfg, batch, max_len, device=device)
    prompts_t = torch.from_numpy(np.ascontiguousarray(prompts)).to(device)
    finite = torch.ones((), dtype=torch.bool, device=device)

    synchronize(device)
    t0 = time.monotonic()
    logits = None
    for t in range(prompt_len):
        logits, cache = lm.decode_step(cfg, model, cache, prompts_t[:, t], t)
        finite &= torch.isfinite(logits).all()
    synchronize(device)
    t_prefill = time.monotonic() - t0
    prompt_logits = logits

    out = []
    tok = torch.argmax(logits, dim=-1)
    synchronize(device)
    t0 = time.monotonic()
    for t in range(prompt_len, prompt_len + gen):
        out.append(tok.cpu().numpy().astype(np.int32))
        logits, cache = lm.decode_step(cfg, model, cache, tok, t)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits, dim=-1)
    synchronize(device)
    t_decode = time.monotonic() - t0
    tokens = (np.stack(out, axis=1) if out
              else np.zeros((batch, 0), np.int32))
    return Generation(tokens, prompt_logits, bool(finite), t_prefill,
                      t_decode)


@dataclass
class Served:
    cfg: ArchConfig
    model: lm.LM
    prompts: np.ndarray
    result: Generation


def serve(arch: str, batch: int = 4, prompt_len: int = 32, gen: int = 16,
          smoke: bool = True, seed: int = 0, max_len: Optional[int] = None,
          device=None) -> Served:
    device = resolve_device(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, size=(batch, prompt_len)
                           ).astype(np.int32)
    model = lm.init_params(cfg, seed, device=device)
    res = generate(cfg, model, prompts, gen, max_len=max_len)
    print(f"prefill {prompt_len} toks x {batch} streams: "
          f"{res.prefill_s*1e3:.1f} ms")
    print(f"decode  {gen} toks x {batch} streams: {res.decode_s*1e3:.1f} ms "
          f"({gen*batch/max(res.decode_s, 1e-9):.1f} tok/s)")
    print("sample generations (first stream):", res.tokens[0][:12])
    return Served(cfg, model, prompts, res)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args()
    serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
          gen=args.gen, smoke=args.smoke, seed=args.seed,
          device=args.device)


if __name__ == "__main__":
    main()
