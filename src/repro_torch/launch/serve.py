"""Serving entry point of the port: batched prompt replay + greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \
        --no-smoke --batch 4 --prompt-len 100 --gen 16

Counterpart of ``repro/launch/serve.py``: random prompts, then (whisper)
audio frame embeddings, then (qwen2-vl) vision embeddings, all from one
``np.random.default_rng(seed)`` in the reference's order; random weights
from the seed; prefill by replaying the prompt through decode steps (one
token for the whole batch against the decode caches: the KV cache
through the flash-decode kernel, the SSM state through ``ssd_step``),
then greedy decoding.  Every family of ``lm.check_supported`` is served:
dense (minitron-4b, granite-20b's MQA, nemotron-4-340b), gemma3's
local/global layers with ring-buffer decode (gemma3-27b), MoE
(granite-moe-1b-a400m), MLA with MoE (deepseek-v3-671b), ssm
(mamba2-370m), hybrid (zamba2-2.7b), the encoder-decoder whisper-tiny
(the encoder and every layer's cross K/V run once, before the replay;
each step's cross-attention reads them) and the vision-language
qwen2-vl-2b (the vision embeddings replace the first prompt tokens'
embeddings in each step; the reference draws them and does not pass them
on, ``ROADMAP.md`` §3).
``--smoke`` (the default) serves the reduced config; ``--no-smoke``
serves the full width, and ``--layers N`` cuts the depth to N layers
(deepseek-v3 at full depth does not fit one card).  Runs on CUDA unless
``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

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
             max_len: Optional[int] = None, aux: Optional[Dict] = None
             ) -> Generation:
    """Replay `prompts` (B, P) through decode steps, then decode `gen`
    tokens greedily (the loop of ``repro/launch/serve.py:65-80``); `aux`
    goes to every step (``lm.decode_step``)."""
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
        logits, cache = lm.decode_step(cfg, model, cache, prompts_t[:, t], t,
                                       aux=aux)
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
        logits, cache = lm.decode_step(cfg, model, cache, tok, t, aux=aux)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits, dim=-1)
    synchronize(device)
    t_decode = time.monotonic() - t0
    tokens = (np.stack(out, axis=1) if out
              else np.zeros((batch, 0), np.int32))
    return Generation(tokens, prompt_logits, bool(finite), t_prefill,
                      t_decode)


def arch_config(arch: str, smoke: bool, layers: Optional[int] = None
                ) -> ArchConfig:
    """`arch`'s config, reduced with `smoke`, its depth cut to `layers`."""
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def draw_inputs(cfg: ArchConfig, rng: np.random.Generator, batch: int,
                prompt_len: int) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Prompts (B, P) int32, then the extra inputs of the family, drawn
    from `rng` in the reference's order (``repro/launch/serve.py:38-51``):
    whisper's "audio_embed" (B, n_audio_frames, d) and qwen2-vl's
    "vision_embed" (B, n_vision_tokens, d), float32 normals."""
    prompts = rng.integers(0, cfg.vocab, size=(batch, prompt_len)
                           ).astype(np.int32)
    extra = {}
    if cfg.enc_dec:
        extra["audio_embed"] = rng.normal(
            size=(batch, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        extra["vision_embed"] = rng.normal(
            size=(batch, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return prompts, extra


@torch.no_grad()
def decode_aux(cfg: ArchConfig, model: lm.LM, extra: Dict[str, np.ndarray]
               ) -> Tuple[Optional[Dict], Dict[str, float]]:
    """What every decode step of `extra`'s requests needs beside the
    cache, and the wall seconds of what it ran: for whisper the encoder
    and each layer's cross K/V, once (``repro/launch/serve.py:55-58``);
    for qwen2-vl the vision embeddings, on the model's device.  None for
    the other families."""
    device = model.device
    if cfg.enc_dec:
        synchronize(device)
        t0 = time.monotonic()
        enc = lm.encode_audio(cfg, model, extra["audio_embed"])
        synchronize(device)
        t1 = time.monotonic()
        kv = lm.cross_kv(cfg, model, enc)
        synchronize(device)
        return ({"enc_states": enc, "cross_kv": kv},
                {"encode_s": t1 - t0, "cross_kv_s": time.monotonic() - t1})
    if cfg.family == "vlm":
        return {"vision_embed": torch.from_numpy(
            extra["vision_embed"]).to(device)}, {}
    return None, {}


@dataclass
class Served:
    cfg: ArchConfig
    model: lm.LM
    prompts: np.ndarray
    result: Generation
    # the family's extra inputs (draw_inputs), and the wall seconds of
    # what decode_aux ran
    extra: Dict[str, np.ndarray] = field(default_factory=dict)
    aux_s: Dict[str, float] = field(default_factory=dict)

    @property
    def batch(self) -> Dict:
        """The full-sequence batch of the same request: what ``lm.forward``
        and ``lm.prefill`` take."""
        return {"tokens": self.prompts, **self.extra}


def serve(arch: str, batch: int = 4, prompt_len: int = 32, gen: int = 16,
          smoke: bool = True, seed: int = 0, max_len: Optional[int] = None,
          device=None, layers: Optional[int] = None) -> Served:
    """Serve `arch` (reduced with `smoke`; its depth cut to `layers` when
    given) on random inputs and weights from `seed`."""
    device = resolve_device(device)
    cfg = arch_config(arch, smoke, layers)
    prompts, extra = draw_inputs(cfg, np.random.default_rng(seed), batch,
                                 prompt_len)
    model = lm.init_params(cfg, seed, device=device)
    aux, aux_s = decode_aux(cfg, model, extra)
    for name, sec in aux_s.items():
        print(f"{name[:-2]}: {sec * 1e3:.1f} ms")
    res = generate(cfg, model, prompts, gen, max_len=max_len, aux=aux)
    print(f"prefill {prompt_len} toks x {batch} streams: "
          f"{res.prefill_s*1e3:.1f} ms")
    print(f"decode  {gen} toks x {batch} streams: {res.decode_s*1e3:.1f} ms "
          f"({gen*batch/max(res.decode_s, 1e-9):.1f} tok/s)")
    print("sample generations (first stream):", res.tokens[0][:12])
    return Served(cfg, model, prompts, res, extra, aux_s)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args()
    serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
          gen=args.gen, smoke=args.smoke, seed=args.seed,
          device=args.device, layers=args.layers)


if __name__ == "__main__":
    main()
