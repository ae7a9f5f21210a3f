"""Language-model stack of the port: the dense decoder.

Counterpart of the dense, non-MoE branches of ``repro/models/lm.py``:

    init_params(cfg, seed, device)          -> LM module
    forward(cfg, model, batch)              -> logits (B, S, V)
    prefill(cfg, model, batch)              -> last-position logits (B, V)
    init_cache(cfg, batch, max_len, device) -> {"kv": {"k", "v"}}
    decode_step(cfg, model, cache, tok, pos) -> (logits (B, V), cache)

The JAX package scans over layer-stacked parameters; here the layers are
a ``ModuleList`` walked by a Python loop, run eagerly.  The other
families raise ``NotImplementedError`` naming their ``ROADMAP.md`` item.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from .attention import Attention, attention, init_attention
from .config import ArchConfig
from .layers import (MLP, dense_init, dtype_of, embed, embed_init,
                     init_mlp, lm_logits, mlp, param, rms_norm)

_TODO = "not ported yet (ROADMAP.md, 'Modules still to port', item {})"


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for the families this slice leaves out."""
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: SSM / hybrid backbones and ssd_chunk are "
            + _TODO.format(1))
    if cfg.mla:
        raise NotImplementedError(f"{cfg.name}: MLA is " + _TODO.format(2))
    if cfg.local_global_ratio:
        raise NotImplementedError(
            f"{cfg.name}: gemma3's grouped local/global layers and "
            "windowed decode are " + _TODO.format(2))
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: MoE is " + _TODO.format(3))
    if cfg.enc_dec or cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: the whisper encoder-decoder is " + _TODO.format(4))
    if cfg.family == "vlm" or cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name}: qwen2-vl (M-RoPE, vision tokens) is "
            + _TODO.format(4))
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is "
                                  + _TODO.format(1))


# ==========================================================================
# Modules and init
# ==========================================================================


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        self.norm1 = param((cfg.d_model,), dtype, device)
        self.norm2 = param((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device,
                       gated=cfg.gated_mlp)


class LM(nn.Module):
    """embed (V, d), final_norm (d,), lm_head (d, V) unless tied, and
    the decoder layers; parameters uninitialised."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        check_supported(cfg)
        dtype = dtype_of(cfg.dtype)
        d = cfg.d_model
        self.embed = param((cfg.vocab, d), dtype, device)
        self.final_norm = param((d,), dtype, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else param((d, cfg.vocab), dtype, device))
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))

    @property
    def head(self) -> torch.Tensor:
        return self.lm_head if self.lm_head is not None else self.embed

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> LM:
    """Random weights drawn on `device` from a generator seeded with
    `seed` (the same distributions as the JAX package, other numbers);
    norms start at zero as there."""
    device = resolve_device(device)
    model = LM(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    embed_init(gen, model.embed)
    model.final_norm.zero_()
    if model.lm_head is not None:
        dense_init(gen, model.lm_head)
    for layer in model.layers:
        layer.norm1.zero_()
        layer.norm2.zero_()
        init_attention(gen, layer.attn)
        init_mlp(gen, layer.mlp)
    return model


# ==========================================================================
# Forward
# ==========================================================================


def _decoder_layer(p: DecoderLayer, h: torch.Tensor, cfg: ArchConfig,
                   positions: torch.Tensor, kv_cache=None, cache_pos=None):
    hn = rms_norm(p.norm1, h, cfg.norm_eps)
    a, new_cache = attention(p.attn, hn, cfg, positions,
                             kv_cache=kv_cache, cache_pos=cache_pos)
    h = h + a
    hn = rms_norm(p.norm2, h, cfg.norm_eps)
    return h + mlp(p.mlp, hn, act=cfg.act, gated=cfg.gated_mlp), new_cache


def _as_tokens(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=torch.long)


def forward_hidden(cfg: ArchConfig, model: LM, batch: Dict
                   ) -> torch.Tensor:
    """Full-sequence forward -> final-norm hidden states (B, S, d)."""
    tokens = _as_tokens(batch["tokens"], model.device)
    B, S = tokens.shape
    h = embed(model.embed, tokens)
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    for layer in model.layers:
        h, _ = _decoder_layer(layer, h, cfg, positions)
    return rms_norm(model.final_norm, h, cfg.norm_eps)


def forward(cfg: ArchConfig, model: LM, batch: Dict) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V)."""
    return lm_logits(model.head, forward_hidden(cfg, model, batch))


def prefill(cfg: ArchConfig, model: LM, batch: Dict) -> torch.Tensor:
    """Prompt processing: full-sequence forward returning last-position
    logits (B, V)."""
    return forward(cfg, model, batch)[:, -1]


# ==========================================================================
# Decode
# ==========================================================================


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None
               ) -> Dict:
    """KV cache {"kv": {"k", "v"}}, each (L, B, Hkv, max_len, hd)."""
    check_supported(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    dtype = dtype_of(cfg.dtype)
    return {"kv": {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device)}}


def decode_step(cfg: ArchConfig, model: LM, cache: Dict, token, pos: int):
    """token (B,) int; pos an int.  Returns (logits (B, V), cache); the
    cache is updated in place and returned."""
    pos = int(pos)
    token = _as_tokens(token, model.device)
    B = token.shape[0]
    h = embed(model.embed, token[:, None])
    positions = torch.full((B, 1), pos, dtype=torch.long, device=h.device)
    ks, vs = cache["kv"]["k"], cache["kv"]["v"]
    for i, layer in enumerate(model.layers):
        h, _ = _decoder_layer(layer, h, cfg, positions,
                              kv_cache=(ks[i], vs[i]), cache_pos=pos)
    h = rms_norm(model.final_norm, h, cfg.norm_eps)
    return lm_logits(model.head, h)[:, 0], cache
