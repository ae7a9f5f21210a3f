"""Language-model stack of the port: dense, SSM and hybrid decoders.

Counterpart of the dense (non-MoE), ``ssm`` (mamba2) and ``hybrid``
(zamba2) branches of ``repro/models/lm.py``:

    init_params(cfg, seed, device)          -> LM module
    forward(cfg, model, batch)              -> logits (B, S, V)
    prefill(cfg, model, batch)              -> last-position logits (B, V)
    init_cache(cfg, batch, max_len, device) -> {"kv": {"k", "v"}} (dense),
        {"ssm": SSMState} (ssm), {"ssm": SSMState, "shared": {"k", "v"}}
        (hybrid)
    decode_step(cfg, model, cache, tok, pos) -> (logits (B, V), cache)

The JAX package scans over layer-stacked parameters; here the layers are
``ModuleList``s walked by Python loops, run eagerly, and the caches are
updated in place.  The other families raise ``NotImplementedError``
naming their ``ROADMAP.md`` item.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from .attention import Attention, attention, init_attention
from .config import ArchConfig
from .layers import (MLP, dense_init, dtype_of, embed, embed_init,
                     init_mlp, lm_logits, mlp, param, rms_norm)
from .ssm import SSM, SSMState, init_ssm, init_ssm_state, ssm_block

_TODO = "not ported yet (ROADMAP.md, 'Modules still to port', item {})"


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for the families the port leaves out."""
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
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is "
                                  "not ported (ROADMAP.md)")


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


class SSMLayer(nn.Module):
    """One Mamba2 layer: pre-norm (d,) and the SSM block."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        self.norm = param((cfg.d_model,), dtype, device)
        self.ssm = SSM(cfg, dtype, device)


class LoRA(nn.Module):
    """A zamba2 group's deltas for the shared block: wq += q_a @ q_b,
    mlp.w_in += in_a @ in_b."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        d, r = cfg.d_model, cfg.lora_rank
        self.q_a = param((d, r), dtype, device)
        self.q_b = param((r, cfg.padded_heads * cfg.head_dim), dtype, device)
        self.in_a = param((d, r), dtype, device)
        self.in_b = param((r, cfg.d_ff), dtype, device)


class ZambaGroup(nn.Module):
    """`shared_attn_every` SSM layers, then the shared block with this
    group's LoRA."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        self.ssm = nn.ModuleList(SSMLayer(cfg, dtype, device)
                                 for _ in range(cfg.shared_attn_every))
        self.lora = LoRA(cfg, dtype, device)


def _hybrid_groups(cfg: ArchConfig) -> int:
    # As in the JAX package, layers past the last whole group are dropped.
    return cfg.n_layers // cfg.shared_attn_every


class LM(nn.Module):
    """embed (V, d), final_norm (d,), lm_head (d, V) unless tied, and by
    family: `layers` (dense: DecoderLayers; ssm: SSMLayers) or `groups`
    (ZambaGroups) and the `shared` DecoderLayer (hybrid); parameters
    uninitialised."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        check_supported(cfg)
        dtype = dtype_of(cfg.dtype)
        d = cfg.d_model
        self.embed = param((cfg.vocab, d), dtype, device)
        self.final_norm = param((d,), dtype, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else param((d, cfg.vocab), dtype, device))
        if cfg.family == "hybrid":
            self.groups = nn.ModuleList(
                ZambaGroup(cfg, dtype, device)
                for _ in range(_hybrid_groups(cfg)))
            self.shared = DecoderLayer(cfg, dtype, device)
        else:
            layer = SSMLayer if cfg.family == "ssm" else DecoderLayer
            self.layers = nn.ModuleList(layer(cfg, dtype, device)
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
    if cfg.family == "dense":
        for layer in model.layers:
            _init_decoder_layer(gen, layer)
    elif cfg.family == "ssm":
        for layer in model.layers:
            _init_ssm_layer(gen, layer)
    else:
        for group in model.groups:
            for layer in group.ssm:
                _init_ssm_layer(gen, layer)
            dense_init(gen, group.lora.q_a)
            group.lora.q_b.zero_()
            dense_init(gen, group.lora.in_a)
            group.lora.in_b.zero_()
        _init_decoder_layer(gen, model.shared)
    return model


def _init_decoder_layer(gen: torch.Generator, layer: DecoderLayer) -> None:
    layer.norm1.zero_()
    layer.norm2.zero_()
    init_attention(gen, layer.attn)
    init_mlp(gen, layer.mlp)


def _init_ssm_layer(gen: torch.Generator, layer: SSMLayer) -> None:
    layer.norm.zero_()
    init_ssm(gen, layer.ssm)


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


def _ssm_layer(p: SSMLayer, h: torch.Tensor, cfg: ArchConfig,
               state: Optional[SSMState] = None):
    y, new_state = ssm_block(p.ssm, rms_norm(p.norm, h, cfg.norm_eps), cfg,
                             state=state)
    return h + y, new_state


def _lora_apply(shared: DecoderLayer, lora: LoRA) -> SimpleNamespace:
    """The shared block's weights with one group's LoRA deltas, built
    anew on every call as in ``repro/models/lm.py:_lora_apply``."""
    a, m = shared.attn, shared.mlp
    return SimpleNamespace(
        norm1=shared.norm1, norm2=shared.norm2,
        attn=SimpleNamespace(wq=a.wq + lora.q_a @ lora.q_b, wk=a.wk,
                             wv=a.wv, wo=a.wo),
        mlp=SimpleNamespace(w_in=m.w_in + lora.in_a @ lora.in_b,
                            w_out=m.w_out, w_gate=m.w_gate))


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
    if cfg.family == "hybrid":
        h0 = h      # the step's own embeddings feed every shared block
        for group in model.groups:
            for layer in group.ssm:
                h, _ = _ssm_layer(layer, h, cfg)
            # the shared block sees h + h0 and its output replaces h
            h, _ = _decoder_layer(_lora_apply(model.shared, group.lora),
                                  h + h0, cfg, positions)
    elif cfg.family == "ssm":
        for layer in model.layers:
            h, _ = _ssm_layer(layer, h, cfg)
    else:
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
    """Zero decode caches in the model dtype.  dense: {"kv": {"k", "v"}},
    each (L, B, Hkv, max_len, hd); ssm: {"ssm": SSMState} stacked over
    (L,); hybrid: {"ssm": SSMState} stacked over (G, R) and the shared
    block's {"shared": {"k", "v"}}, each (G, B, Hkv, max_len, hd)."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)

    def kv(n):
        shape = (n, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    if cfg.family == "ssm":
        return {"ssm": init_ssm_state(cfg, batch, dtype, device,
                                      lead=(cfg.n_layers,))}
    if cfg.family == "hybrid":
        G = _hybrid_groups(cfg)
        return {"ssm": init_ssm_state(cfg, batch, dtype, device,
                                      lead=(G, cfg.shared_attn_every)),
                "shared": kv(G)}
    return {"kv": kv(cfg.n_layers)}


def _ssm_decode(p: SSMLayer, h: torch.Tensor, cfg: ArchConfig,
                st: SSMState) -> torch.Tensor:
    """One decode step of one SSM layer; `st` holds views into the cache,
    which are overwritten with the new state."""
    h, new = _ssm_layer(p, h, cfg, state=st)
    st.conv.copy_(new.conv)
    st.ssd.copy_(new.ssd)
    return h


def decode_step(cfg: ArchConfig, model: LM, cache: Dict, token, pos: int):
    """token (B,) int; pos an int.  Returns (logits (B, V), cache); the
    cache is updated in place and returned."""
    pos = int(pos)
    token = _as_tokens(token, model.device)
    B = token.shape[0]
    h = embed(model.embed, token[:, None])
    positions = torch.full((B, 1), pos, dtype=torch.long, device=h.device)
    if cfg.family == "hybrid":
        st, ks, vs = cache["ssm"], cache["shared"]["k"], cache["shared"]["v"]
        h0 = h
        for g, group in enumerate(model.groups):
            for r, layer in enumerate(group.ssm):
                h = _ssm_decode(layer, h, cfg,
                                SSMState(st.conv[g, r], st.ssd[g, r]))
            h, _ = _decoder_layer(_lora_apply(model.shared, group.lora),
                                  h + h0, cfg, positions,
                                  kv_cache=(ks[g], vs[g]), cache_pos=pos)
    elif cfg.family == "ssm":
        st = cache["ssm"]
        for i, layer in enumerate(model.layers):
            h = _ssm_decode(layer, h, cfg, SSMState(st.conv[i], st.ssd[i]))
    else:
        ks, vs = cache["kv"]["k"], cache["kv"]["v"]
        for i, layer in enumerate(model.layers):
            h, _ = _decoder_layer(layer, h, cfg, positions,
                                  kv_cache=(ks[i], vs[i]), cache_pos=pos)
    h = rms_norm(model.final_norm, h, cfg.norm_eps)
    return lm_logits(model.head, h)[:, 0], cache
