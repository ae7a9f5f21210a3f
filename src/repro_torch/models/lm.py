"""Language-model stack of the port: the decoder-only families.

Counterpart of the ``decoder`` (dense, MoE, MLA), ``grouped`` (gemma3),
``ssm`` (mamba2) and ``hybrid`` (zamba2) backbones of
``repro/models/lm.py``:

    init_params(cfg, seed, device)          -> LM module
    forward(cfg, model, batch)              -> logits (B, S, V)
    prefill(cfg, model, batch)              -> last-position logits (B, V)
    init_cache(cfg, batch, max_len, device) -> decode caches (see there)
    decode_step(cfg, model, cache, tok, pos) -> (logits (B, V), cache)

The JAX package scans over layer-stacked parameters; here the layers are
``ModuleList``s walked by Python loops, run eagerly, and the caches are
updated in place.  deepseek-v3's multi-token-prediction block serves
only the training loss and is not built.  The encoder-decoder (whisper)
and the vision-language model (qwen2-vl) raise ``NotImplementedError``
naming their ``ROADMAP.md`` item.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from .attention import (MLA, Attention, attention, decode_windowed,
                        init_attention, init_mla, mla_attention)
from .config import ArchConfig
from .layers import (MLP, dense_init, dtype_of, embed, embed_init,
                     init_mlp, lm_logits, mlp, param, rms_norm)
from .moe import MoE, init_moe, moe
from .ssm import SSM, SSMState, init_ssm, init_ssm_state, ssm_block

_TODO = "not ported yet (ROADMAP.md, 'Modules still to port', item {})"


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for the families the port leaves out."""
    if cfg.enc_dec or cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: the whisper encoder-decoder is " + _TODO.format(4))
    if cfg.family == "vlm" or cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name}: qwen2-vl (M-RoPE, vision tokens) is "
            + _TODO.format(4))
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is "
                                  "not ported (ROADMAP.md)")


# ==========================================================================
# Modules and init
# ==========================================================================


class DecoderLayer(nn.Module):
    """norm1, norm2 (d,); `attn` (GQA, or MLA when ``cfg.mla``) and either
    `mlp` or, in an MoE layer, `moe`."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device,
                 use_moe: bool = False):
        super().__init__()
        self.norm1 = param((cfg.d_model,), dtype, device)
        self.norm2 = param((cfg.d_model,), dtype, device)
        self.attn = (MLA if cfg.mla else Attention)(cfg, dtype, device)
        if use_moe:
            self.moe = MoE(cfg, dtype, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device,
                           gated=cfg.gated_mlp)


class GemmaGroup(nn.Module):
    """gemma3's group: `local_global_ratio` windowed layers, then one
    layer of full attention (`global_`)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        self.local = nn.ModuleList(DecoderLayer(cfg, dtype, device)
                                   for _ in range(cfg.local_global_ratio))
        self.global_ = DecoderLayer(cfg, dtype, device)


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


def _moe_flags(cfg: ArchConfig) -> Tuple[int, int]:
    """(dense prefix layers, MoE layers), as ``repro/models/lm.py``."""
    if not cfg.n_experts:
        return cfg.n_layers, 0
    return cfg.moe_layer_start, cfg.n_layers - cfg.moe_layer_start


def _grouped_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    """gemma3: (groups, local layers a group, local layers of the tail)."""
    R = cfg.local_global_ratio
    G = cfg.n_layers // (R + 1)
    return G, R, cfg.n_layers - G * (R + 1)


class LM(nn.Module):
    """embed (V, d), final_norm (d,), lm_head (d, V) unless tied, and by
    family:
      * decoder (dense, MoE, MLA): `dense_layers` (the dense prefix of an
        MoE stack; empty otherwise), then `layers` (MoE layers when the
        config has experts);
      * grouped (gemma3): `groups` (GemmaGroups), then the windowed
        `tail` layers;
      * ssm: `layers` (SSMLayers);
      * hybrid: `groups` (ZambaGroups) and the `shared` DecoderLayer.
    Parameters uninitialised."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        check_supported(cfg)
        dtype = dtype_of(cfg.dtype)
        d = cfg.d_model
        self.embed = param((cfg.vocab, d), dtype, device)
        self.final_norm = param((d,), dtype, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else param((d, cfg.vocab), dtype, device))

        def stack(n, *args):
            return nn.ModuleList(DecoderLayer(cfg, dtype, device, *args)
                                 for _ in range(n))

        if cfg.family == "hybrid":
            self.groups = nn.ModuleList(
                ZambaGroup(cfg, dtype, device)
                for _ in range(_hybrid_groups(cfg)))
            self.shared = DecoderLayer(cfg, dtype, device)
        elif cfg.family == "ssm":
            self.layers = nn.ModuleList(SSMLayer(cfg, dtype, device)
                                        for _ in range(cfg.n_layers))
        elif cfg.local_global_ratio:
            G, _, tail = _grouped_dims(cfg)
            self.groups = nn.ModuleList(GemmaGroup(cfg, dtype, device)
                                        for _ in range(G))
            self.tail = stack(tail)
        else:
            n_dense, n_moe = _moe_flags(cfg)
            self.dense_layers = stack(n_dense if n_moe else 0)
            self.layers = stack(n_moe or n_dense, bool(n_moe))

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
    if cfg.family == "ssm":
        for layer in model.layers:
            _init_ssm_layer(gen, layer)
    elif cfg.family == "hybrid":
        for group in model.groups:
            for layer in group.ssm:
                _init_ssm_layer(gen, layer)
            dense_init(gen, group.lora.q_a)
            group.lora.q_b.zero_()
            dense_init(gen, group.lora.in_a)
            group.lora.in_b.zero_()
        _init_decoder_layer(gen, model.shared)
    else:
        for layer in model.modules():
            if isinstance(layer, DecoderLayer):
                _init_decoder_layer(gen, layer)
    return model


def _init_decoder_layer(gen: torch.Generator, layer: DecoderLayer) -> None:
    layer.norm1.zero_()
    layer.norm2.zero_()
    (init_mla if isinstance(layer.attn, MLA) else init_attention)(
        gen, layer.attn)
    if hasattr(layer, "moe"):
        init_moe(gen, layer.moe)
    else:
        init_mlp(gen, layer.mlp)


def _init_ssm_layer(gen: torch.Generator, layer: SSMLayer) -> None:
    layer.norm.zero_()
    init_ssm(gen, layer.ssm)


# ==========================================================================
# Forward
# ==========================================================================


def _decoder_layer(p: DecoderLayer, h: torch.Tensor, cfg: ArchConfig,
                   positions: torch.Tensor, window: Optional[int] = None,
                   kv_cache=None, cache_pos=None):
    """Pre-norm attention then pre-norm MLP or MoE.  `window` reaches the
    GQA attention of the full mode (None: the arch default; 0: full)."""
    hn = rms_norm(p.norm1, h, cfg.norm_eps)
    if isinstance(p.attn, MLA):
        a, new_cache = mla_attention(p.attn, hn, cfg, positions,
                                     kv_cache=kv_cache, cache_pos=cache_pos)
    else:
        a, new_cache = attention(p.attn, hn, cfg, positions, window=window,
                                 kv_cache=kv_cache, cache_pos=cache_pos)
    h = h + a
    return h + _feed_forward(p, rms_norm(p.norm2, h, cfg.norm_eps),
                             cfg), new_cache


def _feed_forward(p: DecoderLayer, hn: torch.Tensor, cfg: ArchConfig
                  ) -> torch.Tensor:
    if hasattr(p, "moe"):
        return moe(p.moe, hn, cfg)
    return mlp(p.mlp, hn, act=cfg.act, gated=cfg.gated_mlp)


def _local_decode(p: DecoderLayer, h: torch.Tensor, cfg: ArchConfig,
                  kv_cache, pos: int) -> torch.Tensor:
    """One decode step of a gemma3 local layer against its ring cache
    (``local_body`` of ``repro/models/lm.py:_gemma_decode``)."""
    a, _ = decode_windowed(p.attn, rms_norm(p.norm1, h, cfg.norm_eps), cfg,
                           kv_cache, pos, cfg.sliding_window)
    h = h + a
    return h + _feed_forward(p, rms_norm(p.norm2, h, cfg.norm_eps), cfg)


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
    elif cfg.local_global_ratio:
        W = cfg.sliding_window
        for group in model.groups:
            for layer in group.local:
                h, _ = _decoder_layer(layer, h, cfg, positions, window=W)
            h, _ = _decoder_layer(group.global_, h, cfg, positions, window=0)
        for layer in model.tail:
            h, _ = _decoder_layer(layer, h, cfg, positions, window=W)
    else:
        for layer in (*model.dense_layers, *model.layers):
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
    """Zero decode caches in the model dtype, laid out as the JAX
    package's (a kv pair is {"k", "v"}, each (n, B, Hkv, S, hd)):
      * dense: {"kv"} over (L,); with an MoE stack, {"kv"} over its MoE
        layers and {"kv_dense"} over its dense prefix;
      * MLA: {"latent"} (n, B, max_len, kv_lora_rank + d_rope), and
        {"latent_dense"} likewise;
      * gemma3: {"local"} over (G, R) and {"tail"} over (tail,), rings of
        min(window, max_len) positions, and {"global"} over (G,);
      * ssm: {"ssm": SSMState} stacked over (L,);
      * hybrid: {"ssm": SSMState} stacked over (G, R) and the shared
        block's {"shared"} over (G,)."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv(lead, S):
        shape = (*lead, batch, cfg.n_kv_heads, S, cfg.head_dim)
        return {"k": zeros(*shape), "v": zeros(*shape)}

    if cfg.family == "ssm":
        return {"ssm": init_ssm_state(cfg, batch, dtype, device,
                                      lead=(cfg.n_layers,))}
    if cfg.family == "hybrid":
        G = _hybrid_groups(cfg)
        return {"ssm": init_ssm_state(cfg, batch, dtype, device,
                                      lead=(G, cfg.shared_attn_every)),
                "shared": kv((G,), max_len)}
    if cfg.local_global_ratio:
        G, R, tail = _grouped_dims(cfg)
        W = min(cfg.sliding_window, max_len)
        c = {"local": kv((G, R), W), "global": kv((G,), max_len)}
        if tail:
            c["tail"] = kv((tail,), W)
        return c
    n_dense, n_moe = _moe_flags(cfg)
    if cfg.mla:
        width = cfg.kv_lora_rank + cfg.d_rope
        c = {"latent": zeros(n_moe or n_dense, batch, max_len, width)}
        if n_dense and n_moe:
            c["latent_dense"] = zeros(n_dense, batch, max_len, width)
        return c
    c = {"kv": kv((n_moe or n_dense,), max_len)}
    if n_dense and n_moe:
        c["kv_dense"] = kv((n_dense,), max_len)
    return c


def _ssm_decode(p: SSMLayer, h: torch.Tensor, cfg: ArchConfig,
                st: SSMState) -> torch.Tensor:
    """One decode step of one SSM layer; `st` holds views into the cache,
    which are overwritten with the new state."""
    h, new = _ssm_layer(p, h, cfg, state=st)
    st.conv.copy_(new.conv)
    st.ssd.copy_(new.ssd)
    return h


def _decoder_caches(cfg: ArchConfig, cache: Dict):
    """Each decoder layer's cache, the dense prefix first: an MLA latent
    (B, max_len, width) or a (k, v) pair of (B, Hkv, max_len, hd)."""
    if cfg.mla:
        stacks = [cache.get("latent_dense", ()), cache["latent"]]
        return [lat for stack in stacks for lat in stack]
    stacks = [cache["kv_dense"]] if "kv_dense" in cache else []
    return [kv for st in stacks + [cache["kv"]]
            for kv in zip(st["k"], st["v"])]


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
    elif cfg.local_global_ratio:
        lk, lv = cache["local"]["k"], cache["local"]["v"]
        gk, gv = cache["global"]["k"], cache["global"]["v"]
        for g, group in enumerate(model.groups):
            for r, layer in enumerate(group.local):
                h = _local_decode(layer, h, cfg, (lk[g, r], lv[g, r]), pos)
            h, _ = _decoder_layer(group.global_, h, cfg, positions,
                                  kv_cache=(gk[g], gv[g]), cache_pos=pos)
        for i, layer in enumerate(model.tail):
            h = _local_decode(layer, h, cfg, (cache["tail"]["k"][i],
                                              cache["tail"]["v"][i]), pos)
    else:
        for layer, layer_cache in zip((*model.dense_layers, *model.layers),
                                      _decoder_caches(cfg, cache)):
            h, _ = _decoder_layer(layer, h, cfg, positions,
                                  kv_cache=layer_cache, cache_pos=pos)
    h = rms_norm(model.final_norm, h, cfg.norm_eps)
    return lm_logits(model.head, h)[:, 0], cache
