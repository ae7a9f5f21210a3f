"""Language-model stack of the port.

Counterpart of the backbones of ``repro/models/lm.py``: ``decoder``
(dense, MoE, MLA, and the vision-language model qwen2-vl: M-RoPE and
vision tokens written over the first prompt positions), ``grouped``
(gemma3), ``ssm`` (mamba2), ``hybrid`` (zamba2) and the encoder-decoder
(whisper: a bidirectional encoder over the audio frames, decoder layers
with cross-attention to it):

    init_params(cfg, seed, device)          -> LM module
    forward(cfg, model, batch)              -> logits (B, S, V)
    prefill(cfg, model, batch)              -> last-position logits (B, V)
    init_cache(cfg, batch, max_len, device) -> decode caches (see there)
    decode_step(cfg, model, cache, tok, pos, aux=None)
                                            -> (logits (B, V), cache)
    encode_audio(cfg, model, audio_embed)   -> encoder states (B, Se, d)
    cross_kv(cfg, model, enc)               -> per-layer cross K/V
    loss_fn(cfg, model, batch)              -> next-token CE (training),
                                               plus deepseek-v3's
                                               multi-token prediction

`batch` holds "tokens" (B, S) and, for whisper, "audio_embed"
(B, n_audio_frames, d) or, for qwen2-vl, optionally "vision_embed"
(B, Nv, d) with Nv <= S.  `aux` carries what a decode step needs beside
the cache: whisper's {"enc_states", "cross_kv"}, qwen2-vl's
{"vision_embed"}.  The JAX package scans over layer-stacked parameters;
here the layers are ``ModuleList``s walked by Python loops, run eagerly,
and the caches are updated in place.  deepseek-v3's
multi-token-prediction block (``MTP``) serves only the training loss:
it is built for training (``init_params(..., mtp=True)``) and when a
reference tree carries it, and serving leaves it out.

Under a mesh (``models.sharding``) each rank holds its shards of the
parameters (``sharding.shard_params``) and its rows of the batch; every
attention (GQA, MLA, gemma3's windows, whisper's encoder and
cross-attention, zamba2's shared block with its LoRA), the SSD block,
the MLP and MoE run in the depth format, on this rank's heads, columns
or experts; the embedding and the LM head take their weights in full.
The decode caches hold this rank's rows and, over `model`, what
``registry.cache_specs`` splits there (``init_cache``).
"""
from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.kernels import ops
from .attention import (MLA, Attention, _attention_tp, _expand_kv,
                        _kv_index, _mask_padded, attention, decode_windowed,
                        init_attention, init_mla, mla_attention)
from . import sharding
from .config import ArchConfig
from .layers import (MLP, cross_entropy, dense_init, dtype_of, embed,
                     embed_init, fused_ce, init_mlp, lm_logits, mlp, param,
                     recomputing, rms_norm)
from .moe import MoE, init_moe, moe
from .ssm import SSM, SSMState, init_ssm, init_ssm_state, ssm_block

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for a family the port does not know."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is "
                                  f"not one of the port's {FAMILIES}")


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


class EncDecLayer(DecoderLayer):
    """A whisper decoder layer: a DecoderLayer plus the cross-attention
    `xattn` and its pre-norm `norm3` (d,)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__(cfg, dtype, device)
        self.xattn = Attention(cfg, dtype, device)
        self.norm3 = param((cfg.d_model,), dtype, device)


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


class MTP(nn.Module):
    """deepseek-v3's multi-token-prediction block: proj (2d, d), one
    decoder `layer` (MoE when the config has experts) and `norm` (d,)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        d = cfg.d_model
        self.proj = param((2 * d, d), dtype, device)
        self.layer = DecoderLayer(cfg, dtype, device,
                                  use_moe=bool(cfg.n_experts))
        self.norm = param((d,), dtype, device)


class LM(nn.Module):
    """embed (V, d), final_norm (d,), lm_head (d, V) unless tied, and by
    family:
      * decoder (dense, MoE, MLA): `dense_layers` (the dense prefix of an
        MoE stack; empty otherwise), then `layers` (MoE layers when the
        config has experts);
      * grouped (gemma3): `groups` (GemmaGroups), then the windowed
        `tail` layers;
      * ssm: `layers` (SSMLayers);
      * hybrid: `groups` (ZambaGroups) and the `shared` DecoderLayer;
      * enc_dec (whisper): `enc_pos` (n_audio_frames, d), `enc_layers`
        (DecoderLayers, bidirectional), `enc_norm` (d,) and `dec_layers`
        (EncDecLayers);
    and, with `mtp` and ``cfg.mtp``, the ``MTP`` block `mtp`, last.
    Parameters uninitialised."""

    def __init__(self, cfg: ArchConfig, device, mtp: bool = False):
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
        elif cfg.enc_dec:
            self.enc_pos = param((cfg.n_audio_frames, d), dtype, device)
            self.enc_layers = stack(cfg.n_enc_layers)
            self.enc_norm = param((d,), dtype, device)
            self.dec_layers = nn.ModuleList(EncDecLayer(cfg, dtype, device)
                                            for _ in range(cfg.n_layers))
        else:
            n_dense, n_moe = _moe_flags(cfg)
            self.dense_layers = stack(n_dense if n_moe else 0)
            self.layers = stack(n_moe or n_dense, bool(n_moe))
        self.mtp = (MTP(cfg, dtype, device) if mtp and cfg.mtp else None)

    @property
    def head(self) -> torch.Tensor:
        return self.lm_head if self.lm_head is not None else self.embed

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, device=None,
                mtp: bool = False) -> LM:
    """Random weights drawn on `device` from a generator seeded with
    `seed` (the same distributions as the JAX package, other numbers);
    norms start at zero as there.  With `mtp` a config's
    multi-token-prediction block is built too, drawn after every other
    weight (so the others do not depend on it)."""
    device = resolve_device(device)
    model = LM(cfg, device, mtp=mtp)
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
        if cfg.enc_dec:
            embed_init(gen, model.enc_pos)
            model.enc_norm.zero_()
        for layer in model.modules():
            if isinstance(layer, DecoderLayer) and (
                    model.mtp is None or layer is not model.mtp.layer):
                _init_decoder_layer(gen, layer)
    if model.mtp is not None:
        dense_init(gen, model.mtp.proj)
        _init_decoder_layer(gen, model.mtp.layer)
        model.mtp.norm.zero_()
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
    if isinstance(layer, EncDecLayer):
        init_attention(gen, layer.xattn)
        layer.norm3.zero_()


def _init_ssm_layer(gen: torch.Generator, layer: SSMLayer) -> None:
    layer.norm.zero_()
    init_ssm(gen, layer.ssm)


# ==========================================================================
# Forward
# ==========================================================================


def _decoder_layer(p: DecoderLayer, h: torch.Tensor, cfg: ArchConfig,
                   positions: torch.Tensor, window: Optional[int] = None,
                   mrope_positions: Optional[torch.Tensor] = None,
                   kv_cache=None, cache_pos=None):
    """Pre-norm attention then pre-norm MLP or MoE.  `window` and
    `mrope_positions` reach the GQA attention (window None: the arch
    default; 0: full)."""
    hn = rms_norm(p.norm1, h, cfg.norm_eps)
    if isinstance(p.attn, MLA):
        a, new_cache = mla_attention(p.attn, hn, cfg,
                                     positions, kv_cache=kv_cache,
                                     cache_pos=cache_pos)
    else:
        a, new_cache = attention(p.attn, hn, cfg, positions, window=window,
                                 mrope_positions=mrope_positions,
                                 kv_cache=kv_cache, cache_pos=cache_pos)
    h = h + a
    hn = rms_norm(p.norm2, h, cfg.norm_eps)
    h = _residual_shard(h, cfg)
    return h + _feed_forward(p, hn, cfg), new_cache


def _residual_shard(h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The reference's residual-stream constraint between blocks:
    sequence-sharded over `model` with ``cfg.seq_parallel`` (when the
    sequence divides the axis), else replicated over it.  Through
    ``sharding.maybe_shard``: a DTensor is redistributed; the per-rank
    program's plain tensors keep their layout (replicated over
    `model`)."""
    nm = sharding.mesh_axis_size("model")
    if cfg.seq_parallel and h.dim() == 3 and nm > 1 \
            and h.shape[1] % nm == 0:
        return sharding.maybe_shard(h, "data", "model", None)
    return sharding.maybe_shard(h, "data", None, None)


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
    anew on every call as in ``repro/models/lm.py:_lora_apply``.  Under a
    `model` axis, this rank's columns of wq and w_in plus the deltas'
    same columns (the replicated LoRA factors cut by columns), marked as
    this rank's shards (``sharding.as_shard``)."""
    a, m = shared.attn, shared.mlp

    def plus(w, fa, fb):
        return sharding.as_shard(
            sharding.local(w, 1)
            + sharding.replicated(fa) @ sharding.local(fb, 1), 1)
    return SimpleNamespace(
        norm1=shared.norm1, norm2=shared.norm2,
        attn=SimpleNamespace(wq=plus(a.wq, lora.q_a, lora.q_b), wk=a.wk,
                             wv=a.wv, wo=a.wo),
        mlp=SimpleNamespace(w_in=plus(m.w_in, lora.in_a, lora.in_b),
                            w_out=m.w_out, w_gate=m.w_gate))


def _as_tensor(x, device) -> torch.Tensor:
    """A numpy array or a tensor as a tensor on `device`, its dtype kept."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def _as_tokens(x, device) -> torch.Tensor:
    return _as_tensor(x, device).long()


def _embed_inputs(cfg: ArchConfig, model: LM, batch: Dict) -> torch.Tensor:
    """Token embeddings (B, S, d); for the vlm, `vision_embed` (B, Nv, d),
    cast to the model dtype, written over positions 0 .. Nv-1 (as the
    reference's dynamic_update_slice, which refuses Nv > S)."""
    h = embed(sharding.full(model.embed),
              _as_tokens(batch["tokens"], model.device))
    if cfg.family == "vlm" and batch.get("vision_embed") is not None:
        ve = _as_tensor(batch["vision_embed"], h.device)
        if ve.dim() != 3 or ve.shape[0] != h.shape[0] or \
                ve.shape[1] > h.shape[1] or ve.shape[2] != h.shape[2]:
            raise ValueError(f"vision_embed {tuple(ve.shape)} does not fit "
                             f"the token embeddings {tuple(h.shape)}: it "
                             f"takes (B, Nv <= S, d)")
        h[:, :ve.shape[1]] = ve.to(h.dtype)
    return h


def _mrope_pos(cfg: ArchConfig, positions: torch.Tensor
               ) -> Optional[torch.Tensor]:
    """The (3, B, S) M-RoPE positions: `positions` on all three axes."""
    if not cfg.mrope:
        return None
    return positions[None].expand(3, *positions.shape)


def _maybe_remat(fn, cfg: ArchConfig):
    """`fn` under activation checkpointing when ``cfg.remat`` is set and
    grad mode is on (the counterpart of ``jax.checkpoint`` around each
    scanned layer, ``repro/models/lm.py:254``): the layer keeps only its
    input, and its forward, K2 and K4 included, runs again in the
    backward, inside ``layers.recomputing()``.  Serving (no grad) runs
    `fn` as it is."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn

    def remat(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_remat_contexts, **kwargs)
    return remat


def _remat_contexts():
    return contextlib.nullcontext(), recomputing()


def forward_hidden(cfg: ArchConfig, model: LM, batch: Dict
                   ) -> torch.Tensor:
    """Full-sequence forward -> final-norm hidden states (B, S, d)."""
    h = _embed_inputs(cfg, model, batch)
    h = sharding.maybe_shard(h, ("pod", "data"), None, None)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    if cfg.family == "hybrid":
        h0 = h      # the step's own embeddings feed every shared block
        ssm_fn = _maybe_remat(_ssm_layer, cfg)
        for group in model.groups:
            for layer in group.ssm:
                h, _ = ssm_fn(layer, h, cfg)
            # the shared block sees h + h0 and its output replaces h; it
            # runs outside remat, as the reference's group_body
            h, _ = _decoder_layer(_lora_apply(model.shared, group.lora),
                                  h + h0, cfg, positions)
    elif cfg.family == "ssm":
        ssm_fn = _maybe_remat(_ssm_layer, cfg)
        for layer in model.layers:
            h, _ = ssm_fn(layer, h, cfg)
    elif cfg.local_global_ratio:
        W = cfg.sliding_window
        layer_fn = _maybe_remat(_decoder_layer, cfg)
        for group in model.groups:
            for layer in group.local:
                h, _ = layer_fn(layer, h, cfg, positions, window=W)
            h, _ = layer_fn(group.global_, h, cfg, positions, window=0)
        for layer in model.tail:
            h, _ = layer_fn(layer, h, cfg, positions, window=W)
    elif cfg.enc_dec:
        xkv = cross_kv(cfg, model,
                       encode_audio(cfg, model, batch["audio_embed"]))
        layer_fn = _maybe_remat(_encdec_layer, cfg)
        for i, layer in enumerate(model.dec_layers):
            h, _ = layer_fn(layer, h, cfg, positions,
                            (xkv["k"][i], xkv["v"][i]))
    else:
        mropep = _mrope_pos(cfg, positions)
        layer_fn = _maybe_remat(_decoder_layer, cfg)
        for layer in (*model.dense_layers, *model.layers):
            h, _ = layer_fn(layer, h, cfg, positions, mrope_positions=mropep)
    return rms_norm(model.final_norm, h, cfg.norm_eps)


def forward(cfg: ArchConfig, model: LM, batch: Dict) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V)."""
    logits = lm_logits(sharding.full(model.head),
                       forward_hidden(cfg, model, batch))
    return sharding.maybe_shard(logits, ("pod", "data"), None, "model")


def prefill(cfg: ArchConfig, model: LM, batch: Dict) -> torch.Tensor:
    """Prompt processing: full-sequence forward returning last-position
    logits (B, V)."""
    return forward(cfg, model, batch)[:, -1]


# ==========================================================================
# Loss
# ==========================================================================


def _head_matrix(cfg: ArchConfig, model: LM) -> torch.Tensor:
    """The LM head as (d, V): `lm_head`, or the tied embedding's
    transpose (a view)."""
    head = sharding.full(model.head)
    return head if head.shape[0] == cfg.d_model else head.T


def loss_fn(cfg: ArchConfig, model: LM, batch: Dict) -> torch.Tensor:
    """Next-token cross-entropy of the full-sequence forward (float32
    0-d), the counterpart of ``repro/models/lm.py:loss_fn``: the chunked
    ``fused_ce`` when ``cfg.fused_ce_loss``, else ``cross_entropy`` of
    the logits; plus ``0.3 * _mtp_loss`` when the config and the model
    have the multi-token-prediction block."""
    labels = _as_tokens(batch["labels"], model.device)
    if cfg.fused_ce_loss:
        h = forward_hidden(cfg, model, batch)
        loss = fused_ce(h[:, :-1], _head_matrix(cfg, model), labels[:, 1:],
                        cfg.ce_chunk)
    else:
        loss = cross_entropy(forward(cfg, model, batch)[:, :-1],
                             labels[:, 1:])
    if cfg.mtp and model.mtp is not None:
        loss = loss + 0.3 * _mtp_loss(cfg, model, batch)
    return loss


def _mtp_loss(cfg: ArchConfig, model: LM, batch: Dict) -> torch.Tensor:
    """deepseek-v3's multi-token prediction: one extra decoder layer
    predicts token t+2 from [h_t ; emb(tok_{t+1})] (the embeddings of
    the token and of the next one, the last position wrapping round as
    the reference's roll), through the shared LM head."""
    tokens = _as_tokens(batch["tokens"], model.device)
    labels = _as_tokens(batch["labels"], model.device)
    B, S = tokens.shape
    table = sharding.full(model.embed)
    h = embed(table, tokens)
    nxt = embed(table, torch.roll(tokens, -1, dims=1))
    mtp = model.mtp
    hh = torch.cat([h, nxt], dim=-1) @ sharding.full(mtp.proj)
    positions = torch.arange(S, device=hh.device)[None].expand(B, S)
    hh, _ = _maybe_remat(_decoder_layer, cfg)(mtp.layer, hh, cfg, positions)
    hh = rms_norm(mtp.norm, hh, cfg.norm_eps)
    if cfg.fused_ce_loss:
        return fused_ce(hh[:, :-2], _head_matrix(cfg, model), labels[:, 2:],
                        cfg.ce_chunk)
    lg = lm_logits(sharding.full(model.head), hh)
    return cross_entropy(lg[:, :-2], labels[:, 2:])


# ==========================================================================
# The encoder-decoder (whisper)
# ==========================================================================


def _bidir_attention(p: Attention, x: torch.Tensor, cfg: ArchConfig
                     ) -> torch.Tensor:
    """The encoder's self-attention: no rotation, not causal (K2 at
    S = Sk), kv expanded to the padded query heads; on this rank's heads
    under a `model` axis."""
    if sharding.model_parallel():
        return _attention_tp(p, x, cfg, None, 0, None, causal=False)
    B, S, _ = x.shape
    H, Hkv, hd, Hp = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.padded_heads
    q = (x @ p.wq).reshape(B, S, Hp, hd)
    k = (x @ p.wk).reshape(B, S, Hkv, hd)
    v = (x @ p.wv).reshape(B, S, Hkv, hd)
    if Hp != H:
        k = _expand_kv(k, H, Hkv, Hp)
        v = _expand_kv(v, H, Hkv, Hp)
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=False,
                            block_k=cfg.attn_block_k)
    o = o.transpose(1, 2).reshape(B, S, Hp * hd)
    return _mask_padded(o, H, Hp, hd) @ p.wo


def _cross_attention(p: Attention, x: torch.Tensor,
                     kv: Tuple[torch.Tensor, torch.Tensor], cfg: ArchConfig
                     ) -> torch.Tensor:
    """x (B, S, d) attends to the encoder states' keys and values `kv`,
    each (B, Hkv, Se, hd) (``cross_kv``), not causal: K2 at Sq = S against
    Sk = Se keys.  They are expanded to the padded query heads in every
    call, as the reference does (here along the head axis of their
    layout, which gives K2 contiguous operands).  Under a `model` axis,
    this rank's query heads against the kv heads they read."""
    if sharding.model_parallel():
        return _attention_tp(p, x, cfg, None, 0, None, causal=False, kv=kv)
    B, S, _ = x.shape
    H, Hkv, hd, Hp = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.padded_heads
    q = (x @ p.wq).reshape(B, S, Hp, hd).transpose(1, 2)
    k, v = kv
    if Hp != H:
        idx = _kv_index(H, Hkv, Hp, k.device)
        k, v = k.index_select(1, idx), v.index_select(1, idx)
    o = ops.flash_attention(q, k, v, causal=False, block_k=cfg.attn_block_k)
    o = o.transpose(1, 2).reshape(B, S, Hp * hd)
    return _mask_padded(o, H, Hp, hd) @ p.wo


def _encdec_layer(p: EncDecLayer, h: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor, xkv, kv_cache=None,
                  cache_pos=None):
    """A decoder layer: causal self-attention, then norm3 and the
    cross-attention to this layer's encoder keys and values `xkv`, then
    the MLP."""
    a, new_cache = attention(p.attn, rms_norm(p.norm1, h, cfg.norm_eps),
                             cfg, positions, kv_cache=kv_cache,
                             cache_pos=cache_pos)
    h = h + a
    h = h + _cross_attention(p.xattn,
                             rms_norm(p.norm3, h, cfg.norm_eps), xkv, cfg)
    return h + _feed_forward(p, rms_norm(p.norm2, h, cfg.norm_eps),
                             cfg), new_cache


def _enc_layer(p: DecoderLayer, x: torch.Tensor, cfg: ArchConfig
               ) -> torch.Tensor:
    """An encoder layer: bidirectional self-attention, then the MLP."""
    x = x + _bidir_attention(p.attn,
                             rms_norm(p.norm1, x, cfg.norm_eps), cfg)
    return x + _feed_forward(p, rms_norm(p.norm2, x, cfg.norm_eps), cfg)


def encode_audio(cfg: ArchConfig, model: LM, audio_embed) -> torch.Tensor:
    """The whisper encoder alone: audio_embed (B, n_audio_frames, d), cast
    to the model dtype, plus `enc_pos`, through the bidirectional layers
    (each under remat in training, as the reference's ``enc_body``) and
    `enc_norm` -> encoder states (B, Se, d).  Differentiable: serving
    calls it under ``torch.no_grad()`` (``launch.serve.decode_aux``)."""
    x = _as_tensor(audio_embed, model.device).to(model.enc_pos.dtype)
    x = x + model.enc_pos
    layer_fn = _maybe_remat(_enc_layer, cfg)
    for layer in model.enc_layers:
        x = layer_fn(layer, x, cfg)
    return rms_norm(model.enc_norm, x, cfg.norm_eps)


def cross_kv(cfg: ArchConfig, model: LM, enc: torch.Tensor) -> Dict:
    """Each decoder layer's cross-attention keys and values from the
    encoder states: {"k", "v"}, each (L, B, Hkv, Se, hd).  Serving calls
    it once a request, under ``torch.no_grad()``; the training forward
    calls it once a step, outside the layers' remat."""
    B, Se, _ = enc.shape
    Hkv, hd = cfg.n_kv_heads, cfg.head_dim

    def heads(w):       # from this rank's columns under a `model` axis
        return sharding.columns_gathered(enc, w).reshape(
            B, Se, Hkv, hd).transpose(1, 2)
    return {"k": torch.stack([heads(l.xattn.wk) for l in model.dec_layers]),
            "v": torch.stack([heads(l.xattn.wv) for l in model.dec_layers])}


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
        block's {"shared"} over (G,);
      * enc_dec: the decoder's {"self"} over (L,) and "cross": None (the
        cross K/V travel in decode_step's `aux`).
    Under a mesh `batch` is the global batch, and each rank holds its
    part of every cache by ``registry.cache_specs`` at the active mesh's
    sizes: its batch / n_data rows; over `model`, its kv heads where
    they divide the axis, else its max_len / n_model positions (decode
    then runs ``attention._decode_seq_sharded``); its SSD heads and its
    part of the conv channels; the MLA latent whole.  Raises where a
    cache does not split so (a gemma3 ring splits only by kv heads)."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    nd, nm = sharding.mesh_axis_size("data"), \
        sharding.mesh_axis_size("model")
    if nd * nm == 1:
        return _cache_tree(cfg, batch, max_len, dtype, device)
    from .registry import cache_specs
    full = _cache_tree(cfg, batch, max_len, dtype, "meta")
    sizes = {"data": nd, "model": nm, "pod": 1}
    specs = cache_specs(cfg, full, "decode_32k", n_model=nm,
                        axis_sizes=sizes)

    def local(path, leaf):
        spec = _lookup_spec(specs, path)
        names = [n for s in spec for n in (s if isinstance(s, tuple)
                                           else (s,)) if n]
        ring = path[0] in ("local", "tail")
        kv = path[-1] in ("k", "v")
        if ("data" not in names) or (kv and "model" not in names) or (
                ring and spec[-2] is not None):
            raise ValueError(
                f"{cfg.name}: the cache {'/'.join(map(str, path))} "
                f"{tuple(leaf.shape)} does not split over a {nd} x {nm} "
                f"mesh (spec {spec})")
        shape = [dim // (sizes[s] if s else 1)
                 for dim, s in zip(leaf.shape, spec)]
        return torch.zeros(shape, dtype=dtype, device=device)
    return sharding.map_with_path(local, full)


def _lookup_spec(specs, path):
    for k in path:
        specs = getattr(specs, k) if hasattr(specs, "_fields") else specs[k]
    return specs


def _cache_tree(cfg: ArchConfig, batch: int, max_len: int,
                dtype: torch.dtype, device) -> Dict:
    """``init_cache``'s tree in full, on `device` (the meta device for
    its shapes)."""
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
    if cfg.enc_dec:
        return {"self": kv((cfg.n_layers,), max_len), "cross": None}
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


def decode_step(cfg: ArchConfig, model: LM, cache: Dict, token, pos: int,
                aux: Optional[Dict] = None):
    """token (B,) int; pos an int.  Returns (logits (B, V), cache); the
    cache is updated in place and returned.  `aux`: whisper needs
    {"cross_kv": cross_kv(...)} (its "enc_states" are not read here); for
    the vlm, {"vision_embed": (B, Nv, d)} replaces the token's embedding
    with the vision embedding at `pos` while pos < Nv."""
    pos = int(pos)
    token = _as_tokens(token, model.device)
    B = token.shape[0]
    h = embed(sharding.full(model.embed), token[:, None])
    if cfg.family == "vlm" and aux is not None and "vision_embed" in aux:
        ve = aux["vision_embed"]                    # (B, Nv, d)
        if pos < ve.shape[1]:
            h = _as_tensor(ve[:, pos:pos + 1], h.device).to(h.dtype)
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
    elif cfg.enc_dec:
        if aux is None or aux.get("cross_kv") is None:
            raise ValueError(f"{cfg.name}: decode_step needs aux = "
                             f"{{'cross_kv': lm.cross_kv(...)}}")
        ks, vs = cache["self"]["k"], cache["self"]["v"]
        xk, xv = aux["cross_kv"]["k"], aux["cross_kv"]["v"]
        for i, layer in enumerate(model.dec_layers):
            h, _ = _encdec_layer(layer, h, cfg, positions, (xk[i], xv[i]),
                                 kv_cache=(ks[i], vs[i]), cache_pos=pos)
    else:
        for layer, layer_cache in zip((*model.dense_layers, *model.layers),
                                      _decoder_caches(cfg, cache)):
            h, _ = _decoder_layer(layer, h, cfg, positions,
                                  kv_cache=layer_cache, cache_pos=pos)
    h = rms_norm(model.final_norm, h, cfg.norm_eps)
    return lm_logits(sharding.full(model.head), h)[:, 0], cache
