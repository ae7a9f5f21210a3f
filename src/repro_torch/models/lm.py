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
or experts.  Where the specs split the vocabulary over `model` (every
vocabulary that 16 divides), the embedding, the LM head, the logits and
the loss work on this rank's slice of it and no rank holds the whole
table: the lookup of ``sharding.vocab_lookup``, logits (..., V / n) as
the reference's out-specs lay them out (``gather_vocab`` makes whole
rows, ``greedy`` picks the token), ``layers.VocabParallelCE``.  With
``cfg.seq_parallel`` and a sequence that the axis divides, the residual
stream between decoder layers holds this rank's S / n positions
(``_decoder_layer``).  The decode caches hold this rank's rows and, over
`model`, what ``registry.cache_specs`` splits there (``init_cache``).
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
from .attention import (MLA, Attention, SeqOverData, _attention_tp,
                        _expand_kv, _kv_index, _mask_padded, attention,
                        decode_windowed, init_attention, init_mla,
                        mla_attention)
from . import sharding
from .config import ArchConfig
from .layers import (MLP, cross_entropy, dense_init, dtype_of, embed,
                     embed_init, fused_ce, init_mlp, mlp, param,
                     recomputing, rms_norm, vocab_cross_entropy)
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
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, device=None,
                mtp: bool = False) -> LM:
    """Random weights drawn on `device` from a generator seeded with
    `seed` (the same distributions as the JAX package, other numbers);
    norms start at zero as there.  With `mtp` a config's
    multi-token-prediction block is built too, drawn after every other
    weight (so the others do not depend on it).  On the meta device
    (the dry run) the model is built and nothing is drawn: there are no
    values to draw."""
    device = resolve_device(device)
    model = LM(cfg, device, mtp=mtp)
    if device.type == "meta":
        return model
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
                   kv_cache=None, cache_pos=None, seq_par: bool = False):
    """Pre-norm attention then pre-norm MLP or MoE.  `window` and
    `mrope_positions` reach the GQA attention (window None: the arch
    default; 0: full).  Every layer function takes its weights gathered
    over `data` where FSDP splits them (``sharding.fsdp_gathered``).

    With `seq_par` (``_seq_parallel``) `h` is this rank's S / n positions
    of the residual stream (B, S / n, d), and so is the result: the
    norms and the residual adds run on them (the norms' weights summed
    over `model` in the backward, ``sharding.replicated``); each block
    takes the normed positions all-gathered along the sequence
    (``sharding.gather_from``: its backward keeps this rank's slice of
    the block's input gradient, which the block sums over `model`) and
    so sees what it sees without the flag, at absolute `positions`; its
    output, summed over `model` in rank order, is cut to this rank's
    positions (``sharding.scatter_to``: its backward all-gathers).  The
    MoE block routes the same T tokens, so its capacity and drops are
    those without the flag."""
    p = sharding.fsdp_gathered(p)
    gather, scatter, norm = _seq_ops(seq_par)
    hn = gather(rms_norm(norm(p.norm1), h, cfg.norm_eps))
    if isinstance(p.attn, MLA):
        a, new_cache = mla_attention(p.attn, hn, cfg,
                                     positions, kv_cache=kv_cache,
                                     cache_pos=cache_pos)
    else:
        a, new_cache = attention(p.attn, hn, cfg, positions, window=window,
                                 mrope_positions=mrope_positions,
                                 kv_cache=kv_cache, cache_pos=cache_pos)
    h = h + scatter(a)
    hn = rms_norm(norm(p.norm2), h, cfg.norm_eps)
    h = _residual_shard(h, cfg)
    return h + scatter(_feed_forward(p, gather(hn), cfg)), new_cache


def _seq_parallel(cfg: ArchConfig, S: int) -> bool:
    """Whether a full-sequence pass of S positions keeps the residual
    stream between decoder layers split over `model` by positions: with
    ``cfg.seq_parallel``, a model axis of n > 1 and S % n == 0, as the
    reference's ``_residual_shard``; replicated otherwise (decode)."""
    nm = sharding.mesh_axis_size("model")
    return bool(cfg.seq_parallel and nm > 1 and S % nm == 0)


def _identity(t):
    return t


def _seq_ops(seq_par: bool):
    """(gather, scatter, norm weight) of ``_decoder_layer``: the
    sequence's all-gather and this rank's slice of it along dim 1, and
    ``sharding.replicated`` for a norm's weight, with `seq_par`;
    identities without."""
    if not seq_par:
        return _identity, _identity, _identity
    return (lambda t: sharding.gather_from(t, 1),
            lambda t: sharding.scatter_to(t, 1), sharding.replicated)


def _seq_final(cfg: ArchConfig, w: torch.Tensor, h: torch.Tensor,
               seq_par: bool) -> torch.Tensor:
    """The last norm of a stack (its weight `w`) on the stream `h`, then,
    with `seq_par`, the positions all-gathered: the head takes the whole
    sequence."""
    gather, _, norm = _seq_ops(seq_par)
    return gather(rms_norm(norm(w), h, cfg.norm_eps))


def _residual_shard(h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The reference's residual-stream constraint between blocks:
    sequence-sharded over `model` with ``cfg.seq_parallel`` (when the
    sequence divides the axis), else replicated over it.  On the
    per-rank path the layout is the program's own: with the flag
    ``_decoder_layer`` already holds this rank's positions (`seq_par`),
    and ``sharding.maybe_shard`` leaves a plain tensor as it is; a
    DTensor is redistributed."""
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
    p = sharding.fsdp_gathered(p)
    a, _ = decode_windowed(p.attn, rms_norm(p.norm1, h, cfg.norm_eps), cfg,
                           kv_cache, pos, cfg.sliding_window)
    h = h + a
    return h + _feed_forward(p, rms_norm(p.norm2, h, cfg.norm_eps), cfg)


def _ssm_layer(p: SSMLayer, h: torch.Tensor, cfg: ArchConfig,
               state: Optional[SSMState] = None):
    p = sharding.fsdp_gathered(p)
    y, new_state = ssm_block(p.ssm, rms_norm(p.norm, h, cfg.norm_eps), cfg,
                             state=state)
    return h + y, new_state


def _lora_apply(shared: DecoderLayer, lora: LoRA) -> SimpleNamespace:
    """The shared block's weights with one group's LoRA deltas, built
    anew on every call as in ``repro/models/lm.py:_lora_apply``.  Under a
    `model` axis, this rank's columns of wq and w_in plus the deltas'
    same columns (the replicated LoRA factors cut by columns), marked as
    this rank's shards (``sharding.as_shard``).  `shared` is gathered over
    `data` first where FSDP splits it."""
    shared = sharding.fsdp_gathered(shared)
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


def _embed_tokens(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """The embeddings of `tokens`: from this rank's slice of the table
    where the vocabulary is split over `model` (``layers.embed``), the
    table gathered over `data` where FSDP splits it."""
    return embed(sharding.unshard_data(model.embed), tokens)


def _embed_inputs(cfg: ArchConfig, model: LM, batch: Dict) -> torch.Tensor:
    """Token embeddings (B, S, d); for the vlm, `vision_embed` (B, Nv, d),
    cast to the model dtype, written over positions 0 .. Nv-1 (as the
    reference's dynamic_update_slice, which refuses Nv > S)."""
    h = _embed_tokens(model, _as_tokens(batch["tokens"], model.device))
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
    `fn` as it is.  The layers draw no random numbers, so no RNG state is
    stashed for the recomputation (which would make a host tensor in a
    step on the meta device)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn

    def remat(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=_remat_contexts, **kwargs)
    return remat


def _remat_contexts():
    return contextlib.nullcontext(), recomputing()


def forward_hidden(cfg: ArchConfig, model: LM, batch: Dict
                   ) -> torch.Tensor:
    """Full-sequence forward -> final-norm hidden states (B, S, d).  With
    ``_seq_parallel``, the decoder layers' stream holds this rank's
    positions (the embeddings cut to them, the final norm on them, then
    gathered); zamba2's shared block cuts and gathers its own, so the
    SSM layers' stream stays whole, as the reference keeps it."""
    h = _embed_inputs(cfg, model, batch)
    h = sharding.maybe_shard(h, ("pod", "data"), None, None)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    sp = _seq_parallel(cfg, S) and cfg.family not in ("ssm", "hybrid") \
        and not cfg.enc_dec
    if sp:
        h = sharding.scatter_to(h, 1)
    if cfg.family == "hybrid":
        h0 = h      # the step's own embeddings feed every shared block
        ssm_fn = _maybe_remat(_ssm_layer, cfg)
        shared_sp = _seq_parallel(cfg, S)
        for group in model.groups:
            for layer in group.ssm:
                h, _ = ssm_fn(layer, h, cfg)
            # the shared block sees h + h0 and its output replaces h; it
            # runs outside remat, as the reference's group_body
            hs = h + h0
            if shared_sp:
                hs = sharding.scatter_to(hs, 1)
            h, _ = _decoder_layer(_lora_apply(model.shared, group.lora),
                                  hs, cfg, positions, seq_par=shared_sp)
            if shared_sp:
                h = sharding.gather_from(h, 1)
    elif cfg.family == "ssm":
        ssm_fn = _maybe_remat(_ssm_layer, cfg)
        for layer in model.layers:
            h, _ = ssm_fn(layer, h, cfg)
    elif cfg.local_global_ratio:
        W = cfg.sliding_window
        layer_fn = _maybe_remat(_decoder_layer, cfg)
        for group in model.groups:
            for layer in group.local:
                h, _ = layer_fn(layer, h, cfg, positions, window=W,
                                seq_par=sp)
            h, _ = layer_fn(group.global_, h, cfg, positions, window=0,
                            seq_par=sp)
        for layer in model.tail:
            h, _ = layer_fn(layer, h, cfg, positions, window=W, seq_par=sp)
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
            h, _ = layer_fn(layer, h, cfg, positions, mrope_positions=mropep,
                            seq_par=sp)
    return _seq_final(cfg, model.final_norm, h, sp)


def _head(cfg: ArchConfig, model: LM) -> Tuple[torch.Tensor, bool]:
    """The LM head as (d, V) - `lm_head`, or the tied embedding's
    transpose (a view) - gathered over `data` where FSDP splits it, and
    whether it is this rank's (d, V / n) columns of a vocabulary split
    over `model`."""
    w = sharding.unshard_data(model.embed if cfg.tie_embeddings
                              else model.lm_head)
    split = sharding.is_sharded(w)
    return (w.T if cfg.tie_embeddings else w), split


def _logits(cfg: ArchConfig, model: LM, h: torch.Tensor) -> torch.Tensor:
    """h (..., d) -> logits (..., V), or this rank's (..., V / n) where
    the vocabulary is split over `model` (`h` entering this rank's
    columns: its gradient is summed over the axis)."""
    w, split = _head(cfg, model)
    return (sharding.copy_to(h) if split else h) @ w


def gather_vocab(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """Whole rows (..., V) of logits that are this rank's vocabulary
    slice (``forward``, ``prefill``, ``decode_step`` under a `model`
    axis that splits the vocabulary): all-gathered over the axis in rank
    order, no autograd; `logits` itself where they are whole.  A
    collective: every rank of the axis calls it."""
    if logits.shape[-1] == cfg.vocab:
        return logits
    return sharding.all_gather_dim(logits.detach(), logits.dim() - 1,
                                   sharding.axis_group("model"))


def greedy(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """The greedy token (int64) of each row of `logits`: ``torch.argmax``
    of the whole rows, also where they are this rank's vocabulary slice
    (``sharding.argmax_over``: the max over `model`, then the lowest
    index among equal maxima, as ``torch.argmax``); the same on every
    rank of the axis."""
    if logits.shape[-1] == cfg.vocab:
        return torch.argmax(logits, dim=-1)
    return sharding.argmax_over(logits, sharding.axis_group("model"))


def forward(cfg: ArchConfig, model: LM, batch: Dict) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V), or this rank's
    (B, S, V / n) where the vocabulary is split over `model` (the
    reference's out-spec, P(data, None, model))."""
    logits = _logits(cfg, model, forward_hidden(cfg, model, batch))
    return sharding.maybe_shard(logits, ("pod", "data"), None, "model")


def prefill(cfg: ArchConfig, model: LM, batch: Dict) -> torch.Tensor:
    """Prompt processing: the full-sequence forward's last-position
    logits (B, V), or this rank's (B, V / n) as ``forward``."""
    return forward(cfg, model, batch)[:, -1]


# ==========================================================================
# Loss
# ==========================================================================


def _ce(cfg: ArchConfig, model: LM, h: torch.Tensor, labels: torch.Tensor
        ) -> torch.Tensor:
    """The mean next-token cross-entropy of hidden states `h` (B, S', d)
    against `labels` (B, S'): ``fused_ce`` when ``cfg.fused_ce_loss``,
    else the cross-entropy of the logits, on this rank's vocabulary
    slice where the head is split."""
    w, split = _head(cfg, model)
    if cfg.fused_ce_loss:
        return fused_ce(h, w, labels, cfg.ce_chunk, vocab_parallel=split)
    if split:
        return vocab_cross_entropy(sharding.copy_to(h) @ w, labels)
    return cross_entropy(h @ w, labels)


def loss_fn(cfg: ArchConfig, model: LM, batch: Dict) -> torch.Tensor:
    """Next-token cross-entropy of the full-sequence forward (float32
    0-d), the counterpart of ``repro/models/lm.py:loss_fn``: the chunked
    ``fused_ce`` when ``cfg.fused_ce_loss``, else ``cross_entropy`` of
    the logits; plus ``0.3 * _mtp_loss`` when the config and the model
    have the multi-token-prediction block."""
    labels = _as_tokens(batch["labels"], model.device)
    loss = _ce(cfg, model, forward_hidden(cfg, model, batch)[:, :-1],
               labels[:, 1:])
    if cfg.mtp and model.mtp is not None:
        loss = loss + 0.3 * _mtp_loss(cfg, model, batch)
    return loss


def _mtp_loss(cfg: ArchConfig, model: LM, batch: Dict) -> torch.Tensor:
    """deepseek-v3's multi-token prediction: one extra decoder layer
    predicts token t+2 from [h_t ; emb(tok_{t+1})] (the embeddings of
    the token and of the next one, the last position wrapping round as
    the reference's roll), through the shared LM head.  With
    ``_seq_parallel`` the layer's stream holds this rank's positions, as
    the stack's."""
    tokens = _as_tokens(batch["tokens"], model.device)
    labels = _as_tokens(batch["labels"], model.device)
    B, S = tokens.shape
    h = _embed_tokens(model, tokens)
    nxt = _embed_tokens(model, torch.roll(tokens, -1, dims=1))
    mtp = model.mtp
    hh = torch.cat([h, nxt], dim=-1) @ sharding.full(mtp.proj)
    positions = torch.arange(S, device=hh.device)[None].expand(B, S)
    sp = _seq_parallel(cfg, S)
    if sp:
        hh = sharding.scatter_to(hh, 1)
    hh, _ = _maybe_remat(_decoder_layer, cfg)(mtp.layer, hh, cfg, positions,
                                              seq_par=sp)
    hh = _seq_final(cfg, mtp.norm, hh, sp)
    return _ce(cfg, model, hh[:, :-2], labels[:, 2:])


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
    p = sharding.fsdp_gathered(p)
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
    p = sharding.fsdp_gathered(p)
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
        w = sharding.unshard_data(w)
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
    then runs ``attention._decode_seq_sharded`` over `model`); its SSD
    heads and its part of the conv channels; the MLA latent whole.  A
    long-context batch (``registry.seq_over_data``) on a data axis above
    1 keeps every row on every rank and splits the positions of each kv
    and latent cache over `data` instead, as the reference's layout does
    (``cache_specs``'s seq_shard; its SSM states stay whole over `data`,
    where the reference splits their rows if they divide): such a cache
    is an ``attention.SeqOverData``, and decode merges the data ranks'
    partial attentions (``attention._decode_seq_sharded`` over `data`).
    Raises where a cache does not split so (a gemma3 ring does not split
    over `model` by position)."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    nd, nm = sharding.mesh_axis_size("data"), \
        sharding.mesh_axis_size("model")
    if nd * nm == 1:
        return _cache_tree(cfg, batch, max_len, dtype, device)
    from .registry import cache_specs, seq_over_data
    full = _cache_tree(cfg, batch, max_len, dtype, "meta")
    sizes = {"data": nd, "model": nm, "pod": 1}
    seq_shard = seq_over_data(batch) and nd > 1
    specs = cache_specs(cfg, full, "long_500k" if seq_shard
                        else "decode_32k", n_model=nm, axis_sizes=sizes)

    def local(path, leaf):
        spec = _lookup_spec(specs, path)
        ring = path[0] in ("local", "tail")
        kv = path[-1] in ("k", "v")
        if seq_shard and not (kv or path[0].startswith("latent")):
            # every rank holds every row: an SSM state is not split over
            # `data` (the reference's splits its batch where it divides)
            spec = tuple(None if s == "data" else s for s in spec)
        names = [n for s in spec for n in (s if isinstance(s, tuple)
                                           else (s,)) if n]
        if (not seq_shard and ("data" not in names or (
                kv and "model" not in names))) or (
                ring and spec[-2] == "model"):
            raise ValueError(
                f"{cfg.name}: the cache {'/'.join(map(str, path))} "
                f"{tuple(leaf.shape)} does not split over a {nd} x {nm} "
                f"mesh (spec {spec})")
        shape = [dim // (sizes[s] if s else 1)
                 for dim, s in zip(leaf.shape, spec)]
        t = torch.zeros(shape, dtype=dtype, device=device)
        if seq_shard and (kv or path[0].startswith("latent")) \
                and spec[-2] == "data":
            t = t.as_subclass(SeqOverData)
        return t
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
    """token (B,) int; pos an int.  Returns (logits (B, V), or this
    rank's (B, V / n) as ``forward``, cache); the cache is updated in
    place and returned.  `aux`: whisper needs
    {"cross_kv": cross_kv(...)} (its "enc_states" are not read here); for
    the vlm, {"vision_embed": (B, Nv, d)} replaces the token's embedding
    with the vision embedding at `pos` while pos < Nv."""
    pos = int(pos)
    token = _as_tokens(token, model.device)
    B = token.shape[0]
    h = _embed_tokens(model, token[:, None])
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
    return _logits(cfg, model, h[:, 0]), cache
