"""Attention variants with KV caches: GQA / MQA, sliding window, MLA.

Counterpart of ``repro/models/attention.py`` (``init_attention``,
``_expand_kv``, ``_mask_padded``, ``attention``, ``decode_windowed``,
``init_mla``, ``mla_attention``; M-RoPE in the full mode of ``attention``
for qwen2-vl).  Two modes each:
  * full   - a whole sequence (prefill), through ``ops.flash_attention``;
  * decode - one new token against the cache, through
    ``ops.flash_decode``.
The GQA cache layout is (B, Hkv, S, hd), as in the JAX package; a local
layer of gemma3 keeps a ring of its last `window` positions
(``decode_windowed``); MLA caches only the latent and the rope key,
(B, S, kv_lora_rank + d_rope).  Caches are written in place.  Not
ported: the sequence-sharded decode, which needs a `model` mesh axis
(``ROADMAP.md``, distribution).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops
from .config import ArchConfig
from .layers import apply_mrope, apply_rope, dense_init, param, rms_norm


class Attention(nn.Module):
    """wq (d, Hp*hd), wk/wv (d, Hkv*hd), wo (Hp*hd, d)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        d, Hkv, hd = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
        Hp = cfg.padded_heads
        self.wq = param((d, Hp * hd), dtype, device)
        self.wk = param((d, Hkv * hd), dtype, device)
        self.wv = param((d, Hkv * hd), dtype, device)
        self.wo = param((Hp * hd, d), dtype, device)


def init_attention(gen: torch.Generator, p: Attention) -> Attention:
    """Fill `p` with random weights drawn from `gen`.  wq/wo are
    allocated at `padded_heads` (a tp_pad multiple); the padded head
    outputs are zero-masked in the forward, so the math is exactly that
    of the nominal-head model."""
    for w in (p.wq, p.wk, p.wv, p.wo):
        dense_init(gen, w)
    return p


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, n, -1)


def _kv_index(H: int, Hkv: int, Hp: int, device) -> torch.Tensor:
    """The kv head each of the Hp padded query heads reads: the original
    H//Hkv group map, padded q heads clamped to the last kv head (their
    outputs are masked away)."""
    group = max(H // max(Hkv, 1), 1)
    return torch.clamp(torch.arange(Hp, device=device) // group,
                       max=Hkv - 1)


def _expand_kv(k: torch.Tensor, H: int, Hkv: int, Hp: int) -> torch.Tensor:
    """(B,S,Hkv,hd) -> (B,S,Hp,hd) by ``_kv_index``."""
    return k.index_select(2, _kv_index(H, Hkv, Hp, k.device))


def _mask_padded(o2d: torch.Tensor, H: int, Hp: int, hd: int
                 ) -> torch.Tensor:
    """Zero the padded-head columns of the flattened attention output
    (B, S, Hp*hd) so wo's padded rows contribute nothing."""
    if Hp == H:
        return o2d
    keep = (torch.arange(Hp * hd, device=o2d.device) < H * hd).to(o2d.dtype)
    return o2d * keep


def attention(p: Attention, x: torch.Tensor, cfg: ArchConfig,
              positions: torch.Tensor,
              window: Optional[int] = None,
              mrope_positions: Optional[torch.Tensor] = None,
              kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_pos: Optional[int] = None,
              ) -> Tuple[torch.Tensor,
                         Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """x (B, S, d).  Full mode when kv_cache is None; decode mode (S == 1)
    writes the new k/v at `cache_pos` and attends to the valid prefix.
    `window`: None -> the arch default; 0 -> full attention; int ->
    that window.  With ``cfg.mrope`` and `mrope_positions` (3, B, S) the
    rotation is M-RoPE, else RoPE at `positions` (decode passes none)."""
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Hp = cfg.padded_heads
    q = _split_heads(x @ p.wq, Hp)
    k = _split_heads(x @ p.wk, Hkv)
    v = _split_heads(x @ p.wv, Hkv)
    if cfg.mrope and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.mrope_sections,
                        cfg.rope_theta)
        k = apply_mrope(k, mrope_positions, cfg.mrope_sections,
                        cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        if window is None:
            w = cfg.sliding_window or None
        elif window <= 0:
            w = None
        else:
            w = window
        if Hp != H:
            # padded heads: expand kv to the padded layout (original
            # group map), so the kernel sees group 1
            k = _expand_kv(k, H, Hkv, Hp)
            v = _expand_kv(v, H, Hkv, Hp)
        o = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=w, block_k=cfg.attn_block_k)
        o = o.transpose(1, 2).reshape(B, S, Hp * hd)
        o = _mask_padded(o, H, Hp, hd)
        return o @ p.wo, None

    # ---- decode: S == 1 (cache stays at the nominal Hkv heads) ----
    ck, cv = kv_cache                              # (B, Hkv, Smax, hd)
    qd = q[:, 0, :H]                               # drop padded heads
    # The JAX package rebuilds the cache with dynamic_update_slice; here
    # the new entry is written into the cache in place.
    ck[:, :, cache_pos] = k[:, 0].to(ck.dtype)
    cv[:, :, cache_pos] = v[:, 0].to(cv.dtype)
    kv_len = torch.full((B,), cache_pos + 1, dtype=torch.int32,
                        device=x.device)
    return _decode_out(p, qd, ck, cv, kv_len, cfg), (ck, cv)


def _decode_out(p: Attention, qd: torch.Tensor, ck: torch.Tensor,
                cv: torch.Tensor, kv_len: torch.Tensor, cfg: ArchConfig
                ) -> torch.Tensor:
    """K3 over the cache, the padded heads' zero columns, then wo:
    qd (B, H, hd) -> (B, 1, d)."""
    B, H, hd = qd.shape
    o = ops.flash_decode(qd, ck, cv, kv_len=kv_len).reshape(B, H * hd)
    if cfg.padded_heads != H:
        o = torch.nn.functional.pad(o, (0, (cfg.padded_heads - H) * hd))
    return (o @ p.wo)[:, None, :]


# --------------------------------------------------------------------------
# Sliding-window KV cache decode (ring buffer)
# --------------------------------------------------------------------------


def decode_windowed(p: Attention, x: torch.Tensor, cfg: ArchConfig,
                    kv_cache: Tuple[torch.Tensor, torch.Tensor],
                    cache_pos: int, window: int
                    ) -> Tuple[torch.Tensor,
                               Tuple[torch.Tensor, torch.Tensor]]:
    """Decode against a ring-buffer cache (B, Hkv, window, hd): position
    `cache_pos` is written at slot ``cache_pos % window`` and the first
    ``min(cache_pos + 1, window)`` slots are attended (the rope is applied
    before caching, so the slots' order does not matter)."""
    B = x.shape[0]
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    Hp = cfg.padded_heads
    q = _split_heads(x @ p.wq, Hp)
    k = _split_heads(x @ p.wk, Hkv)
    v = _split_heads(x @ p.wv, Hkv)
    pos = torch.full((B, 1), cache_pos, dtype=torch.long, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    ck, cv = kv_cache
    slot = cache_pos % window
    ck[:, :, slot] = k[:, 0].to(ck.dtype)
    cv[:, :, slot] = v[:, 0].to(cv.dtype)
    kv_len = torch.full((B,), min(cache_pos + 1, window), dtype=torch.int32,
                        device=x.device)
    return _decode_out(p, q[:, 0, :H], ck, cv, kv_len, cfg), (ck, cv)


# --------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# --------------------------------------------------------------------------


class MLA(nn.Module):
    """w_dq (d, qr), q_norm (qr,), w_uq (qr, H*(dn+dr)), w_dkv (d, kvr+dr),
    kv_norm (kvr,), w_uk (kvr, H*dn), w_uv (kvr, H*dv), wo (H*dv, d)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.d_nope, cfg.d_rope, cfg.d_v
        self.w_dq = param((d, qr), dtype, device)
        self.q_norm = param((qr,), dtype, device)
        self.w_uq = param((qr, H * (dn + dr)), dtype, device)
        self.w_dkv = param((d, kvr + dr), dtype, device)
        self.kv_norm = param((kvr,), dtype, device)
        self.w_uk = param((kvr, H * dn), dtype, device)
        self.w_uv = param((kvr, H * dv), dtype, device)
        self.wo = param((H * dv, d), dtype, device)


def init_mla(gen: torch.Generator, p: MLA) -> MLA:
    """Fill `p` with random weights drawn from `gen`; norms start at
    zero, as in the JAX package."""
    for w in (p.w_dq, p.w_uq, p.w_dkv, p.w_uk, p.w_uv, p.wo):
        dense_init(gen, w)
    p.q_norm.zero_()
    p.kv_norm.zero_()
    return p


def mla_attention(p: MLA, x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor,
                  kv_cache: Optional[torch.Tensor] = None,
                  cache_pos: Optional[int] = None,
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, d).  Full mode when kv_cache is None; decode mode (S == 1)
    writes the token's latent and rope key into the cache
    (B, Smax, kvr + dr) at `cache_pos` and, as the JAX package does,
    expands the whole cache through w_uk / w_uv on every step (keys and
    values past the valid prefix are masked by ``kv_len``)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv, kvr = cfg.d_nope, cfg.d_rope, cfg.d_v, cfg.kv_lora_rank
    cq = rms_norm(p.q_norm, x @ p.w_dq, cfg.norm_eps)
    q = (cq @ p.w_uq).reshape(B, S, H, dn + dr)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    q_all = torch.cat([q[..., :dn], q_rope], dim=-1)

    ckv = x @ p.w_dkv                                # (B, S, kvr + dr)
    latent = rms_norm(p.kv_norm, ckv[..., :kvr], cfg.norm_eps)
    k_rope = apply_rope(ckv[:, :, None, kvr:], positions,
                        cfg.rope_theta)[:, :, 0]
    packed = torch.cat([latent, k_rope], dim=-1)
    if kv_cache is not None:
        kv_cache[:, cache_pos] = packed[:, 0].to(kv_cache.dtype)
        packed = kv_cache
    S_kv = packed.shape[1]
    latent_all = packed[..., :kvr].to(x.dtype)
    k_rope_all = packed[..., kvr:].to(x.dtype)
    k_nope = (latent_all @ p.w_uk).reshape(B, S_kv, H, dn)
    v_all = (latent_all @ p.w_uv).reshape(B, S_kv, H, dv)
    k_all = torch.cat([k_nope, k_rope_all[:, :, None].expand(
        B, S_kv, H, dr)], dim=-1)
    sm = 1.0 / math.sqrt(dn + dr)

    if kv_cache is None:
        o = ops.flash_attention(q_all.transpose(1, 2), k_all.transpose(1, 2),
                                v_all.transpose(1, 2), causal=True,
                                sm_scale=sm, block_k=cfg.attn_block_k)
        o = o.transpose(1, 2).reshape(B, S, H * dv)
        return o @ p.wo, None
    kv_len = torch.full((B,), cache_pos + 1, dtype=torch.int32,
                        device=x.device)
    o = ops.flash_decode(q_all[:, 0], k_all.transpose(1, 2),
                         v_all.transpose(1, 2), kv_len=kv_len, sm_scale=sm)
    return (o.reshape(B, H * dv) @ p.wo)[:, None, :], kv_cache
