"""GQA / MQA attention with a KV cache.

Counterpart of ``repro/models/attention.py`` (``init_attention``,
``_expand_kv``, ``_mask_padded``, ``attention``).  Two modes:
  * full   - a whole sequence (prefill), through ``ops.flash_attention``;
  * decode - one new token against the cache, through
    ``ops.flash_decode``.
The cache layout is (B, Hkv, S, hd), as in the JAX package.  Not ported
yet: the sequence-sharded decode, the ring-buffer windowed decode and MLA
(``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops
from .config import ArchConfig
from .layers import apply_rope, dense_init, param


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


def _expand_kv(k: torch.Tensor, H: int, Hkv: int, Hp: int) -> torch.Tensor:
    """(B,S,Hkv,hd) -> (B,S,Hp,hd) with the original H//Hkv group map
    (padded q heads clamp to the last kv head; their outputs are masked
    away)."""
    group = max(H // max(Hkv, 1), 1)
    idx = torch.clamp(torch.arange(Hp, device=k.device) // group,
                      max=Hkv - 1)
    return k.index_select(2, idx)


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
              kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_pos: Optional[int] = None,
              ) -> Tuple[torch.Tensor,
                         Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """x (B, S, d).  Full mode when kv_cache is None; decode mode (S == 1)
    writes the new k/v at `cache_pos` and attends to the valid prefix.
    `window`: None -> the arch default; 0 -> full attention; int ->
    that window."""
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Hp = cfg.padded_heads
    q = _split_heads(x @ p.wq, Hp)
    k = _split_heads(x @ p.wk, Hkv)
    v = _split_heads(x @ p.wv, Hkv)
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
    o = ops.flash_decode(qd, ck, cv, kv_len=kv_len)
    o = o.reshape(B, H * hd)
    if Hp != H:
        o = torch.nn.functional.pad(o, (0, (Hp - H) * hd))
    return (o @ p.wo)[:, None, :], (ck, cv)
