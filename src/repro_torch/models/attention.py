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
(B, S, kv_lora_rank + d_rope).  Caches are written in place.

Under a `model` mesh axis of n > 1 (``models.sharding``) every mode
runs on this rank's heads.  The full mode (``_attention_tp``, also the
whisper encoder's and cross-attention's) takes this rank's query heads:
the reference's head-sharded q, with k/v on this rank's kv heads when
they divide the axis and, otherwise, computed from this rank's columns,
gathered to replicated and indexed by the query heads.  Decode follows
the cache's layout (``registry.cache_specs``, ``lm.init_cache``): where
the kv heads divide the axis the cache holds this rank's kv heads and K3
runs on them and on the query heads that read them
(``_decode_local_heads``, also for gemma3's rings); otherwise the cache
holds this rank's range of positions, and decode runs K3 on it with its
log-sum-exp and merges the ranks' partials (``_decode_seq_sharded``
over `model`, chosen by ``_use_seq_sharded_decode``).  MLA runs on this
rank's H / n heads: its latent and its cache are replicated, and w_uq /
w_uk / w_uv give this rank's heads only.

A cache whose positions are split over `data` (``lm.init_cache`` with
a long-context batch, ``registry.seq_over_data``, on a data axis above
1) is a ``SeqOverData``, whose type copies keep: it holds this rank's
range of positions and every row, and each decode mode runs
``_decode_seq_sharded`` over `data` on it, as over `model`.
"""
from __future__ import annotations

import copy
import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops
from . import sharding
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
    proj = torch.matmul
    if sharding.model_parallel():
        if kv_cache is None:
            return _attention_tp(p, x, cfg, positions, window,
                                 mrope_positions), None
        if _kv_heads_split(cfg):
            ck, cv = kv_cache
            return _decode_local_heads(p, x, cfg, positions, ck, cv,
                                       cache_pos, cache_pos + 1), (ck, cv)
        proj = sharding.columns_gathered
    q = _split_heads(proj(x, p.wq), Hp)
    k = _split_heads(proj(x, p.wk), Hkv)
    v = _split_heads(proj(x, p.wv), Hkv)
    if cfg.mrope and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.mrope_sections,
                        cfg.rope_theta)
        k = apply_mrope(k, mrope_positions, cfg.mrope_sections,
                        cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        w = _window(cfg, window)
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
    axis = _seq_axis(cfg, ck, B)
    if axis is not None:
        o = _decode_seq_sharded(qd, k[:, 0], v[:, 0], ck, cv, cache_pos,
                                cache_pos + 1, axis)
        return _out_proj(p, o, cfg), (ck, cv)
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
    return _out_proj(p, ops.flash_decode(qd, ck, cv, kv_len=kv_len), cfg)


def _out_proj(p: Attention, o: torch.Tensor, cfg: ArchConfig
              ) -> torch.Tensor:
    """Decode's (B, H, hd) attention output, the padded heads' zero
    columns, then wo -> (B, 1, d): under a `model` axis, this rank's
    columns of the output against its rows of wo, summed over the
    axis."""
    B, H, hd = o.shape
    o = o.reshape(B, H * hd)
    if cfg.padded_heads != H:
        o = torch.nn.functional.pad(o, (0, (cfg.padded_heads - H) * hd))
    if sharding.model_parallel():
        o = sharding.scatter_to(o, -1) @ sharding.local(p.wo, 0)
        return sharding.reduce_from(o)[:, None, :]
    return (o @ p.wo)[:, None, :]


def _decode_local_heads(p: Attention, x: torch.Tensor, cfg: ArchConfig,
                        positions: torch.Tensor, ck: torch.Tensor,
                        cv: torch.Tensor, slot: int, kv_len: int
                        ) -> torch.Tensor:
    """One decode step on this rank's Hkv / n kv heads, whose cache it
    holds (B, Hkv / n, S, hd), and the H / n query heads that read them.
    The new k and v come from this rank's columns of wk / wv and are
    written at `slot`; q comes from this rank's columns of wq where the
    heads are not padded, else it is gathered (a token's worth) and cut
    to this rank's nominal heads; K3 runs over the first `kv_len`
    positions of the local heads; the output goes through this rank's
    rows of wo and one sum over `model` (gathered first where the heads
    are padded, whose rows of wo do not follow the nominal heads).
    x (B, 1, d) -> (B, 1, d)."""
    B = x.shape[0]
    H, Hkv, hd, Hp = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.padded_heads
    n, r = sharding.mesh_axis_size("model"), sharding.axis_rank("model")
    Hl = H // n
    xs = sharding.copy_to(x)
    if Hp == H:
        q = _split_heads(xs @ sharding.local(p.wq, 1), Hl)
    else:
        q = _split_heads(sharding.columns_gathered(x, p.wq),
                         Hp)[:, :, r * Hl:(r + 1) * Hl]
    k = _split_heads(xs @ sharding.local(p.wk, 1), Hkv // n)
    v = _split_heads(xs @ sharding.local(p.wv, 1), Hkv // n)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if seq_over_data(ck):
        o = _decode_seq_sharded(q[:, 0], k[:, 0], v[:, 0], ck, cv, slot,
                                kv_len, "data")
    else:
        ck[:, :, slot] = k[:, 0].to(ck.dtype)
        cv[:, :, slot] = v[:, 0].to(cv.dtype)
        lens = torch.full((B,), kv_len, dtype=torch.int32, device=x.device)
        o = ops.flash_decode(q[:, 0], ck, cv, kv_len=lens)  # (B, Hl, hd)
    if Hp == H:
        o = o.reshape(B, Hl * hd) @ sharding.local(p.wo, 0)
        return sharding.reduce_from(o)[:, None, :]
    return _out_proj(p, sharding.gather_from(o, 1), cfg)


def _window(cfg: ArchConfig, window: Optional[int]) -> Optional[int]:
    """None -> the arch default; 0 (or less) -> full; int -> that."""
    if window is None:
        return cfg.sliding_window or None
    return None if window <= 0 else window


def _attention_tp(p: Attention, x: torch.Tensor, cfg: ArchConfig,
                  positions: Optional[torch.Tensor], window: Optional[int],
                  mrope_positions: Optional[torch.Tensor],
                  causal: bool = True,
                  kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> torch.Tensor:
    """The full mode on this rank's Hp / n query heads (the depth
    format): q from this rank's columns of wq; k and v from this rank's
    kv heads when the padded heads are the nominal ones and the kv heads
    divide the axis, else computed from this rank's columns, gathered in
    full (``sharding.columns_gathered``) and indexed by the kv heads this
    rank's query heads read (the reference's broadcast operand); K2 on
    the local heads; this rank's rows of wo and one sum over the axis.
    x (B, S, d) replicated -> (B, S, d) replicated.  `positions` None:
    no rotation (the whisper encoder).  `kv`: the cross-attention's
    encoder keys and values in full, each (B, Hkv, Se, hd), instead of
    k and v from x."""
    B, S, _ = x.shape
    H, Hkv, hd, Hp = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.padded_heads
    n, r = sharding.mesh_axis_size("model"), sharding.axis_rank("model")
    if Hp % n:
        raise ValueError(f"{cfg.name}: {Hp} query heads do not split over "
                         f"a model axis of {n}")
    Hl = Hp // n
    xs = sharding.copy_to(x)
    q = _split_heads(xs @ sharding.local(p.wq, 1), Hl)
    kv_local = kv is None and Hp == H and Hkv % n == 0
    if kv is not None:
        k, v = (t.transpose(1, 2) for t in kv)          # (B, Se, Hkv, hd)
    elif kv_local:
        k = _split_heads(xs @ sharding.local(p.wk, 1), Hkv // n)
        v = _split_heads(xs @ sharding.local(p.wv, 1), Hkv // n)
    else:
        k = _split_heads(sharding.columns_gathered(x, p.wk), Hkv)
        v = _split_heads(sharding.columns_gathered(x, p.wv), Hkv)
    if positions is not None:           # whisper's attentions: no rotation
        if cfg.mrope and mrope_positions is not None:
            q = apply_mrope(q, mrope_positions, cfg.mrope_sections,
                            cfg.rope_theta)
            k = apply_mrope(k, mrope_positions, cfg.mrope_sections,
                            cfg.rope_theta)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    if not kv_local:
        group = max(H // max(Hkv, 1), 1)      # as _kv_index, on the host
        heads = [min(h // group, Hkv - 1)
                 for h in range(r * Hl, (r + 1) * Hl)]
        uniq = sorted(set(heads))
        if all(heads.count(u) == heads.count(uniq[0]) for u in uniq):
            heads = uniq        # whole groups: K2 reads them grouped
        idx = torch.tensor(heads, dtype=torch.long, device=x.device)
        k = sharding.copy_to(k).index_select(2, idx)
        v = sharding.copy_to(v).index_select(2, idx)
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal,
                            window=_window(cfg, window) if causal else None,
                            block_k=cfg.attn_block_k)
    o = o.transpose(1, 2).reshape(B, S, Hl * hd)
    if Hp != H:
        keep = (torch.arange(Hl * hd, device=o.device) + r * Hl * hd
                < H * hd).to(o.dtype)
        o = o * keep
    return sharding.reduce_from(o @ sharding.local(p.wo, 0))


def _kv_heads_split(cfg: ArchConfig) -> bool:
    """Whether a decode cache holds this rank's kv heads: a `model` axis
    of n > 1 that divides the kv heads (``registry.cache_specs``)."""
    nm = sharding.mesh_axis_size("model")
    return bool(nm > 1 and cfg.n_kv_heads and cfg.n_kv_heads % nm == 0)


def _use_seq_sharded_decode(cfg: ArchConfig, B: int, S: int) -> bool:
    """Whether decode runs on a cache whose positions are split over
    `model`: the kv heads do not divide the axis (the broadcast-operand
    archs), the S positions and the B rows split evenly.  B and S are
    the global batch and cache length."""
    nm = sharding.mesh_axis_size("model")
    nd = sharding.mesh_axis_size("data")
    return bool(nm > 1 and cfg.n_kv_heads and cfg.n_kv_heads % nm != 0
                and S % nm == 0 and B % max(nd, 1) == 0 and B >= nd)


class SeqOverData(torch.Tensor):
    """A kv or latent decode cache whose positions split over `data`
    (``lm.init_cache``'s long-context layout): every row on every rank,
    this rank's range of positions.  The type is the layout: indexing,
    views, stacks, copies and moves (``clone``, ``to``, ``cpu``),
    ``copy.deepcopy`` and ``torch.save`` keep it, so a copied cache
    decodes as the one it copies; an op that computes from the cache
    returns a plain tensor."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*args, **(kwargs or {}))
        return _as_layout(out, cls) if func in _KEEP_LAYOUT else out

    def __deepcopy__(self, memo):
        return copy.deepcopy(self.as_subclass(torch.Tensor),
                             memo).as_subclass(SeqOverData)


#: the functions whose tensors hold the cache's own positions
_KEEP_LAYOUT = frozenset((
    torch.Tensor.__getitem__, torch.Tensor.select, torch.Tensor.unbind,
    torch.unbind, torch.Tensor.view, torch.Tensor.reshape,
    torch.Tensor.contiguous, torch.Tensor.detach, torch.Tensor.clone,
    torch.Tensor.float, torch.Tensor.bfloat16, torch.Tensor.half,
    torch.clone, torch.Tensor.to, torch.Tensor.cpu, torch.Tensor.cuda,
    torch.stack, torch.zeros_like, torch.empty_like))


def _as_layout(out, cls):
    if isinstance(out, torch.Tensor):
        return out if isinstance(out, cls) else out.as_subclass(cls)
    if isinstance(out, (tuple, list)):
        return type(out)(_as_layout(o, cls) for o in out)
    return out


def seq_over_data(c: torch.Tensor) -> bool:
    """Whether decode cache `c` (a layer's, or a stack) holds this rank's
    range of positions over `data`: a ``SeqOverData``, which decodes
    only under a data axis."""
    if not isinstance(c, SeqOverData):
        return False
    if sharding.mesh_axis_size("data") == 1:
        raise ValueError("a cache whose positions split over `data` "
                         "decodes under a mesh with that data axis")
    return True


def _seq_axis(cfg: ArchConfig, c: torch.Tensor, B: int) -> Optional[str]:
    """The mesh axis whose ranks hold ranges of the positions of decode
    cache `c` (B rows here), or None: `data` for a ``SeqOverData``,
    `model` where ``_use_seq_sharded_decode`` says so."""
    if seq_over_data(c):
        return "data"
    if _use_seq_sharded_decode(cfg, B * sharding.mesh_axis_size("data"),
                               c.shape[-2] * sharding.mesh_axis_size(
                                   "model")):
        return "model"
    return None


def _seq_part(c: torch.Tensor, axis: str, slot: int, kv_len: int):
    """For a cache whose positions (dim -2) split over `axis`: (this
    rank's index of global position `slot`, or None where another rank
    holds it; how many of the first `kv_len` global positions this rank
    holds)."""
    S_loc, n = c.shape[-2], sharding.mesh_axis_size(axis)
    if not 0 <= slot < S_loc * n:
        raise IndexError(f"position {slot} is past a cache of {n} x "
                         f"{S_loc} positions over `{axis}`")
    start = sharding.axis_rank(axis) * S_loc
    own = slot - start if start <= slot < start + S_loc else None
    return own, min(max(kv_len - start, 0), S_loc)


def _merge_partials(o: torch.Tensor, lse: torch.Tensor, axis: str
                    ) -> torch.Tensor:
    """K3's partial (o, lse) of every rank of `axis` merged exactly
    (``ops.combine_decode_shards``): the same on every rank."""
    group = sharding.axis_group(axis)
    return ops.combine_decode_shards(
        sharding.all_gather_dim(o[None], 0, group),
        sharding.all_gather_dim(lse[None], 0, group))


def _decode_seq_sharded(q3: torch.Tensor, k_new: torch.Tensor,
                        v_new: torch.Tensor, ck: torch.Tensor,
                        cv: torch.Tensor, slot: int, kv_len: int,
                        axis: str) -> torch.Tensor:
    """Decode against a KV cache whose positions split over mesh axis
    `axis` (``_seq_axis``): this rank holds positions [i S_loc,
    (i + 1) S_loc).  It writes the new key and value only when it owns
    `slot`, runs K3 with its log-sum-exp over its part of the first
    `kv_len` positions (none: its lse is -1e30 and it weighs nothing),
    all-gathers the outputs and lses over the axis and merges them
    exactly (``_merge_partials``).

    q3 (B, H, hd); k_new/v_new (B, Hkv, hd); ck/cv (B, Hkv, S_loc, hd),
    written in place.  Returns (B, H, hd), the same on every rank."""
    own, n = _seq_part(ck, axis, slot, kv_len)
    if own is not None:
        ck[:, :, own] = k_new.to(ck.dtype)
        cv[:, :, own] = v_new.to(cv.dtype)
    lens = torch.full((q3.shape[0],), n, dtype=torch.int32,
                      device=q3.device)
    o, lse = ops.flash_decode(q3, ck, cv, kv_len=lens, return_lse=True)
    return _merge_partials(o, lse, axis)


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
    pos = torch.full((B, 1), cache_pos, dtype=torch.long, device=x.device)
    ck, cv = kv_cache
    slot = cache_pos % window
    if sharding.model_parallel():           # the ring holds this rank's
        return _decode_local_heads(         # kv heads (lm.init_cache)
            p, x, cfg, pos, ck, cv, slot, min(cache_pos + 1, window)), \
            (ck, cv)
    q = _split_heads(x @ p.wq, Hp)
    k = _split_heads(x @ p.wk, Hkv)
    v = _split_heads(x @ p.wv, Hkv)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    if seq_over_data(ck):
        o = _decode_seq_sharded(q[:, 0, :H], k[:, 0], v[:, 0], ck, cv, slot,
                                min(cache_pos + 1, window), "data")
        return _out_proj(p, o, cfg), (ck, cv)
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
    n = sharding.mesh_axis_size("model")
    if cfg.n_heads % n:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} MLA heads do not split "
                         f"over a model axis of {n}")
    H = cfg.n_heads // n            # this rank's heads (all without a mesh)
    dn, dr, dv, kvr = cfg.d_nope, cfg.d_rope, cfg.d_v, cfg.kv_lora_rank
    cq = rms_norm(p.q_norm, x @ p.w_dq, cfg.norm_eps)
    q = (sharding.copy_to(cq) @ sharding.local(p.w_uq, 1)).reshape(
        B, S, H, dn + dr)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    q_all = torch.cat([q[..., :dn], q_rope], dim=-1)

    ckv = x @ p.w_dkv                                # (B, S, kvr + dr)
    latent = rms_norm(p.kv_norm, ckv[..., :kvr], cfg.norm_eps)
    k_rope = apply_rope(ckv[:, :, None, kvr:], positions,
                        cfg.rope_theta)[:, :, 0]
    packed = torch.cat([latent, k_rope], dim=-1)
    over_data = kv_cache is not None and seq_over_data(kv_cache)
    n_valid = None if kv_cache is None else cache_pos + 1
    if over_data:
        own, n_valid = _seq_part(kv_cache, "data", cache_pos, cache_pos + 1)
        if own is not None:
            kv_cache[:, own] = packed[:, 0].to(kv_cache.dtype)
        packed = kv_cache
    elif kv_cache is not None:
        kv_cache[:, cache_pos] = packed[:, 0].to(kv_cache.dtype)
        packed = kv_cache
    S_kv = packed.shape[1]
    packed = sharding.copy_to(packed)
    latent_all = packed[..., :kvr].to(x.dtype)
    k_rope_all = packed[..., kvr:].to(x.dtype)
    k_nope = (latent_all @ sharding.local(p.w_uk, 1)).reshape(
        B, S_kv, H, dn)
    v_all = (latent_all @ sharding.local(p.w_uv, 1)).reshape(B, S_kv, H, dv)
    k_all = torch.cat([k_nope, k_rope_all[:, :, None].expand(
        B, S_kv, H, dr)], dim=-1)
    sm = 1.0 / math.sqrt(dn + dr)

    if kv_cache is None:
        o = ops.flash_attention(q_all.transpose(1, 2), k_all.transpose(1, 2),
                                v_all.transpose(1, 2), causal=True,
                                sm_scale=sm, block_k=cfg.attn_block_k)
        o = o.transpose(1, 2).reshape(B, S, H * dv)
        return sharding.reduce_from(o @ sharding.local(p.wo, 0)), None
    kv_len = torch.full((B,), n_valid, dtype=torch.int32, device=x.device)
    o = ops.flash_decode(q_all[:, 0], k_all.transpose(1, 2),
                         v_all.transpose(1, 2), kv_len=kv_len, sm_scale=sm,
                         return_lse=over_data)
    if over_data:
        o = _merge_partials(*o, "data")
    o = sharding.reduce_from(o.reshape(B, H * dv) @ sharding.local(p.wo, 0))
    return o[:, None, :], kv_cache
