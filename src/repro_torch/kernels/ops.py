"""Public kernel ops of the port: dispatch by the device of the inputs.

Counterpart of ``repro/kernels/ops.py``.  Each op has two
implementations with the same semantics:

  * the hand-written CUDA kernel, taken for CUDA tensors: K1
    ``neutron_matmul.py`` (the int8 vision plan's conv and fc, and the
    Pallas kernel's own contract), K2 ``flash_attention.py``, K3
    ``flash_decode.py``, K4 ``ssd_scan.py``;
  * the plain PyTorch version (``ref.py``), taken for CPU tensors.

``impl="auto"`` dispatches by device: a CUDA tensor gets the kernel or an
exception (there is no fallback), a CPU tensor gets the plain version,
and a meta tensor the kernel's meta version (``meta.py``: outputs of the
kernel's shapes, its work reported to the dry run's cost counter; the
plain version never runs on meta).
``impl="ref"`` returns the plain version on either device; only the tests
and ``chip_smoke.py`` ask for it, to get the value a kernel is held
against.

This differs from the JAX package, where ``"auto"`` means Pallas only on
a TPU (``repro/kernels/ops.py:37-40``) and the models pass ``"ref"``
unless ``ArchConfig.use_pallas`` is set (``repro/models/config.py:129``).
The port's models always pass ``"auto"``: on the card the kernels run
whatever ``use_pallas`` says.

On the card, ``chip_smoke.py`` phase 2 holds every kernel against its
plain version at the shapes of its paths; phase 6 replays the int8
vision plans (mobilenet_v2, resnet50_v1) with every conv and fc on K1.

Gradients.  Attention and the SSD scan are differentiable.  With grad
mode on and q, k or v requiring grad, ``flash_attention`` runs
``FlashAttentionFn``, whose forward is K2 with its log-sum-exp and whose
backward is K2b (``flash_attention_bwd.py``); with an input of
``ssd_scan`` requiring grad, its intra-chunk part is ``SSDChunkFn``,
K4 forward and K4b (``ssd_scan_bwd.py``) backward, and the cross-chunk
recurrence differentiates through autograd; on the CPU both take their
plain versions.  K1, K3 and K2 with a query offset have no backward: a
tensor that requires grad reaching them under grad mode raises at once
(``_no_backward``) on either device, so a training step can neither
lose its gradients on the card (a kernel's output has no ``grad_fn``)
nor differ there from the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import is_dtensor

from . import flash_attention as _fa
from . import flash_attention_bwd as _fab
from . import flash_decode as _fd
from . import meta as _meta
from . import neutron_matmul as _nm
from . import ref as _ref
from . import ssd_scan as _ssd
from . import ssd_scan_bwd as _ssdb

IMPLS = ("auto", "ref")


def _plain(impl: str, t: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}; got {impl!r}")
    return impl == "ref" or t.device.type == "cpu"


def _kernel(t: torch.Tensor, wrapper):
    """The kernel's wrapper module, or its meta version for a meta
    tensor."""
    return _meta if t.device.type == "meta" else wrapper


def _no_backward(impl: str, kernel: str, *tensors) -> None:
    """Raise if a tensor that requires grad reaches `kernel`, which has
    no backward, with grad mode on.  ``impl="ref"`` (the plain version,
    differentiable by autograd) passes."""
    if impl != "auto" or not torch.is_grad_enabled():
        return
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward kernel, and a tensor that requires "
            f"grad reached it with grad mode on: its output would carry no "
            f"gradient on the card.  No training path reaches it; run it "
            f"under torch.no_grad() or on detached inputs")


def _local_only(kernel: str, *tensors) -> None:
    """Raise if a DTensor reaches `kernel`: the kernels take plain
    tensors, and under a mesh each rank runs them on its local shard
    (``models.sharding``)."""
    for t in tensors:
        if t is not None and is_dtensor(t):
            raise TypeError(f"{kernel} takes plain tensors; a DTensor "
                            f"reached it: pass each rank's local shard")


def _repeat_kv(k: torch.Tensor, v: torch.Tensor, H: int):
    Hkv = k.shape[1]
    if H != Hkv:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    return k, v


# --------------------------------------------------------------------------
# neutron_matmul (K1)
# --------------------------------------------------------------------------


def neutron_matmul(x, w, bias=None, scale=None, act: str = "none",
                   out_dtype=None, out_scale: Optional[float] = None,
                   impl: str = "auto", **block_kw):
    """The Pallas kernel's contract: x (M,K) @ w (K,N) -> (M,N)."""
    _local_only("neutron_matmul (K1)", x, w, bias, scale)
    plain = _plain(impl, x)
    _no_backward(impl, "neutron_matmul (K1)", x, w, bias, scale)
    if plain:
        return _ref.neutron_matmul_ref(x, w, bias=bias, scale=scale,
                                       act=act, out_dtype=out_dtype,
                                       out_scale=out_scale)
    return _kernel(x, _nm).neutron_matmul(
        x, w, bias=bias, scale=scale, act=act, out_dtype=out_dtype,
        out_scale=out_scale, **block_kw)


def neutron_matmul_plan(x, w, bias, sc, act: str, out_scale: float,
                        out_zp: int, qmin: int, qmax: int, out,
                        impl: str = "auto"):
    """The int8 plan's contract, written into ``out`` (batch, M, N) in
    place; see ``neutron_matmul.neutron_matmul_plan``."""
    _local_only("neutron_matmul_plan (K1)", x, w, out)
    plain = _plain(impl, x)
    _no_backward(impl, "neutron_matmul_plan (K1)", x, w, bias, sc, out)
    if plain:
        return out.copy_(_ref.neutron_matmul_plan_ref(
            x, w, bias, sc, act, out_scale, out_zp, qmin, qmax))
    return _kernel(x, _nm).neutron_matmul_plan(x, w, bias, sc, act,
                                               out_scale, out_zp, qmin,
                                               qmax, out)


def neutron_matmul_nk(x, wt, bias, act: str, out, impl: str = "auto"):
    """The Pallas contract in float32 with an (N, K) weight, written into
    ``out`` (batch, M, N) in place; see
    ``neutron_matmul.neutron_matmul_nk``."""
    _local_only("neutron_matmul_nk (K1)", x, wt, out)
    plain = _plain(impl, x)
    _no_backward(impl, "neutron_matmul_nk (K1)", x, wt, bias, out)
    if plain:
        return out.copy_(_ref.neutron_matmul_nk_ref(x, wt, bias, act))
    return _kernel(x, _nm).neutron_matmul_nk(x, wt, bias, act, out)


# --------------------------------------------------------------------------
# flash attention (prefill)
# --------------------------------------------------------------------------


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None,
                    sm_scale: Optional[float] = None,
                    impl: str = "auto", q_offset=None, **block_kw):
    """q (B,H,S,D); k (B,Hkv,Sk,D); v (B,Hkv,Sk,Dv) -> (B,H,S,Dv).
    ``q_offset`` (B,) int: each lane's query position in the keys (see
    ``ref.flash_attention_ref``).  With grad mode on and q, k or v
    requiring grad this is ``FlashAttentionFn`` (no ``q_offset``)."""
    _local_only("flash_attention (K2)", q, k, v)
    plain = _plain(impl, q)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q_offset is not None:
            _no_backward(impl, "flash_attention (K2) with a q_offset", q, k,
                         v)
        else:
            if plain:
                k, v = _repeat_kv(k, v, q.shape[1])
            return FlashAttentionFn.apply(q, k, v, causal, window, sm_scale,
                                          block_kw.get("block_k", 512),
                                          plain)
    if plain:
        k, v = _repeat_kv(k, v, q.shape[1])
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window, sm_scale=sm_scale,
                                        block_k=block_kw.get("block_k", 512),
                                        q_offset=q_offset)
    return _kernel(q, _fa).flash_attention(q, k, v, causal=causal,
                                           window=window, sm_scale=sm_scale,
                                           q_offset=q_offset, **block_kw)


# --------------------------------------------------------------------------
# flash decode
# --------------------------------------------------------------------------


def flash_decode(q, k, v, kv_len=None, sm_scale: Optional[float] = None,
                 return_lse: bool = False, impl: str = "auto", **block_kw):
    """q (B,H,D); k (B,Hkv,S,D); v (B,Hkv,S,Dv) -> (B,H,Dv) [, lse]."""
    _local_only("flash_decode (K3)", q, k, v)
    plain = _plain(impl, q)
    _no_backward(impl, "flash_decode (K3)", q, k, v)
    if plain:
        k, v = _repeat_kv(k, v, q.shape[1])
        return _ref.flash_decode_ref(q, k, v, kv_len=kv_len,
                                     sm_scale=sm_scale,
                                     return_lse=return_lse)
    return _kernel(q, _fd).flash_decode(q, k, v, kv_len=kv_len,
                                        sm_scale=sm_scale,
                                        return_lse=return_lse, **block_kw)


# --------------------------------------------------------------------------
# Mamba2 SSD scan
# --------------------------------------------------------------------------


def ssd_scan(x, dt, A, Bm, Cm, chunk: int = 64, init_state=None,
             impl: str = "auto"):
    """Full chunked SSD: the intra-chunk kernel (K4) and the cross-chunk
    recurrence in torch.  x (B,S,H,P); dt (B,S,H); A (H,); Bm/Cm (B,S,N).
    Returns (y (B,S,H,P), final_state (B,H,P,N)) in x's dtype.  With
    grad mode on and an input requiring grad the intra-chunk part is
    ``SSDChunkFn`` (K4 and K4b); ``impl="ref"`` differentiates the plain
    version by autograd."""
    _local_only("ssd_scan (K4)", x, dt, A, Bm, Cm, init_state)
    plain = _plain(impl, x)
    chunk_fn = _ref.ssd_chunk_ref if plain else _kernel(x, _ssd).ssd_chunk
    if impl == "auto" and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, init_state)):
        def chunk_fn(*args):
            return SSDChunkFn.apply(*args, plain)
    return _ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                             init_state=init_state, chunk_fn=chunk_fn)


ssd_step = _ref.ssd_step_ref          # O(1) decode step (plain torch)
apply_activation = _ref.apply_activation
#: merges K3's per-shard (o, lse) of a sequence-sharded cache (plain
#: torch, as in the reference: a few elementwise ops on (N, B, H, D))
combine_decode_shards = _ref.combine_decode_shards


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a fused backward, the counterpart of
    ``flash_attention_fused`` (``repro/kernels/ref.py:217-285``): it saves
    only (q, k, v, o, lse), O(S D), and the backward recomputes each
    block's probabilities.  With ``plain`` False (CUDA tensors) the
    forward is K2 with its log-sum-exp and the backward K2b, both taking
    grouped kv heads as they are; with ``plain`` True it is
    ``ref.flash_attention_fwd_lse_ref`` and ``ref.flash_attention_bwd_ref``
    (H == Hkv: ``flash_attention`` repeats grouped kv heads first, and
    autograd sums their gradients over the group through the repeat).

        FlashAttentionFn.apply(q, k, v, causal, window, sm_scale, block_k,
                               plain) -> o
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale, block_k, plain):
        if plain:
            o, lse = _ref.flash_attention_fwd_lse_ref(
                q, k, v, causal=causal, window=window, sm_scale=sm_scale,
                block_k=block_k)
        else:
            o, lse = _kernel(q, _fa).flash_attention(
                q, k, v, causal=causal, window=window, sm_scale=sm_scale,
                return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, sm_scale, block_k, plain)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, sm_scale, block_k, plain = ctx.args
        if plain:
            dq, dk, dv = _ref.flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal=causal, window=window,
                sm_scale=sm_scale, block_k=block_k)
        else:
            dq, dk, dv = _kernel(q, _fab).flash_attention_bwd(
                q, k, v, o, lse, do, causal=causal, window=window,
                sm_scale=sm_scale)
        return dq, dk, dv, None, None, None, None, None


class SSDChunkFn(torch.autograd.Function):
    """The intra-chunk SSD with a backward kernel: forward K4
    (``ssd_scan.ssd_chunk``) and backward K4b
    (``ssd_scan_bwd.ssd_chunk_bwd``) for CUDA tensors (``plain`` False),
    ``ref.ssd_chunk_ref`` and ``ref.ssd_chunk_bwd_ref`` with ``plain``
    True.  It saves its inputs and seg; the backward takes the
    cotangents of all four outputs (seg's too: ``ssd_scan_ref`` reads it
    again for the cross-chunk term) and returns the gradients in the
    inputs' dtypes.  The JAX package differentiates ``ssd_scan_ref`` by
    autodiff; this is the same function's gradient.

        SSDChunkFn.apply(x, dt, A, Bm, Cm, chunk, plain)
            -> (y_intra, contrib, total, seg)
    """

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, plain):
        fn = _ref.ssd_chunk_ref if plain else _kernel(x, _ssd).ssd_chunk
        y, contrib, total, seg = fn(x, dt, A, Bm, Cm, chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, seg)
        ctx.args = (chunk, plain)
        return y, contrib, total, seg

    @staticmethod
    def backward(ctx, dy, dcontrib, dtotal, dseg):
        x, dt, A, Bm, Cm, seg = ctx.saved_tensors
        chunk, plain = ctx.args
        fn = (_ref.ssd_chunk_bwd_ref if plain
              else _kernel(x, _ssdb).ssd_chunk_bwd)
        grads = fn(x, dt, A, Bm, Cm, seg, dy, dcontrib, dtotal, dseg, chunk)
        return (*(g.to(t.dtype) for g, t in zip(grads, (x, dt, A, Bm, Cm))),
                None, None)
