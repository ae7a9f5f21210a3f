"""Shared layers of the port: norms, rotary embeddings, MLP, embeddings.

Counterpart of ``repro/models/layers.py``.  Parameters live in
``nn.Module``s in the JAX layout (a weight is (d_in, d_out), so ``x @ w``
is the same product); the layers are plain functions
``fn(params, x, ...) -> y`` with the JAX names.  Modules are built with
uninitialised parameters; initialisers fill them in place from an
explicit ``torch.Generator`` on the target device.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Iterator, Optional, Sequence

import torch
from torch import nn

from repro_torch.kernels import ops
from . import sharding


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def param(shape, dtype: torch.dtype, device) -> nn.Parameter:
    """An uninitialised inference parameter (no gradient)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


_remat = threading.local()


@contextlib.contextmanager
def recomputing() -> Iterator[None]:
    """Marks, on this thread, the backward's recomputation of a layer's
    forward under remat (``lm._maybe_remat``), so that state a forward
    updates as a side effect (``MoE.dropped``) counts a step once."""
    prev = in_recompute()
    _remat.on = True
    try:
        yield
    finally:
        _remat.on = prev


def in_recompute() -> bool:
    return getattr(_remat, "on", False)


# --------------------------------------------------------------------------
# Initializers (fill a parameter in place)
# --------------------------------------------------------------------------


@torch.no_grad()
def dense_init(gen: torch.Generator, w: torch.Tensor,
               scale: Optional[float] = None) -> torch.Tensor:
    fan_in = w.shape[-2] if w.dim() >= 2 else w.shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    z = torch.randn(w.shape, generator=gen, dtype=torch.float32,
                    device=w.device)
    return w.copy_(z.mul_(std))


@torch.no_grad()
def embed_init(gen: torch.Generator, w: torch.Tensor) -> torch.Tensor:
    z = torch.randn(w.shape, generator=gen, dtype=torch.float32,
                    device=w.device)
    return w.copy_(z.mul_(0.02))


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) * 2 / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of x's last axis by the angles `ang`
    (broadcast against x's first half), in float32; x's dtype out."""
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x (..., S, H, D) or (..., S, D); positions (..., S)."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)
    ang = positions.float()[..., None] * freqs             # (..., S, D/2)
    if x.dim() == ang.dim() + 1:                            # head axis
        ang = ang[..., None, :]
    return _rotate(x, ang)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Sequence[int], theta: float = 1e4
                ) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x (B, S, H, D); positions3 (3, B, S),
    the temporal / height / width position ids.  `sections` split the
    D/2 frequencies into three bands, in order; a band's angles come from
    its axis's positions."""
    D = x.shape[-1]
    half = D // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {half}")
    freqs = rope_freqs(D, theta, x.device)                  # (half,)
    # which of t/h/w drives each frequency
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(list(sections), device=x.device))      # (half,)
    ang = positions3.float()[..., None] * freqs             # (3, B, S, half)
    idx = sec_id.expand(1, *ang.shape[1:])
    ang = ang.gather(0, idx)[0]                             # (B, S, half)
    return _rotate(x, ang[..., None, :])                    # head axis


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


class MLP(nn.Module):
    """w_in (d, f), w_out (f, d) and, when gated, w_gate (d, f)."""

    def __init__(self, d: int, f: int, dtype: torch.dtype, device,
                 gated: bool = True):
        super().__init__()
        self.w_in = param((d, f), dtype, device)
        self.w_out = param((f, d), dtype, device)
        self.w_gate = param((d, f), dtype, device) if gated else None


def init_mlp(gen: torch.Generator, p: MLP) -> MLP:
    """Fill `p` with random weights drawn from `gen`."""
    for w in (p.w_in, p.w_out, p.w_gate):
        if w is not None:
            dense_init(gen, w)
    return p


def mlp(p: MLP, x: torch.Tensor, act: str = "silu",
        gated: bool = True) -> torch.Tensor:
    """The (gated) MLP.  Under a `model` mesh axis larger than 1 it runs
    on this rank's columns of w_in / w_gate and rows of w_out, and sums
    the partial outputs over the axis (``models.sharding``)."""
    if sharding.model_parallel():
        xs = sharding.copy_to(x)
        h = xs @ sharding.local(p.w_in, 1)
        if gated:
            g = xs @ sharding.local(p.w_gate, 1)
            h = ops.apply_activation(g, act) * h
        else:
            h = ops.apply_activation(h, act)
        return sharding.reduce_from(h @ sharding.local(p.w_out, 0))
    h = x @ p.w_in
    if gated:
        h = ops.apply_activation(x @ p.w_gate, act) * h
    else:
        h = ops.apply_activation(h, act)
    return h @ p.w_out


# --------------------------------------------------------------------------
# Embedding / LM head
# --------------------------------------------------------------------------


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def lm_logits(head: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """head (d, V) or the tied embedding table (V, d)."""
    if head.shape[0] < head.shape[1]:        # (d, V)
        return h @ head
    return h @ head.T


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy in float32.  logits (..., V); labels
    (...,); `mask` (...,) weights the positions."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


# --------------------------------------------------------------------------
# Fused LM-head + cross-entropy (chunked over positions, custom backward)
# --------------------------------------------------------------------------


class FusedCE(torch.autograd.Function):
    """Mean softmax cross-entropy of ``h @ w`` against `labels` without
    the (B, S, V) float32 logits, the counterpart of ``fused_ce``
    (``repro/models/layers.py:170-243``): the sequence is walked in
    `chunk_s`-position blocks, so one (B, chunk_s, V) block of float32
    logits exists at a time, forward and backward; the backward
    recomputes each block's logits and accumulates dw in float32.
    h (B, S, d); w (d, V); labels (B, S) with -1 = ignore.  Logits are
    ``h.float() @ w.float()`` (float32 products: TF32 stays off, as in
    the rest of the port).

        FusedCE.apply(h, w, labels, chunk_s) -> 0-d float32 loss
    """

    @staticmethod
    def forward(ctx, h, w, labels, chunk_s):
        labels = labels.long()
        ctx.save_for_backward(h, w, labels)
        ctx.chunk_s = chunk_s
        wf = w.float()
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for hb, lb in _ce_chunks(h, labels, chunk_s):
            logits = hb.float() @ wf
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, lb.clamp(min=0)[..., None])[..., 0]
            nll = torch.where(lb >= 0, lse - gold, torch.zeros_like(lse))
            total = total + nll.sum()
        return total / _n_valid(labels)

    @staticmethod
    def backward(ctx, g):
        h, w, labels = ctx.saved_tensors
        wf = w.float()
        scale = g / _n_valid(labels)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dh = torch.empty(h.shape, dtype=torch.float32, device=h.device)
        c0 = 0
        for hb, lb in _ce_chunks(h, labels, ctx.chunk_s):
            hf = hb.float()
            p = torch.softmax(hf @ wf, dim=-1)
            # p - onehot(label) at the valid positions, by subtracting 1
            # at each label (no (B, chunk, V) one-hot), then masked and
            # scaled
            valid = lb >= 0
            p.scatter_add_(-1, lb.clamp(min=0)[..., None],
                           -valid[..., None].float())
            dl = p.mul_((valid.float() * scale)[..., None])
            dh[:, c0:c0 + hb.shape[1]] = dl @ wf.T
            dw.addmm_(hf.reshape(-1, hf.shape[-1]).T,
                      dl.reshape(-1, dl.shape[-1]))
            c0 += hb.shape[1]
            del p, dl
        return dh.to(h.dtype), dw.to(w.dtype), None, None


def _ce_chunks(h: torch.Tensor, labels: torch.Tensor, chunk_s: int):
    """(h, labels) in blocks of `chunk_s` positions."""
    cs = max(1, min(chunk_s, h.shape[1]))
    for c0 in range(0, h.shape[1], cs):
        yield h[:, c0:c0 + cs], labels[:, c0:c0 + cs]


def _n_valid(labels: torch.Tensor) -> torch.Tensor:
    return torch.clamp((labels >= 0).sum(), min=1).float()


def fused_ce(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
             chunk_s: int = 512) -> torch.Tensor:
    """See ``FusedCE``."""
    return FusedCE.apply(h, w, labels, chunk_s)
