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
import torch.distributed as dist
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
        torch.tensor(list(sections), device=x.device),
        output_size=half)                                   # (half,)
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
    """``table[tokens]``; where `table` is this rank's rows of a vocabulary
    split over `model` (``sharding.is_sharded``), the lookup of
    ``sharding.vocab_lookup``."""
    if sharding.is_sharded(table):
        return sharding.vocab_lookup(table, tokens)
    return table[tokens]


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
             chunk_s: int = 512, vocab_parallel: bool = False
             ) -> torch.Tensor:
    """See ``FusedCE``; with `vocab_parallel`, `w` is this rank's columns
    of a head split by vocabulary over `model` (``VocabParallelCE``)."""
    if vocab_parallel and sharding.model_parallel():
        return VocabParallelCE.apply(h, w, labels, chunk_s,
                                     sharding.axis_group("model"))
    return FusedCE.apply(h, w, labels, chunk_s)


# --------------------------------------------------------------------------
# The vocabulary split over `model`: cross-entropy on a rank's slice
# --------------------------------------------------------------------------


def _vocab_lse_gold(logits: torch.Tensor, labels: torch.Tensor, group):
    """Of float32 `logits` (..., V_l), this rank's columns [r V_l,
    (r + 1) V_l) of the rows: the rows' log-sum-exp (the max over the
    group, the sums of exp added in rank order) and the gold logit at
    `labels` (global ids; from the rank that holds it, ``sum_of_one``),
    both (...,) and the same bits on every rank; with the labels' local
    index and whether this rank holds it."""
    Vl = logits.shape[-1]
    m = sharding.max_over(logits.amax(-1), group)
    s = sharding.sum_in_rank_order(
        torch.exp(logits - m[..., None]).sum(-1), group)
    lse = m + torch.log(s)
    local = labels - dist.get_rank(group) * Vl
    mine = (local >= 0) & (local < Vl)
    local = local.clamp(0, Vl - 1)
    gold = logits.gather(-1, local[..., None])[..., 0]
    gold = sharding.sum_of_one(torch.where(mine, gold, torch.zeros_like(gold)),
                               group)
    return lse, gold, local, mine


def _vocab_dlogits(logits: torch.Tensor, lse: torch.Tensor,
                   local: torch.Tensor, mine: torch.Tensor,
                   weight: torch.Tensor) -> torch.Tensor:
    """(softmax - onehot(label)) x `weight` (...,) on this rank's columns,
    in place of `logits`: no communication."""
    p = torch.exp(logits.sub_(lse[..., None]))
    p.scatter_add_(-1, local[..., None], -mine[..., None].float())
    return p.mul_(weight[..., None])


class VocabParallelCE(torch.autograd.Function):
    """``FusedCE`` on a head split by vocabulary over the ranks of
    `group`: w (d, V_l) is this rank's columns [r V_l, (r + 1) V_l), h
    (B, S, d) is replicated over the group, labels (B, S) hold global
    ids (-1 = ignore).  Each `chunk_s`-position block makes its float32
    logits over this rank's columns only; the log-sum-exp and the gold
    logit come from ``_vocab_lse_gold`` (max over the group, sums in
    rank order, the gold logit from its owner), so the loss is the same
    bits on every rank and in every rerun.  The backward recomputes each
    block's local logits from the saved log-sum-exp, builds this rank's
    columns of softmax - onehot and its slice of dw with no
    communication, and sums dh = dl @ w_lᵀ over the group in rank order.
    No atomics.

        VocabParallelCE.apply(h, w, labels, chunk_s, group) -> 0-d loss
    """

    @staticmethod
    def forward(ctx, h, w, labels, chunk_s, group):
        labels = labels.long()
        wf = w.float()
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        lses = []
        for hb, lb in _ce_chunks(h, labels, chunk_s):
            lse, gold, _, _ = _vocab_lse_gold(hb.float() @ wf, lb, group)
            total = total + torch.where(lb >= 0, lse - gold,
                                        torch.zeros_like(lse)).sum()
            lses.append(lse)
        ctx.save_for_backward(h, w, labels, torch.cat(lses, dim=1))
        ctx.chunk_s, ctx.group = chunk_s, group
        return total / _n_valid(labels)

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        wf = w.float()
        Vl = w.shape[1]
        scale = g / _n_valid(labels)
        rank = dist.get_rank(ctx.group)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dh = torch.empty(h.shape, dtype=torch.float32, device=h.device)
        c0 = 0
        for hb, lb in _ce_chunks(h, labels, ctx.chunk_s):
            hf = hb.float()
            c1 = c0 + hb.shape[1]
            local = lb - rank * Vl
            mine = (local >= 0) & (local < Vl)
            dl = _vocab_dlogits(hf @ wf, lse[:, c0:c1],
                                local.clamp(0, Vl - 1), mine,
                                (lb >= 0).float() * scale)
            dh[:, c0:c1] = sharding.sum_in_rank_order(dl @ wf.T, ctx.group)
            dw.addmm_(hf.reshape(-1, hf.shape[-1]).T,
                      dl.reshape(-1, Vl))
            c0 = c1
            del dl
        return dh.to(h.dtype), dw.to(w.dtype), None, None, None


class _VocabParallelLogitsCE(torch.autograd.Function):
    """``cross_entropy`` of logits split by vocabulary over `group`
    (this rank's columns, ``VocabParallelCE``'s layout): the mean
    float32 loss, the same bits on every rank; the backward gives this
    rank's columns of (softmax - onehot) / n_valid."""

    @staticmethod
    def forward(ctx, logits, labels, group):
        labels = labels.long()
        lf = logits.float()
        lse, gold, local, mine = _vocab_lse_gold(lf, labels, group)
        valid = labels >= 0
        ctx.save_for_backward(logits, lse, local, mine, valid)
        n = _n_valid(labels)
        ctx.n = n
        return torch.where(valid, lse - gold, torch.zeros_like(lse)).sum() / n

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, mine, valid = ctx.saved_tensors
        dl = _vocab_dlogits(logits.float().clone(), lse, local, mine,
                            valid.float() * (g / ctx.n))
        return dl.to(logits.dtype), None, None


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                        ) -> torch.Tensor:
    """``cross_entropy`` (no mask) of `logits` that are this rank's
    columns of a vocabulary split over `model`."""
    return _VocabParallelLogitsCE.apply(logits, labels,
                                        sharding.axis_group("model"))
