"""Shared layers of the port: norms, rotary embeddings, MLP, embeddings.

Counterpart of ``repro/models/layers.py``.  Parameters live in
``nn.Module``s in the JAX layout (a weight is (d_in, d_out), so ``x @ w``
is the same product); the layers are plain functions
``fn(params, x, ...) -> y`` with the JAX names.  Modules are built with
uninitialised parameters; initialisers fill them in place from an
explicit ``torch.Generator`` on the target device.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from repro_torch.kernels import ops


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def param(shape, dtype: torch.dtype, device) -> nn.Parameter:
    """An uninitialised inference parameter (no gradient)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


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
