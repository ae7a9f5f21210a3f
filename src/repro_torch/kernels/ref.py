"""Plain PyTorch versions of the kernels of the serving slice.

Counterpart of ``repro/kernels/ref.py``.  These are the semantics of the
hand-written CUDA kernels: the CPU path of ``ops.py``, and the value
that the tests and ``chip_smoke.py`` hold each kernel against on the
card.  They run on whatever device their inputs lie on.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Fused-epilogue activations (the Neutron activation engine, paper §III-B)
# --------------------------------------------------------------------------


def apply_activation(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act in ("none", None):
        return x
    if act == "relu":
        return F.relu(x)
    if act == "relu6":
        return torch.clamp(x, 0, 6)
    if act == "silu":
        return F.silu(x)
    if act == "gelu":                          # jax.nn.gelu's tanh form
        return F.gelu(x, approximate="tanh")
    if act == "sigmoid":
        return torch.sigmoid(x)
    if act == "sqrelu":                        # nemotron-4 squared ReLU
        r = F.relu(x)
        return r * r
    if act == "mish":
        return x * torch.tanh(F.softplus(x))
    raise ValueError(f"unknown activation {act!r}")


ACTIVATIONS = ("none", "relu", "relu6", "silu", "gelu", "sigmoid",
               "sqrelu", "mish")


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None,
                        sm_scale: Optional[float] = None,
                        block_k: int = 512) -> torch.Tensor:
    """Streaming-softmax attention, O(S·block_k) memory.

    q (B,H,S,D); k (B,H,Sk,D); v (B,H,Sk,Dv): the heads of q and k/v are
    equal here (``ops.flash_attention`` repeats grouped kv heads first).
    """
    B, H, S, D = q.shape
    Dv = v.shape[-1]
    Sk = k.shape[2]
    sm_scale = sm_scale or 1.0 / math.sqrt(D)
    block_k = min(block_k, Sk)
    nk = math.ceil(Sk / block_k)
    qf = q.float()
    qi = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, H, S), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, Dv), dtype=torch.float32, device=q.device)
    for j in range(nk):
        kc = k[:, :, j * block_k:(j + 1) * block_k].float()
        vc = v[:, :, j * block_k:(j + 1) * block_k].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kc) * sm_scale
        kj = j * block_k + torch.arange(kc.shape[2], device=q.device)[None]
        mask = kj < Sk
        if causal:
            mask = mask & (kj <= qi)
        if window is not None:
            mask = mask & (qi - kj < window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vc)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: Optional[torch.Tensor] = None,
                     sm_scale: Optional[float] = None,
                     return_lse: bool = False):
    """Single-token decode attention.  q (B,H,D); k (B,H,S,D);
    v (B,H,S,Dv).

    `kv_len` (B,) masks the valid prefix of the cache.  With
    ``return_lse`` the (B,H) log-sum-exp is returned as well.  With
    ``kv_len == 0`` this gives the mean of v where the kernel gives 0.
    """
    B, H, S, D = k.shape
    sm_scale = sm_scale or 1.0 / math.sqrt(D)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) * sm_scale
    if kv_len is not None:
        mask = (torch.arange(S, device=k.device)[None, None, :]
                < kv_len.to(k.device)[:, None, None])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    o = torch.einsum("bhk,bhkd->bhd", p, v.float())
    o = (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    if return_lse:
        lse = m[..., 0] + torch.log(torch.clamp(l, min=1e-30))
        return o, lse
    return o
