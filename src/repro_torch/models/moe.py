"""Mixture-of-Experts feed-forward, capacity-bounded.

Counterpart of ``repro/models/moe.py`` on one device: ``init_moe``,
``_router_probs``, the sort dispatch ``_dispatch_sort`` (the JAX
package's default, ``ArchConfig.moe_dispatch = "sort"``), ``moe_dense``
and ``moe``, which here always takes the dense path.  The one-hot
dispatch, which no configuration selects, and the shard_map all-to-all
dispatch (``moe_a2a``), which needs a mesh, are not ported (see
``ROADMAP.md``).

Semantics, as in the JAX package: the float32 router picks the top k
experts of each token and softmaxes their logits into gates; each expert
takes at most ``cap = max(1, ceil(T k / E * capacity_factor))``
assignments of the T tokens, in token-major order, and the rest are
dropped (their gate counts as 0).  The routed experts are gated MLPs run
as batched products over the (E, cap, d) buffers; the shared experts, if
any, see every token.  The JAX package computes all of this outside any
Pallas kernel, so here it is plain PyTorch.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops
from .config import ArchConfig
from .layers import dense_init, param


class Experts(nn.Module):
    """A gated MLP's w_in, w_gate (..., d, f) and w_out (..., f, d): the
    routed experts stacked over (E,), or the shared experts' one MLP."""

    def __init__(self, shape_in: Tuple[int, ...], shape_out: Tuple[int, ...],
                 dtype: torch.dtype, device):
        super().__init__()
        self.w_in = param(shape_in, dtype, device)
        self.w_gate = param(shape_in, dtype, device)
        self.w_out = param(shape_out, dtype, device)


class MoE(nn.Module):
    """router (d, E) float32, experts (E, d, fe) / (E, fe, d) and, with
    `n_shared_experts`, one shared gated MLP of width fe * n_shared.

    ``dropped`` (a 0-d int64 buffer) counts the assignments the capacity
    bound has dropped since it was last zeroed."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype, device):
        super().__init__()
        d, E = cfg.d_model, cfg.n_experts
        fe = cfg.moe_d_ff or cfg.d_ff
        self.router = param((d, E), torch.float32, device)
        self.experts = Experts((E, d, fe), (E, fe, d), dtype, device)
        fs = fe * cfg.n_shared_experts
        self.shared = (Experts((d, fs), (fs, d), dtype, device)
                       if cfg.n_shared_experts else None)
        self.register_buffer(
            "dropped", torch.zeros((), dtype=torch.long, device=device),
            persistent=False)


def init_moe(gen: torch.Generator, p: MoE) -> MoE:
    """Fill `p` with random weights drawn from `gen` (the router at std
    0.02, the experts at 1/sqrt(fan_in), as in the JAX package)."""
    dense_init(gen, p.router, scale=0.02)
    for e in (p.experts, p.shared):
        if e is not None:
            for w in (e.w_in, e.w_gate, e.w_out):
                dense_init(gen, w)
    return p


Combine = Callable[[torch.Tensor], torch.Tensor]


def _router_probs(p: MoE, x2d: torch.Tensor, cfg: ArchConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k gates (T, k) float32 and expert ids (T, k), best first."""
    logits = x2d.float() @ p.router                           # (T, E)
    gates, idx = torch.topk(logits, cfg.top_k, dim=-1)
    return torch.softmax(gates, dim=-1), idx


def _dispatch_sort(x2d: torch.Tensor, gates: torch.Tensor,
                   idx: torch.Tensor, E: int, cap: int
                   ) -> Tuple[torch.Tensor, Combine, torch.Tensor]:
    """Sort-based dispatch, O(T k d): a stable sort of the assignments by
    expert gives each its slot within its expert; tokens are scattered
    into the (E, cap, d) buffers and gathered back.  Each expert keeps
    its first `cap` assignments in token-major order.

    Returns the (E, cap, d) expert buffers, the combine function
    (E, cap, d) -> (T, d) float32 and the kept mask (T, k).

    A dropped assignment is written to one spare row past the E * cap
    buffer rows (the JAX package's out-of-range address, dropped by the
    scatter), so no step depends on how many were dropped.  The combine
    puts the gated outputs back in token-major order and sums each
    token's k of them, in a fixed order: its result does not vary from
    run to run."""
    T, k = idx.shape
    Tk = T * k
    flat_e = idx.reshape(Tk)
    order = torch.argsort(flat_e, stable=True)                # (Tk,)
    sorted_e = flat_e[order]
    seg_first = torch.searchsorted(sorted_e, sorted_e, side="left")
    slot = torch.arange(Tk, device=idx.device) - seg_first    # pos in expert
    keep = slot < cap
    token = order // k
    addr = torch.where(keep, sorted_e * cap + slot,
                       torch.full_like(slot, E * cap))
    xe = x2d.new_zeros((E * cap + 1, x2d.shape[1]))
    xe[addr] = x2d[token]
    xe = xe[:E * cap].reshape(E, cap, x2d.shape[1])
    weight = (keep * gates.reshape(Tk)[order])[:, None]

    def combine(ye: torch.Tensor) -> torch.Tensor:
        ye_flat = ye.reshape(E * cap, -1).float()
        picked = ye_flat[torch.clamp(addr, max=E * cap - 1)] * weight
        by_token = torch.empty_like(picked)
        by_token[order] = picked
        return by_token.view(T, k, -1).sum(1)

    keep_tk = torch.empty_like(keep)
    keep_tk[order] = keep
    return xe, combine, keep_tk.reshape(T, k)


def capacity(cfg: ArchConfig, T: int) -> int:
    """Assignments each expert takes from a batch of T tokens."""
    return max(1, int(math.ceil(T * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


def moe_dense(p: MoE, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Capacity-bounded sort dispatch.  x (B, S, d) -> (B, S, d); adds the
    dropped assignments to ``p.dropped``.  Raises for a
    ``cfg.moe_dispatch`` other than "sort"."""
    if cfg.moe_dispatch != "sort":
        raise NotImplementedError(
            f"moe_dispatch={cfg.moe_dispatch!r} is not ported; only the sort "
            f"dispatch is (ROADMAP.md, speed items: one-hot MoE dispatch)")
    B, S, d = x.shape
    T = B * S
    x2d = x.reshape(T, d)
    gates, idx = _router_probs(p, x2d, cfg)
    xe, combine, keep = _dispatch_sort(x2d, gates, idx, cfg.n_experts,
                                       capacity(cfg, T))
    p.dropped += keep.numel() - keep.sum()
    we = p.experts
    h = torch.bmm(xe, we.w_in)
    if cfg.gated_mlp:
        h = ops.apply_activation(torch.bmm(xe, we.w_gate), cfg.act) * h
    else:
        h = ops.apply_activation(h, cfg.act)
    y = combine(torch.bmm(h, we.w_out)).to(x.dtype)
    if p.shared is not None:
        sh = p.shared
        hs = ops.apply_activation(x2d @ sh.w_gate, cfg.act) * (x2d @ sh.w_in)
        y = y + hs @ sh.w_out
    return y.reshape(B, S, d)


def moe(p: MoE, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The MoE feed-forward of one device: the dense dispatch (the JAX
    package's ``moe`` takes it too wherever no `model` mesh axis is
    larger than 1)."""
    return moe_dense(p, x, cfg)
