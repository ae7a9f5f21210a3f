"""Mixture-of-Experts feed-forward, capacity-bounded.

Counterpart of ``repro/models/moe.py``: ``init_moe``, ``_router_probs``,
the sort dispatch ``_dispatch_sort`` (the JAX package's default,
``ArchConfig.moe_dispatch = "sort"``), ``moe_dense``, the expert-parallel
``moe_a2a`` and ``moe``, which chooses between them as the reference's
``impl="auto"`` does.  The one-hot dispatch, which no configuration
selects, is not ported (see ``ROADMAP.md``).

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
from . import sharding
from .config import ArchConfig
from .layers import dense_init, in_recompute, mlp, param


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
    bound has dropped since it was last zeroed, once per forward also
    under remat."""

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
    return _top_k(x2d.float() @ p.router, cfg)                # (T, E)


def _top_k(logits: torch.Tensor, cfg: ArchConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
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
    dropped assignments to ``p.dropped``, once a forward: not in remat's
    recomputation of the layer in the backward (``layers.recomputing``).
    Differentiable by autograd: the router's gradient flows through the
    kept assignments' top-k gates, as in the reference.  Raises for a
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
    if not in_recompute():      # remat runs the layer again in backward
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


def moe_a2a(p: MoE, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Expert parallelism over the `model` axis, the reference's
    ``moe_a2a``: each rank takes its slice of the sequence (S / n
    tokens of each of its rows), routes and dispatches those tokens
    itself, with the capacity of its own token count, sends each
    expert's (cap, d) buffer to the rank that owns the expert
    (``all_to_all``), runs its E / n experts on the buffers of every
    rank, sends the outputs back and combines them; the sequence slices
    are gathered again.  So where tokens drop, the result differs from
    ``moe_dense``'s, as the reference's does.  The shared experts, if
    any, run on every token as the tensor-parallel MLP.  Requires
    E % n == 0 and S % n == 0."""
    E, n = cfg.n_experts, sharding.mesh_axis_size("model")
    if E % n or x.shape[1] % n:
        raise ValueError(f"moe_a2a needs E={E} and S={x.shape[1]} to split "
                         f"over a model axis of {n}")
    e_loc = E // n
    d = x.shape[-1]
    xl = sharding.scatter_to(x, 1)                 # (B, S / n, d)
    Bl, Sl = xl.shape[:2]
    T = Bl * Sl
    x2d = xl.reshape(T, d)
    # the router is replicated, but each rank routes its own tokens: its
    # gradient is summed over `model`
    gates, idx = _top_k(x2d.float() @ sharding.replicated(p.router), cfg)
    cap = capacity(cfg, T)
    xe, combine, keep = _dispatch_sort(x2d, gates, idx, E, cap)
    if not in_recompute():
        p.dropped += keep.numel() - keep.sum()
    # each rank keeps its experts' buffers from every rank:
    # (n, e_loc, cap, d) -> (e_loc, n * cap, d)
    xe = sharding.all_to_all(xe.reshape(n, e_loc, cap, d))
    xe = xe.transpose(0, 1).reshape(e_loc, n * cap, d)
    we = p.experts
    h = torch.bmm(xe, sharding.local(we.w_in, 0))
    if cfg.gated_mlp:
        g = torch.bmm(xe, sharding.local(we.w_gate, 0))
        h = ops.apply_activation(g, cfg.act) * h
    else:
        h = ops.apply_activation(h, cfg.act)
    ye = torch.bmm(h, sharding.local(we.w_out, 0))
    ye = ye.reshape(e_loc, n, cap, d).transpose(0, 1)
    ye = sharding.all_to_all(ye).reshape(E, cap, d)
    y = combine(ye).to(x.dtype).reshape(Bl, Sl, d)
    y = sharding.gather_from(y, 1)
    if p.shared is not None:
        y = y + mlp(p.shared, x, act=cfg.act, gated=True)
    return y


def moe(p: MoE, x: torch.Tensor, cfg: ArchConfig, impl: str = "auto"
        ) -> torch.Tensor:
    """auto: ``moe_a2a`` whenever a `model` axis larger than 1 is active
    and the expert count and the sequence split over it; the dense
    dispatch otherwise, as the reference.  Under a mesh the dense
    dispatch sees what the reference's sees, the global batch
    (``_moe_dense_data``), with the experts in full over `model`
    (``sharding.gathered``: only where the model axis does not split
    them or the sequence)."""
    if impl not in ("auto", "a2a", "dense"):
        raise ValueError(f"impl must be auto, a2a or dense; got {impl!r}")
    n = sharding.mesh_axis_size("model")
    if impl != "dense" and n > 1 and cfg.n_experts % n == 0 \
            and x.shape[1] % n == 0:
        return moe_a2a(p, x, cfg)
    if impl == "a2a":
        raise ValueError(f"moe_a2a needs a model axis that divides "
                         f"E={cfg.n_experts} and S={x.shape[1]}")
    if sharding.mesh_axis_size("data") == 1:
        return moe_dense(sharding.gathered(p), x, cfg)
    return _moe_dense_data(sharding.gathered(p), x, cfg)


def _moe_dense_data(p: MoE, x: torch.Tensor, cfg: ArchConfig
                    ) -> torch.Tensor:
    """The dense dispatch over a `data` axis of nd > 1, on the global
    batch as the reference's: every rank gathers the rows of every rank
    (``sharding.gather_rows``), routes them and fills the (E, cap, d)
    buffers at the global batch's capacity; then each runs only its
    E / nd experts (all of them where nd does not divide E) and the
    outputs are gathered over `data`, so each rank combines its own
    rows.  x (B, S, d), this rank's rows -> (B, S, d).  The experts'
    weights stay replicated over `data`: each rank's gradient holds its
    experts' share of every rank's loss, and the data-parallel sum of
    the gradients adds the shares up."""
    if cfg.moe_dispatch != "sort":
        return moe_dense(p, x, cfg)         # raises, naming the dispatch
    nd, rd = sharding.mesh_axis_size("data"), sharding.axis_rank("data")
    B, S, d = x.shape
    E = cfg.n_experts
    xg = sharding.gather_rows(x, 0)
    T = xg.shape[0] * S
    x2d = xg.reshape(T, d)
    gates, idx = _router_probs(p, x2d, cfg)
    xe, combine, keep = _dispatch_sort(x2d, gates, idx, E, capacity(cfg, T))
    if not in_recompute():
        p.dropped += keep.numel() - keep.sum()
    split = E % nd == 0
    mine = slice(rd * (E // nd), (rd + 1) * (E // nd)) if split \
        else slice(None)
    we = p.experts
    xe = xe[mine]
    h = torch.bmm(xe, we.w_in[mine])
    if cfg.gated_mlp:
        h = ops.apply_activation(torch.bmm(xe, we.w_gate[mine]),
                                 cfg.act) * h
    else:
        h = ops.apply_activation(h, cfg.act)
    ye = torch.bmm(h, we.w_out[mine])
    if split:
        ye = sharding.gather_rows(ye, 0)
    y = combine(ye).to(x.dtype).reshape(nd * B, S, d).narrow(0, rd * B, B)
    if p.shared is not None:
        sh = p.shared
        x2l = x.reshape(B * S, d)
        hs = ops.apply_activation(x2l @ sh.w_gate, cfg.act) * (x2l @ sh.w_in)
        y = y + (hs @ sh.w_out).reshape(B, S, d)
    return y
