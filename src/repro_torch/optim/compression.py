"""Error-feedback int8 gradient compression, the counterpart of
``repro/optim/compression.py``.

Each leaf is compressed with one scale: ``q = clip(round((g + e) /
scale), -127, 127)`` with ``scale = max|g + e| / 127``, and the residual
is carried to the next step.  The reference takes one scale per leaf of
its parameter tree, where a layer's weight is stacked over all the layers
of its scan; the port keeps one tensor per layer, so ``compress_grads``
takes `groups`: the port's tensors that make up each reference leaf
(``models.convert.reference_groups``), whose scale is the max over all of
them together.  The cross-pod all-reduce the compressed values are meant
for is ROADMAP item 12.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def compress_group(gs: Sequence[torch.Tensor]
                   ) -> Tuple[List[torch.Tensor], torch.Tensor,
                              List[torch.Tensor]]:
    """Tensors that form one leaf -> (int8 q of each, the leaf's float32
    scale, the float32 residual of each)."""
    gfs = [g.float() for g in gs]
    amax = torch.stack([gf.abs().max() for gf in gfs]).max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    qs, resids = [], []
    for gf in gfs:
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        qs.append(q)
        resids.append(gf - q.float() * scale)
    return qs, scale, resids


def compress_leaf(g: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g -> (int8 q, scale, residual)."""
    (q,), scale, (resid,) = compress_group([g])
    return q, scale, resid


def decompress_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]


def compress_grads(grads: Sequence[torch.Tensor],
                   error: Sequence[torch.Tensor],
                   groups: Optional[Sequence[Sequence[int]]] = None
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(decompressed grads as synced, in each grad's dtype; the new error
    feedback).  `groups` lists the indices of the tensors that share a
    scale; None gives every tensor its own."""
    if groups is None:
        groups = [[i] for i in range(len(grads))]
    out_g: List[Optional[torch.Tensor]] = [None] * len(grads)
    out_e: List[Optional[torch.Tensor]] = [None] * len(grads)
    for idx in groups:
        qs, scale, resids = compress_group(
            [grads[i].float() + error[i] for i in idx])
        for i, q, r in zip(idx, qs, resids):
            out_g[i] = decompress_leaf(q, scale).to(grads[i].dtype)
            out_e[i] = r
    if any(g is None for g in out_g):
        raise ValueError("groups do not cover every gradient")
    return out_g, out_e
