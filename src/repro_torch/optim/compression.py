"""Error-feedback int8 gradient compression, the counterpart of
``repro/optim/compression.py``.

Each leaf is compressed with one scale: ``q = clip(round((g + e) /
scale), -127, 127)`` with ``scale = max|g + e| / 127``, and the residual
is carried to the next step.  The reference takes one scale per leaf of
its parameter tree, where a layer's weight is stacked over all the layers
of its scan; the port keeps one tensor per layer, so ``compress_grads``
takes `groups`: the port's tensors that make up each reference leaf
(``models.convert.reference_groups``), whose scale is the max over all of
them together.

Under a mesh a leaf may be split over ``model``: its scale is then the
max over all its shards (``compress_grads(..., sharded=, group=)``: an
all-reduce of the max).  ``cross_pod_mean`` is the all-reduce the
compressed values are meant for: across pods, whose links are the
slowest, int8 values that share one scale are summed exactly as int32.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.models import sharding


def compress_group(gs: Sequence[torch.Tensor], max_groups: Sequence = ()
                   ) -> Tuple[List[torch.Tensor], torch.Tensor,
                              List[torch.Tensor]]:
    """Tensors that form one leaf -> (int8 q of each, the leaf's float32
    scale, the float32 residual of each).  The leaf's max is taken also
    over the ranks of each process group in `max_groups` (the other
    shards of a split leaf, the other pods)."""
    gfs = [g.float() for g in gs]
    amax = torch.stack([gf.abs().max() for gf in gfs]).max()
    for group in max_groups:
        amax = sharding.max_over(amax, group)
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
                   groups: Optional[Sequence[Sequence[int]]] = None,
                   sharded: Optional[Sequence[bool]] = None,
                   group=None, pod_group=None,
                   data_sharded: Optional[Sequence[bool]] = None,
                   data_group=None
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(decompressed grads as synced, in each grad's dtype; the new error
    feedback).  `groups` lists the indices of the tensors that share a
    scale; None gives every tensor its own.  `sharded[i]`: gradient i is
    this rank's shard of a leaf split over the ranks of `group`, whose
    max then enters the scale; `data_sharded[i]` likewise over
    `data_group` (FSDP).  With `pod_group` the compressed values are
    summed across its ranks (``cross_pod_mean``) and the mean is
    returned."""
    if groups is None:
        groups = [[i] for i in range(len(grads))]
    out_g: List[Optional[torch.Tensor]] = [None] * len(grads)
    out_e: List[Optional[torch.Tensor]] = [None] * len(grads)
    for idx in groups:
        max_groups = []
        if sharded is not None and sharded[idx[0]]:
            max_groups.append(group)
        if data_sharded is not None and data_sharded[idx[0]]:
            max_groups.append(data_group)
        if pod_group is not None:
            max_groups.append(pod_group)
        qs, scale, resids = compress_group(
            [grads[i].float() + error[i] for i in idx], max_groups)
        if pod_group is not None:
            qs, n = cross_pod_mean(qs, pod_group)
            scale = scale / n
        for i, q, r in zip(idx, qs, resids):
            out_g[i] = decompress_leaf(q, scale).to(grads[i].dtype)
            out_e[i] = r
    if any(g is None for g in out_g):
        raise ValueError("groups do not cover every gradient")
    return out_g, out_e


def cross_pod_mean(qs: Sequence[torch.Tensor], pod_group
                   ) -> Tuple[List[torch.Tensor], int]:
    """The cross-pod all-reduce of int8 values that share one scale:
    their exact int32 sums over the ranks of `pod_group` (in rank order)
    and the number of pods, by which the caller divides the scale."""
    n = dist.get_world_size(pod_group)
    return [sharding.sum_in_rank_order(q.to(torch.int32), pod_group)
            for q in qs], n
