"""Compute/communication overlap, the counterpart of
``repro/runtime/overlap.py``.

  * **Microbatched gradient accumulation** (``split_microbatches``,
    ``accumulate_grads``).  The reference scans the microbatches inside
    one jit so that GSPMD overlaps each one's gradient reduce-scatter
    with the next one's backward; here they run one after another.
  * **Bucketed gradient sync** (``bucket_tree``): leaves grouped into
    buckets of about ``bucket_bytes``, so that the data-parallel
    all-reduce of the training step (``models.train``) sends a few large
    messages instead of one per leaf.
  * ``overlap_flags``: the XLA flags the reference's launcher would set
    for latency-hiding collectives on a TPU.  They have no torch
    counterpart; the function returns the reference's dict for the
    record, and nothing in the port reads it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch


def overlap_flags() -> Dict[str, str]:
    """The reference's XLA flags for async collectives and its
    latency-hiding scheduler, unchanged (no torch counterpart)."""
    return {
        "xla_tpu_enable_async_collective_fusion": "true",
        "xla_tpu_enable_async_collective_fusion_fuse_all_gather": "true",
        "xla_tpu_overlap_compute_collective_tc": "true",
        "xla_enable_async_all_gather": "true",
        "xla_enable_async_collective_permute": "true",
    }


def _tree_leaves(tree: Any) -> List[Any]:
    """Leaves in the reference's flatten order: dict keys sorted, lists
    and tuples in order; None is no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [] if tree is None else [tree]


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(leaf.size) * leaf.dtype.itemsize


def bucket_tree(tree: Any, bucket_bytes: int = 4 << 20
                ) -> List[List[Tuple[int, Any]]]:
    """Greedy size-bucketing of the leaves (index, leaf) of `tree` (a
    nested dict, a list of tensors, numpy arrays or tensors): a bucket
    closes before the leaf that would take it past `bucket_bytes`."""
    buckets: List[List[Tuple[int, Any]]] = []
    cur: List[Tuple[int, Any]] = []
    size = 0
    for i, leaf in enumerate(_tree_leaves(tree)):
        b = _nbytes(leaf)
        if cur and size + b > bucket_bytes:
            buckets.append(cur)
            cur, size = [], 0
        cur.append((i, leaf))
        size += b
    if cur:
        buckets.append(cur)
    return buckets


def split_microbatches(batch: Dict, n_micro: int) -> Dict:
    """(B, ...) -> (n_micro, B/n_micro, ...) for every array or tensor of
    `batch`."""

    def sp(x):
        B = x.shape[0]
        assert B % n_micro == 0, (B, n_micro)
        return x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))

    return {k: sp(x) for k, x in batch.items()}


def accumulate_grads(loss_fn: Callable[[Dict], torch.Tensor],
                     params: Sequence[torch.Tensor], batch: Dict,
                     n_micro: int
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Mean loss (float32, detached) and grads of `params` over `n_micro`
    microbatches of `batch`; ``loss_fn(batch)`` returns the scalar loss.
    With more than one microbatch the sums are float32, as the
    reference's, and each mean is rounded to its parameter's dtype at the
    end (the reference keeps them float32; the same for float32
    parameters, half the memory for bf16 ones)."""
    if n_micro <= 1:
        loss = loss_fn(batch)
        grads = torch.autograd.grad(loss, list(params))
        return loss.detach(), list(grads)
    mb = split_microbatches(batch, n_micro)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in params]
    total = None
    for i in range(n_micro):
        loss = loss_fn({k: x[i] for k, x in mb.items()})
        grads = torch.autograd.grad(loss, list(params))
        for a, g in zip(acc, grads):
            a.add_(g.float())
        loss = loss.detach().float()
        total = loss if total is None else total + loss
        del grads
    inv = 1.0 / n_micro
    return total * inv, [(a * inv).to(p.dtype) for a, p in zip(acc, params)]
