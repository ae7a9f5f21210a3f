"""Microbatched gradient accumulation, the counterpart of
``split_microbatches`` and ``accumulate_grads`` of
``repro/runtime/overlap.py``.  The reference scans the microbatches
inside one jit so that GSPMD overlaps each one's gradient reduce-scatter
with the next one's backward; on one card there is no collective to
hide, so here they run one after another.  ``overlap_flags`` (XLA flags)
and ``bucket_tree`` (bucketed all-reduce) belong to the distribution
work, ROADMAP item 12.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch


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
