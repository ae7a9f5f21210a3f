"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

The JAX package (``repro``) is the reference; this package imports
neither it nor ``jax``.  Its layout mirrors ``repro/`` so each module has
an obvious counterpart:

    configs/          architecture configs (data only, copied)
    models/           ArchConfig, registry, layers, attention, lm, convert,
                      train (the training step)
    kernels/          plain PyTorch versions (ref.py), dispatch (ops.py)
                      and the wrappers of the hand-written CUDA kernels
    csrc/             the CUDA C++ sources (sm_90a)
    optim/, data/,    AdamW and schedules, the synthetic data pipeline,
    checkpoint/       checkpoints in the reference's layout
    launch/serve.py   batched greedy serving
    launch/train.py   the training loop

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no GPU and no explicit device they raise (``resolve_device``).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless told otherwise.

    Never falls back to the CPU quietly: with no GPU and no explicit
    ``device`` it raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def is_dtensor(x) -> bool:
    """Whether `x` is a ``torch.distributed.tensor.DTensor`` (read from
    its type, so nothing of ``torch.distributed`` is imported)."""
    return any(c.__name__ == "DTensor" for c in type(x).__mro__)
