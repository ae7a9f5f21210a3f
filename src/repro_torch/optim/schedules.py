"""Learning-rate schedules (warmup + cosine decay), the counterpart of
``repro/optim/schedules.py``.  `step` is a number or a tensor; the result
is a float32 0-d tensor on the step's device (the CPU for a number)."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(x, dtype=torch.float32)


def warmup_cosine(step, warmup: int = 100, total: int = 10000,
                  floor: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos


def constant(step, value: float = 1.0) -> torch.Tensor:
    device = step.device if isinstance(step, torch.Tensor) else None
    return torch.full((), value, dtype=torch.float32, device=device)
