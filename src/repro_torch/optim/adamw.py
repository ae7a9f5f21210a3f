"""AdamW with selectable moment precision, the counterpart of
``repro/optim/adamw.py``.

The state mirrors the parameters: ``m`` and ``v`` are lists with one
tensor per parameter, in the order of the parameter list the caller
passes (``list(model.parameters())`` in ``models/train.py``).  AdamW is
elementwise and its global norm a sum over every element, so the port's
per-layer parameters give the reference's stacked update.
``moment_dtype="bfloat16"`` halves the optimizer's memory for the
largest configs.

Unlike the reference, which is functional, ``apply_updates`` updates
parameters and moments in place, one leaf at a time under
``torch.no_grad()``: at full width only one leaf's float32 temporaries
are alive at a time (minitron-4b's embedding, 786M elements, takes 3.1 GB
per float32 temporary).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor            # 0-d int32 on the parameters' device
    m: List[torch.Tensor]
    v: List[torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"       # "bfloat16" for giant configs


def init_state(cfg: AdamWConfig, params: Sequence[torch.Tensor]
               ) -> AdamWState:
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    device = params[0].device if len(params) else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=[torch.zeros(p.shape, dtype=dt, device=p.device) for p in params],
        v=[torch.zeros(p.shape, dtype=dt, device=p.device) for p in params])


def global_norm(tree: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    total = None
    for x in tree:
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Sequence[torch.Tensor],
                  grads: Sequence[torch.Tensor], state: AdamWState,
                  lr_scale: Union[torch.Tensor, float] = 1.0,
                  gnorm: Optional[torch.Tensor] = None
                  ) -> Tuple[Sequence[torch.Tensor], AdamWState]:
    """One AdamW step, the reference's arithmetic: the clip factor from
    the global norm of `grads`, bias correction at the incremented step,
    the update in float32 and each result rounded to its own dtype.
    Updates `params` and the moments in place; returns (params, the new
    state), whose ``step`` is a new tensor.  `gnorm`, when given, is the
    global norm of the gradients (under a mesh: of the full gradients,
    which `grads`, this rank's shards, do not show)."""
    step = state.step + 1
    gn = global_norm(grads) if gnorm is None else gnorm
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0) \
        if cfg.grad_clip else 1.0
    stepf = step.to(torch.float32)
    b1t = 1.0 - torch.pow(cfg.b1, stepf)
    b2t = 1.0 - torch.pow(cfg.b2, stepf)
    lr = cfg.lr * lr_scale
    for p, g, m, v in zip(params, grads, state.m, state.v):
        gf = g.float() * clip
        # m2 = b1 m + (1 - b1) g;  v2 = b2 v + (1 - b2) g g   (float32)
        m2 = m if m.dtype == torch.float32 else m.float()
        m2.mul_(cfg.b1).add_(gf * (1 - cfg.b1))
        v2 = v if v.dtype == torch.float32 else v.float()
        v2.mul_(cfg.b2).add_((gf * (1 - cfg.b2)).mul_(gf))
        del gf
        # delta = (m2 / b1t) / (sqrt(v2 / b2t) + eps) + wd p;  p -= lr delta
        delta = (v2 / b2t).sqrt_().add_(cfg.eps)
        torch.div(m2 / b1t, delta, out=delta)
        p32 = p.float()                 # p itself when it is float32
        delta.add_(cfg.weight_decay * p32)
        p32.sub_(delta.mul_(lr))
        del delta
        if p32 is not p:
            p.copy_(p32)
        if m2 is not m:
            m.copy_(m2)
        if v2 is not v:
            v.copy_(v2)
    return params, AdamWState(step=step, m=state.m, v=state.v)
