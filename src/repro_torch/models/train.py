"""Training step: loss -> grads -> AdamW, with microbatching and optional
int8 gradient compression; the counterpart of ``repro/models/train.py``.

``make_train_step(cfg, ...)`` returns

    train_step(state, batch) -> (state, metrics)

with the reference's metric keys ("loss", "grad_norm", "lr_scale",
"step").  Unlike the reference's pure function it updates ``state`` in
place (parameters and moments; see ``optim/adamw.py``) and returns it
with the new step.  The parameters are an ``LM`` module; the moments and
the error feedback are lists in the order of ``model.parameters()``.
``models.convert.train_state_from_numpy`` / ``train_state_to_numpy``
carry a state across to and from the reference's layout.

Every family trains: dense (gemma3's windowed layers included), vlm,
moe, audio (whisper: the batch carries "audio_embed"), ssm and hybrid.
Attention runs through K2 and its backward kernel K2b, the SSD scan
through K4 and K4b; the MoE sort dispatch is plain torch, as the
reference leaves it to XLA.  A config with deepseek-v3's
multi-token-prediction block (``cfg.mtp``) raises: without ``_mtp_loss``
the loss would not be the reference's (ROADMAP item 11c).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import optim, resolve_device
from repro_torch.runtime.overlap import accumulate_grads
from . import lm
from .config import ArchConfig
from .convert import reference_groups

class TrainState(NamedTuple):
    params: lm.LM
    opt: optim.AdamWState
    error_fb: Optional[List[torch.Tensor]] = None  # compression feedback


@dataclass(frozen=True)
class TrainOptions:
    n_micro: int = 1
    compress_grads: bool = False  # int8 error-feedback compression
    lr_schedule: str = "cosine"
    warmup: int = 100
    total_steps: int = 10000


def check_trainable(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for a config this port does not train:
    one with the multi-token-prediction block."""
    lm.check_supported(cfg)
    if cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name}: the multi-token-prediction loss (cfg.mtp) is "
            f"ROADMAP item 11c; training without it would not give the "
            f"reference's loss")


def default_opt_config(cfg: ArchConfig) -> optim.AdamWConfig:
    # bf16 moments for >= 50B-parameter configs, as the reference
    big = cfg.n_params() > 50e9
    return optim.AdamWConfig(
        moment_dtype="bfloat16" if big else "float32")


def init_train_state(cfg: ArchConfig, seed: int = 0, device=None,
                     opt_cfg: Optional[optim.AdamWConfig] = None,
                     opts: Optional[TrainOptions] = None) -> TrainState:
    """Random weights from `seed` on `device` (CUDA unless told
    otherwise; see ``lm.init_params``), zero moments, and zero error
    feedback when compressing."""
    check_trainable(cfg)
    opt_cfg = opt_cfg or default_opt_config(cfg)
    opts = opts or TrainOptions()
    model = lm.init_params(cfg, seed, resolve_device(device))
    model.requires_grad_(True)
    params = list(model.parameters())
    err = optim.init_error(params) if opts.compress_grads else None
    return TrainState(model, optim.init_state(opt_cfg, params), err)


def make_train_step(cfg: ArchConfig,
                    opt_cfg: Optional[optim.AdamWConfig] = None,
                    opts: Optional[TrainOptions] = None) -> Callable:
    check_trainable(cfg)
    opt_cfg = opt_cfg or default_opt_config(cfg)
    opts = opts or TrainOptions()

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        model = state.params
        params = list(model.parameters())
        loss, grads = accumulate_grads(
            lambda b: lm.loss_fn(cfg, model, b), params, batch,
            opts.n_micro)
        err = state.error_fb
        if opts.compress_grads and err is not None:
            grads, err = optim.compress_grads(
                grads, err, groups=reference_groups(cfg, model))
        if opts.lr_schedule == "cosine":
            lr_scale = optim.warmup_cosine(state.opt.step + 1,
                                           opts.warmup, opts.total_steps)
        else:
            lr_scale = optim.constant(state.opt.step)
        gnorm = optim.global_norm(grads)
        _, opt_state = optim.apply_updates(opt_cfg, params, grads,
                                           state.opt, lr_scale)
        metrics = {"loss": loss.float(), "grad_norm": gnorm,
                   "lr_scale": lr_scale, "step": opt_state.step}
        return TrainState(model, opt_state, err), metrics

    return train_step
