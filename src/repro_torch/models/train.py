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
moe (deepseek-v3 with its multi-token-prediction loss), audio (whisper:
the batch carries "audio_embed"), ssm and hybrid.  Attention runs
through K2 and its backward kernel K2b, the SSD scan through K4 and
K4b; the MoE sort dispatch is plain torch, as the reference leaves it
to XLA.

Under a mesh (``launch.mesh.use_mesh``) the state is laid out by the
specs (``sharding.shard_params``: the moments and the error feedback
like their parameters), each rank's batch holds its rows of the global
batch (over `data`, and `pod`), and the step averages the loss and the
gradients over the data ranks, bucket by bucket (``bucket_tree``), in
rank order; the grad norm is that of the full gradients.  With
``compress_grads`` over pods, the int8 values cross the pods
(``optim.compression.cross_pod_mean``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import optim, resolve_device
from repro_torch.runtime.overlap import accumulate_grads, bucket_tree
from . import lm, sharding
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
    one of a family it does not know."""
    lm.check_supported(cfg)


def default_opt_config(cfg: ArchConfig) -> optim.AdamWConfig:
    # bf16 moments for >= 50B-parameter configs, as the reference
    big = cfg.n_params() > 50e9
    return optim.AdamWConfig(
        moment_dtype="bfloat16" if big else "float32")


def init_train_state(cfg: ArchConfig, seed: int = 0, device=None,
                     opt_cfg: Optional[optim.AdamWConfig] = None,
                     opts: Optional[TrainOptions] = None) -> TrainState:
    """Random weights from `seed` on `device` (CUDA unless told
    otherwise; see ``lm.init_params``; the multi-token-prediction block
    too where the config has one), zero moments, and zero error
    feedback when compressing.  Under a mesh every rank draws the same
    weights and keeps its shards."""
    check_trainable(cfg)
    opt_cfg = opt_cfg or default_opt_config(cfg)
    opts = opts or TrainOptions()
    model = lm.init_params(cfg, seed, resolve_device(device), mtp=True)
    if sharding.active_mesh() is not None:
        sharding.shard_params(cfg, model)
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
        loss, grads = data_parallel_mean(loss, grads, "data")
        pods = sharding.mesh_axis_size("pod") > 1
        err = state.error_fb
        if opts.compress_grads and err is not None:
            mp = sharding.model_parallel()
            grads, err = optim.compress_grads(
                grads, err, groups=reference_groups(cfg, model),
                sharded=[sharding.is_sharded(p) for p in params],
                group=sharding.axis_group("model") if mp else None,
                pod_group=sharding.axis_group("pod") if pods else None)
            loss, _ = data_parallel_mean(loss, [], "pod")
        elif pods:
            loss, grads = data_parallel_mean(loss, grads, "pod")
        if opts.lr_schedule == "cosine":
            lr_scale = optim.warmup_cosine(state.opt.step + 1,
                                           opts.warmup, opts.total_steps)
        else:
            lr_scale = optim.constant(state.opt.step)
        if sharding.model_parallel():
            gnorm = torch.sqrt(sharding.sharded_sum_squares(grads, params))
        else:
            gnorm = optim.global_norm(grads)
        _, opt_state = optim.apply_updates(opt_cfg, params, grads,
                                           state.opt, lr_scale, gnorm=gnorm)
        metrics = {"loss": loss.float(), "grad_norm": gnorm,
                   "lr_scale": lr_scale, "step": opt_state.step}
        return TrainState(model, opt_state, err), metrics

    return train_step


def data_parallel_mean(loss: torch.Tensor, grads: List[torch.Tensor],
                       axis: str) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The mean over the ranks of mesh axis `axis` of the loss and of each
    gradient, summed in rank order in float32: the gradients bucket by
    bucket (``bucket_tree``, ~4 MB each), each bucket one flat message.
    Every rank's batch holds the same number of tokens, so the mean of
    the ranks' means is the global mean.  Unchanged where the axis is 1
    or absent."""
    n = sharding.mesh_axis_size(axis)
    if n == 1:
        return loss, grads
    group = sharding.axis_group(axis)
    loss = sharding.sum_in_rank_order(loss.detach().float().reshape(1),
                                      group).reshape(()) / n
    out = list(grads)
    for bucket in bucket_tree(list(grads)):
        flat = torch.cat([g.float().reshape(-1) for _, g in bucket])
        flat = sharding.sum_in_rank_order(flat, group) / n
        at = 0
        for i, g in bucket:
            out[i] = flat[at:at + g.numel()].view(g.shape).to(g.dtype)
            at += g.numel()
    return loss, out
