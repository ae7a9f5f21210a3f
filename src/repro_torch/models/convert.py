"""Carry weights across: the JAX package's parameter tree -> the port's LM.

``params_from_numpy(cfg, tree, device)`` takes the tree that
``repro.models.lm.init_params`` returns, as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``), with the leading axes
of the stacked layers:

    dense   layers.{norm1, norm2, attn.*, mlp.*}   stacked over (L,)
    ssm     layers.{norm, ssm.*}                   stacked over (L,)
    hybrid  groups.ssm.{norm, ssm.*}               stacked over (G, R)
            groups.lora.{q_a, q_b, in_a, in_b}     stacked over (G,)
            shared.{norm1, norm2, attn.*, mlp.*}   one block

so ``tree["layers"]["attn"]["wq"]`` has shape (L, d, Hp*hd).  Weights
keep the JAX layout, so ``x @ w`` is the same product on both sides.  A
leaf whose shape or dtype does not fit raises ``ValueError``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .config import ArchConfig
from .lm import LM

_SSM_LEAVES = ("ssm_in", "conv_w", "A_log", "D", "dt_bias", "gnorm",
               "ssm_out")


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a torch tensor on `device`.

    JAX hands bf16 leaves over as ``ml_dtypes.bfloat16`` arrays, which
    ``torch.from_numpy`` refuses; they are reinterpreted bit for bit
    through uint16."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:       # torch.from_numpy wants a writable one
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


@torch.no_grad()
def params_from_numpy(cfg: ArchConfig, tree: Dict, device) -> LM:
    """The port's LM holding the weights of `tree` (see module doc)."""
    model = LM(cfg, device)

    def put(dst: torch.Tensor, src: np.ndarray, name: str) -> None:
        t = tensor_from_numpy(src, device)
        if tuple(t.shape) != tuple(dst.shape) or t.dtype != dst.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} does not "
                             f"fit {tuple(dst.shape)} {dst.dtype}")
        dst.copy_(t)

    put(model.embed, tree["embed"], "embed")
    put(model.final_norm, tree["final_norm"], "final_norm")
    if model.lm_head is not None:
        put(model.lm_head, tree["lm_head"], "lm_head")

    def decoder_layer(layer, src, idx, name):
        put(layer.norm1, src["norm1"][idx], f"{name}.norm1")
        put(layer.norm2, src["norm2"][idx], f"{name}.norm2")
        for w in ("wq", "wk", "wv", "wo"):
            put(getattr(layer.attn, w), src["attn"][w][idx],
                f"{name}.attn.{w}")
        for w in ("w_in", "w_out", "w_gate"):
            if getattr(layer.mlp, w) is not None:
                put(getattr(layer.mlp, w), src["mlp"][w][idx],
                    f"{name}.mlp.{w}")

    def ssm_layer(layer, src, idx, name):
        put(layer.norm, src["norm"][idx], f"{name}.norm")
        for w in _SSM_LEAVES:
            put(getattr(layer.ssm, w), src["ssm"][w][idx], f"{name}.ssm.{w}")

    if cfg.family == "hybrid":
        groups = tree["groups"]
        for g, group in enumerate(model.groups):
            for r, layer in enumerate(group.ssm):
                ssm_layer(layer, groups["ssm"], (g, r),
                          f"groups.{g}.ssm.{r}")
            for w in ("q_a", "q_b", "in_a", "in_b"):
                put(getattr(group.lora, w), groups["lora"][w][g],
                    f"groups.{g}.lora.{w}")
        decoder_layer(model.shared, tree["shared"], (), "shared")
    else:
        layer_fn = ssm_layer if cfg.family == "ssm" else decoder_layer
        for i, layer in enumerate(model.layers):
            layer_fn(layer, tree["layers"], i, f"layers.{i}")
    return model
