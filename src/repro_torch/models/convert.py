"""Carry weights across: the JAX package's parameter tree -> the port's LM.

``params_from_numpy(cfg, tree, device)`` takes the tree that
``repro.models.lm.init_params`` returns, as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``), with the leading layer
axis of the stacked layers: ``tree["layers"]["attn"]["wq"]`` has shape
(L, d, Hp*hd).  Weights keep the JAX layout, so ``x @ w`` is the same
product on both sides.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .config import ArchConfig
from .lm import LM


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
    layers = tree["layers"]
    for i, layer in enumerate(model.layers):
        put(layer.norm1, layers["norm1"][i], f"layers.{i}.norm1")
        put(layer.norm2, layers["norm2"][i], f"layers.{i}.norm2")
        for w in ("wq", "wk", "wv", "wo"):
            put(getattr(layer.attn, w), layers["attn"][w][i],
                f"layers.{i}.attn.{w}")
        for w in ("w_in", "w_out", "w_gate"):
            if getattr(layer.mlp, w) is not None:
                put(getattr(layer.mlp, w), layers["mlp"][w][i],
                    f"layers.{i}.mlp.{w}")
    return model
