"""Carry weights across: the JAX package's parameter tree -> the port's LM.

``params_from_numpy(cfg, tree, device)`` takes the tree that
``repro.models.lm.init_params`` returns, as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``), with the leading axes
of the stacked layers:

    dense    layers.{norm1, norm2, attn.*, mlp.*}   stacked over (L,)
    MoE      dense_layers.{..., mlp.*}              over (moe_layer_start,)
             layers.{..., moe.*}                    over (L - that,)
             moe.{router, experts.{w_in, w_gate, w_out}, shared.*}
    MLA      attn.{w_dq, q_norm, w_uq, w_dkv, kv_norm, w_uk, w_uv, wo}
             in place of attn.{wq, wk, wv, wo}
    gemma3   groups.local.{norm1, norm2, attn.*, mlp.*}  over (G, R)
             groups.global.{...}                    over (G,)
             tail.{...}                             over (tail,)
    ssm      layers.{norm, ssm.*}                   over (L,)
    hybrid   groups.ssm.{norm, ssm.*}               over (G, R)
             groups.lora.{q_a, q_b, in_a, in_b}     over (G,)
             shared.{norm1, norm2, attn.*, mlp.*}   one block

so ``tree["layers"]["attn"]["wq"]`` has shape (L, d, Hp*hd).  Weights
keep the JAX layout, so ``x @ w`` is the same product on both sides.  A
leaf whose shape or dtype does not fit, a stack whose leading axes are
not the model's, and a leaf that nothing takes raise ``ValueError``;
the only subtree left out is deepseek-v3's ``mtp`` block, which serves
only the training loss.
"""
from __future__ import annotations

from typing import Dict, Tuple

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


SKIPPED = ("mtp",)


def _leaves(tree: Dict, prefix: Tuple[str, ...] = ()):
    for key, sub in tree.items():
        if isinstance(sub, dict):
            yield from _leaves(sub, prefix + (key,))
        elif sub is not None:
            yield prefix + (key,), sub


@torch.no_grad()
def params_from_numpy(cfg: ArchConfig, tree: Dict, device) -> LM:
    """The port's LM holding the weights of `tree` (see module doc)."""
    model = LM(cfg, device)
    taken = set()

    def stack(path: Tuple[str, ...], lead: Tuple[int, ...]) -> Dict:
        """The subtree at `path`, every leaf of which must lead with the
        axes `lead`."""
        sub = tree
        for key in path:
            sub = sub[key]
        for leaf, a in _leaves(sub, path):
            if tuple(a.shape[:len(lead)]) != lead:
                raise ValueError(f"{'.'.join(leaf)}: {tuple(a.shape)} does "
                                 f"not stack {lead} layers")
        return sub

    def put(dst: torch.Tensor, leaf: np.ndarray, name: str, key: str
            ) -> None:
        """Copy `leaf` into `dst`; `name` says where in the model, `key`
        which leaf of the tree (its path, the stacked axes left out)."""
        taken.add(key)
        t = tensor_from_numpy(leaf, device)
        if tuple(t.shape) != tuple(dst.shape) or t.dtype != dst.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} does not "
                             f"fit {tuple(dst.shape)} {dst.dtype}")
        dst.copy_(t)

    def module(mod: torch.nn.Module, src: Dict, idx, path) -> None:
        """Every parameter of `mod`, from the same names in `src`, the
        subtree at `path` indexed at `idx` (an int or a tuple, one index
        per stacked axis)."""
        idxs = idx if isinstance(idx, tuple) else (idx,)
        # the layer's name: "groups.1.local.3" for path (groups, local)
        where = [f"{c}.{idxs[n]}" if n < len(idxs) else c
                 for n, c in enumerate(path)]
        for name, dst in mod.named_parameters():
            *sub, key = name.split(".")
            s = src
            for k in sub:
                s = s[k]
            put(dst, s[key][idx], ".".join(where + [name]),
                ".".join(path + tuple(sub) + (key,)))

    for key in ("embed", "final_norm", "lm_head"):
        if getattr(model, key) is not None:
            put(getattr(model, key), tree[key], key, key)

    def layers(mods, path):
        src = stack(path, (len(mods),)) if len(mods) else None
        for i, layer in enumerate(mods):
            module(layer, src, i, path)

    if cfg.family == "hybrid":
        G, R = len(model.groups), cfg.shared_attn_every
        ssm = stack(("groups", "ssm"), (G, R))
        lora = stack(("groups", "lora"), (G,))
        for g, group in enumerate(model.groups):
            for r, layer in enumerate(group.ssm):
                module(layer, ssm, (g, r), ("groups", "ssm"))
            module(group.lora, lora, g, ("groups", "lora"))
        module(model.shared, tree["shared"], (), ("shared",))
    elif cfg.local_global_ratio:
        G, R = len(model.groups), cfg.local_global_ratio
        local = stack(("groups", "local"), (G, R))
        glob = stack(("groups", "global"), (G,))
        for g, group in enumerate(model.groups):
            for r, layer in enumerate(group.local):
                module(layer, local, (g, r), ("groups", "local"))
            module(group.global_, glob, g, ("groups", "global"))
        layers(model.tail, ("tail",))
    else:
        if cfg.family != "ssm":
            layers(model.dense_layers, ("dense_layers",))
        layers(model.layers, ("layers",))

    left = sorted(".".join(path) for path, _ in _leaves(tree)
                  if path[0] not in SKIPPED
                  and ".".join(path) not in taken)
    if left:
        raise ValueError(f"leaves of the tree that no parameter takes: "
                         f"{left}")
    return model
