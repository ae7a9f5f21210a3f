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
    enc_dec  enc_pos (n_audio_frames, d), enc_norm  top level
             enc_layers.{norm1, norm2, attn.*, mlp.*}  over (n_enc_layers,)
             dec_layers.{..., xattn.*, norm3}       over (L,)
    mtp      mtp.{proj, norm, layer.*}              one block (deepseek-v3)

so ``tree["layers"]["attn"]["wq"]`` has shape (L, d, Hp*hd).  Weights
keep the JAX layout, so ``x @ w`` is the same product on both sides.  A
leaf whose shape or dtype does not fit, a stack whose leading axes are
not the model's, and a leaf that nothing takes raise ``ValueError``.
deepseek-v3's ``mtp`` block is carried when the tree has it (the model
is then built with its ``MTP`` block).

The training state crosses the same way.  ``reference_leaves(cfg,
model)`` lists the leaves of the reference's parameter tree in JAX's
flatten order (dict keys sorted), each with its stacked axes and the
port's per-layer tensors that make it up; ``train_state_from_numpy`` and
``train_state_to_numpy`` (``train_state_to_host``) carry a whole
``TrainState`` (parameters, AdamW step and moments, error feedback)
between the reference's layout, stacked leaves in tree order, and the
port's.  The checkpoint layout (``checkpoint/manager.py``) and the
grouping of ``compress_grads`` (``reference_groups``) come from the same
mapping.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import sharding
from .config import ArchConfig
from .lm import LM

def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array (or a tensor) as a torch tensor on `device`.

    JAX hands bf16 leaves over as ``ml_dtypes.bfloat16`` arrays, which
    ``torch.from_numpy`` refuses; they are reinterpreted bit for bit
    through uint16."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:       # torch.from_numpy wants a writable one
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


#: subtrees of the reference's tree that the port does not carry
SKIPPED = ()


def _leaves(tree: Dict, prefix: Tuple[str, ...] = ()):
    for key, sub in tree.items():
        if isinstance(sub, dict):
            yield from _leaves(sub, prefix + (key,))
        elif sub is not None:
            yield prefix + (key,), sub


@torch.no_grad()
def params_from_numpy(cfg: ArchConfig, tree: Dict, device) -> LM:
    """The port's LM holding the weights of `tree` (see module doc)."""
    model = LM(cfg, device, mtp="mtp" in tree)
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

    for key in ("embed", "final_norm", "lm_head", "enc_pos", "enc_norm"):
        if getattr(model, key, None) is not None:
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
    elif cfg.enc_dec:
        layers(model.enc_layers, ("enc_layers",))
        layers(model.dec_layers, ("dec_layers",))
    else:
        if cfg.family != "ssm":
            layers(model.dense_layers, ("dense_layers",))
        layers(model.layers, ("layers",))
    if model.mtp is not None:
        put(model.mtp.proj, tree["mtp"]["proj"], "mtp.proj", "mtp.proj")
        put(model.mtp.norm, tree["mtp"]["norm"], "mtp.norm", "mtp.norm")
        module(model.mtp.layer, tree["mtp"]["layer"], (), ("mtp", "layer"))

    left = sorted(".".join(path) for path, _ in _leaves(tree)
                  if path[0] not in SKIPPED
                  and ".".join(path) not in taken)
    if left:
        raise ValueError(f"leaves of the tree that no parameter takes: "
                         f"{left}")
    return model


# ==========================================================================
# The training state
# ==========================================================================

#: (path in the reference's tree, stacked leading axes, the port's tensors
#: that make up the leaf, in row-major order of those axes)
LeafMap = List[Tuple[Tuple[str, ...], Tuple[int, ...], List[torch.Tensor]]]


def reference_leaves(cfg: ArchConfig, model: LM) -> LeafMap:
    """Every leaf of the reference's parameter tree for `model`, in JAX's
    flatten order (see module doc)."""
    entries: Dict[Tuple[str, ...], Tuple[Tuple[int, ...], List]] = {}
    for key in ("embed", "final_norm", "lm_head", "enc_pos", "enc_norm"):
        t = getattr(model, key, None)
        if t is not None:
            entries[(key,)] = ((), [t])

    def stack(mods: Sequence[torch.nn.Module], path, lead) -> None:
        if not len(mods):
            return
        for name, _ in mods[0].named_parameters():
            entries[path + tuple(name.split("."))] = (
                lead, [m.get_parameter(name) for m in mods])

    if cfg.family == "hybrid":
        G, R = len(model.groups), cfg.shared_attn_every
        stack([l for g in model.groups for l in g.ssm], ("groups", "ssm"),
              (G, R))
        stack([g.lora for g in model.groups], ("groups", "lora"), (G,))
        stack([model.shared], ("shared",), ())
    elif cfg.local_global_ratio:
        G, R = len(model.groups), cfg.local_global_ratio
        stack([l for g in model.groups for l in g.local],
              ("groups", "local"), (G, R))
        stack([g.global_ for g in model.groups], ("groups", "global"), (G,))
        stack(model.tail, ("tail",), (len(model.tail),))
    elif cfg.enc_dec:
        stack(model.enc_layers, ("enc_layers",), (len(model.enc_layers),))
        stack(model.dec_layers, ("dec_layers",), (len(model.dec_layers),))
    else:
        if cfg.family != "ssm":
            stack(model.dense_layers, ("dense_layers",),
                  (len(model.dense_layers),))
        stack(model.layers, ("layers",), (len(model.layers),))
    if model.mtp is not None:
        entries[("mtp", "proj")] = ((), [model.mtp.proj])
        entries[("mtp", "norm")] = ((), [model.mtp.norm])
        stack([model.mtp.layer], ("mtp", "layer"), ())
    return [(path, *entries[path]) for path in sorted(entries)]


def reference_groups(cfg: ArchConfig, model: LM) -> List[List[int]]:
    """For each reference leaf, the indices in ``list(model.parameters())``
    of the tensors that make it up (``optim.compress_grads``' groups)."""
    index = {id(p): i for i, p in enumerate(model.parameters())}
    return [[index[id(t)] for t in ts]
            for _, _, ts in reference_leaves(cfg, model)]


def _nest(flat: Dict[Tuple[str, ...], Any]) -> Dict:
    tree: Dict = {}
    for path, leaf in flat.items():
        sub = tree
        for key in path[:-1]:
            sub = sub.setdefault(key, {})
        sub[path[-1]] = leaf
    return tree


def _lookup(tree: Dict, path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def _host(ts: Sequence[torch.Tensor], lead: Tuple[int, ...]
          ) -> torch.Tensor:
    """A new host tensor: the stack of `ts` shaped (*lead, *shape), or the
    one tensor of an unstacked leaf, copied also when it lies on the
    CPU."""
    if not lead:
        return ts[0].detach().to("cpu", copy=True)
    return torch.stack([t.detach().cpu() for t in ts]).reshape(
        *lead, *ts[0].shape)


def stack_reference_tree(cfg: ArchConfig, model: LM,
                         tensors: Sequence[torch.Tensor]) -> Dict:
    """`tensors`, one per parameter of `model` in the order of
    ``model.parameters()`` (its moments, say), as the reference's nested
    dict with stacked leaves: new host tensors that share no memory with
    `tensors`.  Under a mesh each is first gathered in full
    (``sharding.full_tensor``; every rank calls this)."""
    index = {id(p): i for i, p in enumerate(model.parameters())}
    return _nest({path: _host([sharding.full_tensor(t, tensors[index[id(t)]])
                               for t in ts], lead)
                  for path, lead, ts in reference_leaves(cfg, model)})


def split_reference_tree(cfg: ArchConfig, model: LM, tree: Dict,
                         device) -> List[torch.Tensor]:
    """The inverse of ``stack_reference_tree``: a reference-layout nested
    dict (numpy arrays or tensors) as one new tensor on `device` per
    parameter of `model`, in the order of ``model.parameters()``; dtypes
    are the tree's."""
    index = {id(p): i for i, p in enumerate(model.parameters())}
    out: List = [None] * len(index)
    for path, lead, ts in reference_leaves(cfg, model):
        a = tensor_from_numpy(_lookup(tree, path), device)
        shape = sharding.full_shape(ts[0])
        if tuple(a.shape) != (*lead, *shape):
            raise ValueError(f"{'.'.join(path)}: {tuple(a.shape)} does not "
                             f"fit {(*lead, *shape)}")
        a = a.reshape(-1, *shape)
        for n, t in enumerate(ts):
            out[index[id(t)]] = a[n].clone()
    return out


def train_state_to_host(cfg: ArchConfig, state) -> Any:
    """The port's ``TrainState`` in the reference's layout: a
    ``TrainState(params, AdamWState(step, m, v), error_fb)`` of nested
    dicts (``error_fb`` None without compression) whose leaves are new
    host tensors, stacked as the reference stacks them.  Nothing of it
    shares memory with `state`."""
    from repro_torch.optim import AdamWState
    from .train import TrainState
    model, opt = state.params, state.opt

    def tree(ts):
        return stack_reference_tree(cfg, model, ts)

    return TrainState(
        params=tree(list(model.parameters())),
        opt=AdamWState(step=opt.step.detach().to("cpu", copy=True),
                       m=tree(opt.m), v=tree(opt.v)),
        error_fb=None if state.error_fb is None else tree(state.error_fb))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as a numpy array; bf16 as ``ml_dtypes.bfloat16``
    (imported here: only callers that hand arrays to JAX need it)."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def train_state_to_numpy(cfg: ArchConfig, state) -> Any:
    """``train_state_to_host`` with numpy leaves (see ``_to_numpy``)."""
    host = train_state_to_host(cfg, state)

    def conv(tree):
        if tree is None:
            return None
        return {k: conv(v) if isinstance(v, dict) else _to_numpy(v)
                for k, v in tree.items()}
    return type(host)(
        params=conv(host.params),
        opt=type(host.opt)(step=_to_numpy(host.opt.step), m=conv(host.opt.m),
                           v=conv(host.opt.v)),
        error_fb=conv(host.error_fb))


def train_state_from_numpy(cfg: ArchConfig, tree, device) -> Any:
    """The port's ``TrainState`` on `device` from a reference-layout state
    (``.params``, ``.opt.step``, ``.opt.m``, ``.opt.v``, ``.error_fb``
    with stacked leaves, numpy arrays or host tensors): the reference's
    own ``TrainState`` mapped to numpy, ``train_state_to_host``'s output,
    or a restored checkpoint.  The moments and the error feedback keep
    the dtypes of the tree; the parameters require grad.  Under a mesh
    every tensor is cut to this rank's shard (``sharding.shard_params``,
    ``sharding.shard_like``)."""
    from repro_torch.optim import AdamWState
    from .train import TrainState
    model = params_from_numpy(cfg, tree.params, device)
    if sharding.active_mesh() is not None:
        sharding.shard_params(cfg, model)
    model.requires_grad_(True)
    params = list(model.parameters())

    def split(src: Dict) -> List[torch.Tensor]:
        full = split_reference_tree(cfg, model, src, device)
        return [sharding.shard_like(p, t) for p, t in zip(params, full)]

    opt = tree.opt
    step = tensor_from_numpy(opt.step, device).to(torch.int32).reshape(())
    return TrainState(
        params=model,
        opt=AdamWState(step=step,
                       m=split(opt.m), v=split(opt.v)),
        error_fb=None if tree.error_fb is None else split(tree.error_fb))
