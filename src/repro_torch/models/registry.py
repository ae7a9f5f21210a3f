"""Architecture x shape registry: configs, input specs, step functions
and shardings; the counterpart of ``repro/models/registry.py``, which
the dry run (``launch/dryrun.py``), the benchmarks and the tests read:

    get_arch(name)              -> ArchConfig (from repro_torch.configs)
    SHAPES                      -> the four assigned input-shape cells
    cells(cfg)                  -> the valid (arch, shape) cells
    input_specs(cfg, shape)     -> dict of meta-tensor model inputs
    abstract_params / abstract_train_state / abstract_cache
                                -> the port's LM, TrainState and cache
                                   built on the meta device
    build_step(cfg, shape)      -> (step fn, args, in/out specs)

Specs are tuples of mesh axis names (``models.sharding``), one entry a
dimension, as the reference's PartitionSpecs.  Nothing here allocates:
the abstract trees are built on ``torch.device("meta")`` (no values are
drawn), where the reference uses ``jax.eval_shape``.  Decode shapes run
``decode_step`` (one token against a full cache); ``long_500k`` exists
only for sub-quadratic archs; the modality frontends are stubs, as in
the reference: ``input_specs`` emits precomputed frame / patch
embeddings.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import lm, sharding
from .config import ArchConfig
from .layers import dtype_of
from .sharding import (_path_str, enforce_divisible, map_with_path,
                       tree_partition_specs)
from .train import (TrainOptions, TrainState, init_train_state,
                    make_train_step)

ARCH_IDS = [
    "zamba2-2.7b", "whisper-tiny", "granite-moe-1b-a400m",
    "deepseek-v3-671b", "mamba2-370m", "minitron-4b", "gemma3-27b",
    "nemotron-4-340b", "granite-20b", "qwen2-vl-2b",
]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_arch(name: str) -> ArchConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def cells(cfg: ArchConfig) -> List[str]:
    """Valid shape cells for this arch (long_500k only sub-quadratic)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out


# --------------------------------------------------------------------------
# Input specs (meta tensors: shapes and dtypes, no storage)
# --------------------------------------------------------------------------

_META = torch.device("meta")


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device=_META)


def input_specs(cfg: ArchConfig, shape: str) -> Dict[str, torch.Tensor]:
    """The model inputs of a cell as meta tensors, with the reference's
    names, shapes and dtypes."""
    ss = SHAPES[shape]
    B, S = ss.global_batch, ss.seq_len
    if ss.kind in ("train", "prefill"):
        batch = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32)}
        if cfg.enc_dec:
            batch["audio_embed"] = _meta(
                (B, cfg.n_audio_frames, cfg.d_model), torch.float32)
        if cfg.family == "vlm":
            batch["vision_embed"] = _meta(
                (B, cfg.n_vision_tokens, cfg.d_model), torch.float32)
        return batch
    # decode: one token + position
    return {"token": _meta((B,), torch.int32), "pos": _meta((), torch.int32)}


def decode_aux_specs(cfg: ArchConfig, shape: str) -> Optional[Dict]:
    """What an encoder-decoder's decode step takes beside the cache:
    the encoder states and each layer's cross K/V, as meta tensors."""
    if not cfg.enc_dec:
        return None
    B = SHAPES[shape].global_batch
    Se = cfg.n_audio_frames
    kv = (cfg.n_layers, B, cfg.n_kv_heads, Se, cfg.head_dim)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return {"enc_states": _meta((B, Se, cfg.d_model), torch.float32),
            "cross_kv": {"k": _meta(kv, dt), "v": _meta(kv, dt)}}


# --------------------------------------------------------------------------
# Abstract state trees (params / optimizer / caches) on the meta device
# --------------------------------------------------------------------------


def abstract_params(cfg: ArchConfig) -> lm.LM:
    """The port's LM on the meta device, with the multi-token-prediction
    block where the config has one (the reference's parameter tree
    carries it)."""
    return lm.init_params(cfg, device=_META, mtp=True)


def abstract_train_state(cfg: ArchConfig,
                         opts: Optional[TrainOptions] = None) -> TrainState:
    """The port's TrainState on the meta device: parameters, moments and,
    with ``compress_grads``, the error feedback; under a mesh, this
    rank's shards (``init_train_state``)."""
    return init_train_state(cfg, device=_META, opts=opts)


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int) -> Dict:
    """``lm.init_cache`` on the meta device; under a mesh, this rank's
    part of each cache."""
    return lm.init_cache(cfg, batch, max_len, device=_META)


def batch_spec(kind: str, with_pod: bool) -> Any:
    """Rows over `data` (and `pod`); a decode batch's token likewise."""
    data = ("pod", "data") if with_pod else "data"
    if kind == "decode":
        return {"token": (data,), "pos": ()}
    return (data, None)


def state_specs(cfg: ArchConfig, state_like, with_pod: bool = False,
                n_model: int = 16):
    """Specs of a parameter tree, or of any tree of the same layout (the
    moments), in the reference's layout: parameters over `model` by the
    rules, and over `data` too with ``cfg.fsdp``.  Q heads are padded to
    a tp_pad multiple; wk/wv stay column-sharded, and attention gathers
    the small kv to replicated when the kv heads do not divide the model
    axis."""
    fsdp = "data" if cfg.fsdp else None
    return tree_partition_specs(state_like, model_axis="model",
                                fsdp_axis=fsdp)


def seq_over_data(global_batch: int) -> bool:
    """Whether a decode batch of `global_batch` rows lays its caches'
    positions over `data` and keeps every row on every rank: the
    reference's long-context single stream (``cache_specs``)."""
    return global_batch < 8


def cache_specs(cfg: ArchConfig, cache_like, shape: str,
                with_pod: bool = False, n_model: int = 16,
                axis_sizes: Optional[Dict[str, int]] = None):
    """KV caches: batch over data (decode_32k) or sequence over data
    (long_500k, B=1); heads over model only when the nominal kv-head
    count divides the model axis, else the SEQUENCE over model (decode
    attention reduces over it: ``attention._decode_seq_sharded``).
    A dimension keeps an axis only where the production sizes divide
    it, as in the reference, or `axis_sizes` (the active mesh's, which
    ``lm.init_cache`` passes to lay a cache out)."""
    ss = SHAPES[shape]
    seq_shard = seq_over_data(ss.global_batch)
    kv_model = "model" if (cfg.n_kv_heads
                           and cfg.n_kv_heads % n_model == 0) else None

    def spec_of(path, leaf):
        ps = _path_str(path)
        nd = len(leaf.shape)
        names = [None] * nd
        if "conv" in ps:          # SSM conv state (..., B, K-1, C)
            names[nd - 3] = "data"
            names[nd - 1] = "model"
        elif "ssd" in ps:         # SSD state (..., B, H, P, N)
            names[nd - 4] = "data"
            names[nd - 3] = "model"
        elif "latent" in ps:      # MLA latent (..., B, S, w)
            names[nd - 2 if seq_shard else nd - 3] = "data"
        else:                     # KV (..., B, Hkv, S, hd)
            if seq_shard:
                names[nd - 2] = "data"
            else:
                names[nd - 4] = "data"
            names[nd - 3] = kv_model
            if kv_model is None and not seq_shard:
                names[nd - 2] = "model"
        return enforce_divisible(tuple(names), tuple(leaf.shape),
                                 axis_sizes)

    return map_with_path(spec_of, cache_like)


# --------------------------------------------------------------------------
# Step builders
# --------------------------------------------------------------------------


@dataclass
class StepBundle:
    fn: Callable
    args: Tuple                   # arguments, in call order
    in_specs: Tuple
    out_specs: Any
    donate: Tuple = ()


def local_part(t: torch.Tensor, spec) -> torch.Tensor:
    """A meta tensor of this rank's part of `t` laid out by `spec` over
    the active mesh (each dimension divided by the sizes of the axes it
    names); `t` itself where nothing splits it."""
    shape = list(t.shape)
    for d, s in enumerate(spec):
        for name in (s if isinstance(s, tuple) else (s,)):
            if name is not None:
                shape[d] //= sharding.mesh_axis_size(name)
    if shape == list(t.shape):
        return t
    return torch.empty(shape, dtype=t.dtype, device=t.device)


def build_step(cfg: ArchConfig, shape: str, with_pod: bool = False,
               n_micro: int = 1, compress: bool = False) -> StepBundle:
    """The cell's step, its arguments and their specs, as the reference's
    ``build_step``: ``make_train_step``'s step with (state, batch), which
    it donates; ``lm.prefill`` with (params, batch); ``lm.decode_step``
    with (params, cache, token, pos[, aux]), which donates the cache;
    the last two under ``torch.no_grad()``, as ``launch.serve`` runs
    them.  The arguments are built on the meta device; under a mesh they are
    this rank's parts (the state and the parameters cut by their specs,
    ``lm.init_cache``'s layout, the batch's rows), with none the global
    shapes.  A decode step's position is the int ``seq_len - 1``: one
    token against a full cache."""
    ss = SHAPES[shape]
    if ss.kind == "train":
        opts = TrainOptions(n_micro=n_micro, compress_grads=compress)
        step = make_train_step(cfg, opts=opts)
        state = abstract_train_state(cfg, opts=opts)
        batch = input_specs(cfg, shape)
        pspec = state_specs(cfg, _reference_tree(cfg, state.params),
                            with_pod)
        sspec = TrainState(pspec, type(state.opt)(step=(), m=pspec,
                                                  v=pspec),
                           pspec if compress else None)
        bspec = {k: batch_spec("train", with_pod) for k in batch}
        batch = {k: local_part(v, bspec[k]) for k, v in batch.items()}
        mspec = {"loss": (), "grad_norm": (), "lr_scale": (), "step": ()}
        return StepBundle(step, (state, batch), (sspec, bspec),
                          (sspec, mspec), donate=(0,))

    params = abstract_params(cfg)
    pspec = state_specs(cfg, _reference_tree(cfg, params), with_pod)
    if sharding.active_mesh() is not None:
        sharding.shard_params(cfg, params)
    vocab_ok = cfg.vocab % 16 == 0
    if ss.kind == "prefill":

        @torch.no_grad()
        def prefill_fn(params, batch):
            return lm.prefill(cfg, params, batch)

        batch = input_specs(cfg, shape)
        bspec = {k: batch_spec("prefill", with_pod) for k in batch}
        batch = {k: local_part(v, bspec[k]) for k, v in batch.items()}
        out = (("pod", "data") if with_pod else "data",
               "model" if vocab_ok else None)
        return StepBundle(prefill_fn, (params, batch), (pspec, bspec), out)

    # decode
    aux = decode_aux_specs(cfg, shape)

    @torch.no_grad()
    def serve_step(params, cache, token, pos, aux_in=None):
        return lm.decode_step(cfg, params, cache, token, pos, aux=aux_in)

    cache = abstract_cache(cfg, ss.global_batch, ss.seq_len)
    ins = input_specs(cfg, shape)
    cspec = cache_specs(cfg, lm._cache_tree(
        cfg, ss.global_batch, ss.seq_len, dtype_of(cfg.dtype), _META),
        shape, with_pod)
    tok_spec = () if seq_over_data(ss.global_batch) else ("data",)
    logits_spec = ("data" if ss.global_batch % 16 == 0 else None,
                   "model" if vocab_ok else None)
    args = [params, cache, local_part(ins["token"], tok_spec),
            ss.seq_len - 1]
    in_specs = [pspec, cspec, tok_spec, ()]
    if aux is not None:
        args.append(aux)
        in_specs.append({"enc_states": (), "cross_kv": {"k": (), "v": ()}})
    return StepBundle(serve_step, tuple(args), tuple(in_specs),
                      (logits_spec, cspec), donate=(1,))


def _reference_tree(cfg: ArchConfig, model: lm.LM) -> Dict:
    """The reference's parameter tree for `model` with meta leaves of the
    full stacked shapes (``convert.reference_leaves``), whatever the
    active mesh has cut: what ``state_specs`` reads."""
    from .convert import _nest, reference_leaves
    return _nest({path: _meta((*lead, *sharding.full_shape(ts[0])),
                              ts[0].dtype)
                  for path, lead, ts in reference_leaves(cfg, model)})
