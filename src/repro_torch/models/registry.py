"""Architecture registry: configs, shape cells and sharding specs.

Counterpart of ``repro/models/registry.py``: ``get_arch(name)`` resolves
the port's own copies of the configs in ``repro_torch.configs``;
``SHAPES`` holds the four input-shape cells; ``batch_spec``,
``state_specs`` and ``cache_specs`` give the specs (tuples of mesh axis
names, ``models.sharding``) of a batch, of a parameter or training-state
tree in the reference's layout, and of a decode cache.  The shape
functions (``cells``, ``input_specs``, ``abstract_*``, ``build_step``)
belong to the dry run, ROADMAP item 13.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Dict, Optional

from .config import ArchConfig
from .sharding import (_path_str, enforce_divisible, map_with_path,
                       tree_partition_specs)

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
    seq_shard = ss.global_batch < 8          # long-context single stream
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
