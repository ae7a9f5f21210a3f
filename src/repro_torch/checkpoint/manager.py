"""Fault-tolerant checkpointing: atomic, process-sharded, async; the
counterpart of ``repro/checkpoint/manager.py``, with its on-disk layout:

    <dir>/step_<N>/shard_<host>.npz     leaf_<i>: the flattened arrays
    <dir>/step_<N>/MANIFEST.json        step, leaf count, shard count,
                                        per-shard checksums, dtypes
                                        (written LAST)

so a checkpoint crosses packages both ways.  A tree is flattened as
``jax.tree_util`` flattens one: NamedTuples, tuples and lists in order,
dicts by sorted key, None as no leaf.  The port saves its training state
as ``models.convert.train_state_to_host`` lays it out, the reference's
``TrainState`` with stacked leaves, so ``leaf_<i>`` is the reference's
i-th leaf.  bf16 leaves are stored as a uint8 byte view with
"bfloat16" in the manifest's dtypes, as the reference stores them; a
restore returns host tensors (torch holds bf16 without ``ml_dtypes``).

The manifest is the commit record: a step is written into a temporary
directory and renamed into place, a step directory without a valid
manifest is skipped on restore, and a shard whose checksum does not match
falls back to an earlier step.  ``save_async`` copies the leaves to host
memory synchronously (a real copy, also of a CPU tensor that a later step
updates in place) and writes on a daemon thread.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Any) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """(leaves in JAX's order, a function that rebuilds the tree's
    structure from such a list)."""
    if tree is None:
        return [], lambda xs: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]

        def build(xs):
            out, i = {}, 0
            for k, (ls, b) in zip(keys, parts):
                out[k] = b(xs[i:i + len(ls)])
                i += len(ls)
            return out
        return [x for ls, _ in parts for x in ls], build
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(x) for x in tree]

        def build(xs):
            out, i = [], 0
            for ls, b in parts:
                out.append(b(xs[i:i + len(ls)]))
                i += len(ls)
            if hasattr(tree, "_fields"):            # a NamedTuple
                return type(tree)(*out)
            return type(tree)(out)
        return [x for ls, _ in parts for x in ls], build
    return [tree], lambda xs: xs[0]


def _host_copy(x) -> Any:
    """A leaf as a new host array or tensor that nothing else holds."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


def _stored(x) -> Tuple[np.ndarray, str]:
    """(the array written to the shard, its true dtype's name)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint8).numpy(), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(x)
    if str(a.dtype) == "bfloat16":
        return a.view(np.uint8), "bfloat16"
    return a, str(a.dtype)


def _loaded(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    if dtype == "bfloat16" and t.dtype == torch.uint8:
        return t.view(torch.bfloat16)
    if str(a.dtype) != dtype:
        raise TypeError(f"stored {a.dtype}, manifest says {dtype}")
    return t


class CheckpointManager:
    def __init__(self, directory: str, host_id: int = 0, n_hosts: int = 1,
                 keep: int = 3):
        self.dir = directory
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None
             ) -> str:
        leaves, _ = _flatten(tree)
        stored = [_stored(x) for x in leaves]
        sd = self._step_dir(step)
        tmp = sd + f".tmp{self.host_id}"
        os.makedirs(tmp, exist_ok=True)
        shard_path = os.path.join(tmp, f"shard_{self.host_id}.npz")
        np.savez(shard_path, **{f"leaf_{i}": a
                                for i, (a, _) in enumerate(stored)})
        with open(shard_path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        manifest = {
            "step": step,
            "n_leaves": len(leaves),
            "n_hosts": self.n_hosts,
            "checksums": {str(self.host_id): digest},
            "dtypes": [dt for _, dt in stored],
            "time": time.time(),
            "meta": meta or {},
        }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        # atomic commit: rename tmp -> final (last writer wins per host)
        if os.path.isdir(sd):
            shutil.rmtree(sd)
        os.replace(tmp, sd)
        self._gc()
        return sd

    def save_async(self, step: int, tree: Any, meta: Optional[Dict] = None,
                   copy: bool = True) -> None:
        """Snapshot `tree` to host memory now and write it on a daemon
        thread.  ``copy=False`` hands over a tree of new host tensors that
        nothing else holds (``train_state_to_host``'s), written as they
        are."""
        leaves, build = _flatten(tree)
        snap = build([_host_copy(x) for x in leaves]) if copy else tree
        self.wait()
        self._thread = threading.Thread(
            target=self.save, args=(step, snap, meta), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------------
    def _valid_steps(self) -> List[int]:
        out = []
        for d in sorted(os.listdir(self.dir)):
            if not d.startswith("step_") or d.endswith(tuple(
                    f".tmp{i}" for i in range(64))):
                continue
            man = os.path.join(self.dir, d, "MANIFEST.json")
            shard = os.path.join(self.dir, d, f"shard_{self.host_id}.npz")
            if os.path.isfile(man) and os.path.isfile(shard):
                try:
                    with open(man) as f:
                        m = json.load(f)
                    out.append(int(m["step"]))
                except Exception:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self._valid_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None
                ) -> Tuple[Any, int, Dict]:
        """Restore into the structure of `tree_like` (its leaves only
        count).  Returns (tree of host tensors, step, meta).  Verifies the
        checksum: a corrupt shard falls back to the previous valid
        step."""
        steps = self._valid_steps()
        if step is not None:
            steps = [s for s in steps if s == step]
        for s in reversed(steps):
            sd = self._step_dir(s)
            try:
                with open(os.path.join(sd, "MANIFEST.json")) as f:
                    man = json.load(f)
                shard_path = os.path.join(sd, f"shard_{self.host_id}.npz")
                with open(shard_path, "rb") as f:
                    blob = f.read()
                want = man["checksums"].get(str(self.host_id))
                if want and hashlib.sha256(blob).hexdigest() != want:
                    raise IOError(f"checksum mismatch at step {s}")
                leaves, build = _flatten(tree_like)
                assert len(leaves) == man["n_leaves"], \
                    (len(leaves), man["n_leaves"])
                dtypes = man["dtypes"]
                with np.load(shard_path) as data:
                    new = [_loaded(data[f"leaf_{i}"], dtypes[i])
                           for i in range(len(leaves))]
                return build(new), s, man.get("meta", {})
            except Exception:
                continue
        raise FileNotFoundError(f"no valid checkpoint in {self.dir}")

    def _gc(self) -> None:
        steps = self._valid_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
