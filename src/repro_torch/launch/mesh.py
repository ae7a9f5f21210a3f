"""Device meshes, the counterpart of ``repro/launch/mesh.py``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with the reference's
axis names: ("data", "model"), or ("pod", "data", "model") across pods.
It needs a process group of the mesh's size, which the caller
initialises (``torch.distributed.init_process_group`` with its address,
world size and rank: nothing here finds a cluster).  A 1 x 1 mesh needs
none (``single_device_mesh``): its axes have size 1, and no collective
runs.  ``use_mesh`` makes a mesh the active one, which
``models.sharding`` reads (``active_mesh_axes``, ``mesh_axis_size``).
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.models import sharding


class LocalMesh:
    """A mesh whose every axis has size 1, for one process without a
    process group: the interface the port reads from a ``DeviceMesh``."""

    def __init__(self, shape: Sequence[int], names: Sequence[str],
                 device_type: str = "cpu"):
        if any(int(s) != 1 for s in shape):
            raise ValueError(f"a LocalMesh has axes of size 1; got {shape}")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(names)
        self.device_type = device_type

    def get_local_rank(self, name: str) -> int:
        return 0

    def get_group(self, name: str):
        raise RuntimeError("a LocalMesh has no process group")

    def size(self, dim: int = None) -> int:
        return 1


def use_mesh(mesh):
    """Context manager that makes `mesh` the active mesh."""
    return sharding.activate(mesh)


def named_shardings(mesh, tree: Any) -> Any:
    """A tree of specs (tuples; None for replicated) as a tree of DTensor
    placements on `mesh` (``sharding.placements``), the counterpart of
    the reference's tree of NamedShardings."""
    if tree is None:
        return sharding.placements((), mesh)
    if isinstance(tree, dict):
        return {k: named_shardings(mesh, v) for k, v in tree.items()}
    return sharding.placements(tree, mesh)


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device):
    n = 1
    for s in shape:
        n *= s
    dtype = resolve_device(device).type
    if n == 1 and not dist.is_initialized():
        return LocalMesh(shape, names, dtype)
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of "
            f"{n} ranks; the initialised one has {have}: call "
            f"torch.distributed.init_process_group with world_size={n}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dtype, shape, mesh_dim_names=names)


def make_mesh(n_data: int, n_model: int, n_pod: int = 1, device=None):
    """Explicit mesh for tests and the training loop: (data, model), or
    (pod, data, model) with ``n_pod > 1``.  `device`: the device type
    of the mesh's tensors, CUDA unless the caller passes the CPU
    (``resolve_device``: with no GPU and no device it raises)."""
    if n_pod > 1:
        return _mesh((n_pod, n_data, n_model), ("pod", "data", "model"),
                     device)
    return _mesh((n_data, n_model), ("data", "model"), device)


def single_device_mesh(device=None):
    """1 x 1 mesh for unit tests (specs resolve, collectives no-op)."""
    return make_mesh(1, 1, device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 in one pod (256 ranks) or 2 x 16 x 16 (512 ranks, two
    pods); raises unless the process group has that many ranks."""
    n = 512 if multi_pod else 256
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != n:
        raise RuntimeError(f"the production mesh needs {n} ranks; the "
                           f"process group has {have}")
    if multi_pod:
        return make_mesh(16, 16, n_pod=2, device=device)
    return make_mesh(16, 16, device=device)
