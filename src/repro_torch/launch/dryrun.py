"""Multi-pod dry run: trace every (arch x shape x mesh) cell on the meta
device; the counterpart of ``repro/launch/dryrun.py``.

For each cell this runs one rank's step of the production mesh - 16 x 16
= 256 ranks in one pod, or 2 x 16 x 16 = 512 across two pods - once, on
meta tensors, in a fake process group of that many ranks in this one
process: the step's real code (``registry.build_step``: the train step
with its forward, remat, backward and AdamW; prefill; one decode step
against a full cache), its collectives issued on the fake group, its
kernels' meta versions in place of the CUDA ones.  That proves the
distribution config is coherent (every shard's shape fits its op, every
collective's group exists) and counts the rank's cost
(``analysis.cost``): operations, HBM bytes, bytes on the wire, kernel
calls, argument and peak bytes, and from them the H100 roofline
(``analysis.roofline``).  No tensor is allocated off the meta device
(the counter raises if one is).

Artifacts are written as JSON to
``experiments/dryrun_torch/<arch>_<shape>_<mesh>.json`` with the
reference's keys where they mean the same.  Of the reference's keys,
``xla_cost_analysis``, ``hlo_bytes`` and ``max_trip`` have no
counterpart (there is no compiled program or loop), ``compile_s``
becomes ``trace_s`` (the step under the counter) and ``lower_s`` is the
time to build the cell's arguments on meta and shard them;
``memory_analysis`` holds the rank's argument bytes, of them those of
the state or parameters (the first argument), and its peak bytes.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-4b \\
        --shape train_4k [--multi-pod] [--all] [--out experiments/dryrun_torch]

``--arch`` without ``--shape`` runs every cell of that arch; ``--all``
every cell of every arch.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch.distributed as dist

from repro_torch.analysis import roofline as rl
from repro_torch.analysis.cost import CostCounter, storage_bytes
from repro_torch.models.registry import (ARCH_IDS, SHAPES, build_step,
                                         cells, get_arch)
from .mesh import make_production_mesh, use_mesh

#: the world size of the fake process group this module started, if any
_FAKE_WORLD: Optional[int] = None


def fake_world(n: int) -> None:
    """A fake process group of `n` ranks in this process (this process
    rank 0), from ``torch.testing._internal.distributed.fake_pg``: its
    collectives take meta tensors and move nothing.  A process group
    already initialised by the caller is left alone; one this module
    started is replaced when `n` differs."""
    global _FAKE_WORLD
    if dist.is_initialized():
        if _FAKE_WORLD is None or _FAKE_WORLD == n:
            return
        dist.destroy_process_group()
        _FAKE_WORLD = None
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs the fake process group of "
            "torch.testing._internal.distributed.fake_pg, which this "
            "torch does not have") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    _FAKE_WORLD = n


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             out_dir: str = "experiments/dryrun_torch",
             overrides: Optional[Dict] = None, tag: str = "") -> Dict:
    """Trace one cell on rank 0 of the production mesh; returns (and
    writes) the artifact dict."""
    cfg = get_arch(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    mesh_name = "x".join(str(s) for s in mesh.shape)
    chips = 512 if multi_pod else 256
    return trace_cell(cfg, shape, mesh, mesh_name, chips, multi_pod,
                      out_dir, tag, arch=arch)


def trace_cell(cfg, shape: str, mesh, mesh_name: str, chips: int,
               with_pod: bool = False, out_dir: Optional[str] = None,
               tag: str = "", arch: Optional[str] = None) -> Dict:
    """Build `cfg`'s `shape` cell on `mesh` (this process's rank), run its
    step once under the cost counter and return the artifact; written
    to `out_dir` unless it is None."""
    arch = arch or cfg.name
    ss = SHAPES[shape]
    t0 = time.monotonic()
    with use_mesh(mesh):
        bundle = build_step(cfg, shape, with_pod=with_pod)
        t_lower = time.monotonic() - t0
        t0 = time.monotonic()
        with CostCounter(arguments=bundle.args) as counter:
            bundle.fn(*bundle.args)
        t_trace = time.monotonic() - t0
    cost = counter.cost
    state_bytes = storage_bytes(bundle.args[0])
    roof = rl.build_roofline(
        arch=arch, shape=shape, mesh_name=mesh_name, chips=chips,
        flops_per_chip=cost.flops, bytes_per_chip=cost.bytes,
        wire_bytes_per_chip=cost.wire_bytes,
        model_flops=rl.model_flops_for(cfg, ss),
        collectives=cost.collective_bytes,
        memory_per_chip=cost.peak_bytes,
        flops_by_rate=cost.flops_by_rate)
    art = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "chips": chips,
        "multi_pod": with_pod, "tag": tag,
        "lower_s": t_lower, "trace_s": t_trace,
        "memory_analysis": {"argument_size_in_bytes": cost.argument_bytes,
                            "state_size_in_bytes": state_bytes,
                            "peak_size_in_bytes": cost.peak_bytes},
        "per_chip_bytes": cost.peak_bytes,
        "roofline": roof.to_json(),
        "bound_s": roof.bound_s,
        "collective_ops": roof.collectives,
        "collective_counts": dict(cost.collective_count),
        "kernel_calls": dict(cost.kernel_calls),
        "flops_by_rate": dict(cost.flops_by_rate),
    }
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        path = os.path.join(out_dir,
                            f"{arch}_{shape}_{mesh_name}{suffix}.json")
        with open(path, "w") as f:
            json.dump(art, f, indent=1)
    return art


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) for this mesh")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    todo = []
    if args.all:
        for a in ARCH_IDS:
            for s in cells(get_arch(a)):
                todo.append((a, s))
    elif args.arch and not args.shape:
        todo = [(args.arch, s) for s in cells(get_arch(args.arch))]
    else:
        assert args.arch and args.shape, "--arch [--shape] or --all"
        todo = [(args.arch, args.shape)]

    failures = []
    for a, s in todo:
        mesh_name = "2x16x16" if args.multi_pod else "16x16"
        path = os.path.join(args.out, f"{a}_{s}_{mesh_name}.json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip] {a} x {s} ({mesh_name})")
            continue
        try:
            art = run_cell(a, s, multi_pod=args.multi_pod,
                           out_dir=args.out)
            r = art["roofline"]
            print(f"[ok]   {a:22s} {s:12s} {mesh_name:8s} "
                  f"trace={art['trace_s']:6.1f}s "
                  f"hbm={art['per_chip_bytes']/1e9:7.2f}GB "
                  f"bound={r['bottleneck']:10s} "
                  f"roofline={r['peak_fraction']*100:5.1f}%",
                  flush=True)
            print("  memory_analysis:", art["memory_analysis"])
            print("  cost: flops/chip=%.3e bytes/chip=%.3e wire/chip=%.3e "
                  "kernels=%s" % (r["flops_per_chip"], r["bytes_per_chip"],
                                  r["wire_bytes_per_chip"],
                                  art["kernel_calls"]))
        except Exception as e:
            failures.append((a, s, repr(e)))
            print(f"[FAIL] {a} x {s}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for a, s, e in failures:
            print(f"  {a} x {s}: {e}")
        return 1
    print("\nall cells traced clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
