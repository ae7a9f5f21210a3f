"""Training loop of the port: data pipeline -> train step ->
checkpoints, with restart from the latest checkpoint; the counterpart of
``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \\
        --smoke --steps 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \\
        --full --steps 4                         # one CUDA card

Deterministic per-step data (``data/pipeline.py``), the step of
``models/train.py`` on one device (CUDA unless ``device="cpu"``; it never
falls back to the CPU quietly), one read-back of the loss per step, a
heartbeat to ``runtime/fault.py``'s ``FaultMonitor``, asynchronous
checkpoints every `ckpt_every` steps in the reference's layout, and a
restart from the latest one that fast-forwards the pipeline.

`n_data` x `n_model` above 1 trains on a mesh (``launch/mesh.py``) over
the process group the caller initialised with that many ranks: the
state is laid out by the specs, each data rank takes its rows of every
global batch, and the step averages the gradients over the data ranks
(``models/train.py``).  Checkpoints keep the reference's layout: every
rank gathers the full state, global rank 0 writes it, and a restore
cuts each rank's shards again.  The batches carry no audio, so an
encoder-decoder config (whisper) raises here; it trains through
``make_train_step`` (``chip_smoke.py`` phase 19).
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Callable, Optional

import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models import sharding
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_host)
from repro_torch.models.registry import get_arch
from repro_torch.models.train import (TrainOptions, init_train_state,
                                      make_train_step)
from repro_torch.runtime.fault import FaultMonitor
from .mesh import make_mesh, use_mesh


def train_loop(arch: str, steps: int = 30, smoke: bool = True,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
               seq_len: int = 128, global_batch: int = 8,
               n_micro: int = 1, compress: bool = False,
               n_data: Optional[int] = None, n_model: Optional[int] = None,
               log_every: int = 5, seed: int = 0, device=None,
               on_step: Optional[Callable] = None):
    """Train `arch` (its reduced config with `smoke`) from step 0, or from
    the latest checkpoint in `ckpt_dir`, up to `steps`; returns the loss
    of each step run.  ``on_step(i, metrics, seconds)``, when given, is
    called after each step with its metrics (tensors on the device) and
    its wall time, data and loss read-back included.  `n_model` defaults
    to 1 and `n_data` to the process group's size over it (1 without
    one)."""
    device = resolve_device(device)
    n_model = n_model or 1
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_data = n_data or max(1, world // n_model)
    mesh = None
    if n_data * n_model > 1:
        mesh = make_mesh(n_data, n_model, device=device)
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        return _train(arch, steps, smoke, ckpt_dir, ckpt_every, seq_len,
                      global_batch, n_micro, compress, log_every, seed,
                      device, on_step)


def _train(arch, steps, smoke, ckpt_dir, ckpt_every, seq_len, global_batch,
           n_micro, compress, log_every, seed, device, on_step):
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    if cfg.enc_dec:
        raise ValueError(
            f"{arch}: train_loop feeds tokens and labels only, as the "
            f"reference's does; an encoder-decoder config also needs "
            f"'audio_embed' (B, n_audio_frames, d) in each batch: call "
            f"models.train.make_train_step with such batches")
    opts = TrainOptions(n_micro=n_micro, compress_grads=compress,
                        total_steps=max(steps, 2))
    step_fn = make_train_step(cfg, opts=opts)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                      global_batch=global_batch, seed=seed)
    monitor = FaultMonitor(n_hosts=1)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    # the full state is gathered on every rank; global rank 0 writes it
    writer = not dist.is_initialized() or dist.get_rank() == 0
    nd, r = sharding.mesh_axis_size("data"), sharding.axis_rank("data")
    if global_batch % nd:
        raise ValueError(f"a global batch of {global_batch} rows does not "
                         f"split over {nd} data ranks")
    rows = slice(r * global_batch // nd, (r + 1) * global_batch // nd)
    start_step = 0

    state = init_train_state(cfg, seed, device, opts=opts)
    latest = ckpt.latest_step() if ckpt is not None else None
    if dist.is_initialized():       # every rank resumes from rank 0's step
        got = [latest]
        dist.broadcast_object_list(got, src=0)
        latest = got[0]
    if latest is not None:
        tree, start_step, _ = ckpt.restore(
            train_state_to_host(cfg, state),
            step=latest if dist.is_initialized() else None)
        state = train_state_from_numpy(cfg, tree, device)
        print(f"[restore] resumed from step {start_step}")
    # the pipeline starts at the first step to run (a restart
    # fast-forwards it deterministically)
    pipe = Pipeline(dcfg, start_step=start_step)
    losses = []
    try:
        for i in range(start_step, steps):
            t0 = time.monotonic()
            batch = {k: v[rows] for k, v in next(pipe).items()}
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            monitor.beat(0, i, dt)
            losses.append(loss)
            if on_step is not None:
                on_step(i, metrics, dt)
            if i % log_every == 0 or i == steps - 1:
                print(f"step {i:5d}  loss {loss:8.4f}  "
                      f"gnorm {float(metrics['grad_norm']):8.3f}  "
                      f"{dt * 1e3:7.1f} ms", flush=True)
            if ckpt is not None and (i + 1) % ckpt_every == 0:
                host = train_state_to_host(cfg, state)
                if writer:
                    ckpt.save_async(i + 1, host, meta={"loss": loss},
                                    copy=False)
        if ckpt is not None and losses:
            host = train_state_to_host(cfg, state)
            if writer:
                ckpt.wait()
                ckpt.save(steps, host, meta={"loss": losses[-1]})
    finally:
        pipe.close()
        if ckpt is not None:
            ckpt.wait()
    if ckpt is not None and dist.is_initialized():
        dist.barrier()              # rank 0's last checkpoint is on disk
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()
    losses = train_loop(args.arch, steps=args.steps, smoke=args.smoke,
                        ckpt_dir=args.ckpt_dir,
                        ckpt_every=args.ckpt_every,
                        seq_len=args.seq_len,
                        global_batch=args.global_batch,
                        n_micro=args.n_micro, compress=args.compress,
                        seed=args.seed, device=args.device)
    if losses:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    else:
        print("nothing to do (checkpoint already at target step)")


if __name__ == "__main__":
    main()
