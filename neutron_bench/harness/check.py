"""Whether the outputs the timed window served are correct.

After the window has closed, its outputs collected, the device's peak
read and the program's session closed, a sample of the requests that
settled with an output is drawn from the seed.  The configuration's
plain reference (``reference/<config>.py`` through ``reference/qnet.py``)
derives the qparams again from the benchmark's weights and calibration
images and runs the int8 network over each sampled request's image, in
blocks.  The number compared is the widest gap between a served output
head and the reference's, each head's in steps of that head's own
reference output scale (``logit_gap_steps``); its limit is the
configuration's.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from neutron_bench.reference.qnet import Reference

from . import artifact

BLOCK = 64


def sample(seed: int, candidates: np.ndarray, size: int) -> np.ndarray:
    """Up to ``size`` of ``candidates``, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 4])
    if len(candidates) <= size:
        return np.sort(candidates)
    return np.sort(rng.choice(candidates, size=size, replace=False))


def reference_for(cfg: Dict, forward, device: torch.device,
                  weight_bits: int = 8) -> Reference:
    _, params = artifact.params_for(cfg, forward, device)
    return Reference(forward, cfg["resolution"], params,
                     artifact.calib_images(cfg, device), weight_bits)


def logit_gaps(ref: Reference, images: np.ndarray, outputs: List[List],
               device: torch.device) -> np.ndarray:
    """Per request: the widest |served - reference| over its output heads,
    each head's in steps of its own reference output scale.  ``outputs``:
    one list a request of its served heads in the network's output order,
    each an (H, W, C) float array; ``images`` the images they were served
    for.  Raises ValueError where a request's heads differ from the
    reference's in number or shape: no head is ever left out."""
    shapes = ref.out_shapes
    for i, heads in enumerate(outputs):
        got = [tuple(np.shape(h)) for h in heads]
        if got != shapes:
            raise ValueError(f"request {i} of the check: served heads "
                             f"{got}, the reference's {shapes}")
    steps = [qp[0] for qp in ref.out_qparams]
    gaps = []
    for i in range(0, len(images), BLOCK):
        imgs = torch.from_numpy(np.ascontiguousarray(
            images[i:i + BLOCK])).to(device)
        block = outputs[i:i + BLOCK]
        gap = np.zeros(len(block))
        for k, (want, step) in enumerate(zip(ref.logits(imgs), steps)):
            got = np.stack([np.asarray(o[k], np.float32).reshape(-1)
                            for o in block])
            gap = np.maximum(gap, np.abs(got - want.cpu().numpy()).max(
                axis=1) / step)
        gaps.extend(gap)
    return np.asarray(gaps, float)
