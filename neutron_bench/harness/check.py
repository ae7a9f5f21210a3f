"""Whether the outputs the timed window served are correct.

After the window has closed, its outputs collected, the device's peak
read and the program's session closed, a sample of the requests that
settled with an output is drawn from the seed.  The configuration's
plain reference (``reference/<config>.py`` through ``reference/qnet.py``)
derives the qparams again from the benchmark's weights and calibration
images and runs the int8 network over each sampled request's image, in
blocks.  The number compared is the widest gap between a served output
and the reference's, in steps of the reference's output scale
(``logit_gap_steps``); its limit is the configuration's.
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


def logit_gaps(ref: Reference, images: np.ndarray, outputs: List,
               device: torch.device) -> np.ndarray:
    """Per output: the widest |served - reference| in steps of the
    reference's output scale.  ``outputs``: one (N,) float array each,
    ``images`` the images they were served for."""
    step = ref.out_qparams[0]
    gaps = []
    for i in range(0, len(images), BLOCK):
        imgs = torch.from_numpy(np.ascontiguousarray(
            images[i:i + BLOCK])).to(device)
        want = ref.logits(imgs).cpu().numpy()
        got = np.stack([np.asarray(o, np.float32).reshape(-1)
                        for o in outputs[i:i + BLOCK]])
        gaps.extend(np.abs(got - want).max(axis=1) / step)
    return np.asarray(gaps, float)
