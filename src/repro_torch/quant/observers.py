"""Range observers for post-training calibration.

An observer watches every value a tensor takes across the calibration
set and reduces it to the float range the quantizer maps onto the int
grid.  Two estimators (the ones every production PTQ stack ships):

  * **min-max** — the exact envelope; optimal for weights and for
    activations with hard range bounds (relu6), but a single outlier
    stretches the scale and wastes codes;
  * **percentile** — clips the top/bottom ``(100 - pct)/2`` percent per
    sample and takes the worst case over samples; robust to heavy-tailed
    activations (silu/gelu feature maps).

Observers also come in per-channel form (reduce over all axes except
``axis``) for conv/fc weights.

Copy of the JAX package's ``quant/observers.py`` (numpy only; the port imports
nothing of that package and keeps its own copy).  The tests hold it
equal to the original.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class MinMaxObserver:
    """Running min/max over all observed values (per-tensor)."""

    def __init__(self) -> None:
        self.lo = np.inf
        self.hi = -np.inf
        self.samples = 0

    def update(self, arr: np.ndarray) -> None:
        a = np.asarray(arr)
        if a.size == 0:
            return
        self.lo = min(self.lo, float(a.min()))
        self.hi = max(self.hi, float(a.max()))
        self.samples += 1

    def range(self) -> Tuple[float, float]:
        if self.samples == 0:
            return (0.0, 0.0)
        return (self.lo, self.hi)


class PercentileObserver:
    """Per-sample symmetric percentile clip, worst case across samples.

    ``pct=99.9`` keeps the [0.05, 99.95] percentile band of each sample
    and returns the widest such band seen — tighter than min-max under
    outliers, never tighter than the bulk of the distribution."""

    def __init__(self, pct: float = 99.9) -> None:
        if not 0.0 < pct <= 100.0:
            raise ValueError(f"pct must be in (0, 100], got {pct}")
        self.pct = pct
        self.lo = np.inf
        self.hi = -np.inf
        self.samples = 0

    def update(self, arr: np.ndarray) -> None:
        a = np.asarray(arr, dtype=np.float64).reshape(-1)
        if a.size == 0:
            return
        tail = (100.0 - self.pct) / 2.0
        lo, hi = np.percentile(a, [tail, 100.0 - tail])
        self.lo = min(self.lo, float(lo))
        self.hi = max(self.hi, float(hi))
        self.samples += 1

    def range(self) -> Tuple[float, float]:
        if self.samples == 0:
            return (0.0, 0.0)
        return (self.lo, self.hi)


class PerChannelMinMaxObserver:
    """Min/max per channel along ``axis`` (weights: axis 0 == outC)."""

    def __init__(self, axis: int = 0) -> None:
        self.axis = axis
        self.lo: Optional[np.ndarray] = None
        self.hi: Optional[np.ndarray] = None

    def update(self, arr: np.ndarray) -> None:
        a = np.asarray(arr, dtype=np.float64)
        if a.ndim == 0:
            a = a.reshape(1)
        moved = np.moveaxis(a, self.axis, 0).reshape(a.shape[self.axis], -1)
        lo = moved.min(axis=1)
        hi = moved.max(axis=1)
        self.lo = lo if self.lo is None else np.minimum(self.lo, lo)
        self.hi = hi if self.hi is None else np.maximum(self.hi, hi)

    def range(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.lo is None:
            return (np.zeros(1), np.zeros(1))
        return (self.lo, self.hi)


def make_observer(method: str = "minmax", percentile: float = 99.9):
    if method == "minmax":
        return MinMaxObserver()
    if method == "percentile":
        return PercentileObserver(percentile)
    raise ValueError(f"unknown calibration method {method!r} "
                     "(expected 'minmax' or 'percentile')")
