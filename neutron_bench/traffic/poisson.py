"""Open loop, Poisson arrivals at ``rate`` requests a second: the window
holds round(rate x seconds) arrivals, each uniform over the window (a
Poisson process given its count), so every seed sends the same number,
at other times."""
from __future__ import annotations

import numpy as np

from neutron_bench.harness.openloop import drive_arrivals


def arrivals(params, seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed), 3])
    n = int(round(float(params["rate"]) * seconds))
    return np.sort(rng.uniform(0.0, seconds, n))


def drive(server, params, seconds: float, seed: int):
    return drive_arrivals(server, arrivals(params, seconds, seed), seconds,
                          seed)
