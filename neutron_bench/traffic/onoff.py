"""Open loop with on/off bursts: every ``period_s`` a burst of
``burst_s`` at ``rate_on`` requests a second, then the rest of the
period at ``rate_off``.  Each phase holds round(rate x its length)
arrivals, uniform over the phase (Poisson arrivals given their count),
so every seed sends the same number in each phase, at other times."""
from __future__ import annotations

import math

import numpy as np

from neutron_bench.harness.openloop import drive_arrivals


def arrivals(params, seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed), 3])
    period, burst = float(params["period_s"]), float(params["burst_s"])
    out = []
    for k in range(int(math.ceil(seconds / period))):
        t = k * period
        for a, b, rate in ((t, t + burst, params["rate_on"]),
                           (t + burst, t + period, params["rate_off"])):
            b = min(b, seconds)
            if b > a:
                n = int(round(float(rate) * (b - a)))
                out.append(rng.uniform(a, b, n))
    return np.sort(np.concatenate(out)) if out else np.zeros(0)


def drive(server, params, seconds: float, seed: int):
    return drive_arrivals(server, arrivals(params, seconds, seed), seconds,
                          seed)
