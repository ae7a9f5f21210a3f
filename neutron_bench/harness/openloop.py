"""The open-loop sender: one thread that submits each request at its
due time (``time.sleep`` to it; never early), whatever the server's
state.  Each request is timed from its due time, so a late sender or a
stalled server shows in every later request's latency."""
from __future__ import annotations

import time

import numpy as np

from . import data

#: the first arrival's distance from the window's start
LEAD_S = 0.002


def drive_arrivals(server, offsets: np.ndarray, seconds: float, seed: int):
    order = data.image_order(seed, len(offsets), len(server.images))
    t0 = time.monotonic() + LEAD_S
    sleep, clock = time.sleep, time.monotonic
    for off, img in zip(offsets.tolist(), order.tolist()):
        due = t0 + off
        dt = due - clock()
        if dt > 0:
            sleep(dt)
        server.submit(due, img)
    return t0, t0 + seconds
