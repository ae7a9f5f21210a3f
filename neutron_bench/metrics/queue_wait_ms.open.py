"""Median of the window's ``queue_wait`` spans (the program's tracer:
from ``Session.submit`` to the start of the batch that serves the
request), in ms."""
import numpy as np

UNIT = "ms"


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.in_window(run.trace.named("queue_wait",
                                                "async:serving"))
    if not spans:
        return None
    return float(np.median([s[3] - s[2] for s in spans])) * 1e3
