"""What one run hands to the metric readers (``metrics/<name>.py``).

A reader is ``read(run: Run) -> float or None``; it returns None where
the run gives it nothing to read (no trace, no batch), and the harness
then leaves the metric out of the result."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from .trace import Trace


@dataclass
class Run:
    cell: str
    workload: Dict
    config: Dict
    seconds: float
    window: tuple                    # (start, end), monotonic seconds
    setup_s: float
    requests: Dict[str, np.ndarray]  # due, submitted, done, failed
    macs_per_image: int
    #: op label of each plan step -> (kind, input shape, output shape,
    #: weight shape, has bias)
    steps: Dict[str, tuple] = field(default_factory=dict)
    trace: Optional[Trace] = None

    def completed_in_window(self) -> np.ndarray:
        """Mask of the requests that settled with an output inside the
        window."""
        r = self.requests
        w0, w1 = self.window
        return (~r["failed"]) & (r["done"] >= w0) & (r["done"] <= w1)

    def due_in_window(self) -> np.ndarray:
        r = self.requests
        w0, w1 = self.window
        return (r["due"] >= w0) & (r["due"] < w1)

    def latencies_s(self) -> np.ndarray:
        """Due-to-settled seconds of every request due in the window that
        did not fail."""
        r = self.requests
        m = self.due_in_window() & ~r["failed"]
        return r["done"][m] - r["due"][m]

    def batch_spans(self):
        """The window's ``batch`` spans (a trace is needed)."""
        if self.trace is None:
            return None
        return self.trace.in_window(self.trace.named("batch", "serving"))
