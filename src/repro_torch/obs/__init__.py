"""Observability of the port: the span tracer (``trace``) and the
metrics registry (``metrics``).

Counterpart of ``repro/obs``.  The compiler opens its spans through the
tracer (``core/tiling.py``, ``core/pipeline.py``), and so do the serving
session, its pool and the plan's steps; the session's counters and
histograms live in a ``MetricsRegistry`` (``Session.metrics()``).  The
profiler (``profile``) is ``ROADMAP.md`` item 9.
"""
from __future__ import annotations

from . import metrics, trace
from .metrics import LogHistogram, MetricsRegistry
from .trace import Tracer, validate_chrome_trace

__all__ = ["trace", "metrics", "Tracer", "validate_chrome_trace",
           "MetricsRegistry", "LogHistogram"]
