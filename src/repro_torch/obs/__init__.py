"""Observability of the port: the span tracer (``trace``) and the
metrics registry (``metrics``).

Counterpart of ``repro/obs``.  The compiler opens its spans through the
tracer (``core/tiling.py``, ``core/pipeline.py``), and so do the serving
session, its pool and the plan's steps; the session's counters and
histograms live in a ``MetricsRegistry`` (``Session.metrics()``).  The
profiler (``profile``) correlates a timed plan replay with the cost
model, per op (``CompiledModel.profile()``).
"""
from __future__ import annotations

from . import metrics, trace
from .metrics import LogHistogram, MetricsRegistry
from .profile import ProfileReport, profile_model
from .trace import Tracer, validate_chrome_trace

__all__ = ["trace", "metrics", "Tracer", "validate_chrome_trace",
           "MetricsRegistry", "LogHistogram", "ProfileReport",
           "profile_model"]
