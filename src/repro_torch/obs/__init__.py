"""Observability of the port: the span tracer (``trace``).

Counterpart of ``repro/obs``.  Only the tracer is ported: the compiler
opens its spans through it (``core/tiling.py``, ``core/pipeline.py``).
The metrics registry and the profiler (``metrics``, ``profile``) are
``ROADMAP.md`` item 9.
"""
from __future__ import annotations

from . import trace

__all__ = ["trace"]
