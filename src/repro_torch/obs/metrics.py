"""Metrics registry: counters, gauges, log-bucketed histograms with
label sets, and Prometheus-style text exposition.

One registry per :class:`repro_torch.api.Session` (the serving runtime's
counters, the program cache's tier stats and the pool's worker health
all register here); ``Session.metrics()`` renders it.  The design is a
deliberately small subset of the Prometheus client model:

* a **metric family** is created once (``registry.counter(name, help,
  labelnames)``) and is idempotent — re-requesting the same name
  returns the same family, so independent modules can share a series
  (the pool and the session both count ``repro_shed_total{model=...}``
  without coordinating).
* **children** are label-value tuples: ``family.labels(model="x")``
  returns the mutable child (a float cell, or a
  :class:`LogHistogram`); convenience forms ``family.inc(n, model=x)``
  / ``family.observe(ms, model=x)`` skip the intermediate object.
* **collectors** are callbacks run at render/snapshot time for state
  that lives elsewhere (queue depths, cache occupancy, worker health):
  they set gauges instead of every module pushing on every change.

Histograms are log-spaced (:class:`LogHistogram` — O(1) record, ~5%
quantile resolution, fixed memory; this is the serving runtime's
p50/p99 surface, absorbed from the old
``runtime.serving.LatencyHistogram``) and render as Prometheus
*summaries* (quantile series + ``_sum``/``_count``).

Copy of the JAX package's ``obs/metrics.py`` (pure Python; the port
imports nothing of that package and keeps its own copy).
"""
from __future__ import annotations

import math
import re
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape(v: object) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def _fmt_labels(labelnames: Tuple[str, ...], values: Tuple,
                extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in zip(labelnames, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_val(v: float) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


# --------------------------------------------------------------------------
# Log-spaced histogram (p50/p99 without storing samples)
# --------------------------------------------------------------------------


class LogHistogram:
    """Log-spaced histogram: O(1) record, ~5% quantile resolution,
    fixed memory.  Thread-safe.  Units are whatever you feed it (the
    serving runtime records milliseconds)."""

    def __init__(self, lo: float = 0.05, hi: float = 120_000.0,
                 per_decade: int = 48):
        self._lo = lo
        self._log_ratio = math.log(10.0) / per_decade
        self._n = int(math.log(hi / lo) / self._log_ratio) + 2
        self._counts = [0] * self._n
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    # serving-era aliases (the histogram recorded milliseconds there)
    @property
    def sum_ms(self) -> float:
        return self.sum

    @property
    def max_ms(self) -> float:
        return self.max

    def record(self, v: float) -> None:
        v = max(v, 0.0)
        idx = 0 if v <= self._lo else min(
            self._n - 1, 1 + int(math.log(v / self._lo) / self._log_ratio))
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.sum += v
            self.max = max(self.max, v)

    observe = record

    def percentile(self, p: float) -> float:
        """Upper edge of the bucket holding the p-th percentile (0 when
        empty)."""
        with self._lock:
            if not self.count:
                return 0.0
            target = p / 100.0 * self.count
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= target:
                    return self._lo * math.exp(i * self._log_ratio)
            return self.max

    def snapshot(self) -> Dict[str, float]:
        p50, p99 = self.percentile(50), self.percentile(99)
        with self._lock:
            mean = self.sum / self.count if self.count else 0.0
            return {"count": self.count, "mean_ms": mean,
                    "p50_ms": p50, "p99_ms": p99, "max_ms": self.max}


# --------------------------------------------------------------------------
# Metric families
# --------------------------------------------------------------------------


class _Family:
    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Tuple[str, ...] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: "OrderedDict[Tuple, object]" = OrderedDict()

    def _key(self, labels: Dict[str, object]) -> Tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def series(self) -> Dict[Tuple, object]:
        with self._lock:
            return dict(self._children)


class Counter(_Family):
    """Monotonically increasing float cells, one per label set."""

    kind = "counter"

    def inc(self, n: float = 1.0, **labels) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + n

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._children.get(key, 0.0))

    def total(self) -> float:
        with self._lock:
            return float(sum(self._children.values()))

    def set_total(self, v: float, **labels) -> None:
        """Collector use only: expose an externally-maintained
        monotonic total (the source counter lives elsewhere — a stats
        dict, the program cache — and render pulls it)."""
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(v)


class Gauge(_Family):
    """Settable float cells, one per label set."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(v)

    def inc(self, n: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + n

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._children.get(key, 0.0))

    def clear(self) -> None:
        """Drop every child — collectors that enumerate live state
        (e.g. per-worker health) clear first so retired series don't
        linger forever."""
        with self._lock:
            self._children.clear()


class Histogram(_Family):
    """A family of :class:`LogHistogram` children."""

    kind = "summary"
    QUANTILES = (0.5, 0.9, 0.99)

    def __init__(self, name: str, help: str,
                 labelnames: Tuple[str, ...] = (),
                 lo: float = 0.05, hi: float = 120_000.0,
                 per_decade: int = 48):
        super().__init__(name, help, labelnames)
        self._lo, self._hi, self._pd = lo, hi, per_decade

    def labels(self, **labels) -> LogHistogram:
        key = self._key(labels)
        with self._lock:
            h = self._children.get(key)
            if h is None:
                h = self._children[key] = LogHistogram(
                    self._lo, self._hi, self._pd)
            return h

    def observe(self, v: float, **labels) -> None:
        self.labels(**labels).record(v)

    record = observe


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------


class MetricsRegistry:
    """Create-once metric families + render-time collectors."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: "OrderedDict[str, _Family]" = OrderedDict()
        self._collectors: List[Callable[[], None]] = []

    def _get(self, cls, name: str, help: str,
             labelnames: Tuple[str, ...], **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or \
                        fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {fam.labelnames}")
                return fam
            fam = cls(name, help, tuple(labelnames), **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Tuple[str, ...] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Tuple[str, ...] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Tuple[str, ...] = (),
                  lo: float = 0.05, hi: float = 120_000.0,
                  per_decade: int = 48) -> Histogram:
        return self._get(Histogram, name, help, labelnames,
                         lo=lo, hi=hi, per_decade=per_decade)

    def register_collector(self, fn: Callable[[], None]) -> None:
        """``fn()`` runs before every render/snapshot; it should set
        gauges from live state (queue depth, cache occupancy, worker
        health) so that state is pull-based instead of push-on-change."""
        with self._lock:
            self._collectors.append(fn)

    def families(self) -> List[_Family]:
        with self._lock:
            return list(self._families.values())

    def collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn()                    # a broken collector should be loud

    # -- output -------------------------------------------------------------
    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4): ``# HELP`` /
        ``# TYPE`` headers, one sample line per child; histograms as
        summaries (quantile series + ``_sum``/``_count``)."""
        self.collect()
        out: List[str] = []
        for fam in self.families():
            if fam.help:
                out.append(f"# HELP {fam.name} {_escape(fam.help)}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            if isinstance(fam, Histogram):
                for key, h in fam.series().items():
                    for q in Histogram.QUANTILES:
                        lbl = _fmt_labels(fam.labelnames, key,
                                          f'quantile="{q}"')
                        out.append(f"{fam.name}{lbl} "
                                   f"{_fmt_val(h.percentile(100 * q))}")
                    lbl = _fmt_labels(fam.labelnames, key)
                    out.append(f"{fam.name}_sum{lbl} {_fmt_val(h.sum)}")
                    out.append(f"{fam.name}_count{lbl} {h.count}")
            else:
                series = fam.series() or ({(): 0.0}
                                          if not fam.labelnames else {})
                for key, v in series.items():
                    lbl = _fmt_labels(fam.labelnames, key)
                    out.append(f"{fam.name}{lbl} {_fmt_val(v)}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict[str, Dict]:
        """Machine-readable form: name -> {labels repr -> value /
        histogram snapshot}."""
        self.collect()
        out: Dict[str, Dict] = {}
        for fam in self.families():
            d: Dict[str, object] = {}
            for key, v in fam.series().items():
                lbl = ",".join(f"{k}={val}" for k, val in
                               zip(fam.labelnames, key)) or "_"
                d[lbl] = v.snapshot() if isinstance(v, LogHistogram) \
                    else v
            out[fam.name] = d
        return out
