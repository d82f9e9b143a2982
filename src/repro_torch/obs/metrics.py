"""Counters, gauges, and histograms with percentile summaries.

A :class:`Registry` is a flat name -> instrument map.  Each serving engine
owns one (``engine.metrics``) — TTFT, inter-token latency, queue wait;
``engine.reset_counters()`` clears it together with the batch/wasted-step
integers.  The process-global one (:func:`get_registry`) is where the device
telemetry of ROADMAP queue 1, item 13 will record.

Everything here is stdlib + numpy — importable from the f64 design layer.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np

# Histograms keep raw observations up to this many samples, then reservoir-
# decimate by dropping every other retained sample (percentiles stay honest
# to ~1% for the serving workloads this instrument; the cap only exists so a
# week-long engine cannot grow without bound).
HIST_CAP = 1 << 20


def percentiles(values: Iterable[float],
                qs=(50.0, 95.0, 99.0)) -> Dict[str, float]:
    """{"p50": ..., "p95": ..., "p99": ...} (empty input -> {})."""
    arr = np.asarray(list(values), dtype=np.float64)
    if arr.size == 0:
        return {}
    return {f"p{q:g}": float(np.percentile(arr, q)) for q in qs}


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def add(self, n=1) -> None:
        self.value += n

    def summary(self):
        return self.value


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v) -> None:
        self.value = v

    def summary(self):
        return self.value


class Histogram:
    __slots__ = ("values", "count", "_stride")

    def __init__(self):
        self.values: List[float] = []
        self.count = 0  # total observed, including decimated-away samples
        self._stride = 1

    def observe(self, v: float) -> None:
        self.count += 1
        if self.count % self._stride == 0:
            self.values.append(float(v))
            if len(self.values) >= HIST_CAP:
                self.values = self.values[::2]
                self._stride *= 2

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {"count": self.count}
        if self.values:
            arr = np.asarray(self.values)
            out.update(mean=float(arr.mean()), min=float(arr.min()),
                       max=float(arr.max()))
            out.update(percentiles(arr))
        return out


class Registry:
    """Flat name -> instrument map with get-or-create accessors."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self._histograms.setdefault(name, Histogram())

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._histograms.clear()

    def summary(self) -> dict:
        """JSON-ready snapshot: {"counters": {...}, "gauges": {...},
        "histograms": {name: {count, mean, p50, p95, p99, ...}}}."""
        return {
            "counters": {k: c.summary() for k, c in
                         sorted(self._counters.items())},
            "gauges": {k: g.summary() for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.summary() for k, h in
                           sorted(self._histograms.items())},
        }


_REGISTRY = Registry()


def get_registry() -> Registry:
    return _REGISTRY


def reset_registry() -> Registry:
    _REGISTRY.reset()
    return _REGISTRY
