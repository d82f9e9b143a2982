"""Counters, gauges, and histograms with percentile summaries.

A :class:`Registry` is a flat name -> instrument map.  Two registries matter:

* each serving engine owns one (``engine.metrics``) — TTFT, inter-token
  latency, queue wait; ``engine.reset_counters()`` clears it together with
  the batch/wasted-step integers;
* the process-global one (:func:`get_registry`) receives the device-side
  approximation telemetry of ``repro_torch.approx`` (counter names, as the
  JAX package's: ``approx.oob.<fn>`` / ``approx.lookups.<fn>`` clamp-or-
  extrapolation hits out of total lookups, ``approx.routed.<fn>`` routed rows
  dispatched per member, and ``approx.quant_sat.<fn>`` /
  ``approx.quant_gathers.<fn>`` saturated endpoint codes out of total code
  gathers).

A :class:`Counter` takes host ints and device tensors alike.  A tensor (a
probe's 0-d count) is summed on its device, out of place, with no host sync;
:meth:`Registry.summary` reads every pending device sum in one transfer a
device, so callers see ints, as in the JAX package.  Out of place, the sum
may be fed from inside ``torch.inference_mode()`` (serving) and outside it
(training) alike.

Stdlib + numpy; torch is imported only to read pending device counts.
"""

from __future__ import annotations

from numbers import Number
from typing import Dict, Iterable, List, Optional

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
    __slots__ = ("_host", "_pending")

    def __init__(self):
        self._host = 0
        self._pending = None  # device-side int64 sum not read yet

    def add(self, n=1) -> None:
        """Add a host number, or a device tensor's count without a sync."""
        if isinstance(n, Number):
            self._host += n
        else:
            self._pending = n if self._pending is None else self._pending + n

    def _settle(self, n) -> None:
        self._host += n
        self._pending = None

    @property
    def value(self):
        if self._pending is not None:
            self._settle(int(self._pending))
        return self._host

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
        """Drop every instrument (pending device counts unread)."""
        self._counters.clear()
        self._gauges.clear()
        self._histograms.clear()

    def _drain(self) -> None:
        """Read the counters' pending device sums: one stacked transfer a
        device."""
        by_device: Dict[object, List[Counter]] = {}
        for c in self._counters.values():
            if c._pending is not None:
                by_device.setdefault(c._pending.device, []).append(c)
        if not by_device:
            return
        import torch

        for group in by_device.values():
            sums = torch.stack([c._pending.to(torch.int64) for c in group])
            for c, n in zip(group, sums.tolist()):
                c._settle(n)

    def summary(self) -> dict:
        """JSON-ready snapshot: {"counters": {...}, "gauges": {...},
        "histograms": {name: {count, mean, p50, p95, p99, ...}}}."""
        self._drain()
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


def merge_summaries(base: Optional[dict], *others: dict) -> dict:
    """Sum counters across registry summaries (gauges/histograms keep the
    last non-empty value) — the fleet-aggregation shape a multi-replica
    deployment feeds per-replica summaries through."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for s in (base, *others):
        if not s:
            continue
        for k, v in s.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0) + v
        out["gauges"].update(s.get("gauges", {}))
        out["histograms"].update(s.get("histograms", {}))
    return out
