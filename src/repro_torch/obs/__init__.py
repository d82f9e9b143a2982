"""repro_torch.obs — the port's copy of ScopeKit's host-side layers.

* :mod:`repro_torch.obs.trace` — a span/event recorder emitting Chrome-trace-
  event JSON (load the file in Perfetto).  The serving engines and the design
  flow emit spans through it; every hook is a no-op unless :func:`configure`
  enabled observability.
* :mod:`repro_torch.obs.metrics` — counters / gauges / histograms with
  percentile summaries (engines carry their own :class:`Registry`).

Stdlib + numpy only.  Device-side approximation telemetry (the JAX package's
``device_telemetry`` counters) is not ported yet (ROADMAP queue 1, item 13).
"""

from .config import ObsConfig, configure, disable, enabled, get_config
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    get_registry,
    percentiles,
    reset_registry,
)
from .trace import (
    Tracer,
    counter_event,
    get_tracer,
    instant,
    reset_tracer,
    span,
    traced,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "ObsConfig",
    "Registry",
    "Tracer",
    "configure",
    "counter_event",
    "disable",
    "enabled",
    "get_config",
    "get_registry",
    "get_tracer",
    "instant",
    "percentiles",
    "reset_registry",
    "reset_tracer",
    "span",
    "traced",
]
