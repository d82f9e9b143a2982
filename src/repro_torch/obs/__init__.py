"""repro_torch.obs — the port's copy of ScopeKit's host-side layers.

* :mod:`repro_torch.obs.trace` — a span/event recorder emitting Chrome-trace-
  event JSON (load the file in Perfetto).  The serving engines and the design
  flow emit spans through it; every hook is a no-op unless :func:`configure`
  enabled observability.
* :mod:`repro_torch.obs.metrics` — counters / gauges / histograms with
  percentile summaries.  Engines carry their own :class:`Registry`; the
  global registry (:func:`get_registry`) receives the device-side
  approximation telemetry (out-of-domain clamp hits, routed dispatch rows,
  quant-code saturation) that ``repro_torch.approx`` counts on the device
  when ``device_telemetry`` is enabled, read in one transfer by
  ``summary()``.
* :mod:`repro_torch.obs.report` — render a run summary from a trace file and
  diff two runs (CLI: ``tools/torch_obs_report.py``; validation:
  ``tools/check_trace.py``).

Stdlib + numpy, and torch only where a counter reads a device count.  With
:class:`ObsConfig` disabled — the default — every hook is a cheap boolean
check, no events are recorded and the activation closures are the un-wrapped
ones.
"""

from .config import (
    ObsConfig,
    configure,
    device_telemetry_enabled,
    disable,
    enabled,
    get_config,
)
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
    "device_telemetry_enabled",
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
