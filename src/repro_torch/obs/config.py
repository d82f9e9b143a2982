"""ScopeKit's one switch: a process-global :class:`ObsConfig`.

Observability is OFF by default.  Enabling it is a host-side decision made
once per process (CLIs do it from ``--trace`` / ``--obs``); the two flags are
independent layers, as in the JAX package:

* ``enabled`` — host-side spans and metrics.  Pure Python bookkeeping that
  never touches the device computation.  Engines re-check it on every
  ``serve()`` entry, so flipping it between calls works without rebuilding
  anything.
* ``device_telemetry`` — the approximation telemetry counted on the device
  (out-of-domain clamp hits, routed dispatch rows, quant-code saturation):
  each probe sums on the tensor's device and the counter keeps the sum there
  until ``Registry.summary()`` reads every pending count in one transfer, so
  the decode loop never waits on a counter.  It is captured when the
  activation closures are built (``ApproxConfig.unary`` / ``routed_fn`` /
  ``attn_exp``): enabling it after a model was built has no effect on that
  model.  The off path returns the un-wrapped callable, so the model runs
  the same operators as a build without telemetry.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

_UNSET = object()


@dataclass(frozen=True)
class ObsConfig:
    enabled: bool = False
    device_telemetry: bool = False
    trace_path: Optional[str] = None  # where CLIs write the trace artifact


_CONFIG = ObsConfig()


def configure(enabled=_UNSET, device_telemetry=_UNSET,
              trace_path=_UNSET) -> ObsConfig:
    """Update the process-global config; only passed fields change."""
    global _CONFIG
    kw = {}
    if enabled is not _UNSET:
        kw["enabled"] = bool(enabled)
    if device_telemetry is not _UNSET:
        kw["device_telemetry"] = bool(device_telemetry)
    if trace_path is not _UNSET:
        kw["trace_path"] = trace_path
    _CONFIG = replace(_CONFIG, **kw)
    return _CONFIG


def disable() -> ObsConfig:
    """Back to the all-off default (tests restore state through this)."""
    global _CONFIG
    _CONFIG = ObsConfig()
    return _CONFIG


def get_config() -> ObsConfig:
    return _CONFIG


def enabled() -> bool:
    return _CONFIG.enabled


def device_telemetry_enabled() -> bool:
    """Device-side telemetry needs BOTH flags: it records into the metrics
    layer, which only exists as a consumer when observability is on."""
    return _CONFIG.enabled and _CONFIG.device_telemetry
