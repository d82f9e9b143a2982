"""ScopeKit's one switch: a process-global :class:`ObsConfig`.

Observability is OFF by default.  Enabling it is a host-side decision made
once per process (the serving CLI does it from ``--trace``): host-side spans
and metrics, pure Python bookkeeping that never touches the device
computation.  Engines re-check it on every ``serve()`` entry, so flipping it
between calls works without rebuilding anything.

The JAX package's second flag, ``device_telemetry``, has no counterpart yet:
the device-side counters come with ROADMAP queue 1, item 13.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

_UNSET = object()


@dataclass(frozen=True)
class ObsConfig:
    enabled: bool = False
    trace_path: Optional[str] = None  # where CLIs write the trace artifact


_CONFIG = ObsConfig()


def configure(enabled=_UNSET, trace_path=_UNSET) -> ObsConfig:
    """Update the process-global config; only passed fields change."""
    global _CONFIG
    kw = {}
    if enabled is not _UNSET:
        kw["enabled"] = bool(enabled)
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
