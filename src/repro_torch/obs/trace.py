"""Chrome-trace-event recorder (Perfetto-loadable).

Events follow the Trace Event Format's JSON-object form: a top-level
``{"traceEvents": [...]}`` whose entries carry ``name`` / ``cat`` / ``ph`` /
``ts`` (microseconds) / ``pid`` / ``tid`` / ``args``.  We emit four phases —
``B``/``E`` duration spans, ``i`` instants, ``C`` counters, and ``M``
metadata (track names) — and guarantee two invariants the schema validator
(``tools/check_trace.py``) and the trace-schema test pin:

* per ``(pid, tid)`` track, ``B``/``E`` events are balanced and properly
  nested (``span``'s context manager makes this structural; explicit
  ``begin``/``end`` callers own it);
* timestamps are non-decreasing per track (one monotonic clock, events
  appended in order).

Track convention used by the instrumented subsystems:

=====  ======================  =======================================
pid    tid                     contents
=====  ======================  =======================================
1      0                       the driving host loop (serve/train/design)
1      100 + slot              per-request lifecycle spans, one track per
                               engine slot (requests on a slot never overlap)
=====  ======================  =======================================

The module-level helpers (:func:`span`, :func:`instant`,
:func:`counter_event`) record into the global tracer only when
``obs.configure(enabled=True)`` was called; disabled they cost one boolean
check.
"""

from __future__ import annotations

import functools
import json
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from . import config as _config

PID = 1
MAIN_TID = 0
SLOT_TID0 = 100  # per-request tracks: tid = SLOT_TID0 + engine slot


class Tracer:
    """Append-only event buffer over one monotonic clock."""

    def __init__(self, process_name: str = "repro_torch"):
        self._t0 = time.perf_counter()
        self._events: List[Dict[str, Any]] = []
        self._thread_names: Dict[int, str] = {}
        self._events.append({
            "name": "process_name", "ph": "M", "pid": PID, "tid": MAIN_TID,
            "args": {"name": process_name},
        })

    # ------------------------------ clock ------------------------------------

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # ------------------------------ events -----------------------------------

    def _event(self, name: str, ph: str, cat: str, tid: int,
               ts: Optional[float] = None, **extra) -> Dict[str, Any]:
        ev = {"name": name, "cat": cat, "ph": ph,
              "ts": self.now_us() if ts is None else ts,
              "pid": PID, "tid": tid}
        ev.update(extra)
        self._events.append(ev)
        return ev

    def begin(self, name: str, cat: str = "", tid: int = MAIN_TID,
              **args) -> None:
        self._event(name, "B", cat, tid, args=args)

    def end(self, name: str, cat: str = "", tid: int = MAIN_TID,
            **args) -> None:
        self._event(name, "E", cat, tid, args=args)

    def instant(self, name: str, cat: str = "", tid: int = MAIN_TID,
                **args) -> None:
        self._event(name, "i", cat, tid, s="t", args=args)

    def counter(self, name: str, value, cat: str = "",
                tid: int = MAIN_TID) -> None:
        """One counter track per ``name``; ``value`` is a number or a dict of
        series-name -> number."""
        args = dict(value) if isinstance(value, dict) else {"value": value}
        self._event(name, "C", cat, tid, args=args)

    @contextmanager
    def span(self, name: str, cat: str = "", tid: int = MAIN_TID, **args):
        """Balanced B/E pair; extra fields set on the dict the context yields
        land on the E event's args (e.g. ``s["compiled"] = True``)."""
        self.begin(name, cat, tid, **args)
        end_args: Dict[str, Any] = {}
        try:
            yield end_args
        finally:
            self.end(name, cat, tid, **end_args)

    def set_thread_name(self, tid: int, name: str) -> None:
        if self._thread_names.get(tid) == name:
            return
        self._thread_names[tid] = name
        self._events.append({
            "name": "thread_name", "ph": "M", "pid": PID, "tid": tid,
            "args": {"name": name},
        })

    # ------------------------------ output -----------------------------------

    @property
    def events(self) -> List[Dict[str, Any]]:
        return self._events

    def clear(self) -> None:
        del self._events[:]
        self._thread_names.clear()
        self._t0 = time.perf_counter()

    def to_json(self, metadata: Optional[dict] = None) -> dict:
        out = {"traceEvents": list(self._events), "displayTimeUnit": "ms"}
        if metadata:
            out["metadata"] = metadata
        return out

    def save(self, path: str, metadata: Optional[dict] = None) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(metadata), f, indent=1)
            f.write("\n")
        return path


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def reset_tracer() -> Tracer:
    """Fresh global tracer (new clock origin); returns it."""
    global _TRACER
    _TRACER = Tracer()
    return _TRACER


# ------------------------------------------------------------------------------
# Module-level helpers, gated on the global ObsConfig.
# ------------------------------------------------------------------------------


@contextmanager
def span(name: str, cat: str = "", tid: int = MAIN_TID, **args):
    """No-op context manager unless observability is enabled."""
    if not _config.enabled():
        yield None
        return
    with _TRACER.span(name, cat, tid, **args) as s:
        yield s


def instant(name: str, cat: str = "", tid: int = MAIN_TID, **args) -> None:
    if _config.enabled():
        _TRACER.instant(name, cat, tid, **args)


def counter_event(name: str, value, cat: str = "",
                  tid: int = MAIN_TID) -> None:
    if _config.enabled():
        _TRACER.counter(name, value, cat, tid)


def traced(name: str, cat: str = ""):
    """Decorator form of :func:`span`.  Stacked INSIDE ``lru_cache``
    (``@lru_cache`` above ``@traced``) the span fires on cache misses only —
    how the design-time pipeline phases (splitter / poly_member / quantize)
    report the work actually done rather than memo hits."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _config.enabled():
                return fn(*args, **kwargs)
            with _TRACER.span(name, cat):
                return fn(*args, **kwargs)
        return wrapper
    return deco
