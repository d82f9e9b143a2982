"""Run summaries and run-to-run diffs over ScopeKit trace files (the JAX
package's ``obs/report.py``; the output is the same text on the same trace).

A trace file is the Chrome-trace JSON ``obs.Tracer.save`` writes:
``{"traceEvents": [...], "metadata": {"metrics": {...}, ...}}``.  This module
turns it back into numbers:

* :func:`span_stats` — per-span-name aggregate (count, total/mean/max
  duration) from matched ``B``/``E`` pairs (per ``(pid, tid)`` stack) and
  ``X`` complete events;
* :func:`render_summary` — a text table of the above plus the embedded
  metrics summary (histogram percentiles, counters);
* :func:`diff_summaries` — two runs side by side with absolute and relative
  deltas, the ``tools/torch_obs_report.py --baseline`` path.

stdlib + numpy only.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional


def load_trace(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):  # bare-array form is legal Trace Event JSON
        doc = {"traceEvents": doc}
    if "traceEvents" not in doc:
        raise ValueError(f"{path}: not a trace file (no traceEvents)")
    return doc


def span_stats(doc: dict) -> Dict[str, Dict[str, float]]:
    """name -> {count, total_us, mean_us, max_us, compiled} from B/E + X."""
    stacks: Dict[tuple, List[dict]] = {}
    out: Dict[str, Dict[str, float]] = {}

    def add(name: str, dur_us: float, compiled: bool) -> None:
        s = out.setdefault(name, {"count": 0, "total_us": 0.0, "max_us": 0.0,
                                  "compiled": 0})
        s["count"] += 1
        s["total_us"] += dur_us
        s["max_us"] = max(s["max_us"], dur_us)
        s["compiled"] += int(compiled)

    for ev in doc.get("traceEvents", []):
        ph = ev.get("ph")
        if ph == "B":
            stacks.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
        elif ph == "E":
            stack = stacks.get((ev.get("pid"), ev.get("tid")))
            if stack:
                b = stack.pop()
                compiled = bool((ev.get("args") or {}).get("compiled"))
                add(b["name"], ev["ts"] - b["ts"], compiled)
        elif ph == "X":
            add(ev["name"], float(ev.get("dur", 0.0)),
                bool((ev.get("args") or {}).get("compiled")))
    for s in out.values():
        s["mean_us"] = s["total_us"] / s["count"] if s["count"] else 0.0
    return out


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.3f}s"
    if us >= 1e3:
        return f"{us / 1e3:.3f}ms"
    return f"{us:.1f}us"


def _table(rows: List[List[str]], header: List[str]) -> List[str]:
    widths = [max(len(header[i]), *(len(r[i]) for r in rows)) if rows
              else len(header[i]) for i in range(len(header))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*header), fmt.format(*("-" * w for w in widths))]
    lines += [fmt.format(*r) for r in rows]
    return lines


def render_summary(doc: dict, title: str = "run") -> str:
    lines = [f"== ScopeKit summary: {title} =="]
    stats = span_stats(doc)
    if stats:
        rows = []
        for name, s in sorted(stats.items(),
                              key=lambda kv: -kv[1]["total_us"]):
            rows.append([name, str(s["count"]), _fmt_us(s["total_us"]),
                         _fmt_us(s["mean_us"]), _fmt_us(s["max_us"]),
                         str(s["compiled"])])
        lines += ["", "spans:"]
        lines += _table(rows, ["name", "count", "total", "mean", "max",
                               "compiled"])

    metrics = (doc.get("metadata") or {}).get("metrics") or {}
    hists = metrics.get("histograms") or {}
    if hists:
        rows = []
        for name, h in sorted(hists.items()):
            rows.append([name, str(h.get("count", 0))] +
                        [f"{h[k] * 1e3:.2f}ms" if k in h else "-"
                         for k in ("mean", "p50", "p95", "p99")])
        lines += ["", "latency histograms (seconds recorded, shown in ms):"]
        lines += _table(rows, ["name", "count", "mean", "p50", "p95", "p99"])
    counters = metrics.get("counters") or {}
    if counters:
        lines += ["", "counters:"]
        lines += _table([[k, str(v)] for k, v in sorted(counters.items())],
                        ["name", "value"])
    for key in ("summary", "engine"):
        extra = (doc.get("metadata") or {}).get(key)
        if extra:
            lines += ["", f"{key}:"]
            lines += [f"  {k}: {v}" for k, v in sorted(extra.items())]
    return "\n".join(lines)


def _rel(new: float, old: float) -> str:
    if old == 0:
        return "n/a" if new else "+0.0%"
    return f"{(new - old) / old * 100.0:+.1f}%"


def diff_summaries(doc_a: dict, doc_b: dict,
                   label_a: str = "baseline", label_b: str = "run") -> str:
    """Span totals and histogram percentiles of ``b`` relative to ``a``."""
    lines = [f"== ScopeKit diff: {label_b} vs {label_a} =="]
    sa, sb = span_stats(doc_a), span_stats(doc_b)
    rows = []
    for name in sorted(set(sa) | set(sb)):
        ta = sa.get(name, {}).get("total_us", 0.0)
        tb = sb.get(name, {}).get("total_us", 0.0)
        rows.append([name,
                     str(sa.get(name, {}).get("count", 0)),
                     str(sb.get(name, {}).get("count", 0)),
                     _fmt_us(ta), _fmt_us(tb), _rel(tb, ta)])
    if rows:
        lines += ["", "span totals:"]
        lines += _table(rows, ["name", f"n({label_a})", f"n({label_b})",
                               label_a, label_b, "delta"])

    ha = ((doc_a.get("metadata") or {}).get("metrics") or {}).get(
        "histograms") or {}
    hb = ((doc_b.get("metadata") or {}).get("metrics") or {}).get(
        "histograms") or {}
    rows = []
    for name in sorted(set(ha) | set(hb)):
        for q in ("p50", "p95", "p99"):
            va: Optional[float] = ha.get(name, {}).get(q)
            vb: Optional[float] = hb.get(name, {}).get(q)
            if va is None and vb is None:
                continue
            rows.append([f"{name}.{q}",
                         f"{va * 1e3:.2f}ms" if va is not None else "-",
                         f"{vb * 1e3:.2f}ms" if vb is not None else "-",
                         _rel(vb or 0.0, va or 0.0)])
    if rows:
        lines += ["", "histogram percentiles:"]
        lines += _table(rows, ["metric", label_a, label_b, "delta"])
    return "\n".join(lines)


def summarize_file(path: str, baseline: Optional[str] = None) -> str:
    doc = load_trace(path)
    if baseline is None:
        return render_summary(doc, title=path)
    return diff_summaries(load_trace(baseline), doc,
                          label_a=baseline, label_b=path)


__all__ = [
    "diff_summaries",
    "load_trace",
    "render_summary",
    "span_stats",
    "summarize_file",
]
