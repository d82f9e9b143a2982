"""Render a ScopeKit run summary — or diff two runs — from the port's trace
files.

Run:  PYTHONPATH=src python tools/torch_obs_report.py TRACE_serve.json
      PYTHONPATH=src python tools/torch_obs_report.py TRACE_new.json --baseline TRACE_old.json

The traces come from ``python -m repro_torch.launch.serve --trace PATH`` (or
the train CLI, or ``examples/serve_decode_torch.py``); with ``--obs`` their
metadata carries the device telemetry's counters.  The work is done by
``repro_torch.obs.report`` (span aggregation from matched B/E pairs,
metric-percentile tables, relative deltas); this is the thin CLI over it.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.obs.report import summarize_file  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="ScopeKit Chrome-trace JSON file")
    ap.add_argument("--baseline", default=None,
                    help="second trace to diff against (prints deltas)")
    args = ap.parse_args(argv)
    try:
        print(summarize_file(args.trace, baseline=args.baseline))
    except BrokenPipeError:  # e.g. piped into head; not an error
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())


if __name__ == "__main__":
    main()
