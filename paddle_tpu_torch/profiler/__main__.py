"""CLI entry point: ``python -m paddle_tpu_torch.profiler trace.json``.

Per-lane span self-time of a Chrome trace-event JSON file — what
``GET /debug/trace`` serves — through :mod:`.chrometrace`, so a saved
serving capture answers "where did the step go" without Perfetto::

    python -m paddle_tpu_torch.profiler trace.json --top 25
    python -m paddle_tpu_torch.profiler trace.json --json

A directory argument (a ``jax.profiler`` XPlane trace) raises: that
reader is ROADMAP Queue A step 14. Exit status: 0 when spans were
parsed, 1 on unparseable input.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.profiler",
        description="Per-lane span self-time over a Chrome trace-event "
                    "JSON file (as served by GET /debug/trace).")
    ap.add_argument("trace", help="a Chrome trace-event JSON file")
    ap.add_argument("--top", type=int, default=10,
                    help="rows to report (0 = all)")
    ap.add_argument("--json", action="store_true",
                    help="emit the span table as JSON instead of text")
    args = ap.parse_args(argv)
    if os.path.isdir(args.trace):
        raise NotImplementedError(
            "XPlane trace directories are not ported to paddle_tpu_torch "
            "yet (ROADMAP Queue A step 14); pass a Chrome trace JSON file")
    from .chrometrace import load_chrome_trace, span_self_times, \
        summarize_chrome
    if args.json:
        try:
            rows = span_self_times(load_chrome_trace(args.trace))
        except ValueError as e:
            print(json.dumps({"error": str(e)}))
            return 1
        if args.top:
            rows = rows[:args.top]
        print(json.dumps({"trace": args.trace, "rows": rows}, indent=1))
        return 0 if rows else 1
    try:
        out = summarize_chrome(args.trace, top=args.top)
    except ValueError as e:
        print(f"unparseable trace: {e}")
        return 1
    print(out)
    return 0 if out != "no spans parsed" else 1


if __name__ == "__main__":
    sys.exit(main())
