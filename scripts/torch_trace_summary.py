#!/usr/bin/env python
# Render a per-stage time breakdown for an engine trace that the PyTorch
# port saved — the terminal counterpart to opening the file in Perfetto
# (ui.perfetto.dev).  It reads files only, so it needs no card.
#
#   PYTHONPATH=src python scripts/torch_trace_summary.py query.json.gz
#   PYTHONPATH=src python scripts/torch_trace_summary.py trace.jsonl --dispatch
#
# The counterpart of scripts/trace_summary.py.  Accepts both formats
# ``QueryTrace.save`` writes (Chrome trace-event JSON and JSON-lines,
# optionally gzipped) via ``repro_torch.obs.load_trace``.  The default view
# is the per-span-name aggregate (count, total, mean, share of the busiest
# root); ``--dispatch`` appends the per-op chunk table rebuilt from the
# ``dispatch`` spans — the same numbers EXPLAIN ANALYZE prints.
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.obs import QueryTrace, load_trace  # noqa: E402


def render_summary(trace: QueryTrace) -> str:
    lines: List[str] = []
    roots = trace.roots()
    root_ms = sum(s.dur_ms for s in roots)
    meta = ", ".join(f"{k}={v}" for k, v in sorted(trace.meta.items()))
    lines.append(f"trace: {len(trace)} spans, {len(roots)} roots, {root_ms:.1f}ms total"
                 + (f"  ({meta})" if meta else ""))
    stages = sorted(trace.stage_times().items(), key=lambda kv: -kv[1]["total_ms"])
    if not stages:
        lines.append("  (empty trace)")
        return "\n".join(lines)
    width = max(len(name) for name, _ in stages)
    lines.append(f"  {'stage':<{width}}  {'count':>5}  {'total_ms':>9}  {'mean_ms':>8}  {'%root':>5}")
    for name, st in stages:
        pct = 100.0 * st["total_ms"] / root_ms if root_ms > 0 else 0.0
        lines.append(
            f"  {name:<{width}}  {st['count']:>5.0f}  {st['total_ms']:>9.2f}"
            f"  {st['mean_ms']:>8.3f}  {pct:>4.0f}%"
        )
    return "\n".join(lines)


# dispatch-adjacent event spans: emitted *between* chunk dispatches by the
# fault-tolerance and adaptive re-planning machinery.  Rendered as their own
# section (and folded into the per-op table) rather than silently dropped.
EVENT_SPANS = ("fault.retry", "fault.speculate", "replan.split", "replan.drift")


def render_dispatch(trace: QueryTrace) -> str:
    recs = trace.dispatch_records()
    events = [s for name in EVENT_SPANS for s in trace.by_name(name)]
    if not recs and not events:
        return "dispatch: (no chunk dispatch spans in this trace)"
    per_op = {}
    for r in recs:
        per_op.setdefault(r.get("op", "?"), []).append(r)
    ev_per_op: dict = {}
    for s in events:
        op = s.attrs.get("op", "?")
        ev_per_op.setdefault(op, {}).setdefault(s.name, 0)
        ev_per_op[op][s.name] += 1
    lines = [f"dispatch: {len(recs)} chunks over {len(per_op)} op(s)"
             + (f", {len(events)} fault/replan event(s)" if events else "")]
    for op, rs in sorted(per_op.items()):
        workers = sorted({r.get("worker", 0) for r in rs})
        compiled = sum(1 for r in rs if r.get("compiled"))
        evs = ev_per_op.get(op, {})
        ev_str = "".join(f" {name}={n}" for name, n in sorted(evs.items()))
        lines.append(
            f"  {op:<40s} chunks={len(rs):<4d} rows={sum(r.get('rows', 0) for r in rs):<9d}"
            f" busy={sum(r.get('t_ms', 0.0) for r in rs):8.1f}ms"
            f" queue={sum(r.get('queue_ms', 0.0) for r in rs):7.1f}ms"
            f" compiles={compiled:<3d} workers={workers}" + ev_str
        )
    if events:
        lines.append(f"events: {len(events)} fault/replan span(s)")
        for s in events:
            attrs = " ".join(f"{k}={v}" for k, v in sorted(s.attrs.items()))
            lines.append(f"  {s.name:<18s} {attrs}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="per-stage time breakdown for a saved repro_torch.obs trace file")
    ap.add_argument("trace", help="trace file written by QueryTrace.save "
                                  "(.json[.gz] Chrome trace-event or .jsonl[.gz])")
    ap.add_argument("--dispatch", action="store_true",
                    help="also print the per-op chunk table from the dispatch spans")
    args = ap.parse_args(argv)
    try:
        trace = load_trace(args.trace)
    except (OSError, ValueError) as e:
        print(f"torch_trace_summary: cannot read {args.trace!r}: {e}", file=sys.stderr)
        return 2
    print(render_summary(trace))
    if args.dispatch:
        print(render_dispatch(trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
