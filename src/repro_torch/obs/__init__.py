# repro_torch.obs — end-to-end observability for the query engine: per-stage
# spans (``Tracer``/``QueryTrace``), an engine-wide ``MetricsRegistry``,
# and Perfetto/Chrome-trace + JSON-lines export.  Zero dependencies.
#
# The engine threads a tracer through every pipeline stage:
#
#   query ─ sql.parse | mr.translate ─ canonicalize
#         ─ optimize ─ passes ─ cache.lookup (hit/miss)
#                    ─ plan.stats ─ plan.enumerate ─ lower
#         ─ execute ─ dispatch:<op> ─ dispatch (one per chunk, carrying the
#                      ChunkDispatch fields: partition, rows, worker,
#                      bucket, compiled, queue_ms)
#
# Entry points: ``Session(trace=True)`` / ``Session.profile()`` /
# ``Session.metrics()``; ``QueryTrace.save("x.json.gz")`` opens directly in
# Perfetto (ui.perfetto.dev); ``scripts/trace_summary.py`` renders a
# per-stage breakdown from a saved trace.
from .trace import NULL_TRACER, NullTracer, QueryTrace, Span, Tracer
from .metrics import METRICS, MetricsRegistry, diff_counters
from .export import chrome_trace, load_trace, spans_jsonl, write_trace

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "Span",
    "QueryTrace",
    "MetricsRegistry",
    "METRICS",
    "diff_counters",
    "chrome_trace",
    "spans_jsonl",
    "write_trace",
    "load_trace",
]
