# Per-stage span tracing for the query engine (the data layer ROADMAP's
# serving and adaptive-re-optimization items both need: *measured* time per
# pipeline stage and per chunk, not just the planner's estimates).
#
# Design constraints, in order:
#   1. Zero cost when disabled — every call site defaults to ``NULL_TRACER``
#     whose ``span``/``start``/``end`` do nothing and allocate nothing, so
#     the warm dispatch path pays one attribute check per stage.
#   2. Thread-safe with *explicit* parent ids — the partitioned backend's
#     async worker pool executes chunks on pool threads, so a chunk span
#     cannot inherit its parent from any thread-local stack; the dispatcher
#     captures the owning span's id and workers attach to it explicitly.
#   3. Monotonic clock (``perf_counter_ns``) — spans order and nest by time;
#     wall-clock jumps must not produce negative durations.
#
# Within one thread, spans nest implicitly (a per-thread stack), which is
# what the serial pipeline stages use; ``parent=`` overrides.
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Span:
    """One timed region.  ``t0_ns``/``t1_ns`` are ``perf_counter_ns``
    readings; ``tid`` is a small per-tracer logical thread id (track id in
    the Chrome-trace export); ``parent`` is the owning span's ``id`` (None
    for a root)."""

    name: str
    id: int
    parent: Optional[int]
    t0_ns: int
    t1_ns: int = 0
    tid: int = 0
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def dur_ms(self) -> float:
        return max(0, self.t1_ns - self.t0_ns) / 1e6

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes after start (e.g. facts only known at end:
        cache hit/miss, compiled flag, measured rows)."""
        self.attrs.update(attrs)
        return self


class _NullSpan:
    """The shared do-nothing span: ``set`` discards, identity is constant.
    Never stores attributes — a singleton must not accumulate state."""

    __slots__ = ()
    name = ""
    id = 0
    parent = None
    t0_ns = 0
    t1_ns = 0
    tid = 0
    dur_ms = 0.0

    @property
    def attrs(self) -> Dict[str, Any]:
        return {}

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class _NullCtx:
    """Reusable no-op context manager yielding the null span."""

    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return _NULL_SPAN

    def __exit__(self, *exc) -> bool:
        return False


_NULL_CTX = _NullCtx()


class NullTracer:
    """The disabled-tracing fast path: every operation is a constant-time
    no-op returning shared singletons.  ``enabled`` is the one attribute
    hot paths may branch on to skip even argument construction."""

    enabled = False

    def span(self, name: str, parent: Optional[int] = None, **attrs: Any) -> _NullCtx:
        return _NULL_CTX

    def start(self, name: str, parent: Optional[int] = None, **attrs: Any) -> _NullSpan:
        return _NULL_SPAN

    def end(self, span: Any, **attrs: Any) -> None:
        pass

    def drain(self) -> List[Span]:
        return []


NULL_TRACER = NullTracer()


class _SpanCtx:
    """Context manager produced by ``Tracer.span`` (hand-rolled rather than
    ``@contextmanager``: no generator allocation per span)."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self._span.attrs.setdefault("error", exc_type.__name__)
        self._tracer.end(self._span)
        return False


class Tracer:
    """Collects finished spans.  One tracer per profiling scope (a
    ``Session.profile()`` block or a ``Session(trace=True)`` lifetime).

    Same-thread nesting is implicit (per-thread span stack); cross-thread
    attachment is explicit via ``parent=`` — the async worker pool's chunk
    spans attach to the dispatching query's span this way."""

    enabled = True

    def __init__(self, clock=time.perf_counter_ns):
        self._clock = clock
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._next_id = 1
        self._tids: Dict[int, int] = {}  # os thread ident -> small track id
        self._tls = threading.local()

    # -- internals -----------------------------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _tid(self) -> int:
        tid = getattr(self._tls, "tid", None)
        if tid is None:
            ident = threading.get_ident()
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
            self._tls.tid = tid
        return tid

    # -- span API ------------------------------------------------------------
    def start(self, name: str, parent: Optional[int] = None, **attrs: Any) -> Span:
        """Open a span.  ``parent=None`` parents to the calling thread's
        innermost open span (or makes a root)."""
        stack = self._stack()
        if parent is None and stack:
            parent = stack[-1].id
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        span = Span(name, sid, parent, self._clock(), tid=self._tid(), attrs=dict(attrs))
        stack.append(span)
        return span

    def end(self, span: Span, **attrs: Any) -> None:
        if span is _NULL_SPAN:
            return
        if attrs:
            span.attrs.update(attrs)
        span.t1_ns = self._clock()
        stack = self._stack()
        if span in stack:  # tolerate out-of-order ends across helpers
            stack.remove(span)
        with self._lock:
            self._spans.append(span)

    def span(self, name: str, parent: Optional[int] = None, **attrs: Any) -> _SpanCtx:
        return _SpanCtx(self, self.start(name, parent=parent, **attrs))

    # -- collection ----------------------------------------------------------
    def drain(self) -> List[Span]:
        """Return all finished spans (start-time order) and clear."""
        with self._lock:
            spans, self._spans = self._spans, []
        return sorted(spans, key=lambda s: (s.t0_ns, s.id))

    def peek(self) -> List[Span]:
        with self._lock:
            return sorted(list(self._spans), key=lambda s: (s.t0_ns, s.id))


class QueryTrace:
    """Finished spans of one profiling scope plus metadata — what
    ``Session.profile()`` hands back.  Knows how to summarize itself and to
    export (``repro_torch.obs.export``) to JSON-lines or Chrome trace-event JSON
    (loads directly in Perfetto: ui.perfetto.dev → Open trace file)."""

    def __init__(self, spans: Optional[List[Span]] = None, meta: Optional[Dict[str, Any]] = None):
        self.spans: List[Span] = spans if spans is not None else []
        self.meta: Dict[str, Any] = meta if meta is not None else {}

    def __len__(self) -> int:
        return len(self.spans)

    def by_name(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def roots(self) -> List[Span]:
        ids = {s.id for s in self.spans}
        return [s for s in self.spans if s.parent is None or s.parent not in ids]

    def children(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent == span.id]

    def find(self, span_id: int) -> Optional[Span]:
        for s in self.spans:
            if s.id == span_id:
                return s
        return None

    def ancestors(self, span: Span) -> List[Span]:
        """Parent chain from ``span`` (exclusive) up to its root."""
        by_id = {s.id: s for s in self.spans}
        out: List[Span] = []
        cur = span
        while cur.parent is not None and cur.parent in by_id:
            cur = by_id[cur.parent]
            out.append(cur)
        return out

    def stage_times(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name aggregate: count, total/mean ms (what
        ``scripts/trace_summary.py`` renders)."""
        agg: Dict[str, Dict[str, float]] = {}
        for s in self.spans:
            e = agg.setdefault(s.name, {"count": 0, "total_ms": 0.0})
            e["count"] += 1
            e["total_ms"] += s.dur_ms
        for e in agg.values():
            e["mean_ms"] = e["total_ms"] / e["count"] if e["count"] else 0.0
        return agg

    def dispatch_records(self) -> List[Dict[str, Any]]:
        """The per-chunk ``dispatch`` spans' attributes, in dispatch order —
        the trace-side view of ``PartitionedPlan.dispatch_log``."""
        out = [dict(s.attrs, t_span_ms=s.dur_ms) for s in self.by_name("dispatch")]
        out.sort(key=lambda d: d.get("seq", 0))
        return out

    # -- export (delegates; repro_torch.obs.export owns the formats) --------------
    def to_chrome(self) -> Dict[str, Any]:
        from .export import chrome_trace

        return chrome_trace(self.spans, self.meta)

    def to_jsonl(self) -> str:
        from .export import spans_jsonl

        return spans_jsonl(self.spans, self.meta)

    def save(self, path: str) -> str:
        """Write the trace to ``path``: ``.jsonl[.gz]`` → JSON-lines,
        anything else (``.json[.gz]``) → Chrome trace-event JSON."""
        from .export import write_trace

        return write_trace(self, path)
