# Trace exporters + loaders.  Two formats:
#
#   JSON-lines      — one span object per line (header line first): the
#                     machine-friendly format for diffing and ad-hoc jq.
#   Chrome trace    — the trace-event JSON the Chrome tracing UI and
#                     Perfetto (ui.perfetto.dev → "Open trace file") read
#                     directly: complete ("ph":"X") events in microseconds,
#                     one track (tid) per engine thread/worker.
#
# ``write_trace`` dispatches on the file name (``.jsonl[.gz]`` vs
# ``.json[.gz]``) and gzips transparently; ``load_trace`` round-trips both,
# which is what ``scripts/trace_summary.py`` builds on.
from __future__ import annotations

import gzip
import io
import json
import math
from typing import Any, Dict, List, Optional, Sequence

from .trace import QueryTrace, Span

PID = 1  # single-process engine: one Chrome-trace process group


def chrome_trace(spans: Sequence[Span], meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Spans → Chrome trace-event JSON object.  Timestamps are rebased to
    the earliest span so traces start at t=0; span/parent ids ride along in
    ``args`` so the tree survives the format round-trip."""
    base = min((s.t0_ns for s in spans), default=0)
    events: List[Dict[str, Any]] = []
    for tid in sorted({s.tid for s in spans}):
        events.append({
            "name": "thread_name", "ph": "M", "pid": PID, "tid": tid,
            "args": {"name": "main" if tid == 0 else f"worker-{tid}"},
        })
    for s in spans:
        args = {k: _jsonable(v) for k, v in s.attrs.items()}
        args["span_id"] = s.id
        if s.parent is not None:
            args["parent_id"] = s.parent
        events.append({
            "name": s.name,
            "cat": s.name.split(".", 1)[0].split(":", 1)[0],
            "ph": "X",
            "ts": (s.t0_ns - base) / 1e3,      # µs, float
            "dur": max(0, s.t1_ns - s.t0_ns) / 1e3,
            "pid": PID,
            "tid": s.tid,
            "args": args,
        })
    out: Dict[str, Any] = {"traceEvents": events, "displayTimeUnit": "ms"}
    if meta:
        out["otherData"] = {k: _jsonable(v) for k, v in meta.items()}
    return out


def spans_jsonl(spans: Sequence[Span], meta: Optional[Dict[str, Any]] = None) -> str:
    """Spans → JSON-lines text: a ``{"trace_meta": ...}`` header line, then
    one span per line."""
    lines = [json.dumps({"trace_meta": {k: _jsonable(v) for k, v in (meta or {}).items()}})]
    for s in spans:
        lines.append(json.dumps({
            "name": s.name,
            "id": s.id,
            "parent": s.parent,
            "tid": s.tid,
            "t0_ns": s.t0_ns,
            "t1_ns": s.t1_ns,
            "dur_ms": s.dur_ms,
            "attrs": {k: _jsonable(v) for k, v in s.attrs.items()},
        }))
    return "\n".join(lines) + "\n"


def write_trace(trace: QueryTrace, path: str) -> str:
    """Write ``trace`` to ``path`` (gzip when it ends in ``.gz``); the
    format follows the extension: ``.jsonl`` → JSON-lines, else Chrome
    trace-event JSON.  Returns ``path``."""
    stem = path[:-3] if path.endswith(".gz") else path
    if stem.endswith(".jsonl"):
        text = trace.to_jsonl()
    else:
        text = json.dumps(trace.to_chrome(), indent=1)
    _write_text(path, text)
    return path


def load_trace(path: str) -> QueryTrace:
    """Read a trace written by ``write_trace`` (either format) back into a
    ``QueryTrace``."""
    text = _read_text(path)
    stripped = text.lstrip()
    if stripped.startswith("{") and '"traceEvents"' in stripped[:4096]:
        return _from_chrome(json.loads(text))
    return _from_jsonl(text)


# -- internals ---------------------------------------------------------------

def _jsonable(v: Any) -> Any:
    if isinstance(v, float):
        # strict-JSON consumers (Perfetto) reject Infinity/NaN literals
        return v if math.isfinite(v) else str(v)
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    try:  # numpy scalars and friends
        return v.item()
    except AttributeError:
        return str(v)


def _write_text(path: str, text: str) -> None:
    if path.endswith(".gz"):
        with gzip.open(path, "wt", encoding="utf-8") as f:
            f.write(text)
    else:
        with io.open(path, "w", encoding="utf-8") as f:
            f.write(text)


def _read_text(path: str) -> str:
    if path.endswith(".gz"):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            return f.read()
    with io.open(path, "r", encoding="utf-8") as f:
        return f.read()


def _from_jsonl(text: str) -> QueryTrace:
    meta: Dict[str, Any] = {}
    spans: List[Span] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        obj = json.loads(line)
        if "trace_meta" in obj:
            meta = obj["trace_meta"]
            continue
        spans.append(Span(
            name=obj["name"], id=obj["id"], parent=obj.get("parent"),
            t0_ns=obj["t0_ns"], t1_ns=obj["t1_ns"], tid=obj.get("tid", 0),
            attrs=obj.get("attrs", {}),
        ))
    return QueryTrace(spans, meta)


def _from_chrome(obj: Dict[str, Any]) -> QueryTrace:
    spans: List[Span] = []
    for ev in obj.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args", {}))
        sid = args.pop("span_id", len(spans) + 1)
        parent = args.pop("parent_id", None)
        t0 = int(ev["ts"] * 1e3)
        spans.append(Span(
            name=ev["name"], id=sid, parent=parent,
            t0_ns=t0, t1_ns=t0 + int(ev.get("dur", 0) * 1e3),
            tid=ev.get("tid", 0), attrs=args,
        ))
    return QueryTrace(spans, obj.get("otherData", {}))
