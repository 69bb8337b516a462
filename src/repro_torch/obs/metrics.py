# Engine-wide metrics registry: counters, gauges and histograms with
# labels, snapshot-able as a plain dict.  Absorbs the counters that grew up
# scattered across the engine (chunk-kernel jit compiles/hits/overflows,
# plan-cache hits/misses/invalidations, worker busy / queue-wait ms, rows
# scanned/emitted) into one queryable place.
#
# Zero dependencies, thread-safe (one lock; every instrument is a dict
# update).  A ``Session`` owns a registry by default; the module-level
# ``METRICS`` instance is the process-wide default for callers that want
# one registry across sessions (pass ``Session(metrics=obs.METRICS)``).
from __future__ import annotations

import math
import threading
from typing import Any, Dict, Optional, Tuple

LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, Any]) -> LabelKey:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


def _fmt_key(key: LabelKey) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class _Histogram:
    """Log2-bucketed histogram: tracks count/sum/min/max plus counts per
    power-of-two bucket of the observed value — enough for latency
    distributions without a dependency."""

    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: Dict[int, int] = {}  # floor(log2(v)) -> count

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        b = math.frexp(v)[1] - 1 if v > 0 else -1074  # log2 exponent; ≤0 → sentinel
        self.buckets[b] = self.buckets.get(b, 0) + 1

    def snapshot(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.sum / self.count if self.count else 0.0,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "buckets": {f"2^{b}": c for b, c in sorted(self.buckets.items())},
        }


class MetricsRegistry:
    """Process- or session-scoped metric store.

    >>> m = MetricsRegistry()
    >>> m.inc("queries", source="sql")
    >>> m.set_gauge("plan_cache.entries", 3)
    >>> m.observe("query.ms", 1.25)
    >>> m.snapshot()["counters"]["queries{source=sql}"]
    1.0
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[LabelKey, float] = {}
        self._gauges: Dict[LabelKey, float] = {}
        self._hists: Dict[LabelKey, _Histogram] = {}

    # -- instruments ---------------------------------------------------------
    def inc(self, name: str, value: float = 1, **labels: Any) -> None:
        """Monotonic counter add (negative deltas are a bug: rejected)."""
        if value < 0:
            raise ValueError(f"counter {name!r} increment must be >= 0, got {value}")
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels: Any) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = float(value)

    def observe(self, name: str, value: float, **labels: Any) -> None:
        k = _key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = _Histogram()
            h.observe(value)

    # -- reads ---------------------------------------------------------------
    def counter(self, name: str, **labels: Any) -> float:
        with self._lock:
            return self._counters.get(_key(name, labels), 0.0)

    def gauge(self, name: str, **labels: Any) -> Optional[float]:
        with self._lock:
            return self._gauges.get(_key(name, labels))

    def counter_total(self, name: str) -> float:
        """Sum of a counter across all label sets (e.g. queries over every
        ``source=``)."""
        with self._lock:
            return sum(v for (n, _), v in self._counters.items() if n == name)

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view: ``{"counters": {...}, "gauges": {...},
        "histograms": {...}}`` with ``name{label=value}`` keys — stable,
        json-serializable, diffable across calls."""
        with self._lock:
            return {
                "counters": {_fmt_key(k): v for k, v in sorted(self._counters.items())},
                "gauges": {_fmt_key(k): v for k, v in sorted(self._gauges.items())},
                "histograms": {
                    _fmt_key(k): h.snapshot() for k, h in sorted(self._hists.items())
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


def diff_counters(before: Dict[str, Any], after: Dict[str, Any]) -> Dict[str, float]:
    """Counter deltas between two ``snapshot()`` dicts (new counters count
    from zero) — what the metrics-stability tests assert on."""
    b = before.get("counters", {})
    out: Dict[str, float] = {}
    for k, v in after.get("counters", {}).items():
        d = v - b.get(k, 0.0)
        if d:
            out[k] = d
    return out


# Process-wide default registry (opt-in: ``Session(metrics=METRICS)``).
METRICS = MetricsRegistry()

__all__ = ["MetricsRegistry", "METRICS", "diff_counters"]
