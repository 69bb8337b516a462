# Plan cache for repeated serving traffic: the same query shape over the
# same data epoch reuses the planning decision AND the compiled (jitted)
# plan, skipping stats collection, enumeration and lowering entirely.
#
# Keyed on (program fingerprint, stats epoch): a change to the underlying
# data (rows added, reformatting, new tables) bumps ``Database.stats_epoch``
# and naturally invalidates every entry for the old epoch.
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

from repro_torch.core.ir import Program, program_str


def program_fingerprint(program: Program) -> str:
    """Deterministic fingerprint of a program's semantics: the pretty-printed
    body (stable across parses of the same SQL) plus results/params and the
    ORDER BY / LIMIT post-ops.

    The display name is *excluded*: two frontends producing the same logical
    program under different names (e.g. 'sql_groupby' vs 'mapreduce' through
    the Session front door) must share one cache entry."""
    h = hashlib.sha1()
    h.update(program_str(replace(program, name="")).encode())
    h.update(repr(program.results).encode())
    h.update(repr(program.params).encode())
    h.update(repr(program.order_by).encode())
    h.update(repr(program.limit).encode())
    return h.hexdigest()


@dataclass
class CacheEntry:
    decision: Any            # enumerate.Decision
    plan: Any                # lower.Plan (compiled) — reusable within epoch
    explain: str
    program: Program         # post-pipeline program backing ``plan``
    epoch: str


class PlanCache:
    """LRU cache of planned+compiled queries.

    Thread-safe: a ``QueryServer`` shares one cache across every tenant
    session, so lookups (which mutate LRU order and counters), inserts and
    evictions race without a lock — an OrderedDict mid-``move_to_end`` is
    not safe to read from another thread."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._entries: "OrderedDict[Tuple[str, str], CacheEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, fingerprint: str, epoch: str) -> Optional[CacheEntry]:
        key = (fingerprint, epoch)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry

    def put(self, fingerprint: str, epoch: str, entry: CacheEntry) -> None:
        key = (fingerprint, epoch)
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def invalidate_fingerprint(self, prefix: str) -> int:
        """Drop every entry whose fingerprint starts with ``prefix``.

        The planner's cache key is ``<semantic fingerprint>|<knob suffix>``,
        so passing the semantic ``program_fingerprint`` evicts every knob
        variant of ONE query while neighbour queries survive — this is the
        drift trigger's targeted invalidation path.  Returns the count."""
        with self._lock:
            stale = [k for k in self._entries if k[0].startswith(prefix)]
            for k in stale:
                del self._entries[k]
            return len(stale)

    def invalidate_epoch(self, epoch: str) -> int:
        """Drop every entry planned against ``epoch``; returns count."""
        with self._lock:
            stale = [k for k in self._entries if k[1] == epoch]
            for k in stale:
                del self._entries[k]
            return len(stale)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits, "misses": self.misses}


# Shared default cache used by passes.optimize(planner="cost") when the
# caller does not pass an explicit one (OptimizeOptions.plan_cache).
DEFAULT_CACHE = PlanCache()
