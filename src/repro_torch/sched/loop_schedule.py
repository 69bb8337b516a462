# Loop scheduling (paper §III-A2): static schedules plus the dynamic
# self-scheduling family — "Iterations are allocated in groups called
# chunks.  The process starts with a large chunk size and this size
# gradually decreases with the course of execution."
#
# The schedulers are pure chunk-size policies; `simulate_schedule` is a
# deterministic event-driven executor used by tests/benchmarks and — with
# real timing callbacks — by the fault-tolerant training scheduler.
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Chunk-size policies
# ---------------------------------------------------------------------------


class ChunkPolicy:
    """next_chunk(remaining, n_workers, worker, history) -> chunk size ≥ 1."""

    name = "abstract"

    def next_chunk(self, remaining: int, n_workers: int, worker: int, history: List[Tuple[int, int, float]]) -> int:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class StaticBlock(ChunkPolicy):
    """Entire iteration space pre-divided into one block per worker
    ("determined entirely at compile-time" — zero overhead, no adaptivity)."""

    name = "static"

    def __init__(self, total: int, n_workers: int):
        self.block = max(1, math.ceil(total / n_workers))

    def next_chunk(self, remaining, n_workers, worker, history):
        return min(self.block, remaining)


class FixedChunk(ChunkPolicy):
    name = "fixed"

    def __init__(self, size: int):
        self.size = size

    def next_chunk(self, remaining, n_workers, worker, history):
        return min(self.size, remaining)


class GuidedSelfScheduling(ChunkPolicy):
    """GSS [Polychronopoulos & Kuck 1987]: chunk = ceil(remaining / N)."""

    name = "gss"

    def __init__(self, min_chunk: int = 1):
        self.min_chunk = min_chunk

    def next_chunk(self, remaining, n_workers, worker, history):
        return max(self.min_chunk, min(remaining, math.ceil(remaining / max(1, n_workers))))


class TrapezoidSelfScheduling(ChunkPolicy):
    """TSS [Tzen & Ni 1993]: chunk sizes decrease linearly from `first` to
    `last`."""

    name = "tss"

    def __init__(self, total: int, n_workers: int, first: Optional[int] = None, last: int = 1):
        self.first = first if first is not None else max(1, total // (2 * max(1, n_workers)))
        self.last = max(1, last)
        n = max(1, math.ceil(2 * total / (self.first + self.last)))
        self.delta = (self.first - self.last) / max(1, n - 1)
        self.step = 0

    def reset(self) -> None:
        self.step = 0

    def next_chunk(self, remaining, n_workers, worker, history):
        size = max(self.last, int(round(self.first - self.delta * self.step)))
        self.step += 1
        return min(size, remaining)


class Factoring(ChunkPolicy):
    """Factoring [Hummel et al.]: rounds of P equal chunks, each round
    allocating half the remaining work."""

    name = "factoring"

    def __init__(self):
        self.in_round = 0
        self.round_size = 0

    def reset(self) -> None:
        self.in_round = 0
        self.round_size = 0

    def next_chunk(self, remaining, n_workers, worker, history):
        if self.in_round == 0:
            self.round_size = max(1, math.ceil(remaining / (2 * max(1, n_workers))))
            self.in_round = n_workers
        self.in_round -= 1
        return min(self.round_size, remaining)


class FeedbackGuided(ChunkPolicy):
    """Feedback-guided dynamic loop scheduling [Bull 1998]: chunk sizes are
    adapted from observed per-worker iteration rates so each dispatch aims
    at `target_time` seconds of work."""

    name = "feedback"

    def __init__(self, target_time: float = 1.0, init_chunk: int = 64):
        self.target_time = target_time
        self.init_chunk = init_chunk
        self.rates: Dict[int, float] = {}

    def reset(self) -> None:
        self.rates = {}

    def observe(self, worker: int, iters: int, seconds: float) -> None:
        if seconds > 0:
            r = iters / seconds
            old = self.rates.get(worker)
            self.rates[worker] = r if old is None else 0.5 * old + 0.5 * r

    def next_chunk(self, remaining, n_workers, worker, history):
        rate = self.rates.get(worker)
        if rate is None:
            return min(self.init_chunk, remaining)
        return max(1, min(remaining, int(rate * self.target_time)))


def make_policy(name: str, total: int, n_workers: int, **kw) -> ChunkPolicy:
    if name == "static":
        return StaticBlock(total, n_workers)
    if name == "fixed":
        return FixedChunk(kw.get("size", max(1, total // (8 * n_workers))))
    if name in ("gss", "guided"):  # 'guided' = the OpenMP-style spelling
        return GuidedSelfScheduling(kw.get("min_chunk", 1))
    if name == "tss":
        return TrapezoidSelfScheduling(total, n_workers, kw.get("first"), kw.get("last", 1))
    if name == "factoring":
        return Factoring()
    if name == "feedback":
        return FeedbackGuided(kw.get("target_time", 1.0), kw.get("init_chunk", 64))
    raise ValueError(f"unknown policy {name}")


# ---------------------------------------------------------------------------
# Event-driven simulation
# ---------------------------------------------------------------------------


@dataclass
class ChunkRecord:
    worker: int
    start_iter: int
    size: int
    t_begin: float
    t_end: float
    completed: bool


def busy_times(worker_times: Sequence[Tuple[int, float]]) -> Dict[int, float]:
    """Fold (worker, elapsed) samples into per-worker busy totals — the
    shared reduction between the simulator's records and a *measured*
    dispatch log (the partitioned backend's runtime report and the obs
    trace summary both feed chunk timings through this)."""
    busy: Dict[int, float] = {}
    for w, t in worker_times:
        busy[w] = busy.get(w, 0.0) + t
    return busy


def worker_imbalance(per_worker_busy: Dict[int, float]) -> float:
    """1 − mean/max of per-worker busy time: 0 = perfectly balanced,
    → 1 as one worker carries all the work.  Shared by the simulator and
    by measured dispatch logs (the partitioned backend's EXPLAIN ANALYZE
    reports the *achieved* imbalance of its worker pool with the same
    definition the planner's schedule model uses)."""
    busy = list(per_worker_busy.values())
    if not busy or max(busy) == 0:
        return 0.0
    return 1.0 - (sum(busy) / len(busy)) / max(busy)


@dataclass
class SimResult:
    makespan: float
    records: List[ChunkRecord]
    per_worker_busy: Dict[int, float]
    n_dispatches: int
    iterations_done: int
    rescheduled_iters: int

    def imbalance(self) -> float:
        return worker_imbalance(self.per_worker_busy)


def simulate_schedule(
    policy: ChunkPolicy,
    iter_costs: np.ndarray,
    n_workers: int,
    worker_speed: Optional[Sequence[float]] = None,
    failures: Optional[Dict[int, float]] = None,  # worker -> failure time
    dispatch_overhead: float = 0.0,
) -> SimResult:
    """Deterministic event-driven execution of a 1-D loop under a chunk
    policy.  Supports heterogeneous iteration costs, heterogeneous worker
    speeds (stragglers), per-worker failure times (paper §III-A3: iterations
    of a failed node are re-scheduled onto others) and per-dispatch overhead
    (static has none; dynamic pays it)."""
    policy.reset()
    total = len(iter_costs)
    speed = list(worker_speed) if worker_speed is not None else [1.0] * n_workers
    failures = dict(failures or {})
    prefix = np.concatenate([[0.0], np.cumsum(iter_costs)])

    # static policies pre-assign; dynamic pull from a shared queue
    next_iter = 0
    records: List[ChunkRecord] = []
    busy: Dict[int, float] = {w: 0.0 for w in range(n_workers)}
    requeue: List[Tuple[int, int]] = []  # (start, size) chunks to redo
    rescheduled = 0
    history: List[Tuple[int, int, float]] = []

    # event queue of (time, worker) availability
    avail: List[Tuple[float, int]] = [(0.0, w) for w in range(n_workers)]
    heapq.heapify(avail)
    dead: set = set()
    done_iters = 0
    t_now = 0.0

    while avail:
        t_now, w = heapq.heappop(avail)
        if w in dead:
            continue
        # dead workers can't pull
        if w in failures and t_now >= failures[w]:
            dead.add(w)
            continue
        # pull work
        if requeue:
            start, size = requeue.pop()
        else:
            remaining = total - next_iter
            if remaining <= 0:
                continue
            size = policy.next_chunk(remaining, n_workers - len(dead), w, history)
            size = max(1, min(size, remaining))
            start = next_iter
            next_iter += size
        cost = float(prefix[start + size] - prefix[start]) / speed[w] + dispatch_overhead
        t_end = t_now + cost
        if w in failures and t_end > failures[w]:
            # worker dies mid-chunk: work lost, chunk requeued (paper:
            # "remaining iterations scheduled for that node ... can be
            # scheduled to other nodes")
            records.append(ChunkRecord(w, start, size, t_now, failures[w], False))
            busy[w] += failures[w] - t_now
            requeue.append((start, size))
            rescheduled += size
            dead.add(w)
            # wake an idle live worker if all are parked
            continue
        records.append(ChunkRecord(w, start, size, t_now, t_end, True))
        busy[w] += cost
        done_iters += size
        history.append((w, size, cost))
        if isinstance(policy, FeedbackGuided):
            policy.observe(w, size, cost)
        heapq.heappush(avail, (t_end, w))

    # if work remains (all pullers died or requeue left), drain with any
    # live worker round-robin
    live = [w for w in range(n_workers) if w not in dead]
    pending = list(requeue)
    if next_iter < total:
        pending.append((next_iter, total - next_iter))
    if pending and not live:
        raise RuntimeError("all workers failed; computation must restart (static schedule pathology)")
    wall = [max([r.t_end for r in records if r.worker == w], default=0.0) for w in live]
    wall_t = {w: t for w, t in zip(live, wall)}
    for start, size in pending:
        w = min(live, key=lambda x: wall_t[x])
        cost = float(prefix[start + size] - prefix[start]) / speed[w] + dispatch_overhead
        t0 = wall_t[w]
        records.append(ChunkRecord(w, start, size, t0, t0 + cost, True))
        wall_t[w] = t0 + cost
        busy[w] += cost
        done_iters += size

    makespan = max([r.t_end for r in records if r.completed], default=0.0)
    return SimResult(makespan, records, busy, len(records), done_iters, rescheduled)
