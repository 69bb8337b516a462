# Fault tolerance by hybrid loop scheduling (paper §III-A3):
#
#   "One can even take one step further and devise hybrid schemes, where at
#    a higher level dynamic loop scheduling is carried out and chunks of
#    data are executed according to a static schedule with no overhead.
#    When a node within the static group fails, only that chunk has to be
#    computed on another set of nodes, something the dynamic loop scheduler
#    at a higher level will take care of."
#
# In the accelerator adaptation, a *worker* is a group of devices executing
# a static schedule internally (one train step), a *chunk* is a
# range of data (microbatch indices / token ranges produced by the forelem
# data pipeline's blocked index set), and failure = slice preemption.  The
# dynamic top level re-queues chunks of failed slices, detects stragglers by
# runtime z-score and duplicates their chunks speculatively, and cooperates
# with checkpoint/restart + elastic re-meshing (sched/elastic.py).
from __future__ import annotations

import bisect
import heapq
import math
import threading
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple


from .loop_schedule import ChunkPolicy, GuidedSelfScheduling

# ---------------------------------------------------------------------------
# Runtime fault tolerance (the non-simulated half of this module):
# the partitioned backend's dispatch queue and the serving engine's shared
# chunk pool consume these to turn a slow or failing chunk into a re-queue
# instead of a stalled query.
# ---------------------------------------------------------------------------


class ChunkRetryExceeded(RuntimeError):
    """A chunk failed more times than ``RetryPolicy.max_retries`` allows —
    the query fails loudly instead of retrying forever."""


@dataclass(frozen=True)
class RetryPolicy:
    """Chunk-level fault-tolerance knobs for *real* dispatch (the simulator
    above models the same scheme; this configures the runtime).

    ``fault_hook`` is the injectable chunk-level fault point for testing: it
    is called with the chunk's ``ChunkDispatch`` record at execution start
    and may raise to simulate a worker losing that chunk.  A raised hook (or
    any execution error) re-queues the chunk up to ``max_retries`` extra
    attempts; past that the original error propagates as
    ``ChunkRetryExceeded``."""

    max_retries: int = 2               # extra attempts per chunk after the first
    speculate: bool = True             # duplicate straggling in-flight chunks
    straggler_factor: float = 4.0      # in-flight > factor x median(done) => straggler
    min_completed: int = 3             # completed samples before detection engages
    fault_hook: Optional[Callable[[Any], None]] = None

    def retryable(self, attempt: int) -> bool:
        return attempt < self.max_retries


@dataclass
class FaultStats:
    """Cumulative fault-handling counters of one plan / one pool (the
    analogue of ``JitCacheStats`` for the fault path).  Thread-safe: pooled
    workers bump these concurrently."""

    retries: int = 0          # chunk attempts re-queued after a failure
    speculated: int = 0       # backup copies launched for straggling chunks
    wasted: int = 0           # speculative copies that lost the race
    failed: int = 0           # chunks abandoned after max_retries
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "retries": self.retries,
                "speculated": self.speculated,
                "wasted": self.wasted,
                "failed": self.failed,
            }


class StragglerDetector:
    """Online straggler detection over completed-chunk durations: an
    in-flight chunk whose elapsed time exceeds ``factor`` x the median
    completed duration is a straggler candidate for speculative
    re-execution (first finisher wins — classic backup-task execution).

    The runtime analogue of the simulator's busy_until-based victim pick;
    thread-safe, O(log n) per record via a bounded sorted sample."""

    def __init__(self, factor: float = 4.0, min_completed: int = 3, max_samples: int = 512):
        self.factor = factor
        self.min_completed = min_completed
        self.max_samples = max_samples
        self._lock = threading.Lock()
        self._sorted: List[float] = []

    def record(self, t_ms: float) -> None:
        with self._lock:
            bisect.insort(self._sorted, float(t_ms))
            if len(self._sorted) > self.max_samples:
                # drop the extremes pairwise so the median stays representative
                self._sorted = self._sorted[1:-1]

    def threshold_ms(self) -> Optional[float]:
        """Elapsed time past which an in-flight chunk counts as a
        straggler; None until enough completions have been observed."""
        with self._lock:
            n = len(self._sorted)
            if n < self.min_completed:
                return None
            return self.factor * self._sorted[n // 2]

    def is_straggler(self, elapsed_ms: float) -> bool:
        thr = self.threshold_ms()
        return thr is not None and elapsed_ms > thr


def deterministic_fault_hook(
    rate: float, seed: int = 0, max_faulty_attempts: int = 1
) -> Callable[[Any], None]:
    """A reproducible chunk-fault injector for tests and the serve
    benchmark: fails ~``rate`` of chunks on their first
    ``max_faulty_attempts`` attempts (so every query still completes under
    bounded retry), keyed on the chunk's (op, partition, rows) identity —
    the same chunk fails deterministically across runs and across serial
    vs concurrent execution."""
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"fault rate must be in [0, 1], got {rate}")
    denom = 1_000_000

    def hook(d: Any) -> None:
        if getattr(d, "attempt", 0) >= max_faulty_attempts:
            return
        key = f"{seed}:{d.op}:{d.partition}:{d.rows}".encode()
        if zlib.crc32(key) % denom < int(rate * denom):
            raise InjectedChunkFault(
                f"injected fault: chunk op={d.op} partition={d.partition} "
                f"rows={d.rows} attempt={d.attempt}"
            )

    return hook


class InjectedChunkFault(RuntimeError):
    """Raised by ``deterministic_fault_hook`` — a distinguishable, always
    retryable failure class for fault-injection tests."""


@dataclass(frozen=True)
class Chunk:
    """A unit of schedulable work: [start, start+size) iterations."""

    start: int
    size: int
    attempt: int = 0


@dataclass
class WorkerState:
    alive: bool = True
    busy_until: float = 0.0
    current: Optional[Chunk] = None
    chunks_done: int = 0
    time_busy: float = 0.0
    speed_estimate: float = 1.0


@dataclass
class FTEvent:
    time: float
    kind: str  # 'dispatch' | 'complete' | 'fail' | 'requeue' | 'speculate' | 'join' | 'checkpoint'
    worker: Optional[int]
    chunk: Optional[Chunk]
    note: str = ""


@dataclass
class FTResult:
    makespan: float
    events: List[FTEvent]
    completed: Dict[int, int]  # chunk start -> worker that finished it
    duplicated_work: int  # iterations executed more than once
    lost_work: int  # iterations lost to failures (recomputed)
    checkpoints: int

    def summary(self) -> str:
        return (
            f"makespan={self.makespan:.2f}s chunks={len(self.completed)} "
            f"dup={self.duplicated_work} lost={self.lost_work} ckpt={self.checkpoints}"
        )


class HybridFaultTolerantScheduler:
    """The paper's two-level scheme, simulated deterministically.

    Top level: a dynamic chunk policy (default GSS) pulls chunks off a
    shared queue.  Bottom level: a chunk executes as a *static* schedule on
    the worker (no per-iteration overhead — modeled by `chunk_cost`).

    Fault handling:
      * worker failure mid-chunk → chunk re-queued, worker removed;
      * straggler mitigation  → when the queue is empty and a worker is
        idle, the slowest in-flight chunk is *speculatively duplicated*
        (first finisher wins — classic backup-task execution, which the
        MapReduce paper itself uses);
      * periodic checkpoints → completed-chunk frontier is durable; a full
        restart only replays work after the last checkpoint.
    """

    def __init__(
        self,
        total_iters: int,
        n_workers: int,
        policy: Optional[ChunkPolicy] = None,
        iter_cost: float = 1.0,
        dispatch_overhead: float = 0.01,
        checkpoint_period: float = math.inf,
        speculate: bool = True,
        worker_speed: Optional[Sequence[float]] = None,
    ):
        self.total = total_iters
        self.n0 = n_workers
        self.policy = policy or GuidedSelfScheduling()
        self.iter_cost = iter_cost
        self.overhead = dispatch_overhead
        self.ckpt_period = checkpoint_period
        self.speculate = speculate
        self.speed = list(worker_speed) if worker_speed else [1.0] * n_workers

    def run(self, failures: Optional[Dict[int, float]] = None, joins: Optional[Dict[int, float]] = None) -> FTResult:
        """failures: worker -> time of death; joins: new worker id -> time
        it becomes available (elastic scale-up)."""
        failures = dict(failures or {})
        joins = dict(joins or {})
        self.policy.reset()

        workers: Dict[int, WorkerState] = {w: WorkerState() for w in range(self.n0)}
        events: List[FTEvent] = []
        completed: Dict[int, int] = {}
        inflight: Dict[int, Chunk] = {}
        queue: List[Chunk] = []
        next_iter = 0
        dup_work = 0
        lost_work = 0
        ckpts = 0
        t_last_ckpt = 0.0

        # discrete event loop: (time, seq, kind, worker)
        eq: List[Tuple[float, int, str, int]] = []
        seq = 0
        for w in workers:
            heapq.heappush(eq, (0.0, seq, "idle", w))
            seq += 1
        for w, t in failures.items():
            heapq.heappush(eq, (t, seq, "fail", w))
            seq += 1
        for w, t in joins.items():
            heapq.heappush(eq, (t, seq, "join", w))
            seq += 1

        def n_live() -> int:
            return sum(1 for s in workers.values() if s.alive)

        def work_remaining() -> bool:
            return bool(queue) or next_iter < self.total or any(
                c.start not in completed for c in inflight.values()
            )

        t_now = 0.0
        while eq:
            t_now, _, kind, w = heapq.heappop(eq)

            if kind == "fail":
                st = workers.get(w)
                if st is None or not st.alive:
                    continue
                st.alive = False
                if st.current is not None and st.current.start not in completed:
                    # chunk lost — requeue (paper: only that chunk recomputed)
                    lost = st.current
                    frac = min(1.0, max(0.0, (t_now - (st.busy_until - self._cost(lost, w))) / max(self._cost(lost, w), 1e-9)))
                    lost_work += int(lost.size * frac)
                    queue.append(Chunk(lost.start, lost.size, lost.attempt + 1))
                    inflight.pop(w, None)
                    events.append(FTEvent(t_now, "requeue", w, lost, "failure requeue"))
                events.append(FTEvent(t_now, "fail", w, st.current))
                st.current = None
                if n_live() == 0 and work_remaining():
                    raise RuntimeError("all workers dead with work remaining — restart from checkpoint required")
                continue

            if kind == "join":
                workers[w] = WorkerState()
                if w >= len(self.speed):
                    self.speed.extend([1.0] * (w - len(self.speed) + 1))
                events.append(FTEvent(t_now, "join", w, None))
                heapq.heappush(eq, (t_now, seq, "idle", w))
                seq += 1
                continue

            st = workers.get(w)
            if st is None or not st.alive:
                continue

            if kind == "complete":
                c = st.current
                st.current = None
                inflight.pop(w, None)
                if c is not None:
                    if c.start in completed:
                        dup_work += c.size  # lost the speculation race
                    else:
                        completed[c.start] = w
                        st.chunks_done += 1
                    events.append(FTEvent(t_now, "complete", w, c))
                # checkpoint frontier
                if t_now - t_last_ckpt >= self.ckpt_period:
                    ckpts += 1
                    t_last_ckpt = t_now
                    events.append(FTEvent(t_now, "checkpoint", None, None, f"{len(completed)} chunks durable"))
                heapq.heappush(eq, (t_now, seq, "idle", w))
                seq += 1
                continue

            # kind == 'idle': pull work
            if queue:
                c = queue.pop(0)
            elif next_iter < self.total:
                size = self.policy.next_chunk(self.total - next_iter, n_live(), w, [])
                size = max(1, min(size, self.total - next_iter))
                c = Chunk(next_iter, size)
                next_iter += size
            elif self.speculate and inflight:
                # straggler mitigation: duplicate the chunk predicted to
                # finish last (backup task)
                victim_w, victim_c = max(
                    inflight.items(), key=lambda kv: workers[kv[0]].busy_until
                )
                if workers[victim_w].busy_until > t_now + self._cost(victim_c, w):
                    c = Chunk(victim_c.start, victim_c.size, victim_c.attempt + 1)
                    events.append(FTEvent(t_now, "speculate", w, c, f"backup of worker {victim_w}"))
                else:
                    continue
            else:
                continue
            cost = self._cost(c, w)
            st.current = c
            st.busy_until = t_now + cost
            st.time_busy += cost
            inflight[w] = c
            events.append(FTEvent(t_now, "dispatch", w, c))
            heapq.heappush(eq, (t_now + cost, seq, "complete", w))
            seq += 1

        makespan = max((e.time for e in events if e.kind == "complete"), default=0.0)
        return FTResult(makespan, events, completed, dup_work, lost_work, ckpts)

    def _cost(self, c: Chunk, w: int) -> float:
        return c.size * self.iter_cost / self.speed[w] + self.overhead


def verify_coverage(result: FTResult, total: int) -> bool:
    """Every iteration executed exactly once in the completed set."""
    seen: Set[int] = set()
    starts = sorted(result.completed.keys())
    # Reconstruct sizes from gaps: chunks are [start, next_start)
    # — callers should use contiguous chunking; we check coverage by
    # replaying starts against total.
    covered = 0
    for i, s in enumerate(starts):
        end = starts[i + 1] if i + 1 < len(starts) else total
        if s != covered:
            return False
        covered = end
    return covered == total
