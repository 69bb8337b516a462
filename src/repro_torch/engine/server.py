# Multi-tenant query serving (paper §I: one compiler IR as the *shared
# infrastructure* under many Big Data frontends).  A ``QueryServer`` turns
# the single-session engine into a serving process:
#
#   tenant threads → admission control → per-tenant Session (shared db,
#   shared PlanCache, shared MetricsRegistry) → compiled plan →
#   SharedChunkPool (one worker pool for *all* queries' chunks)
#
# Admission control bounds concurrent queries (reject or block on
# overload); a shared cross-session plan cache plus single-flight
# compilation means identical logical queries from different tenants
# compile exactly once; chunk dispatch inherits the fault-tolerant retry /
# speculation machinery (sched.fault_tolerant) wired through
# ``backends/partitioned.py``; and the pool scales its worker count
# up/down with queue depth under ``sched.elastic.PoolScalePolicy``'s
# hysteresis.  Every decision — admit / reject / retry / speculate /
# scale — lands in ``repro_torch.obs`` spans and metrics.  On a CUDA device
# each pool worker runs its chunks on its own CUDA stream.
from __future__ import annotations

import heapq
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Set, Tuple

import torch

from repro_torch.backends.partitioned import StreamHandoff
from repro_torch.data.multiset import Database
from repro_torch.engine.session import EngineError, QueryResult, Session, resolve_device
from repro_torch.frontends.mapreduce import MapReduceSpec
from repro_torch.obs import NULL_TRACER, MetricsRegistry, Tracer
from repro_torch.planner import PlanCache
from repro_torch.sched.elastic import PoolScalePolicy
from repro_torch.sched.fault_tolerant import (
    ChunkRetryExceeded,
    RetryPolicy,
    StragglerDetector,
)


class AdmissionError(EngineError):
    """Raised by ``QueryServer.submit`` when the submission queue is full
    and the admission policy is 'reject' (backpressure: the caller should
    retry later or shed load)."""


# ---------------------------------------------------------------------------
# Shared chunk worker pool
# ---------------------------------------------------------------------------


class _OpRun:
    """One op's chunk set in flight on the shared pool: per-op results,
    completion flags and fault bookkeeping, all guarded by the pool's
    condition variable (completion must wake the waiting query thread)."""

    __slots__ = (
        "chunks", "work", "tr", "traced", "op_id", "fault", "fault_stats",
        "metrics", "results", "done", "ndone", "errors", "inflight",
        "speculated", "detector", "t0", "handoff",
    )

    def __init__(self, chunks, work, tr, op_id, fault, fault_stats, metrics, handoff):
        self.chunks = chunks
        self.work = work
        self.tr = tr
        self.traced = bool(getattr(tr, "enabled", False))
        self.op_id = op_id
        self.fault = fault
        self.fault_stats = fault_stats
        self.metrics = metrics
        self.results: List[Any] = [None] * len(chunks)
        self.done = [False] * len(chunks)
        self.ndone = 0
        self.errors: List[BaseException] = []
        self.inflight: Dict[int, float] = {}
        self.speculated: Set[int] = set()
        self.detector = (
            StragglerDetector(fault.straggler_factor, fault.min_completed)
            if fault is not None and fault.speculate
            else None
        )
        self.t0 = time.perf_counter()
        self.handoff = handoff

    @property
    def finished(self) -> bool:
        return bool(self.errors) or self.ndone >= len(self.chunks)


class SharedChunkPool:
    """One chunk worker pool serving every concurrent query of a
    ``QueryServer`` (the plural of ``partitioned._dispatch``'s per-query
    pool).  Plans delegate here via their ``chunk_executor`` attachment:
    ``run_chunks`` enqueues one prioritized task per chunk and blocks the
    query's own thread until its op completes, while pool workers drain
    the global queue — so a K-chunk query from one tenant and a K-chunk
    query from another interleave on the same threads instead of
    oversubscribing the host 2×.

    Fault tolerance matches the local pool: a failing chunk is re-queued
    (at front-of-queue priority) up to ``RetryPolicy.max_retries``; the
    waiting query thread watches its op's in-flight chunks and enqueues one
    speculative backup per straggler; the first finisher wins (results are
    deterministic, so either attempt's value is THE value and chunk-order
    merging stays bit-identical to serial).

    Elasticity: ``PoolScalePolicy`` hysteresis grows the pool on sustained
    queue pressure (checked at enqueue time) and retires workers idle past
    ``idle_timeout``, never below ``min_workers``.

    Limitation: the shared pool does NOT perform mid-run straggler
    *splitting* (``SplitPolicy``) — chunk lists here are shared across
    tenants and re-shaping one query's chunks under the pool lock would
    stall the others.  Skewed partitions on the shared pool are instead
    handled across runs by feedback-driven re-planning (the next plan of
    that fingerprint picks a finer/guided chunk policy up front)."""

    # queue priorities: retries and speculative backups outrank any fresh
    # submission (they gate an already-running query's completion)
    _URGENT = -1

    def __init__(
        self,
        policy: Optional[PoolScalePolicy] = None,
        *,
        tracer: Any = NULL_TRACER,
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.policy = policy if policy is not None else PoolScalePolicy()
        self.tracer = tracer
        self.metrics = metrics
        self._cv = threading.Condition()
        # heap of (priority, seq, op, chunk_index, is_backup)
        self._queue: List[Tuple[int, int, _OpRun, int, bool]] = []
        self._seq = 0
        self._stop = False
        self._tls = threading.local()
        self.n_workers = 0
        self._next_wid = 0
        self._threads: List[threading.Thread] = []
        with self._cv:
            for _ in range(self.policy.initial_workers()):
                self._spawn_locked()

    # -- priority context ----------------------------------------------------
    @contextmanager
    def priority(self, prio: int) -> Iterator[None]:
        """Chunk-queue priority for ops submitted by this thread (lower is
        sooner); the server wraps each query's execution in its submission
        priority."""
        old = getattr(self._tls, "priority", 0)
        self._tls.priority = prio
        try:
            yield
        finally:
            self._tls.priority = old

    # -- executor protocol (PartitionedPlan.chunk_executor) ------------------
    def run_chunks(
        self,
        chunks: List[Tuple[int, Any, Any]],
        work: Callable[[Tuple[int, Any, Any]], Any],
        *,
        tr: Any = NULL_TRACER,
        op_id: Any = None,
        fault: Optional[RetryPolicy] = None,
        fault_stats: Any = None,
        metrics: Any = None,
        device: Any = None,
    ) -> List[Any]:
        """Run one op's chunks on the shared pool; returns results in chunk
        order.  Blocks the calling (query) thread until every chunk
        completed or a chunk exhausted its retries.  ``device`` is where the
        chunks' tensors live: on a CUDA device every worker's stream first
        waits for the caller's stream, and each result is handed back after
        an event sync on the stream that made it."""
        if not chunks:
            return []
        prio = getattr(self._tls, "priority", 0)
        op = _OpRun(chunks, work, tr, op_id, fault, fault_stats,
                    metrics if metrics is not None else self.metrics, StreamHandoff(device))
        with self._cv:
            for i in range(len(chunks)):
                self._push_locked(prio, op, i, backup=False)
            self._cv.notify_all()
            self._maybe_grow_locked()
            while not op.finished:
                self._speculate_locked(op)
                self._cv.wait(timeout=0.005)
        if op.errors:
            raise op.errors[0]
        return op.results

    # -- internals (call with self._cv held) ---------------------------------
    def _push_locked(self, prio: int, op: _OpRun, i: int, backup: bool) -> None:
        self._seq += 1
        heapq.heappush(self._queue, (prio, self._seq, op, i, backup))
        if self.metrics is not None:
            self.metrics.set_gauge("serve.pool.queue_depth", len(self._queue))

    def _spawn_locked(self) -> None:
        wid = self._next_wid
        self._next_wid += 1
        t = threading.Thread(target=self._worker, args=(wid,), daemon=True,
                             name=f"chunk-pool-{wid}")
        self.n_workers += 1
        self._threads.append(t)
        t.start()

    def _maybe_grow_locked(self) -> None:
        now = time.perf_counter()
        while self.policy.want_grow(len(self._queue), self.n_workers, now):
            self._spawn_locked()
            self.policy.note("up", self.n_workers, len(self._queue), now)
            self._note_scale("up")

    def _note_scale(self, kind: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(f"serve.pool.scale_{kind}")
            self.metrics.set_gauge("serve.pool.workers", self.n_workers)
        if getattr(self.tracer, "enabled", False):
            s = self.tracer.start("serve.scale", kind=kind, n_workers=self.n_workers,
                                  queue_depth=len(self._queue))
            self.tracer.end(s)

    def _speculate_locked(self, op: _OpRun) -> None:
        """Query-side straggler watch: while an op waits, chunks running
        past the detector threshold get ONE speculative backup each, at
        urgent priority (re-execution elsewhere — the paper's §III-A3
        dynamic answer to a slow node)."""
        det = op.detector
        if det is None:
            return
        thr = det.threshold_ms()
        if thr is None:
            return
        now = time.perf_counter()
        for j, tj in list(op.inflight.items()):
            if op.done[j] or j in op.speculated:
                continue
            if (now - tj) * 1e3 < thr:
                continue
            op.speculated.add(j)
            d = op.chunks[j][2]
            d.speculated = True
            if op.fault_stats is not None:
                op.fault_stats.bump("speculated")
            if op.metrics is not None:
                op.metrics.inc("serve.chunk.speculated")
            if op.traced:
                s = op.tr.start("fault.speculate", parent=op.op_id,
                                op=d.op, partition=d.partition)
                op.tr.end(s)
            self._push_locked(self._URGENT, op, j, backup=True)
        self._cv.notify_all()

    # -- worker loop ----------------------------------------------------------
    def _worker(self, wid: int) -> None:
        # this worker's own CUDA stream on each device it has run chunks for
        streams: Dict[Any, Any] = {}
        idle_t0 = time.perf_counter()
        while True:
            with self._cv:
                while not self._queue:
                    if self._stop:
                        return
                    if self.policy.want_shrink(
                        time.perf_counter() - idle_t0, self.n_workers
                    ):
                        self.n_workers -= 1
                        self.policy.note("down", self.n_workers, 0, time.perf_counter())
                        self._note_scale("down")
                        return
                    self._cv.wait(timeout=0.02)
                if self._stop:
                    return
                _, _, op, i, backup = heapq.heappop(self._queue)
                if self.metrics is not None:
                    self.metrics.set_gauge("serve.pool.queue_depth", len(self._queue))
                if op.done[i] or op.errors:
                    continue
            hd = op.handoff
            if hd.cuda and hd.device not in streams:
                streams[hd.device] = hd.new_stream()
            self._run_one(op, i, backup, wid, streams.get(hd.device))
            idle_t0 = time.perf_counter()

    def _run_one(
        self, op: _OpRun, i: int, backup: bool, wid: int, stream: Optional[torch.cuda.Stream]
    ) -> None:
        ch = op.chunks[i]
        d = ch[2]
        fault = op.fault
        t0 = time.perf_counter()
        with self._cv:
            if not backup:
                op.inflight.setdefault(i, t0)
                if d.queue_ms == 0.0:
                    d.queue_ms = (t0 - op.t0) * 1e3
        s = op.tr.start("dispatch", parent=op.op_id, seq=i, worker=wid) if op.traced else None
        try:
            # a speculative backup skips the fault hook — it models the
            # retry landing on a different (healthy) worker
            if fault is not None and fault.fault_hook is not None and not backup:
                fault.fault_hook(d)
            with op.handoff.on(stream):
                r = op.work(ch)
            op.handoff.finish(stream, r)
        except BaseException as e:
            if op.traced:
                op.tr.end(s, error=type(e).__name__)
            with self._cv:
                if op.done[i]:
                    self._cv.notify_all()
                    return
                if fault is not None and fault.retryable(d.attempt):
                    d.attempt += 1
                    if op.fault_stats is not None:
                        op.fault_stats.bump("retries")
                    if op.metrics is not None:
                        op.metrics.inc("serve.chunk.retries")
                    if op.traced:
                        rs = op.tr.start("fault.retry", parent=op.op_id, op=d.op,
                                         partition=d.partition, attempt=d.attempt)
                        op.tr.end(rs)
                    self._push_locked(self._URGENT, op, i, backup=False)
                else:
                    if fault is not None:
                        if op.fault_stats is not None:
                            op.fault_stats.bump("failed")
                        err: BaseException = ChunkRetryExceeded(
                            f"chunk {d.op}[p{d.partition}] failed after "
                            f"{d.attempt + 1} attempts"
                        )
                        err.__cause__ = e
                    else:
                        err = e
                    op.errors.append(err)
                self._cv.notify_all()
            return
        t_ms = (time.perf_counter() - t0) * 1e3
        with self._cv:
            if op.done[i]:
                # lost the first-finisher race (deterministic results make
                # the loser's value identical — dropping it is safe)
                if op.fault_stats is not None:
                    op.fault_stats.bump("wasted")
                self._cv.notify_all()
                if op.traced:
                    op.tr.end(s, wasted=True, seq=i)
                return
            op.done[i] = True
            op.ndone += 1
            op.results[i] = r
            op.inflight.pop(i, None)
            d.worker = wid
            d.t_ms = t_ms
            if op.detector is not None:
                op.detector.record(t_ms)
            self._cv.notify_all()
        if op.traced:
            op.tr.end(s, **d.trace_attrs())

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            return {
                "n_workers": self.n_workers,
                "queue_depth": len(self._queue),
                "scale_events": [
                    {"kind": e.kind, "n_workers": e.n_workers, "queue_depth": e.queue_depth}
                    for e in self.policy.events
                ],
            }


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------


class QueryServer:
    """Serves queries from many concurrent tenants over one engine.

    >>> srv = QueryServer(n_partitions=8, max_pending=16)   # device="cpu" off the card
    >>> srv.register("access", url=..., size=...)
    >>> r = srv.submit("SELECT url, COUNT(url) FROM access GROUP BY url",
    ...                tenant="alice", priority=1)

    Shared state: one ``Database``, one ``PlanCache`` (identical logical
    queries from different tenants compile once — guarded by single-flight
    locks so racing first submissions do not compile twice), one
    ``MetricsRegistry``, one ``SharedChunkPool``.  Per-tenant state: a
    ``Session`` (its own parse/dispatch memos, query log and stats epoch
    view), created lazily per tenant id with the serving posture —
    ``revalidate='signature'`` (O(#tables) per dispatch; tables are
    treated as immutable between ``register`` calls) and
    ``reformat=False`` (a background reformat would fork the shared
    database under the other tenants).

    Admission control: at most ``max_pending`` queries are in flight;
    beyond that ``admission='reject'`` raises :class:`AdmissionError`
    (shed load) and ``admission='block'`` waits for a slot
    (backpressure).  ``priority`` orders *chunk* scheduling on the shared
    pool, so an admitted high-priority query overtakes lower-priority
    work at every dispatch boundary.

    Adaptive re-optimization (``feedback=True``): the server owns ONE
    shared ``FeedbackStore`` whose LRU budget spans all tenants, but
    profiles are keyed per tenant — tenant A's measured selectivities
    never steer tenant B's plans (workloads with per-tenant parameter
    skew must not cross-contaminate).  ``drift_band`` is the shared
    re-planning tolerance.

    ``device``: where every tenant's plans run — None means 'cuda', and
    raises EngineError when no CUDA device is present (pass device='cpu'
    to serve on the CPU), as ``Session`` does."""

    def __init__(
        self,
        db: Optional[Database] = None,
        *,
        backend: str = "partitioned",
        device: Optional[str] = None,
        n_partitions: Optional[int] = None,
        schedule: str = "auto",
        jit_chunks: bool = True,
        max_pending: int = 16,
        admission: str = "reject",
        fault: Optional[RetryPolicy] = None,
        scale: Optional[PoolScalePolicy] = None,
        plan_cache: Optional[PlanCache] = None,
        metrics: Optional[MetricsRegistry] = None,
        trace: bool = False,
        max_query_log: int = 256,
        feedback: Any = False,
        drift_band: float = 2.0,
    ):
        if admission not in ("reject", "block"):
            raise EngineError(f"admission must be 'reject' or 'block', got {admission!r}")
        if max_pending < 1:
            raise EngineError(f"max_pending must be >= 1, got {max_pending}")
        self.device = resolve_device(device)
        self.db = db if db is not None else Database()
        self.backend = backend
        self.n_partitions = n_partitions
        self.schedule = schedule
        self.jit_chunks = jit_chunks
        self.max_pending = max_pending
        self.admission = admission
        self.fault = fault
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = Tracer() if trace else NULL_TRACER
        self.max_query_log = max_query_log
        if feedback is True:
            from repro_torch.planner import FeedbackStore

            self.feedback: Any = FeedbackStore()
        elif feedback is False or feedback is None:
            self.feedback = None
        else:
            # a store instance (possibly empty, hence no truthiness test)
            self.feedback = feedback
        self.drift_band = drift_band
        self.pool = SharedChunkPool(scale, tracer=self.tracer, metrics=self.metrics)
        self._sessions: Dict[str, Session] = {}
        self._sessions_lock = threading.Lock()
        # admission state: count of admitted, not-yet-finished queries
        self._admit_cv = threading.Condition()
        self._inflight = 0
        # single-flight compilation: first submission of a logical query
        # holds its key lock through execution; racers for the SAME key
        # wait, then hit the shared plan cache — distinct keys never block
        # each other
        self._sf_lock = threading.Lock()
        self._sf_done: Set[Tuple[str, str]] = set()
        self._sf_locks: Dict[Tuple[str, str], threading.Lock] = {}
        self._closed = False

    # -- tables ---------------------------------------------------------------
    def register(self, table: Any, **columns: Any) -> "QueryServer":
        """Register (or replace) a table in the shared database.  Epoch
        bumps and plan-cache invalidation follow ``Session.register``;
        compiled-key memos reset so changed data recompiles."""
        self._admin().register(table, **columns)
        with self._sf_lock:
            self._sf_done.clear()
            self._sf_locks.clear()
        return self

    def _admin(self) -> Session:
        return self.session("__admin__")

    # -- sessions -------------------------------------------------------------
    def session(self, tenant: str = "default") -> Session:
        """The tenant's Session (created on first use), wired to every
        piece of shared state."""
        with self._sessions_lock:
            sess = self._sessions.get(tenant)
            if sess is None:
                sess = self._sessions[tenant] = Session(
                    self.db,
                    backend=self.backend,
                    device=self.device,
                    n_partitions=self.n_partitions,
                    schedule=self.schedule,
                    jit_chunks=self.jit_chunks,
                    async_dispatch=True,
                    plan_cache=self.plan_cache,
                    reformat=False,
                    revalidate="signature",
                    metrics=self.metrics,
                    trace=self.tracer if self.tracer.enabled else False,
                    max_query_log=self.max_query_log,
                    fault=self.fault,
                    chunk_executor=self.pool,
                    feedback=self.feedback if self.feedback is not None else False,
                    feedback_tenant=tenant,
                    drift_band=self.drift_band,
                )
            return sess

    def tenants(self) -> List[str]:
        with self._sessions_lock:
            return sorted(t for t in self._sessions if t != "__admin__")

    # -- admission ------------------------------------------------------------
    def _admit(self, tenant: str, priority: int) -> None:
        with self._admit_cv:
            if self._inflight < self.max_pending:
                self._inflight += 1
                self.metrics.inc("serve.admitted")
                self._trace_admit("admit", tenant, priority)
                return
            if self.admission == "reject":
                self.metrics.inc("serve.rejected")
                self._trace_admit("reject", tenant, priority)
                raise AdmissionError(
                    f"submission queue full ({self._inflight}/{self.max_pending} in flight)"
                )
            t0 = time.perf_counter()
            self.metrics.inc("serve.blocked")
            self._trace_admit("block", tenant, priority)
            while self._inflight >= self.max_pending:
                self._admit_cv.wait()
            self._inflight += 1
            self.metrics.inc("serve.admitted")
            self.metrics.observe("serve.block_ms", (time.perf_counter() - t0) * 1e3)

    def _release(self) -> None:
        with self._admit_cv:
            self._inflight -= 1
            self._admit_cv.notify()

    def _trace_admit(self, decision: str, tenant: str, priority: int) -> None:
        if self.tracer.enabled:
            s = self.tracer.start("serve.admission", decision=decision,
                                  tenant=tenant, priority=priority,
                                  inflight=self._inflight)
            self.tracer.end(s)

    # -- single-flight compilation --------------------------------------------
    @contextmanager
    def _single_flight(self, key: Tuple[str, str]) -> Iterator[None]:
        with self._sf_lock:
            if key in self._sf_done:
                yield
                return
            lk = self._sf_locks.setdefault(key, threading.Lock())
        with lk:
            try:
                yield
            finally:
                with self._sf_lock:
                    self._sf_done.add(key)

    # -- submission -----------------------------------------------------------
    def submit(
        self,
        query: Any,
        params: Optional[Dict[str, Any]] = None,
        *,
        tenant: str = "default",
        priority: int = 0,
    ) -> QueryResult:
        """Submit one query (SQL string or ``MapReduceSpec``) on the
        calling thread and return its :class:`QueryResult`.

        ``query`` is either a SQL string (parameterized with ``:name``
        placeholders bound from ``params``) or a ``MapReduceSpec``.
        ``tenant`` selects the per-tenant :class:`Session` (created on
        first use); all tenants share the plan cache, chunk pool,
        metrics registry and — when the server was built with
        ``feedback=True`` — the feedback store, though observed profiles
        remain keyed per tenant.  ``priority`` (higher = sooner) orders
        this query's chunks on the shared pool relative to concurrent
        submissions.

        Admission control applies before any work: under
        ``admission='reject'`` a full server raises
        :class:`AdmissionError`; under ``'block'`` the call waits for an
        in-flight slot.  Identical logical queries race through a
        single-flight latch so only one thread compiles; the rest reuse
        the shared plan cache."""
        if self._closed:
            raise EngineError("QueryServer is closed")
        is_mr = isinstance(query, MapReduceSpec)
        key = ("mr", repr(query)) if is_mr else ("sql", str(query))
        t0 = time.perf_counter()
        self._admit(tenant, priority)
        try:
            sess = self.session(tenant)
            with self._single_flight(key):
                with self.pool.priority(priority):
                    qr = sess.mapreduce(query, params) if is_mr else sess.sql(str(query), params)
            self.metrics.observe("serve.latency_ms", (time.perf_counter() - t0) * 1e3)
            return qr
        finally:
            self._release()

    # -- introspection / lifecycle --------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """One serving-level snapshot: admission counters, pool state and
        the shared plan cache (``plan_cache.misses`` == number of distinct
        logical queries compiled, the CI-gated counter)."""
        snap = self.metrics.snapshot()
        st = self.plan_cache.stats()
        return {
            "metrics": snap,
            "plan_cache": st,
            "pool": self.pool.stats(),
            "inflight": self._inflight,
        }

    def close(self) -> None:
        self._closed = True
        self.pool.close()

    def __enter__(self) -> "QueryServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
