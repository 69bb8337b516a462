# The unified query engine's front door (paper §I: "all problems can be
# expressed in this single intermediate representation, allowing a single
# 'super'-optimizer to be employed").
#
# A ``Session`` owns a Database, a plan cache and the planning options, and
# routes *every* frontend through one pipeline:
#
#   frontend (SQL | MapReduce) → forelem IR → canonicalization →
#   query-optimization passes → cost planner → plan cache →
#   backend lowering (repro_torch.backends registry) → results
#
# Routing MapReduce through the planner means MR jobs get cost-picked
# agg_method / parallel / partition-field decisions exactly like SQL — and
# because array names are canonicalized and fingerprints are
# name-independent, the same logical query submitted via either frontend
# hits the *same* plan-cache entry.
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Deque, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.analysis import IRVerificationError, LintWarning, lint_program, render_lint, verify_program
from repro_torch.core.ir import Program
from repro_torch.core.passes import OptimizeOptions, OptimizeResult, optimize
from repro_torch.core.transforms import canonicalize_array_names
from repro_torch.data.multiset import Database, Multiset
from repro_torch.frontends.mapreduce import MapReduceSpec, mapreduce_to_forelem
from repro_torch.frontends.sql import sql_to_forelem
from repro_torch.obs import NULL_TRACER, MetricsRegistry, QueryTrace, Tracer
from repro_torch.planner import PlanCache


class EngineError(Exception):
    pass


def resolve_device(device: Optional[str]) -> str:
    """The device a Session or QueryServer runs on: None means 'cuda', and
    asking for a CUDA device where torch sees none raises EngineError — the
    engine never falls back to the CPU without being told."""
    if device is None:
        if not torch.cuda.is_available():
            raise EngineError(
                "no CUDA device: the engine runs on the card by default — "
                "pass device='cpu' to run on the CPU"
            )
        return "cuda"
    if str(device).startswith("cuda") and not torch.cuda.is_available():
        raise EngineError(f"device={device!r} asked for, but no CUDA device is present")
    return str(device)


@dataclass
class QueryResult:
    """Outcome of one query submitted through a ``Session``.

    ``results`` maps result names to densified values (lists of tuples for
    multiset results, Python scalars otherwise); ``rows`` is the
    conventional single multiset result ``R``."""

    results: Dict[str, Any]
    source: str                      # 'sql' | 'mapreduce'
    query: str                       # original SQL text / MR spec repr
    explain: Optional[str]           # EXPLAIN text (cost planner only)
    cache_hit: bool                  # plan served from the plan cache
    dispatch_hit: bool               # whole dispatch served from the warm path
    elapsed_s: float
    program: Program
    decision: Any = None             # planner.Decision
    plan: Any = None                 # the backend's ExecutablePlan

    @property
    def rows(self) -> Optional[List[Tuple]]:
        r = self.results.get("R")
        return r if isinstance(r, list) else None

    def scalar(self, name: str = "scalar") -> Any:
        return self.results[name]


@dataclass
class CheckReport:
    """Outcome of ``Session.check(query)``: static verification + lint of a
    query without executing (or even compiling) it.

    ``ok`` means the frontend-produced IR passed the verifier; ``warnings``
    are advisory lint findings (legal but likely slow or wrong-in-intent)."""

    query: str
    source: str                      # 'sql' | 'mapreduce'
    program: Program
    ok: bool
    error: Optional[IRVerificationError]
    warnings: List[LintWarning]

    def __str__(self) -> str:
        head = f"CHECK {self.query}"
        if not self.ok:
            return f"{head}\n  verifier: FAILED\n    {self.error}"
        return f"{head}\n  verifier: ok ({len(self.warnings)} lint warning(s))\n{render_lint(self.warnings)}"


@dataclass(frozen=True)
class QueryLogEntry:
    """Metadata-only record kept in ``Session.history`` (no result rows,
    no plan objects — a bounded log must not pin those)."""

    source: str
    query: str
    cache_hit: bool
    dispatch_hit: bool
    elapsed_s: float


class Session:
    """Front door of the unified query engine.

    >>> s = Session(n_parts=8)          # on the card; Session(device="cpu") on the CPU
    >>> s.register("access", url=np.array([...]))
    >>> s.sql("SELECT url, COUNT(url) FROM access GROUP BY url").rows
    >>> s.mapreduce(MapReduceSpec.count("access", "url")).rows   # same plan-cache entry
    >>> print(s.explain("SELECT url, COUNT(url) FROM access GROUP BY url"))

    The session owns the stats epoch: registering or replacing a table bumps
    it (replacement also invalidates the old epoch's plan-cache entries so a
    stale compiled plan can never be served), and data reformatting done by
    the optimizer persists across queries (the paper's amortization model).

    With ``feedback`` enabled the session also closes the adaptive
    re-optimization loop (planner/feedback.py): every run's measured
    selectivity / row skew / chunk cost is recorded, drift outside
    ``drift_band`` invalidates the cached plan so the next dispatch
    re-plans against the observations, and pathological partitions are
    split mid-run (``replan.split``).

    Constructor arguments:

    ``db``              database to serve (a fresh empty one by default).
    ``n_parts``         target parallel width for the monolithic backends.
    ``planner``         'cost' (default: statistics-driven planning with a
                        plan cache) or 'none' (the fixed pass pipeline).
    ``backend``         executor: 'torch' | 'reference' | 'partitioned'.
    ``device``          where the 'torch' and 'partitioned' backends run:
                        None means 'cuda', and raises EngineError when no
                        CUDA device is present (pass device='cpu' to run on
                        the CPU).
    ``n_partitions``    pin the partitioned backend's K (None = planner).
    ``schedule``        pin the chunk schedule policy ('static' | 'fixed' |
                        'guided'); 'auto' leaves it to the planner.
    ``jit_chunks``      bucketed chunk kernels, captured in CUDA graphs on
                        the card (partitioned backend).
    ``async_dispatch``  worker-pool chunk dispatch, one CUDA stream per
                        worker (partitioned backend).
    ``plan_cache``      planner.PlanCache to share (a QueryServer passes
                        its server-wide cache); None = private cache.
    ``reformat``        allow amortized data reformatting.
    ``expected_runs``   reformatting amortization horizon.
    ``history_limit`` / ``max_query_log``
                        cap of the metadata-only query log ring buffer.
    ``revalidate``      'content' re-hashes table data per dispatch;
                        'signature' only checks table identity (serving).
    ``trace``           True → collect per-stage spans on every query
                        (``take_trace()``); or pass a ``Tracer`` to share.
                        ``profile()`` scopes a tracer to one block instead.
    ``metrics``         MetricsRegistry to feed (shared by a QueryServer);
                        None = a private registry (``metrics()`` snapshot).
    ``fault``           sched.fault_tolerant.RetryPolicy for chunk retries.
    ``chunk_executor``  shared chunk pool (engine.server.SharedChunkPool).
    ``feedback``        adaptive re-optimization: True → private
                        FeedbackStore; a FeedbackStore instance → shared
                        (the QueryServer wiring); False/None → open loop.
    ``drift_band``      observed/estimated tolerance band (default 2×)
                        before the drift trigger invalidates the plan.
    ``feedback_tenant`` tenant label namespacing profiles in a shared
                        FeedbackStore (set by ``QueryServer.session``).
    """

    def __init__(
        self,
        db: Optional[Database] = None,
        *,
        n_parts: int = 1,
        planner: str = "cost",
        backend: str = "torch",
        device: Optional[str] = None,
        n_partitions: Optional[int] = None,
        schedule: str = "auto",
        jit_chunks: bool = True,
        async_dispatch: bool = True,
        plan_cache: Optional[PlanCache] = None,
        reformat: bool = True,
        expected_runs: int = 20,
        history_limit: int = 256,
        max_query_log: Optional[int] = None,
        revalidate: str = "content",
        trace: Union[bool, Tracer] = False,
        metrics: Optional[MetricsRegistry] = None,
        fault: Any = None,
        chunk_executor: Any = None,
        feedback: Any = False,
        drift_band: float = 2.0,
        feedback_tenant: str = "",
    ):
        if revalidate not in ("content", "signature"):
            raise EngineError(f"revalidate must be 'content' or 'signature', got {revalidate!r}")
        if schedule != "auto":
            from repro_torch.backends.partitioned import normalize_schedule

            try:
                schedule = normalize_schedule(schedule)
            except ValueError as e:
                raise EngineError(str(e)) from None
        device = resolve_device(device)
        self.db = db if db is not None else Database()
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache()
        self.n_parts = n_parts
        self.planner = planner
        self.backend = backend
        self.device = str(device)
        # partitioned-backend knobs (ignored by the monolithic executors):
        # K-way data distribution and the chunk-schedule policy; None /
        # 'auto' leave the choice to the cost planner
        self.n_partitions = n_partitions
        self.schedule = schedule
        # bucketed captured chunk kernels + worker-pool dispatch
        # (backends/partitioned.py); part of the plan-cache fingerprint
        self.jit_chunks = jit_chunks
        self.async_dispatch = async_dispatch
        self.reformat = reformat
        self.expected_runs = expected_runs
        self.revalidate = revalidate
        # lightweight query log: metadata only — QueryResults pin their full
        # densified rows and compiled plans, which a log must not retain.
        # A *ring buffer*: the cap (``max_query_log``, or the legacy
        # ``history_limit`` spelling) evicts the oldest entry, so long-lived
        # serving sessions never grow without bound.
        cap = max_query_log if max_query_log is not None else history_limit
        if cap is not None and cap < 1:
            raise EngineError(f"max_query_log must be >= 1, got {cap}")
        self.max_query_log = cap
        self.history: Deque[QueryLogEntry] = deque(maxlen=cap)
        # observability (repro_torch.obs): the session-scoped tracer — NULL_TRACER
        # unless tracing was requested (zero-overhead no-ops on every hot
        # path) — and the metrics registry every query feeds.  A fresh
        # registry per session by default; pass ``repro_torch.obs.METRICS`` to
        # share the process-wide one across sessions.
        if isinstance(trace, (Tracer,)):
            self.tracer: Any = trace
        else:
            self.tracer = Tracer() if trace else NULL_TRACER
        self.metrics_registry = metrics if metrics is not None else MetricsRegistry()
        # serving-time execution policy, attached to every compiled plan on
        # the dispatch path (run-time attachments — deliberately NOT part of
        # the plan-cache fingerprint, see ``_configure_plan``): a
        # ``sched.fault_tolerant.RetryPolicy`` and a shared chunk executor
        # (``engine.server.SharedChunkPool``)
        self.fault = fault
        self.chunk_executor = chunk_executor
        # adaptive re-optimization (planner/feedback.py): the feedback store
        # (True = private, or a shared FeedbackStore), the drift band the
        # trigger compares observed/estimated ratios against, and the tenant
        # label isolating this session's profiles in a shared store
        if feedback is True:
            from repro_torch.planner import FeedbackStore

            self.feedback: Any = FeedbackStore()
        elif feedback is False or feedback is None:
            self.feedback = None
        else:
            # a store instance (possibly empty, hence no truthiness test)
            self.feedback = feedback
        if drift_band < 1.0:
            raise EngineError(f"drift_band must be >= 1.0, got {drift_band}")
        self.drift_band = drift_band
        self.feedback_tenant = feedback_tenant
        self._split_policy: Any = None
        # warm-dispatch memo: (query key, stats epoch) → OptimizeResult;
        # bounded like the plan cache — serving traffic with per-request
        # literals would otherwise pin one compiled plan per query text
        self._dispatch: Dict[Tuple[str, str], OptimizeResult] = {}
        self._dispatch_cap = 512
        # frontend memo: query key → canonicalized Program (parse once);
        # cleared whenever the database changes (programs bind schemas)
        self._programs: Dict[str, Program] = {}
        self._programs_cap = 1024
        # both memos are plain LRU dicts whose get does pop+reinsert — under
        # concurrent submissions (QueryServer tenants share nothing *per
        # session*, but one session may still be driven from several
        # threads) the pop/insert pair must be atomic
        self._memo_lock = threading.Lock()
        self._epoch = self.db.stats_epoch()
        self._db_sig = self._signature()

    # -- table registration --------------------------------------------------
    def register(self, table: Any, **columns: Any) -> "Session":
        """Register (or replace) a table.

        ``table`` is either a ``Multiset`` or a table name accompanied by
        column keyword arguments (array-likes).  Replacing an existing table
        bumps the stats epoch and invalidates the old epoch's plan-cache
        entries — compiled plans bake in key-space sizes and join
        multiplicities measured from the data, so serving one against
        swapped data would be silently wrong."""
        if isinstance(table, Multiset):
            ms = table
            if columns:
                raise EngineError("pass either a Multiset or name+columns, not both")
        else:
            if not columns:
                raise EngineError(f"register({table!r}) needs column arrays")
            ms = Multiset.from_columns(str(table), **columns)
        replacing = ms.name in self.db
        old_epoch = self._epoch
        self.db.add(ms)
        if replacing:
            self.db.bump_epoch()
            self.metrics_registry.inc(
                "plan_cache.invalidations", self.plan_cache.invalidate_epoch(old_epoch)
            )
        self._refresh_epoch()
        return self

    def drop(self, name: str) -> "Session":
        if name not in self.db:
            raise EngineError(f"no table {name!r}")
        old_epoch = self._epoch
        del self.db.tables[name]
        self.db.bump_epoch()
        self.metrics_registry.inc(
            "plan_cache.invalidations", self.plan_cache.invalidate_epoch(old_epoch)
        )
        self._refresh_epoch()
        return self

    def tables(self) -> List[str]:
        return sorted(self.db.tables)

    def schemas(self) -> Dict[str, Sequence[str]]:
        return {name: ms.field_names() for name, ms in self.db.tables.items()}

    def _signature(self) -> Tuple:
        """Cheap O(#tables) identity of the database's table objects
        (``Multiset.uid`` is a monotonic counter — unlike id(), it cannot
        be reused by a table allocated after another was collected)."""
        return tuple((name, ms.uid, len(ms)) for name, ms in sorted(self.db.tables.items()))

    def _refresh_epoch(self) -> None:
        self._epoch = self.db.stats_epoch()
        self._db_sig = self._signature()
        # warm-dispatch entries from older epochs are unreachable — prune;
        # parsed programs bind table schemas that may just have changed
        self._dispatch = {k: v for k, v in self._dispatch.items() if k[1] == self._epoch}
        self._programs.clear()

    def _revalidate(self) -> None:
        """``self.db`` is public and mutable (examples hand it to low-level
        passes) — detect out-of-band mutation before touching any memo, so
        a stale parse or compiled plan is never served.

        ``revalidate='content'`` (default) recomputes the content-hashed
        epoch per dispatch — the same guarantee the hand-wired
        ``optimize()`` path always had, catching in-place column edits
        (vectorized hash; cost scales with data size).
        ``revalidate='signature'`` only compares (name, object id, length)
        per table — O(#tables), for serving sessions whose tables are
        treated as immutable: swaps/adds/drops are caught, in-place buffer
        edits are NOT."""
        if self.revalidate == "signature":
            if self._signature() != self._db_sig:
                self._refresh_epoch()
            return
        if self.db.stats_epoch() != self._epoch:
            self._refresh_epoch()

    # -- frontends -----------------------------------------------------------
    def _sql_program(self, query: str) -> Tuple[str, Program]:
        key = f"sql::{query}"
        prog = self._get_program(key)
        if prog is None:
            with self.tracer.span("sql.parse"):
                raw = sql_to_forelem(query, self.schemas())
            with self.tracer.span("canonicalize"):
                prog = canonicalize_array_names(raw)
            self._memo_program(key, prog)
        return key, prog

    def _mr_program(self, spec: MapReduceSpec) -> Tuple[str, Program]:
        if spec.table not in self.db:
            raise EngineError(f"mapreduce over unregistered table {spec.table!r}")
        key = f"mr::{spec!r}"
        prog = self._get_program(key)
        if prog is None:
            with self.tracer.span("mr.translate"):
                raw = mapreduce_to_forelem(spec, self.db[spec.table].field_names())
            with self.tracer.span("canonicalize"):
                prog = canonicalize_array_names(raw)
            self._memo_program(key, prog)
        return key, prog

    def _get_program(self, key: str) -> Optional[Program]:
        with self._memo_lock:
            prog = self._programs.get(key)
            if prog is not None:
                # LRU: re-insert so cap eviction removes the coldest entry
                self._programs[key] = self._programs.pop(key)
            return prog

    def _memo_program(self, key: str, prog: Program) -> None:
        with self._memo_lock:
            if len(self._programs) >= self._programs_cap:
                self._programs.pop(next(iter(self._programs)))
            self._programs[key] = prog

    def sql(self, query: str, params: Optional[Dict[str, Any]] = None) -> QueryResult:
        """Submit a SQL query through the engine pipeline."""
        self._revalidate()
        with self.tracer.span("query", source="sql", query=query) as qs:
            key, prog = self._sql_program(query)
            qr = self._submit(key, prog, params, source="sql", text=query)
            qs.set(cache_hit=qr.cache_hit, dispatch_hit=qr.dispatch_hit)
        return qr

    def mapreduce(self, spec: MapReduceSpec, params: Optional[Dict[str, Any]] = None) -> QueryResult:
        """Submit a declarative MapReduce job through the *same* pipeline as
        SQL — the job is translated onto the forelem IR (paper §IV) and gets
        planner-chosen execution strategies and plan caching for free."""
        self._revalidate()
        with self.tracer.span("query", source="mapreduce", query=repr(spec)) as qs:
            key, prog = self._mr_program(spec)
            qr = self._submit(key, prog, params, source="mapreduce", text=repr(spec))
            qs.set(cache_hit=qr.cache_hit, dispatch_hit=qr.dispatch_hit)
        return qr

    def check(self, query: Any) -> CheckReport:
        """Statically analyze a SQL string or ``MapReduceSpec`` without
        executing it: run the IR verifier over the frontend-produced program
        (always — independent of REPRO_VERIFY_IR), then the plan linter
        (unused columns, partition skew, pushable filters, SUM overflow)
        against the session's live tables and statistics."""
        self._revalidate()
        if isinstance(query, MapReduceSpec):
            source, text = "mapreduce", repr(query)
            _, prog = self._mr_program(query)
        else:
            source, text = "sql", str(query)
            _, prog = self._sql_program(text)
        err: Optional[IRVerificationError] = None
        try:
            verify_program(prog, pass_name="frontend")
        except IRVerificationError as e:
            err = e
        warnings: List[LintWarning] = []
        if err is None:
            from repro_torch.planner import collect_stats

            warnings = lint_program(
                prog,
                db=self.db,
                stats=collect_stats(self.db),
                n_partitions=self.n_partitions or self.n_parts,
            )
        return CheckReport(text, source, prog, err is None, err, warnings)

    def explain(
        self,
        query: Any,
        analyze: bool = False,
        params: Optional[Dict[str, Any]] = None,
        lint: bool = False,
    ) -> str:
        """Plan (and compile+cache) a SQL string or ``MapReduceSpec`` and
        return the planner's EXPLAIN text.

        ``lint=True`` appends the plan linter's advisory findings (the same
        rules as ``check()``) after the plan.

        ``analyze=True`` additionally *executes* the plan and appends the
        measured profile — on the partitioned backend: per-op chunk
        timings, achieved worker imbalance vs the schedule model's
        prediction over the same measured chunk costs (next to the
        planner's skew estimate above it), and the chunk-kernel jit cache
        hit-rate."""
        if self.planner != "cost":
            raise EngineError("explain requires a cost-planned session (planner='cost')")
        self._revalidate()
        if isinstance(query, MapReduceSpec):
            key, prog = self._mr_program(query)
        else:
            key, prog = self._sql_program(str(query))
        res, _ = self._prepare(key, prog)
        text = res.explain or "(no explain available)"
        if lint:
            from repro_torch.planner import collect_stats

            warnings = lint_program(
                prog,
                db=self.db,
                stats=collect_stats(self.db),
                n_partitions=self.n_partitions or self.n_parts,
            )
            text += "\n" + render_lint(warnings)
        if analyze:
            # ANALYZE is expressed on top of the obs trace: the plan runs
            # under a profiling tracer and the report is rebuilt from the
            # per-chunk dispatch spans (the dispatch log stays available as
            # a cross-check — tests assert the two agree)
            t0 = time.perf_counter()
            with self.profile() as qt:
                res.plan.run(params, tracer=self.tracer)
            wall_ms = (time.perf_counter() - t0) * 1e3
            from_trace = getattr(res.plan, "report_from_trace", None)
            if from_trace is not None:
                from repro_torch.planner import render_analyze

                text += "\n" + render_analyze(from_trace(qt))
            else:
                text += (
                    f"\n  analyze (measured): wall={wall_ms:.1f}ms "
                    f"(backend {self.backend!r} has no chunk dispatch)"
                )
        return text

    # -- the one pipeline ----------------------------------------------------
    def _configure_plan(self, plan: Any) -> None:
        """Attach the serving-time execution policy to a compiled plan.

        These are *run-time attachments*, deliberately not plan-cache
        fingerprint inputs: a plan cached by one tenant must behave
        identically for every tenant, so sessions sharing a cache (a
        ``QueryServer``) all attach the same server-wide fault policy /
        chunk executor / metrics registry, and re-attaching on every
        dispatch keeps a cache-shared plan consistent with *this*
        session's configuration."""
        if hasattr(plan, "fault"):
            plan.fault = self.fault
        if hasattr(plan, "chunk_executor"):
            plan.chunk_executor = self.chunk_executor
        if hasattr(plan, "metrics_registry"):
            plan.metrics_registry = self.metrics_registry
        if hasattr(plan, "split"):
            plan.split = self._split_policy_for()

    def _split_policy_for(self) -> Any:
        """The mid-run skew-split policy attached to partitioned plans —
        only when feedback is enabled (the split is the runtime half of the
        adaptive loop; open-loop sessions keep the historical behavior)."""
        if self.feedback is None:
            return None
        if self._split_policy is None:
            from repro_torch.backends.partitioned import SplitPolicy

            self._split_policy = SplitPolicy()
        return self._split_policy

    def _prepare(self, key: str, prog: Program) -> Tuple[OptimizeResult, bool]:
        """Returns (optimize outcome, dispatch_hit).  Callers run
        ``_revalidate`` first, so ``self._epoch`` is trustworthy here."""
        dkey = (key, self._epoch)
        with self._memo_lock:
            hit = self._dispatch.get(dkey)
            if hit is not None:
                # LRU: re-insert so cap eviction removes the coldest entry
                self._dispatch[dkey] = self._dispatch.pop(dkey)
        if hit is not None:
            if self.tracer.enabled:
                with self.tracer.span("dispatch.lookup") as ds:
                    ds.set(hit=True)
            self._configure_plan(hit.plan)
            return hit, True
        with self.tracer.span("optimize", backend=self.backend):
            res = optimize(
                prog,
                self.db,
                OptimizeOptions(
                    n_parts=self.n_parts,
                    planner=self.planner,
                    plan_cache=self.plan_cache,
                    backend=self.backend,
                    device=self.device,
                    n_partitions=self.n_partitions,
                    schedule=self.schedule,
                    jit_chunks=self.jit_chunks,
                    async_dispatch=self.async_dispatch,
                    reformat=self.reformat,
                    expected_runs=self.expected_runs,
                    tracer=self.tracer,
                    feedback=self.feedback,
                    feedback_tenant=self.feedback_tenant,
                    drift_band=self.drift_band,
                ),
            )
        # reformatting persists across the session (amortization, §III-C1);
        # adopting the reformatted database moves the epoch forward
        if res.db is not self.db:
            self.db = res.db
            self._refresh_epoch()
        with self._memo_lock:
            if len(self._dispatch) >= self._dispatch_cap:
                self._dispatch.pop(next(iter(self._dispatch)))
            self._dispatch[(key, self._epoch)] = res
        self._configure_plan(res.plan)
        return res, False

    def _submit(
        self, key: str, prog: Program, params: Optional[Dict[str, Any]], source: str, text: str
    ) -> QueryResult:
        t0 = time.perf_counter()
        res, dispatch_hit = self._prepare(key, prog)
        jit_before = self._jit_counters(res.plan)
        with self.tracer.span("execute", backend=self.backend):
            out = res.plan.run(params, tracer=self.tracer)
        qr = QueryResult(
            results=out,
            source=source,
            query=text,
            explain=res.explain,
            cache_hit=res.cache_hit or dispatch_hit,
            dispatch_hit=dispatch_hit,
            elapsed_s=time.perf_counter() - t0,
            program=res.program,
            decision=res.decision,
            plan=res.plan,
        )
        self.history.append(
            QueryLogEntry(source, text, qr.cache_hit, qr.dispatch_hit, qr.elapsed_s)
        )
        self._record_metrics(qr, res, jit_before)
        self._feedback_update(key, res, qr)
        return qr

    # -- adaptive re-optimization (planner/feedback.py) ----------------------
    def _feedback_update(self, key: str, res: OptimizeResult, qr: QueryResult) -> None:
        """Close the feedback loop after one run: record the measured
        profile, then fire the drift trigger — when an observed/estimated
        ratio leaves the band AND the plan was open-loop (it consumed no
        profile), evict the cached plan + warm-dispatch memo so the next
        submission re-plans against the observations.

        The open-loop guard is the convergence proof: a re-planned decision
        carries ``observed`` and is priced on the profile itself
        (est==observed), so it can never re-trigger — each fingerprint
        re-plans at most once per stats epoch, no oscillation."""
        store = self.feedback
        decision = res.decision
        if store is None or decision is None:
            return
        sem_fp = getattr(decision, "fingerprint", "")
        if not sem_fp:
            return
        from repro_torch.planner import drift_report, extract_profile

        prof = extract_profile(res.plan, decision=decision, results=qr.results)
        if prof is None:
            return
        stored = store.record(sem_fp, prof, tenant=self.feedback_tenant)
        self.metrics_registry.inc("replan.profiles")
        if getattr(decision, "observed", None) is not None:
            return  # already profile-planned — converged
        reasons = drift_report(stored, getattr(decision, "estimates", {}), self.drift_band)
        if not reasons:
            return
        n = self.plan_cache.invalidate_fingerprint(sem_fp)
        with self._memo_lock:
            self._dispatch.pop((key, self._epoch), None)
        self.metrics_registry.inc("replan.drift")
        if n:
            self.metrics_registry.inc("replan.invalidated_plans", n)
        if self.tracer.enabled:
            s = self.tracer.start("replan.drift", fingerprint=sem_fp[:12], n_invalidated=n)
            self.tracer.end(s, reason=reasons[0])

    # -- metrics recording ---------------------------------------------------
    @staticmethod
    def _jit_counters(plan: Any) -> Optional[Tuple[int, int, int]]:
        js = getattr(plan, "jit_stats", None)
        if js is None:
            return None
        return (js.compiles, js.hits, js.overflows)

    def _record_metrics(
        self, qr: QueryResult, res: OptimizeResult, jit_before: Optional[Tuple[int, int, int]]
    ) -> None:
        """Feed one query's observable outcome into the metrics registry —
        the engine-wide absorption point for the counters that previously
        lived only on individual objects (plan jit stats, plan cache,
        dispatch log)."""
        m = self.metrics_registry
        m.inc("queries", source=qr.source)
        m.inc("plan_cache.hit" if qr.cache_hit else "plan_cache.miss")
        if qr.dispatch_hit:
            m.inc("dispatch.hit")
        m.observe("query.latency_ms", qr.elapsed_s * 1e3)
        jit_after = self._jit_counters(res.plan)
        if jit_before is not None and jit_after is not None:
            # clamped: when two sessions run one cache-shared plan
            # concurrently, another tenant's counters may move between this
            # query's before/after reads — a negative delta is attribution
            # noise, not a real decrement
            m.inc("jit.compiles", max(0, jit_after[0] - jit_before[0]))
            m.inc("jit.hits", max(0, jit_after[1] - jit_before[1]))
            m.inc("jit.overflows", max(0, jit_after[2] - jit_before[2]))
        log = getattr(res.plan, "dispatch_log", None)
        if log:
            m.inc("chunks.dispatched", len(log))
            m.inc("rows.scanned", sum(d.rows for d in log))
            m.inc("worker.busy_ms", sum(d.t_ms for d in log))
            m.inc("queue.wait_ms", sum(d.queue_ms for d in log))
        rows = qr.rows
        if rows is not None:
            m.inc("rows.emitted", len(rows))

    # -- observability (repro_torch.obs) -------------------------------------------
    @contextmanager
    def profile(self) -> Iterator[QueryTrace]:
        """Trace every query submitted inside the block:

        >>> with s.profile() as qt:
        ...     s.sql("SELECT url, COUNT(url) FROM access GROUP BY url")
        >>> qt.save("query.json.gz")     # opens in ui.perfetto.dev
        >>> qt.stage_times()             # per-stage breakdown

        The yielded ``QueryTrace`` is populated when the block exits.  A
        session-lifetime tracer (``Session(trace=True)``) is restored
        afterwards; spans recorded inside the block belong to the profile,
        not to the session trace."""
        prev = self.tracer
        tr = Tracer()
        self.tracer = tr
        qt = QueryTrace(meta={"backend": self.backend, "device": self.device, "epoch": self._epoch})
        try:
            yield qt
        finally:
            self.tracer = prev
            qt.spans = tr.drain()
            qt.meta["n_spans"] = len(qt.spans)

    def take_trace(self) -> QueryTrace:
        """Spans accumulated by a session-lifetime tracer
        (``Session(trace=True)``) since the last call; clears the buffer."""
        return QueryTrace(
            self.tracer.drain(),
            meta={"backend": self.backend, "device": self.device, "epoch": self._epoch},
        )

    def metrics(self) -> Dict[str, Any]:
        """Snapshot of the session's metrics registry as a plain dict, with
        the live cache gauges synced in at read time (so the snapshot always
        matches ``PlanCache``'s own counters)."""
        m = self.metrics_registry
        st = self.plan_cache.stats()
        m.set_gauge("plan_cache.entries", st["entries"])
        m.set_gauge("plan_cache.hits", st["hits"])
        m.set_gauge("plan_cache.misses", st["misses"])
        m.set_gauge("dispatch.entries", len(self._dispatch))
        m.set_gauge("query_log.entries", len(self.history))
        return m.snapshot()

    # -- introspection -------------------------------------------------------
    @property
    def query_log(self) -> Tuple[QueryLogEntry, ...]:
        """The bounded query log (metadata-only ring buffer, capped at
        ``max_query_log`` entries), oldest first."""
        return tuple(self.history)

    def last_query(self) -> Optional[QueryLogEntry]:
        """The most recent ``QueryLogEntry``, or None before any query."""
        return self.history[-1] if self.history else None

    def cache_stats(self) -> Dict[str, Any]:
        st = dict(self.plan_cache.stats())
        st["dispatch_entries"] = len(self._dispatch)
        return st

    def stats_epoch(self) -> str:
        self._revalidate()  # never report an epoch a query wouldn't plan under
        return self._epoch
