# The "super-optimizer" (paper §I: "all problems can be expressed in this
# single intermediate representation, allowing a single 'super'-optimizer to
# be employed").  One entry point runs query optimization, classic loop
# optimization, parallelization, distribution selection and reformatting on
# any frontend-produced program.
#
# With OptimizeOptions(planner="cost") the execution-strategy knobs
# (agg_method, parallel_exec, partition_field, loop order) are chosen by the
# cost-based planner in repro_torch.planner from live table statistics instead of
# being taken from the options, and the resulting compiled plan is memoized
# in a plan cache keyed on (program fingerprint, stats epoch).
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from repro_torch.data.multiset import Database
from repro_torch.analysis import deps
from repro_torch.analysis.verify import verify_enabled, verify_program
from .ir import Program, program_str
from . import transforms as T
from .partition import partition_direct, partition_indirect
from .distribution import optimize_distribution, DistributionReport
from .reformat import auto_reformat, ReformatPlan
from repro_torch.backends import ExecutablePlan, get_backend
from repro_torch.backends.torch_vec import CodegenChoices
from repro_torch.obs.trace import NULL_TRACER


@dataclass
class OptimizeOptions:
    """Every knob of the ``optimize`` pass pipeline.

    The first block configures the *fixed* pipeline (used as-is when
    ``planner='none'``); ``planner='cost'`` hands the strategy knobs to the
    cost-based planner and uses the remainder (backend, cache, feedback,
    tracing, verification) as planning inputs.
    """

    n_parts: int = 1                   # target parallel width (forall N)
    partition: str = "indirect"        # 'direct' | 'indirect' | 'none'
    partition_field: Optional[Tuple[str, str]] = None  # (table, field)
    mesh_axis: Optional[str] = None
    reformat: bool = True
    expected_runs: int = 10
    agg_method: str = "dense"
    parallel_exec: str = "vmap"        # 'none' | 'vmap'
    join_method: str = "auto"          # 'auto' | 'lookup' | 'expand'
    trace: bool = False
    # 'none'  — the knobs above are used as-is (the historical behavior);
    # 'cost'  — the cost-based planner (repro_torch.planner) fills agg_method,
    #           parallel_exec, partition_field and the loop order from table
    #           statistics, with a plan cache over (program, stats epoch).
    planner: str = "none"
    plan_cache: Any = None             # planner.PlanCache; None → shared default
    # executor backend (repro_torch.backends registry): 'torch' (vectorized
    # PyTorch), 'reference' (the oracle interpreter) or 'partitioned' (K-way
    # data distribution + chunk-scheduled execution over the torch kernels).
    backend: str = "torch"
    # device the 'torch' and 'partitioned' backends' plans run on; None →
    # 'cuda'.  It also sets which mode of the segreduce kernel the cost model
    # prices.
    device: Optional[str] = None
    # -- partitioned-backend knobs (backend='partitioned') -------------------
    # K-way data distribution; None → planner-chosen (planner='cost') or
    # max(1, n_parts) with the fixed pipeline.
    n_partitions: Optional[int] = None
    # chunk-schedule policy over the partitioned iteration space
    # (sched/loop_schedule.py): 'auto' → planner-chosen ('static' with the
    # fixed pipeline); or pin 'static' | 'fixed' | 'guided'.
    schedule: str = "auto"
    # bucketed chunk kernels: pad each chunk up to a geometric shape bucket
    # so per-chunk kernels are captured once per (kernel, bucket)
    jit_chunks: bool = True
    # overlap host-side chunk slice/upload with device execution via a
    # thread worker pool, one CUDA stream per worker (self-scheduling
    # policies become real load balancing)
    async_dispatch: bool = True
    # -- adaptive re-optimization (planner='cost'; repro_torch.planner.feedback) ---
    # FeedbackStore of ObservedProfiles from earlier runs of the same
    # program: the planner substitutes measured selectivity / row skew /
    # jit hit rate for the static estimates.  None → open-loop planning.
    feedback: Any = None
    # tenant label namespacing profile lookups inside a shared FeedbackStore
    # (a QueryServer passes the tenant id; profiles never cross tenants)
    feedback_tenant: str = ""
    # drift tolerance: after a run, an observed/estimated ratio outside
    # [1/drift_band, drift_band] invalidates the cached plan so the next
    # dispatch re-plans against the measured profile (Session._feedback_update)
    drift_band: float = 2.0
    # repro_torch.obs.Tracer receiving per-stage spans (passes, cache.lookup,
    # plan.enumerate, lower); None → NULL_TRACER (zero-cost no-ops).  Not
    # part of any plan fingerprint — tracing must never change the plan.
    tracer: Any = None
    # run the IR verifier (repro_torch.analysis.verify) after every pass, raising
    # IRVerificationError naming the offending pass on any broken invariant.
    # None → controlled by the REPRO_VERIFY_IR environment variable (set to
    # "1" in tests/CI, off by default in production use).
    verify_ir: Optional[bool] = None


@dataclass
class OptimizeResult:
    program: Program
    db: Database
    plan: ExecutablePlan
    distribution: Optional[DistributionReport]
    reformat: Optional[ReformatPlan]
    trace: List[str] = field(default_factory=list)
    decision: Any = None               # planner.Decision (planner='cost' only)
    explain: Optional[str] = None      # EXPLAIN text (planner='cost' only)
    cache_hit: bool = False


def optimize(program: Program, db: Database, opts: Optional[OptimizeOptions] = None) -> OptimizeResult:
    """The full pass pipeline (paper §II–§III):

    1. query optimization:  interchange (push selections out), DCE, fusion
    2. data reformatting:   dict-encode / prune / compress (amortized)
    3. parallelization:     direct or indirect partitioning to n_parts
    4. iteration-space expansion (privatized accumulators) + code motion
    5. distribution:        conflict resolution by reorder+fusion
    6. codegen:             index-set materialization + parallel execution
    """
    opts = opts or OptimizeOptions()
    device = opts.device or "cuda"
    trace: List[str] = []
    tr = opts.tracer if opts.tracer is not None else NULL_TRACER
    verify = opts.verify_ir if opts.verify_ir is not None else verify_enabled()

    def log(stage: str, p: Program) -> None:
        if opts.trace:
            trace.append(f"=== {stage} ===\n{program_str(p)}")

    def check(p: Program, pass_name: str) -> Program:
        if verify:
            verify_program(p, pass_name=pass_name)
        return p

    p = check(program, "frontend")
    log("input", p)

    # -- 1. query optimization ------------------------------------------------
    # Resolved through the module (T.<name>) at call time so tests can
    # monkeypatch an individual transform; each output is verifier-checked
    # with the pass name attached so a broken invariant names its culprit.
    with tr.span("passes"):
        for pass_name in ("loop_interchange", "dead_code_elimination", "loop_fusion"):
            p = check(getattr(T, pass_name)(p), pass_name)
    log("query-optimized", p)

    # -- 2. data reformatting ---------------------------------------------------
    ref_plan = None
    if opts.reformat:
        with tr.span("reformat") as rs:
            db, ref_plan = auto_reformat(p, db, opts.expected_runs)
            rs.set(applied=ref_plan is not None and bool(getattr(ref_plan, "steps", None)))

    # -- 2b. cost-based planning (optional; repro_torch.planner) ----------------------
    # Fills the codegen knobs + loop order from table statistics; a plan-cache
    # hit short-circuits the rest of the pipeline with the compiled plan.
    agg_method = opts.agg_method
    parallel_exec = opts.parallel_exec
    partition_field = opts.partition_field
    join_method = opts.join_method
    n_parts = opts.n_parts
    outcome = None
    decision = None
    explain = None
    n_partitions = opts.n_partitions or max(1, opts.n_parts)
    if opts.schedule == "auto":
        schedule = "static"
    else:
        # validate (and canonicalize 'gss'→'guided') before planning, so an
        # unknown policy fails here, not after the whole pipeline has run
        from repro_torch.backends.partitioned import normalize_schedule

        schedule = normalize_schedule(opts.schedule)
    if opts.planner == "cost":
        from repro_torch.planner import run_planner

        outcome = run_planner(
            p,
            db,
            n_parts=opts.n_parts,
            plan_cache=opts.plan_cache,
            backend=opts.backend,
            device=device,
            n_partitions=opts.n_partitions,
            schedule=None if opts.schedule == "auto" else schedule,
            jit_chunks=opts.jit_chunks,
            async_dispatch=opts.async_dispatch,
            tracer=tr,
            feedback=opts.feedback,
            feedback_tenant=opts.feedback_tenant,
        )
        decision, explain = outcome.decision, outcome.explain
        if outcome.cached_entry is not None:
            entry = outcome.cached_entry
            return OptimizeResult(
                entry.program, db, entry.plan, None, ref_plan, trace,
                decision=decision, explain=explain, cache_hit=True,
            )
        chosen = decision.chosen
        p = chosen.program
        agg_method = chosen.agg_method
        parallel_exec = chosen.parallel
        partition_field = chosen.partition_field
        if chosen.join_method is not None:
            join_method = chosen.join_method
        if chosen.n_partitions is not None:
            n_partitions = chosen.n_partitions
        if chosen.schedule is not None:
            schedule = chosen.schedule
        if chosen.parallel == "none":
            n_parts = 1  # partitioning buys nothing without parallel execution
        check(p, "planner.join_order")
        log("planned", p)
    elif opts.planner != "none":
        raise ValueError(f"unknown planner {opts.planner!r} (use 'none' or 'cost')")

    # -- 3/4. parallelization ---------------------------------------------------
    # The partitioned backend distributes the *data* (hash/range partitions
    # + scheduled chunk dispatch) instead of restructuring the IR, so the
    # loop-level partitioning transform is skipped for it.
    if n_parts > 1 and opts.partition != "none" and opts.backend != "partitioned":
        # legality: per-partition partials are only mergeable when every
        # accumulate op is commutative + associative (analysis.deps); with
        # the fixed pipeline an illegal program silently stays sequential.
        ok, reasons = deps.partitionable(p)
        if not ok:
            n_parts = 1  # fall back to sequential codegen
            trace.append("=== parallelization skipped (illegal) ===\n" + "\n".join(reasons))
        else:
            with tr.span("parallelize", n_parts=n_parts, partition=opts.partition):
                if opts.partition == "direct":
                    p = check(partition_direct(p, n_parts, mesh_axis=opts.mesh_axis),
                              "partition_direct")
                else:
                    tf = partition_field
                    if tf is None:
                        tf = _default_partition_field(p)
                    if tf is not None:
                        p = check(
                            partition_indirect(p, tf[0], tf[1], n_parts, mesh_axis=opts.mesh_axis),
                            "partition_indirect",
                        )
                p = check(T.iteration_space_expansion(p), "iteration_space_expansion")
            log("parallelized", p)

    # -- 5. distribution ---------------------------------------------------------
    dist_report = None
    with tr.span("distribute"):
        p, dist_report = optimize_distribution(p, db=db)
        check(p, "optimize_distribution")
    log("distributed", p)

    # -- 6. codegen ----------------------------------------------------------------
    choices: Any = CodegenChoices(
        agg_method=agg_method,
        parallel=parallel_exec if n_parts > 1 else "none",
        join_method=join_method,
        device=device,
    )
    if opts.backend == "partitioned":
        from repro_torch.backends.partitioned import PartitionedChoices

        choices = PartitionedChoices(
            base=choices,
            n_partitions=n_partitions,
            schedule=schedule,
            partition_field=partition_field,
            jit_chunks=opts.jit_chunks,
            async_dispatch=opts.async_dispatch,
        )
    with tr.span("lower", backend=opts.backend):
        plan = get_backend(opts.backend).compile(p, db, choices)
    # Per-aggregate method downgrades (e.g. a non-SUM op under
    # agg_method='onehot', or a non-fusable op under 'kernel') must never be
    # silent: the lowering records them, and they surface both in the pass
    # trace and in the planner decision's legality diagnostics.
    notes = getattr(getattr(plan, "lowering", None), "method_notes", None)
    if notes:
        trace.append("=== aggregation-method fallback ===\n" + "\n".join(notes))
        if decision is not None:
            decision.rejections = decision.rejections + tuple(notes)
    if outcome is not None:
        outcome.store(plan, p)
    return OptimizeResult(
        p, db, plan, dist_report, ref_plan, trace,
        decision=decision, explain=explain, cache_hit=False,
    )


def _default_partition_field(p: Program) -> Optional[Tuple[str, str]]:
    """Pick the first aggregation key as the indirect-partition field (the
    paper's X = Access.url choice)."""
    from .ir import Accumulate, FieldRef, walk

    for s in walk(p.body):
        if isinstance(s, Accumulate) and isinstance(s.key, FieldRef):
            return (s.key.table, s.key.field)
    return None
