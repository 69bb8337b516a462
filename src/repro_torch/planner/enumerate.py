# Plan enumeration: loop orders (via the interchange hooks in
# core/transforms.py) × index-set materialization methods × parallel
# execution strategies × partition-field choices, priced with the cost
# model and pruned to the cheapest.
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import deps
from repro_torch.core import transforms as T
from repro_torch.core.ir import Program
from repro_torch.backends import (
    FUSABLE_AGG_OPS,
    ProgramSpec,
    UnsupportedProgram,
    extract_spec,
    fused_agg_groups,
)

from .cardinality import CardinalityEstimator, LoopEstimate
from .cost import CostCoefficients, CostModel
from .feedback import ObservedProfile, filter_signature
from .stats import DbStats

AGG_METHODS = ("dense", "sort", "onehot", "kernel")
PARTITION_SCHEDULES = ("static", "fixed", "guided")


@dataclass(frozen=True)
class Candidate:
    """One fully specified executable plan."""

    order: str                      # 'as-written' | 'interchanged[k]'
    program: Program
    agg_method: str
    parallel: str                   # 'none' | 'vmap' | 'shard_map'
    partition_field: Optional[Tuple[str, str]]
    cost: float
    breakdown: Tuple[Tuple[str, float], ...] = ()
    join_method: Optional[str] = None  # 'lookup' | 'expand'; None = no joins
    # partitioned-executor distribution decision (backends/partitioned.py):
    # K-way hash/range data distribution + chunk-schedule policy; None when
    # the candidate targets a monolithic executor
    n_partitions: Optional[int] = None
    schedule: Optional[str] = None
    # aggregates the fused multi-aggregate kernel evaluates in one pass
    # (agg_method='kernel' only; None = no fusion) — EXPLAIN renders this
    # as agg_method=kernel(fused, N aggs)
    fused_aggs: Optional[int] = None


@dataclass
class Decision:
    """Outcome of planning one query."""

    chosen: Candidate
    candidates: List[Candidate]               # all enumerated, sorted by cost
    loop_estimates: List[LoopEstimate]        # cardinalities of the chosen order
    stats_epoch: str
    fallback_reason: Optional[str] = None     # set when enumeration bailed out
    # legality diagnostics (repro_torch.analysis.deps): strategy-space regions the
    # dependence analysis rejected before pricing (shown by EXPLAIN)
    rejections: Tuple[str, ...] = ()
    # -- feedback-loop bookkeeping (planner/feedback.py) ---------------------
    # the estimates the chosen plan was priced on (``sel[...]``/``skew[...]``
    # keys) — the drift trigger compares these against the run's measurements
    estimates: Dict[str, float] = field(default_factory=dict)
    # the ObservedProfile this decision consumed (None = open-loop plan);
    # also the convergence guard: profile-informed plans never re-trigger
    observed: Optional[object] = None
    # EXPLAIN's ``replanned:`` line — how this decision differs from the one
    # the profile was measured under (None = same decision or open loop)
    replanned: Optional[str] = None
    # semantic program fingerprint (cache.program_fingerprint) — the
    # FeedbackStore key and the prefix for targeted cache invalidation
    fingerprint: str = ""

    @property
    def n_enumerated(self) -> int:
        return len(self.candidates)


def _partition_candidates(
    spec: ProgramSpec, stats: DbStats, include_join_keys: bool = False
) -> List[Optional[Tuple[str, str]]]:
    """Candidate (table, field) pairs for indirect partitioning: the
    aggregation keys (the paper's X = Access.url choice), plus — for the
    partitioned executor — the equi-join probe keys (shuffle-on-key)."""
    seen: List[Optional[Tuple[str, str]]] = []
    for agg in spec.aggs:
        tf = (agg.table, agg.key_field)
        if tf not in seen:
            seen.append(tf)
    if include_join_keys:
        for j in spec.joins:
            tf = (j.probe_table, j.probe_fk)
            if tf not in seen:
                seen.append(tf)
    if not seen:
        seen.append(None)
    return seen


def _k_choices(n_parts: int, override: Optional[int]) -> Tuple[int, ...]:
    """Partition counts worth pricing: K=1 (effectively monolithic — the
    launch-overhead floor), the session's parallel width, and 8 (the
    conventional device count)."""
    if override is not None:
        return (max(1, override),)
    ks = {1, 8}
    if n_parts > 1:
        ks.add(n_parts)
    return tuple(sorted(ks))


def _join_methods(spec: ProgramSpec, stats: DbStats) -> Sequence[Optional[str]]:
    """Join lowerings worth pricing for this loop order.  Expansion is
    always faithful; the cheaper unique-lookup is only a candidate when
    every build key is *provably* unique (full-scan stats — ``is_unique is
    None`` from sampling is treated as non-unique, conservative)."""
    if not spec.joins:
        return (None,)
    methods: List[Optional[str]] = ["expand"]
    if all(
        (fs := stats.field(j.build_table, j.build_key)) is not None and fs.is_unique is True
        for j in spec.joins
    ):
        methods.insert(0, "lookup")
    return tuple(methods)


def enumerate_candidates(
    program: Program,
    stats: DbStats,
    n_parts: int = 1,
    coeffs: Optional[CostCoefficients] = None,
    allow_shard_map: bool = False,
    device: str = "cuda",
    executor: Optional[str] = None,
    n_partitions: Optional[int] = None,
    schedule: Optional[str] = None,
    rejections: Optional[List[str]] = None,
    profile: Optional[ObservedProfile] = None,
) -> List[Candidate]:
    """Enumerate and price every plan in the strategy space.  Programs whose
    shape the vectorized lowering does not support are skipped (they would
    fail at codegen anyway).  Raises UnsupportedProgram when *no* variant is
    supported.

    ``device`` is where the plan will run, which sets the price of the
    segreduce kernel (cost.CostModel).

    ``executor`` is the ExecutorBackend name the plan will compile on; for
    ``'partitioned'`` the strategy space is K-way data distribution ×
    chunk-schedule policy (spec_cost_partitioned) instead of the monolithic
    forall strategies.  ``n_partitions`` / ``schedule`` pin those axes.

    The dependence analysis (repro_torch.analysis.deps) gates the parallel regions
    of the space: when any accumulate op is not commutative+associative the
    K>1 / parallel≠'none' candidates are never priced, and a diagnostic is
    appended to ``rejections`` (surfaced by EXPLAIN).

    ``profile`` (planner/feedback.py) substitutes measured selectivity /
    row skew / jit hit rate for the static-stats estimates when pricing."""
    model = CostModel(stats, coeffs, device=device, profile=profile)
    orders: List[Tuple[str, Program]] = [("as-written", program)]
    for k, variant in enumerate(T.join_orders(program)):
        orders.append((f"interchanged[{k}]", variant))

    partitioned = executor == "partitioned"
    # legality gate — op algebra is order-invariant, so decide once up front
    illegal_ops = deps.merge_illegal_ops(deps.accumulate_ops(program.body))
    had_parallel_axis = (
        any(K > 1 for K in _k_choices(n_parts, n_partitions)) if partitioned else n_parts > 1
    )
    if illegal_ops and had_parallel_axis and rejections is not None:
        ops_s = ", ".join(repr(o) for o in sorted(illegal_ops))
        axis = "K>1 data-distribution" if partitioned else "parallel-execution"
        rejections.append(
            f"{axis} candidates rejected: accumulate op(s) {ops_s} are not "
            "commutative+associative, so per-partition partials cannot be merged"
        )
    out: List[Candidate] = []
    last_err: Optional[Exception] = None
    kernel_gate_noted = False
    for order_name, prog in orders:
        try:
            spec = extract_spec(prog)
        except UnsupportedProgram as e:
            last_err = e
            continue
        has_aggs = bool(spec.aggs) or any(j.aggs for j in spec.joins)
        methods: Sequence[str] = AGG_METHODS if has_aggs else ("dense",)
        # Fused-kernel legality (analysis.deps): the fused kernel's partials
        # merge under the op itself, so every op it covers must be
        # commutative+associative AND one the kernel implements.  When no
        # aggregate qualifies, a 'kernel' candidate would just be the dense
        # plan wearing a kernel label — don't emit it.
        agg_ops = {a.op for a in spec.aggs} | {ja.op for j in spec.joins for ja in j.aggs}
        kernel_ops = {
            op for op in agg_ops
            if op in FUSABLE_AGG_OPS and op not in deps.fusion_illegal_ops(agg_ops)
        }
        if has_aggs and agg_ops and not kernel_ops:
            methods = tuple(m for m in methods if m != "kernel")
            if rejections is not None and not kernel_gate_noted:
                ops_s = ", ".join(repr(o) for o in sorted(agg_ops))
                rejections.append(
                    "fused-kernel candidates rejected: accumulate op(s) "
                    f"{ops_s} are outside the fusable op algebra "
                    "(commutative+associative +/max/min)"
                )
                kernel_gate_noted = True
        # aggregates one fused launch covers (EXPLAIN: kernel(fused, N aggs))
        n_fused = sum(len(g) for g in fused_agg_groups(spec.aggs))
        if partitioned:
            ks = _k_choices(n_parts, n_partitions)
            if illegal_ops:
                ks = (1,)  # only the degenerate single-partition distribution is legal
            schedules = PARTITION_SCHEDULES if schedule is None else (schedule,)
            # the runtime hash-partitions every operator on its *own* key
            # column, so partition-field variants execute identically —
            # enumerate only the primary one (what EXPLAIN reports)
            pfields = _partition_candidates(spec, stats, include_join_keys=True)[:1]
            for method in methods:
                for jm in _join_methods(spec, stats):
                    for pf in pfields:
                        for K in ks:
                            # K=1 has a single partition: every policy
                            # degenerates to one block, so price static only
                            # (unless a policy was pinned explicitly)
                            for sched in schedules if (K > 1 or schedule) else ("static",):
                                cost, breakdown = model.spec_cost_partitioned(
                                    spec, method, K, sched, pf, join_method=jm or "auto"
                                )
                                out.append(
                                    Candidate(
                                        order_name, prog, method, "none", pf, cost,
                                        tuple(breakdown), join_method=jm,
                                        n_partitions=K, schedule=sched,
                                        fused_aggs=(
                                            n_fused if method == "kernel" and n_fused else None
                                        ),
                                    )
                                )
            continue
        parallels: List[str] = ["none"]
        if n_parts > 1 and not illegal_ops:
            parallels.append("vmap")
            if allow_shard_map:
                parallels.append("shard_map")
        for method in methods:
            for jm in _join_methods(spec, stats):
                for parallel in parallels:
                    pfields = _partition_candidates(spec, stats) if parallel != "none" else [None]
                    for pf in pfields:
                        cost, breakdown = model.spec_cost(
                            spec, method, parallel, n_parts, pf, join_method=jm or "auto"
                        )
                        out.append(
                            Candidate(
                                order_name, prog, method, parallel, pf, cost,
                                tuple(breakdown), join_method=jm,
                                # the monolithic lowering only fuses on the
                                # sequential path (vmap/shard_map stay per-agg)
                                fused_aggs=(
                                    n_fused
                                    if method == "kernel" and parallel == "none" and n_fused
                                    else None
                                ),
                            )
                        )
    if not out:
        raise last_err or UnsupportedProgram("no enumerable plan")
    out.sort(key=lambda c: c.cost)
    return out


def _decision_estimates(est: CardinalityEstimator, chosen: Candidate) -> Dict[str, float]:
    """The row-count estimates the chosen plan was priced on, keyed so
    ``ObservedProfile.value_for`` can resolve each one to its measurement:
    ``sel[<filter signature>]`` per filtered projection, ``skew[table.field]``
    per partitioned aggregation/join key.  The drift trigger compares this
    dict against the run's observations."""
    out: Dict[str, float] = {}
    try:
        spec = extract_spec(chosen.program)
    except UnsupportedProgram:
        return out
    K = chosen.n_partitions or 1
    for fp in spec.filter_projects:
        if fp.filter_pred is not None:
            sig = filter_signature(fp.filter_pred, fp.table)
            out[f"sel[{sig}]"] = est.selectivity(fp.filter_pred, fp.table)
    if K > 1:
        for agg in spec.aggs:
            out[f"skew[{agg.table}.{agg.key_field}]"] = est.partition_row_skew(
                agg.table, agg.key_field, K
            )
        for j in spec.joins:
            out[f"skew[{j.probe_table}.{j.probe_fk}]"] = est.partition_row_skew(
                j.probe_table, j.probe_fk, K
            )
    return out


def plan_query(
    program: Program,
    stats: DbStats,
    n_parts: int = 1,
    coeffs: Optional[CostCoefficients] = None,
    allow_shard_map: bool = False,
    device: str = "cuda",
    executor: Optional[str] = None,
    n_partitions: Optional[int] = None,
    schedule: Optional[str] = None,
    profile: Optional[ObservedProfile] = None,
) -> Decision:
    """Pick the cheapest plan; on unsupported shapes fall back to the
    as-written program with the pipeline's fixed defaults.

    With a feedback ``profile`` the estimator and cost model prefer the
    measured values, so ``Decision.estimates`` reflects what the plan was
    *actually* priced on (est==observed after a replan — the fixed point
    the drift trigger converges to)."""
    est = CardinalityEstimator(stats, profile)
    rejections: List[str] = []
    try:
        cands = enumerate_candidates(
            program, stats, n_parts, coeffs, allow_shard_map=allow_shard_map,
            device=device, executor=executor, n_partitions=n_partitions, schedule=schedule,
            rejections=rejections, profile=profile,
        )
        chosen = cands[0]
        return Decision(
            chosen, cands, est.loop_estimates(chosen.program), stats.epoch,
            rejections=tuple(rejections),
            estimates=_decision_estimates(est, chosen),
        )
    except UnsupportedProgram as e:
        illegal = bool(deps.merge_illegal_ops(deps.accumulate_ops(program.body)))
        if executor == "partitioned":
            fallback = Candidate(
                "as-written", program, "dense", "none", None, float("inf"),
                n_partitions=1 if illegal else max(1, n_partitions or n_parts),
                schedule=schedule or "static",
            )
        else:
            fallback = Candidate(
                "as-written", program, "dense",
                "vmap" if n_parts > 1 and not illegal else "none", None, float("inf"),
            )
        return Decision(
            fallback, [fallback], est.loop_estimates(program), stats.epoch,
            fallback_reason=str(e), rejections=tuple(rejections),
        )
