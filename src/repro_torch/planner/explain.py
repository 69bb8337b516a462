# EXPLAIN rendering: estimated cardinalities alongside the chosen plan and
# the priced alternatives, so a user can see *why* the planner picked what
# it picked (and whether the plan came from the cache).  EXPLAIN ANALYZE
# appends the *measured* execution profile (``render_analyze``): achieved
# worker imbalance from the dispatch log next to the schedule model's
# prediction over the same measured chunk costs, plus the chunk-kernel jit
# cache hit-rate — so the planner's skew estimate can be checked against
# what actually happened.
from __future__ import annotations

from typing import Any, Dict

from .enumerate import Decision


def _agg_method(c) -> str:
    """``kernel(fused, N aggs)`` when the candidate runs the fused
    multi-aggregate kernel; the bare method name otherwise."""
    if getattr(c, "fused_aggs", None):
        return f"{c.agg_method}(fused, {c.fused_aggs} aggs)"
    return c.agg_method


def _distribution(c) -> str:
    """Chosen data distribution of a partitioned-executor candidate:
    `` partition=<table>.<field> K=<k> schedule=<policy>`` (empty for
    monolithic candidates)."""
    if c.n_partitions is None:
        return ""
    pf = f"{c.partition_field[0]}.{c.partition_field[1]}" if c.partition_field else "rows"
    return f" partition={pf} K={c.n_partitions} schedule={c.schedule}"


def _fmt(x: float) -> str:
    if x >= 1e15:
        return "inf"
    if x >= 1e6:
        return f"{x:.3g}"
    if x == int(x):
        return str(int(x))
    return f"{x:.1f}"


def render_explain(
    decision: Decision,
    name: str = "query",
    cache_hit: bool = False,
    max_alternatives: int = 6,
) -> str:
    lines = []
    src = "cache HIT" if cache_hit else "cache MISS"
    lines.append(f"EXPLAIN {name}  (planner=cost, {src}, epoch={decision.stats_epoch[:10]})")

    lines.append("  estimated cardinalities:")
    for le in decision.loop_estimates:
        pad = "    " + "  " * le.depth
        lines.append(f"{pad}{le.description:<52s} rows≈{_fmt(le.per_visit)}  total≈{_fmt(le.total)}")
    if not decision.loop_estimates:
        lines.append("    (no loops)")

    c = decision.chosen
    pf = f"{c.partition_field[0]}.{c.partition_field[1]}" if c.partition_field else "-"
    jm = f" join_method={c.join_method}" if c.join_method else ""
    dist = _distribution(c)
    lines.append(
        f"  chosen: order={c.order} agg_method={_agg_method(c)} parallel={c.parallel} "
        f"partition_field={pf}{jm}{dist} est_cost≈{_fmt(c.cost)}"
    )
    for op, cost in c.breakdown:
        lines.append(f"    {op:<56s} cost≈{_fmt(cost)}")

    # feedback block (planner/feedback.py): the measured profile this plan
    # consumed, lined up est=/observed= per estimate, plus the decision
    # delta vs the run the profile was measured under
    prof = getattr(decision, "observed", None)
    if prof is not None:
        lines.append(f"  feedback (profile: {prof.n_runs} prior run(s)):")
        for key in sorted(decision.estimates):
            obs_v = prof.value_for(key)
            if obs_v is None:
                continue
            lines.append(
                f"    {key:<52s} est={decision.estimates[key]:.4g} observed={obs_v:.4g}"
            )
        lines.append(
            f"    chunk_cost≈{prof.chunk_ms:.3f}ms"
            f" jit_hit_rate={prof.jit_hit_rate * 100:.0f}%"
            f" chunks={prof.n_chunks}"
        )
        if decision.replanned:
            lines.append(f"  replanned: {decision.replanned}")

    if decision.fallback_reason:
        lines.append(f"  (fallback to fixed defaults: {decision.fallback_reason})")

    if decision.rejections:
        lines.append("  legality (dependence analysis):")
        for r in decision.rejections:
            lines.append(f"    {r}")

    alts = [a for a in decision.candidates[1:]]
    if alts:
        lines.append(f"  rejected alternatives ({len(alts)} of {decision.n_enumerated} enumerated):")
        for a in alts[:max_alternatives]:
            apf = f"{a.partition_field[0]}.{a.partition_field[1]}" if a.partition_field else "-"
            ajm = f" join_method={a.join_method}" if a.join_method else ""
            lines.append(
                f"    order={a.order} agg_method={_agg_method(a)} parallel={a.parallel} "
                f"partition_field={apf}{ajm}{_distribution(a)} est_cost≈{_fmt(a.cost)}"
            )
        if len(alts) > max_alternatives:
            lines.append(f"    ... {len(alts) - max_alternatives} more")
    return "\n".join(lines)


def render_analyze(report: Dict[str, Any]) -> str:
    """Render a ``PartitionedPlan.runtime_report()`` as the ANALYZE block
    appended to EXPLAIN output: measured wall-clock, per-op achieved vs
    modeled imbalance (the measured per-chunk times replayed through
    ``sched.simulate_schedule`` under the configured policy), and the
    bucketed-jit chunk-kernel cache counters."""
    lines = [
        "  analyze (measured):"
        f" wall={report['wall_ms']:.1f}ms K={report['k']}"
        f" schedule={report['schedule']}"
        f" jit={'on' if report['jit_chunks'] else 'off'}"
        f" async={'on' if report['async_dispatch'] else 'off'}"
        f" workers={report['n_workers']}"
    ]
    if not report.get("ran", True):
        lines.append("    (no chunks dispatched — plan not yet run, or 0-row input)")
        return "\n".join(lines)
    for op in report.get("ops", []):
        modeled = (
            f" modeled_imbalance={op['modeled_imbalance'] * 100:.1f}%"
            if "modeled_imbalance" in op
            else ""
        )
        lines.append(
            f"    {op['op']:<40s} chunks={op['n_chunks']:<4d} rows={op['rows']:<9d}"
            f" busy={op['t_ms']:.1f}ms"
            f" achieved_imbalance={op['achieved_imbalance'] * 100:.1f}%{modeled}"
        )
    jit = report.get("jit", {})
    if jit:
        lines.append(
            f"    jit cache: kernels={jit['kernels']} buckets={jit['buckets']}"
            f" compiles={jit['compiles']} hits={jit['hits']}"
            f" overflows={jit['overflows']} hit_rate={jit['hit_rate'] * 100:.1f}%"
        )
    return "\n".join(lines)
