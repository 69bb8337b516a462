# Cost-based query planner over the forelem IR (paper §I: the single
# intermediate representation "enables the integration of compiler
# optimization and query optimization").
#
# The subsystem turns the fixed pass pipeline of ``core.passes.optimize``
# into a data-driven *super-optimizer*:
#
#   stats.py        table statistics (row counts, distinct counts, min/max,
#                   equi-width histograms) + a cheap ``stats_epoch``
#                   fingerprint over the Database,
#   cardinality.py  selectivity / cardinality estimation for Filtered
#                   predicates, FieldMatch equi-joins and GROUP BY outputs,
#                   propagated through nested Forelem loops,
#   cost.py         a cost model over the lowering's real strategy space
#                   (index-set materialization method, parallel execution,
#                   partition-field choice),
#   enumerate.py    loop-order (join-order) enumeration via the interchange
#                   transform, pruned with the cost model,
#   cache.py        a plan cache keyed on (program fingerprint, stats epoch)
#                   for repeated serving traffic,
#   feedback.py     adaptive re-optimization: ObservedProfiles distilled
#                   from run telemetry, a bounded per-tenant FeedbackStore,
#                   and the drift trigger that re-plans when measurements
#                   leave the estimate band,
#   explain.py      EXPLAIN rendering of estimates vs. the chosen plan
#                   (est=/observed= + ``replanned:`` under feedback).
#
# Entry point: ``run_planner(program, db, opts)`` — used by
# ``core.passes.optimize`` when ``OptimizeOptions(planner="cost")``.
from .stats import DbStats, FieldStats, TableStats, collect_stats
from .feedback import (
    FeedbackStore,
    ObservedProfile,
    drift_report,
    extract_profile,
    filter_signature,
)
from .cardinality import CardinalityEstimator, LoopEstimate
from .cost import CostCoefficients, CostModel, calibrate
from .enumerate import Candidate, Decision, enumerate_candidates, plan_query
from .cache import DEFAULT_CACHE, CacheEntry, PlanCache, program_fingerprint
from .explain import render_analyze, render_explain
from .driver import PlannerOutcome, run_planner

__all__ = [
    "DbStats",
    "FieldStats",
    "TableStats",
    "collect_stats",
    "CardinalityEstimator",
    "LoopEstimate",
    "CostCoefficients",
    "CostModel",
    "calibrate",
    "Candidate",
    "Decision",
    "enumerate_candidates",
    "plan_query",
    "DEFAULT_CACHE",
    "CacheEntry",
    "PlanCache",
    "program_fingerprint",
    "render_analyze",
    "render_explain",
    "PlannerOutcome",
    "run_planner",
    "FeedbackStore",
    "ObservedProfile",
    "drift_report",
    "extract_profile",
    "filter_signature",
]
