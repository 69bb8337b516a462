# Planner driver: the piece ``core.passes.optimize`` calls when
# ``OptimizeOptions(planner="cost")``.
#
# Flow per query:
#   1. fingerprint the (query-optimized) program + the database epoch,
#   2. plan-cache probe — a hit returns the previously compiled Plan,
#   3. on miss: collect stats, enumerate+price candidates, pick the
#      cheapest, render EXPLAIN; passes.py then finishes the pipeline
#      (partitioning, distribution, lowering) with the chosen knobs and
#      stores the compiled plan back via ``PlannerOutcome.store``.
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.core.ir import Program
from repro_torch.data.multiset import Database
from repro_torch.obs.trace import NULL_TRACER

from .cache import DEFAULT_CACHE, CacheEntry, PlanCache, program_fingerprint
from .enumerate import Decision, plan_query
from .explain import render_explain
from .stats import collect_stats


@dataclass
class PlannerOutcome:
    program: Program            # chosen loop order (pre-partitioning)
    decision: Decision
    explain: str
    cache_hit: bool
    fingerprint: str
    epoch: str
    cache: PlanCache
    cached_entry: Optional[CacheEntry] = None

    def store(self, plan: Any, final_program: Program) -> None:
        """Memoize the compiled plan for identical future queries."""
        self.cache.put(
            self.fingerprint,
            self.epoch,
            CacheEntry(self.decision, plan, self.explain, final_program, self.epoch),
        )


def run_planner(
    program: Program,
    db: Database,
    n_parts: int = 1,
    plan_cache: Optional[PlanCache] = None,
    allow_shard_map: bool = False,
    coeffs: Any = None,
    backend: str = "torch",
    device: str = "cuda",
    n_partitions: Optional[int] = None,
    schedule: Optional[str] = None,
    jit_chunks: bool = True,
    async_dispatch: bool = True,
    tracer: Any = None,
    feedback: Any = None,
    feedback_tenant: str = "",
) -> PlannerOutcome:
    tr = tracer if tracer is not None else NULL_TRACER
    cache = plan_cache if plan_cache is not None else DEFAULT_CACHE
    # the cached plan was compiled under these planning inputs — different
    # inputs must miss, even for the same program text (and DEFAULT_CACHE
    # is shared across callers with different options).  The executor
    # backend and its device are part of the key: a plan compiled by one
    # backend, or for one device, must never be served to a caller asking
    # for another (the device also changes the kernel's price); likewise a pinned K /
    # schedule / chunk-dispatch knob (jit_chunks, async_dispatch) produces
    # a different compiled plan than the planner's pick.  The semantic
    # fingerprint is the key's PREFIX so the drift trigger can evict every
    # knob variant of one query (PlanCache.invalidate_fingerprint).
    sem_fp = program_fingerprint(program)
    fp = (
        f"{sem_fp}|n{n_parts}|s{int(allow_shard_map)}"
        f"|c{hash(coeffs)}|b{backend}|d{device}|K{n_partitions}|sch{schedule}"
        f"|j{int(jit_chunks)}|a{int(async_dispatch)}"
    )
    epoch = db.stats_epoch()

    with tr.span("cache.lookup") as ls:
        entry = cache.get(fp, epoch)
        ls.set(hit=entry is not None, fingerprint=fp[:12], epoch=epoch[:10])
    if entry is not None:
        explain = render_explain(entry.decision, name=program.name, cache_hit=True)
        return PlannerOutcome(
            entry.decision.chosen.program,
            entry.decision,
            explain,
            True,
            fp,
            epoch,
            cache,
            cached_entry=entry,
        )

    # feedback lookup (planner/feedback.py): measurements from earlier runs
    # of this exact program, isolated per tenant.  A profile recorded
    # against a different stats epoch is stale — the data changed — and is
    # ignored rather than steering the plan with dead history.
    profile = None
    if feedback is not None:
        profile = feedback.get(sem_fp, tenant=feedback_tenant)
        if profile is not None and profile.epoch and profile.epoch != epoch:
            profile = None

    with tr.span("plan.stats"):
        stats = collect_stats(db)
    # enumeration and costing happen together per candidate (plan_query
    # prices each variant as it is produced), so one span covers both
    with tr.span("plan.enumerate") as es:
        decision = plan_query(
            program, stats, n_parts=n_parts, coeffs=coeffs, allow_shard_map=allow_shard_map,
            device=device, executor=backend, n_partitions=n_partitions, schedule=schedule,
            profile=profile,
        )
        es.set(
            n_enumerated=decision.n_enumerated,
            chosen_order=decision.chosen.order,
            chosen_cost=float(decision.chosen.cost),
            replanned=profile is not None,
        )
    decision.fingerprint = sem_fp
    if profile is not None:
        decision.observed = profile
        decision.replanned = profile.decision_diff(decision.chosen)
    explain = render_explain(decision, name=program.name, cache_hit=False)
    return PlannerOutcome(decision.chosen.program, decision, explain, False, fp, epoch, cache)
