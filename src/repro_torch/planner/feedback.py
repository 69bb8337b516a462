# Feedback-driven re-optimization: distill what a finished run *measured*
# (per-filter selectivity, per-partition row skew, chunk cost, jit hit
# rate) into an ``ObservedProfile`` and feed it back into the next plan of
# the same program.
#
# The loop closes in four places:
#   extract_profile()  — Session._submit() calls this after every run() to
#                        turn the partitioned backend's dispatch_log +
#                        layouts into measurements;
#   FeedbackStore      — bounded, thread-safe, (tenant, fingerprint)-keyed
#                        store; a QueryServer shares ONE store across all
#                        tenant sessions while keeping profiles isolated
#                        per tenant;
#   CardinalityEstimator / CostModel — accept an optional profile and
#                        prefer observed selectivity / row skew / jit hit
#                        rate over the static-stats estimates;
#   drift_report()     — compares observed vs estimated after a run; any
#                        ratio outside the configurable band (default 2x)
#                        makes the Session invalidate the cached plan so
#                        the next dispatch re-plans with the profile.
#
# Convergence: a plan produced *with* a profile records that profile on
# its Decision (``decision.observed``), and the drift trigger only fires
# for open-loop decisions (``observed is None``) — so each fingerprint
# re-plans at most once per stats epoch and cannot oscillate.
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.ir import Expr, _expr_str


def filter_signature(pred: Expr, table: str) -> str:
    """Stable key for one filter predicate over one table.

    Shared by profile extraction (writer side) and the cardinality
    estimator (reader side) so observed selectivities land on exactly the
    key the next plan looks up."""
    return f"{table}: {_expr_str(pred)}"


@dataclass
class ObservedProfile:
    """Measurements distilled from one (or EWMA-merged several) run(s) of a
    single program fingerprint.

    ``selectivity`` maps ``filter_signature()`` keys to measured pass
    fractions; ``row_skew`` maps ``"table.field"`` partition keys to the
    measured max/mean per-partition row ratio (1.0 = perfectly even).
    ``chunk_ms`` / ``jit_hit_rate`` describe achieved chunk cost and cache
    behaviour; the ``k``/``schedule``/``agg_method``/``join_method``
    fields snapshot the decision the measurements were taken under, so
    EXPLAIN can render a ``replanned:`` diff when the next plan differs."""

    fingerprint: str = ""
    epoch: str = ""                 # stats epoch the run executed against
    n_runs: int = 1
    wall_ms: float = 0.0
    chunk_ms: float = 0.0           # mean measured per-chunk time
    jit_hit_rate: float = 0.0
    n_chunks: int = 0
    rows_scanned: int = 0
    selectivity: Dict[str, float] = field(default_factory=dict)
    row_skew: Dict[str, float] = field(default_factory=dict)
    k: Optional[int] = None         # decision the profile was measured under
    schedule: Optional[str] = None
    agg_method: Optional[str] = None
    join_method: Optional[str] = None

    def value_for(self, key: str) -> Optional[float]:
        """Resolve an estimate key (``sel[...]`` / ``skew[...]``, as put in
        ``Decision.estimates``) to the matching observation, or None."""
        if key.startswith("sel[") and key.endswith("]"):
            return self.selectivity.get(key[4:-1])
        if key.startswith("skew[") and key.endswith("]"):
            return self.row_skew.get(key[5:-1])
        return None

    def decision_diff(self, chosen: Any) -> Optional[str]:
        """Human-readable diff between the decision this profile was
        measured under and a newly chosen candidate — the EXPLAIN
        ``replanned:`` line.  None when nothing changed."""
        parts: List[str] = []
        new_k = getattr(chosen, "n_partitions", None)
        if self.k is not None and new_k is not None and new_k != self.k:
            parts.append(f"K {self.k}→{new_k}")
        new_sched = getattr(chosen, "schedule", None)
        if self.schedule is not None and new_sched is not None and new_sched != self.schedule:
            parts.append(f"schedule {self.schedule}→{new_sched}")
        new_agg = getattr(chosen, "agg_method", None)
        if self.agg_method is not None and new_agg is not None and new_agg != self.agg_method:
            parts.append(f"agg {self.agg_method}→{new_agg}")
        new_join = getattr(chosen, "join_method", None)
        if self.join_method is not None and new_join is not None and new_join != self.join_method:
            parts.append(f"join {self.join_method}→{new_join}")
        return ", ".join(parts) if parts else None


class FeedbackStore:
    """Bounded, thread-safe store of ``ObservedProfile``s keyed by
    ``(tenant, program fingerprint)``.

    One instance can back a whole ``QueryServer``: tenants share the LRU
    budget but never see each other's profiles (the tenant label is part
    of the key).  Repeated observations of the same key merge by EWMA
    (``alpha`` weight on the newest run) so a single noisy run cannot whip
    the planner around; observations from a different stats epoch replace
    the old profile outright (the data changed — history is stale)."""

    def __init__(self, capacity: int = 128, alpha: float = 0.5):
        self.capacity = capacity
        self.alpha = alpha
        self._profiles: "OrderedDict[Tuple[str, str], ObservedProfile]" = OrderedDict()
        self._lock = threading.Lock()
        self.records = 0
        self.merges = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._profiles)

    def record(self, fingerprint: str, profile: ObservedProfile, tenant: str = "") -> ObservedProfile:
        """Merge (or insert) one run's profile; returns the stored profile."""
        key = (tenant, fingerprint)
        a = self.alpha
        with self._lock:
            self.records += 1
            prev = self._profiles.get(key)
            if prev is None or prev.epoch != profile.epoch:
                stored = replace(
                    profile,
                    fingerprint=fingerprint,
                    n_runs=1,
                    selectivity=dict(profile.selectivity),
                    row_skew=dict(profile.row_skew),
                )
            else:
                self.merges += 1

                def ewma(old: float, new: float) -> float:
                    return (1.0 - a) * old + a * new

                sel = dict(prev.selectivity)
                for k, v in profile.selectivity.items():
                    sel[k] = ewma(sel[k], v) if k in sel else v
                skew = dict(prev.row_skew)
                for k, v in profile.row_skew.items():
                    skew[k] = ewma(skew[k], v) if k in skew else v
                stored = replace(
                    profile,
                    fingerprint=fingerprint,
                    n_runs=prev.n_runs + 1,
                    wall_ms=ewma(prev.wall_ms, profile.wall_ms),
                    chunk_ms=ewma(prev.chunk_ms, profile.chunk_ms),
                    jit_hit_rate=ewma(prev.jit_hit_rate, profile.jit_hit_rate),
                    selectivity=sel,
                    row_skew=skew,
                )
            self._profiles[key] = stored
            self._profiles.move_to_end(key)
            while len(self._profiles) > self.capacity:
                self._profiles.popitem(last=False)
            return stored

    def get(self, fingerprint: str, tenant: str = "") -> Optional[ObservedProfile]:
        with self._lock:
            prof = self._profiles.get((tenant, fingerprint))
            if prof is not None:
                self._profiles.move_to_end((tenant, fingerprint))
            return prof

    def clear(self) -> None:
        with self._lock:
            self._profiles.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "profiles": len(self._profiles),
                "records": self.records,
                "merges": self.merges,
                "capacity": self.capacity,
            }


def extract_profile(plan: Any, decision: Any = None, results: Any = None) -> Optional[ObservedProfile]:
    """Distill one finished run of a partitioned plan into an
    ``ObservedProfile``.  Returns None when the plan exposes no dispatch
    telemetry (reference / monolithic torch backends).

    Measured selectivity is emitted-rows / scanned-rows per filtered
    projection — only when the program has no LIMIT (a limit truncates
    the emitted count and would corrupt the fraction).  Row skew comes
    from the backend's hash layouts (``partition_row_counts``): the
    max/mean per-partition row ratio the partitioner actually produced."""
    log = getattr(plan, "dispatch_log", None)
    if not log:
        return None
    n_chunks = len(log)
    rows_scanned = int(sum(d.rows for d in log))
    chunk_ms = float(sum(d.t_ms for d in log)) / n_chunks
    wall_ms = float(getattr(plan, "last_run_ms", 0.0) or 0.0)
    jit_stats = getattr(plan, "jit_stats", None)
    hit_rate = float(jit_stats.hit_rate) if jit_stats is not None else 0.0

    selectivity: Dict[str, float] = {}
    spec = getattr(plan, "spec", None)
    program = getattr(plan, "program", None)
    no_limit = program is None or getattr(program, "limit", None) is None
    if spec is not None and results is not None and no_limit:
        for fp in getattr(spec, "filter_projects", ()):
            if fp.filter_pred is None or fp.result not in results:
                continue
            scanned = sum(d.rows for d in log if d.op == f"project:{fp.result}")
            if scanned <= 0:
                continue
            emitted = len(results[fp.result])
            selectivity[filter_signature(fp.filter_pred, fp.table)] = emitted / scanned

    row_skew: Dict[str, float] = {}
    counts_fn = getattr(plan, "partition_row_counts", None)
    if counts_fn is not None:
        for key, counts in counts_fn().items():
            total = int(counts.sum())
            if total > 0 and len(counts) > 1:
                row_skew[key] = float(counts.max()) / (total / len(counts))

    chosen = getattr(decision, "chosen", None) if decision is not None else None
    return ObservedProfile(
        fingerprint=getattr(decision, "fingerprint", "") if decision is not None else "",
        epoch=getattr(decision, "stats_epoch", "") if decision is not None else "",
        wall_ms=wall_ms,
        chunk_ms=chunk_ms,
        jit_hit_rate=hit_rate,
        n_chunks=n_chunks,
        rows_scanned=rows_scanned,
        selectivity=selectivity,
        row_skew=row_skew,
        k=getattr(chosen, "n_partitions", None) if chosen is not None else None,
        schedule=getattr(chosen, "schedule", None) if chosen is not None else None,
        agg_method=getattr(chosen, "agg_method", None) if chosen is not None else None,
        join_method=getattr(chosen, "join_method", None) if chosen is not None else None,
    )


def drift_report(profile: ObservedProfile, estimates: Dict[str, float], band: float = 2.0) -> List[str]:
    """Compare observed values against the estimates the current plan was
    built from; return one message per estimate whose observed/estimated
    ratio falls outside ``[1/band, band]``.  Empty list = no drift.

    Only row-count-derived quantities (selectivity, row skew) participate
    — chunk wall time and jit hit rate are timing-noisy and must not
    trigger re-planning on a quiet machine vs a loaded one."""
    out: List[str] = []
    if band <= 1.0:
        band = 1.0 + 1e-9
    for key in sorted(estimates):
        est = estimates[key]
        if est is None or est <= 0:
            continue
        obs = profile.value_for(key)
        if obs is None or obs <= 0:
            continue
        ratio = obs / est
        if ratio > band or ratio < 1.0 / band:
            out.append(
                f"{key}: observed={obs:.4g} vs est={est:.4g} "
                f"(×{ratio:.2f} outside ±{band:g}× band)"
            )
    return out
