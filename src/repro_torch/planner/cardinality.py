# Selectivity / cardinality estimation over the forelem IR.
#
# Classic System-R style estimation, re-targeted at index sets: a FullSet
# yields the table's row count, a Filtered applies predicate selectivity
# (histograms for range predicates, 1/n_distinct for equality), a
# FieldMatch whose value is bound by an *outer* loop is an equi-join whose
# per-probe cardinality is n_rows/n_distinct, a Distinct yields the distinct
# count (the GROUP BY output size).  Estimates are propagated through
# nested Forelem loops so EXPLAIN can show per-loop totals.
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.ir import (
    BinOp,
    Blocked,
    Const,
    Distinct,
    Expr,
    FieldMatch,
    FieldRef,
    Filtered,
    ForValue,
    Forall,
    Forelem,
    FullSet,
    IndexSet,
    Program,
    Stmt,
    _ixset_str,
)

from .feedback import ObservedProfile, filter_signature
from .stats import DbStats

DEFAULT_SELECTIVITY = 1.0 / 3.0  # fallback for unestimatable predicates


@dataclass(frozen=True)
class LoopEstimate:
    """One loop of the program with its estimated cardinalities."""

    depth: int
    kind: str          # 'forelem' | 'forall' | 'forvalue'
    description: str
    per_visit: float   # iterations each time the loop is entered
    total: float       # iterations summed over all visits


class CardinalityEstimator:
    def __init__(self, stats: DbStats, profile: Optional[ObservedProfile] = None):
        self.stats = stats
        self.profile = profile

    # -- predicate selectivity ----------------------------------------------
    def selectivity(self, pred: Optional[Expr], table: str) -> float:
        if pred is None:
            return 1.0
        if self.profile is not None:
            obs = self.profile.selectivity.get(filter_signature(pred, table))
            if obs is not None:
                return float(obs)
        return self._sel(pred, table)

    def partition_row_skew(self, table: str, fld: str, n_partitions: int) -> float:
        """Max/mean per-partition row ratio when hash-partitioning ``table``
        on ``fld`` into ``n_partitions`` parts (1.0 = perfectly even).

        Open-loop estimate: the most-common value's frequency bounds the
        heaviest partition at ``most_common_frac × K`` of even share.  With
        a feedback profile, the *measured* ratio from the last run's layout
        wins — it also captures residue clustering (many distinct keys
        hashing to one partition) that per-key stats cannot see."""
        if self.profile is not None:
            obs = self.profile.row_skew.get(f"{table}.{fld}")
            if obs is not None:
                return max(1.0, float(obs))
        fs = self.stats.field(table, fld)
        if fs is None:
            return 1.0
        return max(1.0, fs.most_common_frac * max(1, n_partitions))

    def _sel(self, e: Expr, table: str) -> float:
        if isinstance(e, BinOp):
            if e.op == "and":
                return self._sel(e.lhs, table) * self._sel(e.rhs, table)
            if e.op == "or":
                a, b = self._sel(e.lhs, table), self._sel(e.rhs, table)
                return min(1.0, a + b - a * b)
            if e.op in ("==", "!=", "<", "<=", ">", ">="):
                return self._cmp_sel(e, table)
        if isinstance(e, Const):
            return 1.0 if bool(e.value) else 0.0
        return DEFAULT_SELECTIVITY

    def _cmp_sel(self, e: BinOp, table: str) -> float:
        fld, lit = self._field_and_literal(e)
        if fld is None:
            return DEFAULT_SELECTIVITY
        fs = self.stats.field(fld[0], fld[1])
        nd = self.stats.n_distinct(fld[0], fld[1])
        if e.op == "==":
            if lit is not None and fs is not None and fs.is_numeric and fs.vmin is not None:
                if lit < fs.vmin or lit > fs.vmax:
                    return 0.0
            return 1.0 / nd
        if e.op == "!=":
            return 1.0 - 1.0 / nd
        # range comparison
        if lit is None or fs is None or not fs.is_numeric or fs.vmin is None or fs.vmax is None:
            return DEFAULT_SELECTIVITY
        if e.op in ("<", "<="):
            return fs.range_fraction(fs.vmin, lit)
        return fs.range_fraction(lit, fs.vmax)

    def _field_and_literal(
        self, e: BinOp
    ) -> Tuple[Optional[Tuple[str, str]], Optional[float]]:
        """Normalize ``field <op> literal`` / ``literal <op> field``; the
        literal is None for parameters (Var) and non-constant sides."""
        l, r = e.lhs, e.rhs
        if isinstance(l, FieldRef):
            lit = float(r.value) if isinstance(r, Const) and _is_num(r.value) else None
            return (l.table, l.field), lit
        if isinstance(r, FieldRef):
            lit = float(l.value) if isinstance(l, Const) and _is_num(l.value) else None
            return (r.table, r.field), lit
        return None, None

    # -- index sets ----------------------------------------------------------
    def indexset_rows(self, ix: IndexSet, bound_loopvars: Dict[str, str]) -> float:
        """Expected rows yielded per visit of a loop over ``ix``.

        bound_loopvars: loopvar -> table for loops *surrounding* this one
        (a FieldMatch on an outer loop's field value is an equi-join probe)."""
        if isinstance(ix, FullSet):
            return float(self.stats.n_rows(ix.table))
        if isinstance(ix, Distinct):
            return float(self.stats.n_distinct(ix.table, ix.field))
        if isinstance(ix, Filtered):
            base = self.indexset_rows(ix.base, bound_loopvars)
            return base * self.selectivity(ix.predicate, ix.table)
        if isinstance(ix, FieldMatch):
            n = self.stats.n_rows(ix.table)
            nd = self.stats.n_distinct(ix.table, ix.field)
            # equality match selects ~n/nd rows regardless of where the
            # value comes from (outer loop field, parameter, constant)
            return n / nd
        if isinstance(ix, Blocked):
            return self.indexset_rows(ix.base, bound_loopvars) / max(1, ix.n_parts)
        return 1.0

    def groupby_output(self, table: str, fld: str) -> float:
        return float(self.stats.n_distinct(table, fld))

    # -- joins ----------------------------------------------------------------
    def join_expansion_factor(self, build_table: str, build_key: str) -> float:
        """Fan-out bound of the duplicate-key expansion lowering: the max
        rows sharing one build-key value (1.0 for a unique key).  The
        lowering's static output shape is probe_rows × this, which is what
        every per-slot cost term scales with."""
        return float(self.stats.max_multiplicity(build_table, build_key))

    # -- whole-program propagation -------------------------------------------
    def loop_estimates(self, program: Program) -> List[LoopEstimate]:
        out: List[LoopEstimate] = []

        def visit(stmts: Sequence[Stmt], depth: int, visits: float, bound: Dict[str, str]) -> None:
            for s in stmts:
                if isinstance(s, Forelem):
                    per = self.indexset_rows(s.indexset, bound)
                    out.append(
                        LoopEstimate(
                            depth,
                            "forelem",
                            f"forelem {s.loopvar} ∈ {_ixset_str(s.indexset)}",
                            per,
                            per * visits,
                        )
                    )
                    b2 = dict(bound)
                    b2[s.loopvar] = s.indexset.table
                    visit(s.body, depth + 1, per * visits, b2)
                elif isinstance(s, Forall):
                    out.append(
                        LoopEstimate(depth, "forall", f"forall {s.partvar} ≤ {s.n_parts}", s.n_parts, s.n_parts * visits)
                    )
                    visit(s.body, depth + 1, s.n_parts * visits, bound)
                elif isinstance(s, ForValue):
                    rp = s.range_part
                    nd = self.stats.n_distinct(rp.base.table, rp.base.field)
                    per = nd / max(1, rp.n_parts)
                    out.append(
                        LoopEstimate(
                            depth,
                            "forvalue",
                            f"for {s.valvar} ∈ ({rp.base.table}.{rp.base.field})_{rp.part_var}",
                            per,
                            per * visits,
                        )
                    )
                    visit(s.body, depth + 1, per * visits, bound)

        visit(program.body, 0, 1.0, {})
        return out


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)
