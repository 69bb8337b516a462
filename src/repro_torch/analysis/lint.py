# Plan linter: advisory findings over a verifier-clean program — things
# that are *legal* but likely slow or wrong-in-intent, surfaced through
# ``Session.check(query)``, ``Session.explain(..., lint=True)`` and the
# ``scripts/irlint.py`` CLI.
#
# Rules (the names appear in LintWarning.rule and the docs table):
#
#   unused-column       registered columns the query never reads — the
#                       reformatter's prune step (§III-C1) can drop them,
#                       but a narrower projection avoids loading them at all
#   partition-skew      the indirect-partition field has fewer distinct
#                       values than partitions, or one dominant value —
#                       partitioned execution will be imbalanced
#   filter-pushdown     a filter evaluated inside an outer loop although its
#                       predicate is independent of that loop — push it
#                       above the join (classic selection pushdown)
#   sum-overflow        a SUM accumulator whose worst-case total exceeds the
#                       column's integer dtype — the lowering accumulates in
#                       the input dtype, so the result can wrap
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ir import (
    Accumulate,
    FieldRef,
    Filtered,
    Forelem,
    FullSet,
    Program,
    Stmt,
    walk,
)

from .deps import required_fields

# partition-skew thresholds: warn when the field has fewer distinct values
# than partitions, or when one value covers more than this fraction of rows
SKEW_TOP_VALUE_FRAC = 0.5
# accumulator headroom: warn when the worst-case SUM exceeds this fraction
# of the dtype's range (1.0 = only certain overflow; below 1.0 = margin)
OVERFLOW_MARGIN = 1.0


@dataclass(frozen=True)
class LintWarning:
    rule: str
    message: str
    table: Optional[str] = None
    field: Optional[str] = None

    def __str__(self) -> str:
        return f"[{self.rule}] {self.message}"


def _partition_field(program: Program) -> Optional[Tuple[str, str]]:
    """The field indirect partitioning would use — mirrors the planner's
    primary candidate (the first aggregation key, the paper's
    ``X = Access.url`` choice)."""
    for s in walk(program.body):
        if isinstance(s, Accumulate) and isinstance(s.key, FieldRef):
            return (s.key.table, s.key.field)
    return None


def _lint_unused_columns(program: Program, db: Any, out: List[LintWarning]) -> None:
    used = required_fields(program)
    for decl in program.tables:
        if db is not None and decl.name in db:
            columns = list(db[decl.name].field_names())
        else:
            columns = list(decl.schema.names())
        unused = sorted(set(columns) - used.get(decl.name, set()))
        if unused:
            out.append(
                LintWarning(
                    "unused-column",
                    f"table {decl.name!r}: column(s) {', '.join(unused)} are never read "
                    "by this query — the reformatter's prune step drops them, but a "
                    "narrower projection avoids materializing them at all",
                    table=decl.name,
                    field=unused[0],
                )
            )


def _lint_partition_skew(
    program: Program, stats: Any, n_partitions: int, out: List[LintWarning]
) -> None:
    tf = _partition_field(program)
    if tf is None or stats is None or n_partitions <= 1:
        return
    fs = stats.field(tf[0], tf[1])
    if fs is None or fs.n_rows == 0:
        return
    if fs.n_distinct < n_partitions:
        out.append(
            LintWarning(
                "partition-skew",
                f"partition field {tf[0]}.{tf[1]} has only {fs.n_distinct} distinct "
                f"value(s) for {n_partitions} partitions — "
                f"{n_partitions - fs.n_distinct} partition(s) will sit idle",
                table=tf[0],
                field=tf[1],
            )
        )
    elif fs.most_common_frac > SKEW_TOP_VALUE_FRAC:
        out.append(
            LintWarning(
                "partition-skew",
                f"partition field {tf[0]}.{tf[1]} is skewed: one value covers "
                f"{fs.most_common_frac * 100:.0f}% of rows — the partition holding it "
                "dominates the critical path",
                table=tf[0],
                field=tf[1],
            )
        )


def _predicate_independent_of(pred: Any, loopvar: str) -> bool:
    from repro_torch.core.ir import ArrayRead, BinOp, TupleExpr

    def refs(e: Any) -> bool:
        if isinstance(e, FieldRef):
            return e.loopvar == loopvar
        if isinstance(e, BinOp):
            return refs(e.lhs) or refs(e.rhs)
        if isinstance(e, TupleExpr):
            return any(refs(el) for el in e.elements)
        if isinstance(e, ArrayRead):
            return refs(e.key)
        return False

    return not refs(pred)


def _lint_filter_pushdown(program: Program, out: List[LintWarning]) -> None:
    def visit(stmts: Sequence[Stmt]) -> None:
        for s in stmts:
            if isinstance(s, Forelem):
                for inner in s.body:
                    if (
                        isinstance(inner, Forelem)
                        and isinstance(inner.indexset, Filtered)
                        and isinstance(inner.indexset.base, FullSet)
                        and _predicate_independent_of(inner.indexset.predicate, s.loopvar)
                    ):
                        out.append(
                            LintWarning(
                                "filter-pushdown",
                                f"filter on {inner.indexset.table!r} is re-evaluated inside "
                                f"the loop over {s.indexset.table!r} although its predicate "
                                "does not depend on it — push the selection above the "
                                "outer loop (loop interchange / selection pushdown)",
                                table=inner.indexset.table,
                            )
                        )
                visit(s.body)

    visit(program.body)


def _int_bounds(dtype: np.dtype) -> Optional[Tuple[int, int]]:
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return int(info.min), int(info.max)
    return None


def _lint_sum_overflow(program: Program, db: Any, stats: Any, out: List[LintWarning]) -> None:
    if db is None:
        return
    for s in walk(program.body):
        if not (isinstance(s, Accumulate) and s.op == "+"):
            continue
        v = s.value
        if not isinstance(v, FieldRef):
            continue  # COUNT (Const 1) totals are bounded by n_rows
        if v.table not in db:
            continue
        col = np.asarray(db[v.table].field(v.field))
        bounds = _int_bounds(col.dtype)
        if bounds is None:
            continue
        if stats is not None and (fs := stats.field(v.table, v.field)) is not None:
            n_rows = fs.n_rows
            vmax = max(abs(fs.vmax or 0), abs(fs.vmin or 0))
        else:
            n_rows = len(col)
            vmax = float(np.abs(col).max()) if len(col) else 0.0
        worst = n_rows * vmax
        if worst > bounds[1] * OVERFLOW_MARGIN:
            out.append(
                LintWarning(
                    "sum-overflow",
                    f"SUM({v.table}.{v.field}) accumulates {n_rows} rows of "
                    f"{col.dtype} with |value| up to {vmax:g}: worst case {worst:.3g} "
                    f"exceeds the dtype maximum {bounds[1]} — cast the column to int64 "
                    "or float before aggregating",
                    table=v.table,
                    field=v.field,
                )
            )


def lint_program(
    program: Program,
    db: Any = None,
    stats: Any = None,
    n_partitions: int = 1,
) -> List[LintWarning]:
    """Run every lint rule.  ``db`` (a ``repro_torch.data.multiset.Database``)
    enables the column-inventory and overflow rules; ``stats`` (a planner
    ``DbStats``, duck-typed to avoid a planner import cycle) enables the
    skew and sharper overflow estimates."""
    out: List[LintWarning] = []
    _lint_unused_columns(program, db, out)
    _lint_partition_skew(program, stats, n_partitions, out)
    _lint_filter_pushdown(program, out)
    _lint_sum_overflow(program, db, stats, out)
    return out


def render_lint(warnings: Sequence[LintWarning]) -> str:
    if not warnings:
        return "  lint: clean"
    return "\n".join(["  lint:"] + [f"    {w}" for w in warnings])
