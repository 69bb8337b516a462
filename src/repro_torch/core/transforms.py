# Re-targeted classic compiler transformations on the forelem IR (paper §II,
# §III).  Each transform is semantics-preserving; tests/test_transforms.py
# checks preservation by executing programs before/after on random data.
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .ir import (
    Accumulate,
    ArrayRead,
    BinOp,
    Blocked,
    CombinePartials,
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
    RangePart,
    ResultAppend,
    ScalarAssign,
    Stmt,
    TupleExpr,
    ValueRange,
    Var,
    arrays_used,
    children,
    walk,
    with_children,
)
from repro_torch.analysis import deps as _deps

# ---------------------------------------------------------------------------
# Dependence analysis (Def-Use, paper §II).  The authoritative dataflow
# logic lives in repro_torch.analysis.deps — one module shared with the backends'
# required_columns and the planner's legality gate; the names below are
# thin compatibility wrappers so existing call sites (and tests) keep
# working.  ``independent`` fails CLOSED on unknown Stmt subtypes.
# ---------------------------------------------------------------------------


def _expr_array_reads(e: Expr, out: Set[str]) -> None:
    out.update(_deps.expr_array_reads(e))


def stmt_reads(s: Stmt) -> Set[str]:
    """Names (arrays, scalars) read anywhere under s."""
    return _deps.stmt_reads(s)


def stmt_writes(s: Stmt) -> Set[str]:
    return _deps.stmt_writes(s)


def independent(a: Stmt, b: Stmt) -> bool:
    """True if a and b can be reordered (no RAW/WAR/WAW hazards).

    Accumulations into the same array with the same commutative+associative
    op commute, which is what legalizes the fusion in the paper's §III-A4
    example.  Statement kinds the dependence module does not model are
    never independent (fail closed)."""
    return _deps.independent(a, b)


def _accum_ops(s: Stmt, name: str) -> Optional[Set[str]]:
    """The set of ops used to write `name` under s, or None if a
    non-accumulating write (ResultAppend / ScalarAssign '=') occurs."""
    return _deps.accum_ops(s, name)


# ---------------------------------------------------------------------------
# Statement reordering (code motion) — bubble independent statements next to
# each other so that Loop Fusion applies (paper §III-A4: "exploiting the
# possibility to reorder the loops such that the two parallelized loops ...
# are consecutive to one another").
# ---------------------------------------------------------------------------


def _can_move_before(body: Sequence[Stmt], src: int, dst: int) -> bool:
    """Can body[src] hop over body[dst..src-1]?"""
    for j in range(dst, src):
        if not independent(body[j], body[src]):
            return False
    return True


def reorder_adjacent(body: Sequence[Stmt], fusible) -> List[Stmt]:
    """Greedy reorder: for each statement, try to move a later fusible
    partner up to be adjacent.  `fusible(a, b)` decides candidate pairs."""
    out = list(body)
    i = 0
    while i < len(out):
        a = out[i]
        for j in range(i + 2, len(out)):
            if fusible(a, out[j]) and _can_move_before(out, j, i + 1):
                st = out.pop(j)
                out.insert(i + 1, st)
                break
        i += 1
    return out


# ---------------------------------------------------------------------------
# Loop Fusion
# ---------------------------------------------------------------------------


def _same_indexset(a: IndexSet, b: IndexSet) -> bool:
    return a == b


def _foralls_fusible(a: Stmt, b: Stmt) -> bool:
    return (
        isinstance(a, Forall)
        and isinstance(b, Forall)
        and a.n_parts == b.n_parts
        and a.mesh_axis == b.mesh_axis
    )


def _forvalues_fusible(a: Stmt, b: Stmt) -> bool:
    # Fusible when the iterated value ranges have identical *partitionings*.
    # Per the paper, X = A.field1 vs A.field2 only fuse after the
    # distribution solver decides they use the same partitioning of X, which
    # requires the value multisets to be congruent; we require equality of
    # the ValueRange (same table+field) OR an explicit congruence witness
    # registered on the program (handled in distribution.py).
    return (
        isinstance(a, ForValue)
        and isinstance(b, ForValue)
        and a.range_part.n_parts == b.range_part.n_parts
        and a.range_part.base == b.range_part.base
    )


def _rename_loopvar(stmts: Sequence[Stmt], old: str, new: str) -> List[Stmt]:
    def fix_expr(e: Expr) -> Expr:
        if isinstance(e, FieldRef) and e.loopvar == old:
            return FieldRef(e.table, new, e.field)
        if isinstance(e, Var) and e.name == old:
            return Var(new)
        if isinstance(e, BinOp):
            return BinOp(e.op, fix_expr(e.lhs), fix_expr(e.rhs))
        if isinstance(e, TupleExpr):
            return TupleExpr(tuple(fix_expr(x) for x in e.elements))
        if isinstance(e, ArrayRead):
            return ArrayRead(e.array, fix_expr(e.key))
        return e

    def fix_ix(ix: IndexSet) -> IndexSet:
        if isinstance(ix, FieldMatch):
            return FieldMatch(ix.table, ix.field, fix_expr(ix.value))
        if isinstance(ix, Filtered):
            return Filtered(ix.table, fix_expr(ix.predicate), ix.base)
        if isinstance(ix, Blocked):
            return Blocked(fix_ix(ix.base), ix.n_parts, ix.part_var)
        return ix

    out: List[Stmt] = []
    for s in stmts:
        if isinstance(s, Forelem):
            out.append(Forelem(s.loopvar, fix_ix(s.indexset), tuple(_rename_loopvar(s.body, old, new))))
        elif isinstance(s, ForValue):
            rp = s.range_part
            if rp.part_var == old:
                rp = RangePart(rp.base, rp.n_parts, new)
            valvar = new if s.valvar == old else s.valvar
            out.append(ForValue(valvar, rp, tuple(_rename_loopvar(s.body, old, new))))
        elif isinstance(s, Forall):
            out.append(with_children(s, _rename_loopvar(children(s), old, new)))
        elif isinstance(s, Accumulate):
            part = new if s.partitioned == old else s.partitioned
            out.append(dataclasses.replace(s, key=fix_expr(s.key), value=fix_expr(s.value), partitioned=part))
        elif isinstance(s, ResultAppend):
            part = new if s.partitioned == old else s.partitioned
            out.append(dataclasses.replace(s, tuple_expr=fix_expr(s.tuple_expr), partitioned=part))
        elif isinstance(s, CombinePartials):
            out.append(dataclasses.replace(s, partvar=new) if s.partvar == old else s)
        elif isinstance(s, ScalarAssign):
            out.append(dataclasses.replace(s, expr=fix_expr(s.expr)))
        else:
            out.append(s)
    return out


def fuse_once(body: Sequence[Stmt]) -> Tuple[List[Stmt], bool]:
    """One fusion pass over a statement list; returns (new_body, changed)."""
    out: List[Stmt] = []
    i = 0
    changed = False
    body = list(body)
    while i < len(body):
        s = body[i]
        if i + 1 < len(body):
            nxt = body[i + 1]
            # forall + forall
            if _foralls_fusible(s, nxt):
                nb = _rename_loopvar(nxt.body, nxt.partvar, s.partvar)
                out.append(dataclasses.replace(s, body=tuple(list(s.body) + nb)))
                i += 2
                changed = True
                continue
            # for (l ∈ X_k) + for (l' ∈ X_k)
            if _forvalues_fusible(s, nxt):
                nb = _rename_loopvar(nxt.body, nxt.valvar, s.valvar)
                rp = s.range_part
                nb = _rename_loopvar(nb, nxt.range_part.part_var, rp.part_var)
                out.append(ForValue(s.valvar, rp, tuple(list(s.body) + nb)))
                i += 2
                changed = True
                continue
            # forelem + forelem over identical index sets
            if (
                isinstance(s, Forelem)
                and isinstance(nxt, Forelem)
                and _same_indexset(s.indexset, nxt.indexset)
                and independent(s, nxt)
            ):
                nb = _rename_loopvar(nxt.body, nxt.loopvar, s.loopvar)
                out.append(Forelem(s.loopvar, s.indexset, tuple(list(s.body) + nb)))
                i += 2
                changed = True
                continue
        # recurse
        ch = children(s)
        if ch:
            nb, ch_changed = fuse_once(ch)
            if ch_changed:
                s = with_children(s, nb)
                changed = True
        out.append(s)
        i += 1
    return out, changed


def loop_fusion(program: Program, reorder: bool = True) -> Program:
    """Fixpoint fusion with optional dependence-safe reordering."""
    body = list(program.body)
    for _ in range(32):
        if reorder:
            body = reorder_adjacent(body, _foralls_fusible)
            body = [
                with_children(s, reorder_adjacent(children(s), _forvalues_fusible)) if children(s) else s
                for s in body
            ]
        body, changed = fuse_once(body)
        if not changed:
            break
    return program.with_body(body)


# ---------------------------------------------------------------------------
# Loop Interchange (push selective index sets outward — paper §III-B)
# ---------------------------------------------------------------------------


def loop_interchange(program: Program) -> Program:
    """Swap perfectly nested forelem loops so that the more *selective*
    index set (FieldMatch/Filtered with no dependence on the outer loop
    variable) runs outermost, shrinking data read (paper: "push any
    conditions on data to outer loops")."""

    def selectivity(ix: IndexSet) -> int:
        if isinstance(ix, FieldMatch):
            return 2
        if isinstance(ix, (Filtered, Distinct)):
            return 1
        return 0

    def uses_var(ix: IndexSet, var: str) -> bool:
        if isinstance(ix, FieldMatch):
            return any(
                isinstance(e, FieldRef) and e.loopvar == var for e in _expr_leaves(ix.value)
            ) or any(isinstance(e, Var) and e.name == var for e in _expr_leaves(ix.value))
        if isinstance(ix, Filtered):
            return any(isinstance(e, FieldRef) and e.loopvar == var for e in _expr_leaves(ix.predicate))
        return False

    def rewrite(stmts: Sequence[Stmt]) -> List[Stmt]:
        out: List[Stmt] = []
        for s in stmts:
            if (
                isinstance(s, Forelem)
                and len(s.body) == 1
                and isinstance(s.body[0], Forelem)
                and not uses_var(s.body[0].indexset, s.loopvar)
                and selectivity(s.body[0].indexset) > selectivity(s.indexset)
            ):
                inner = s.body[0]
                out.append(
                    Forelem(inner.loopvar, inner.indexset, (Forelem(s.loopvar, s.indexset, inner.body),))
                )
            elif children(s):
                out.append(with_children(s, rewrite(children(s))))
            else:
                out.append(s)
        return out

    return program.with_body(rewrite(program.body))


def _expr_leaves(e: Expr):
    if isinstance(e, BinOp):
        yield from _expr_leaves(e.lhs)
        yield from _expr_leaves(e.rhs)
    elif isinstance(e, TupleExpr):
        for el in e.elements:
            yield from _expr_leaves(el)
    elif isinstance(e, ArrayRead):
        yield from _expr_leaves(e.key)
    else:
        yield e


# ---------------------------------------------------------------------------
# Loop-order (join-order) enumeration — the planner's interchange hook.
# A two-table equi-join is a pair of nested forelem loops (Fig. 1); which
# table drives the outer loop is a *plan choice*, not a semantic property.
# ---------------------------------------------------------------------------


def swap_join_nest(outer: Forelem) -> Optional[Forelem]:
    """Given ``forelem (i ∈ pA) forelem (j ∈ pB.key[A[i].fk]) BODY`` return
    the interchanged ``forelem (j ∈ pB) forelem (i ∈ pA.fk[B[j].key]) BODY``
    (same result multiset — equi-join commutes).  Returns None when the
    nest is not of that shape."""
    if not (isinstance(outer, Forelem) and isinstance(outer.indexset, FullSet)):
        return None
    if len(outer.body) != 1 or not isinstance(outer.body[0], Forelem):
        return None
    inner = outer.body[0]
    iix = inner.indexset
    if not (
        isinstance(iix, FieldMatch)
        and isinstance(iix.value, FieldRef)
        and iix.value.loopvar == outer.loopvar
        and iix.value.table == outer.indexset.table
    ):
        return None
    a, fk = outer.indexset.table, iix.value.field
    b, key = iix.table, iix.field
    new_inner = Forelem(outer.loopvar, FieldMatch(a, fk, FieldRef(b, inner.loopvar, key)), inner.body)
    return Forelem(inner.loopvar, FullSet(b), (new_inner,))


def join_orders(program: Program) -> List[Program]:
    """All loop-order variants of the program obtained by interchanging one
    join nest (the original program is NOT included)."""
    out: List[Program] = []
    for idx, s in enumerate(program.body):
        if isinstance(s, Forelem):
            swapped = swap_join_nest(s)
            if swapped is not None:
                body = list(program.body)
                body[idx] = swapped
                out.append(program.with_body(body))
    return out


# ---------------------------------------------------------------------------
# Direct data partitioning: Loop Blocking (paper §III-A1)
# ---------------------------------------------------------------------------


def loop_blocking(program: Program, n_parts: int, partvar: str = "k", mesh_axis: Optional[str] = None) -> Program:
    """Split every top-level ``forelem (i ∈ pA)`` into
    ``forall (k) forelem (i ∈ p_k A)``  — pA = p1A ∪ … ∪ pNA."""
    out: List[Stmt] = []
    for s in program.body:
        if isinstance(s, Forelem) and isinstance(s.indexset, (FullSet, Filtered)):
            blocked = Blocked(s.indexset, n_parts, partvar)
            out.append(
                Forall(partvar, n_parts, (Forelem(s.loopvar, blocked, s.body),), mesh_axis=mesh_axis)
            )
        else:
            out.append(s)
    return program.with_body(out)


# ---------------------------------------------------------------------------
# Indirect data partitioning: Orthogonalization (paper §III-A1)
# ---------------------------------------------------------------------------


def orthogonalize(
    program: Program,
    table: str,
    field: str,
    n_parts: int,
    partvar: str = "k",
    valvar: str = "l",
    mesh_axis: Optional[str] = None,
    which: Optional[Sequence[int]] = None,
) -> Program:
    """Rewrite ``forelem (i ∈ pA) SEQ`` into

        forall (k = 1..N)
          for (l ∈ X_k)                 # X = A.field
            forelem (i ∈ pA.field[l]) SEQ

    (the paper's indirect data partitioning).  ``which`` optionally selects
    a subset of the eligible loops by ordinal (default: all of them)."""
    vr = ValueRange(table, field)
    out: List[Stmt] = []
    ordinal = -1
    for s in program.body:
        eligible = isinstance(s, Forelem) and isinstance(s.indexset, FullSet) and s.indexset.table == table
        if eligible:
            ordinal += 1
        if eligible and (which is None or ordinal in which):
            inner = Forelem(s.loopvar, FieldMatch(table, field, Var(valvar)), s.body)
            fv = ForValue(valvar, RangePart(vr, n_parts, partvar), (inner,))
            out.append(Forall(partvar, n_parts, (fv,), mesh_axis=mesh_axis))
        else:
            out.append(s)
    return program.with_body(out)


# ---------------------------------------------------------------------------
# Iteration Space Expansion (paper §IV: applied before parallelizing the
# URL-count query) — privatize accumulator arrays per partition and add the
# combining reduction.
# ---------------------------------------------------------------------------


def iteration_space_expansion(program: Program, partvar: str = "k") -> Program:
    """Inside every ``forall(partvar)``, rewrite ``arr[key] op= v`` into the
    privatized ``arr_k[key] op= v``; reads of ``arr`` *outside* the forall
    become reads of the combined array, preceded by a CombinePartials."""
    privatized: Dict[str, Tuple[str, int, str]] = {}  # arr -> (partvar, n, op)

    def rewrite_in_forall(stmts: Sequence[Stmt], pv: str, n: int) -> List[Stmt]:
        out: List[Stmt] = []
        for s in stmts:
            if isinstance(s, Accumulate) and s.partitioned is None:
                privatized[s.array] = (pv, n, s.op)
                out.append(dataclasses.replace(s, partitioned=pv))
            elif children(s):
                out.append(with_children(s, rewrite_in_forall(children(s), pv, n)))
            else:
                out.append(s)
        return out

    body: List[Stmt] = []
    for s in program.body:
        if isinstance(s, Forall):
            body.append(with_children(s, rewrite_in_forall(children(s), s.partvar, s.n_parts)))
        else:
            body.append(s)

    # Insert combines before first outside use of each privatized array.
    out: List[Stmt] = []
    combined: Set[str] = set()
    for s in body:
        needs = stmt_reads(s) if not isinstance(s, Forall) else set()
        for arr, (pv, n, op) in privatized.items():
            if arr in needs and arr not in combined:
                out.append(CombinePartials(arr, pv, n, op))
                combined.add(arr)
        out.append(s)
    return program.with_body(out)


# ---------------------------------------------------------------------------
# Dead Code Elimination + dead-field pruning (Def-Use)
# ---------------------------------------------------------------------------


def dead_code_elimination(program: Program) -> Program:
    """Remove accumulations into arrays that are never read and not results,
    loops whose bodies become empty, and ResultAppends to non-result names
    that are never read."""
    for _ in range(8):
        used = arrays_used(program.body)
        live = set(used) | set(program.results)
        changed = False

        def rewrite(stmts: Sequence[Stmt]) -> List[Stmt]:
            nonlocal changed
            out: List[Stmt] = []
            for s in stmts:
                if isinstance(s, Accumulate) and s.array not in live:
                    changed = True
                    continue
                if isinstance(s, ResultAppend) and s.result not in live:
                    changed = True
                    continue
                if isinstance(s, CombinePartials) and s.array not in live:
                    changed = True
                    continue
                if isinstance(s, ScalarAssign) and s.var not in live:
                    changed = True
                    continue
                if children(s):
                    nb = rewrite(children(s))
                    if not nb:
                        changed = True
                        continue
                    s = with_children(s, nb)
                out.append(s)
            return out

        program = program.with_body(rewrite(program.body))
        if not changed:
            break
    return program


# ---------------------------------------------------------------------------
# Common sub-expression elimination over index sets: detect repeated
# FieldMatch index sets so that a single materialized index serves multiple
# forelem loops (paper §III-B "sometimes an index can be generated in such a
# way that it can be used for more than one forelem loop").
# ---------------------------------------------------------------------------


def shared_index_sets(program: Program) -> Dict[Tuple[str, str], int]:
    """(table, field) -> number of forelem loops that would use one index."""
    counts: Dict[Tuple[str, str], int] = {}
    for s in walk(program.body):
        if isinstance(s, Forelem):
            ix = s.indexset
            while isinstance(ix, Blocked):
                ix = ix.base
            if isinstance(ix, FieldMatch):
                k = (ix.table, ix.field)
                counts[k] = counts.get(k, 0) + 1
    return counts


# ---------------------------------------------------------------------------
# Full "super-optimizer" pipeline helpers
# ---------------------------------------------------------------------------


def parallelize_groupby(
    program: Program,
    table: str,
    field: str,
    n_parts: int,
    mesh_axis: Optional[str] = None,
) -> Program:
    """The paper's §IV URL-count pipeline: Iteration Space Expansion + Code
    Motion + indirect partitioning, producing

        forall (k) { count_k = 0; for (l ∈ X_k) forelem (i ∈ pT.f[l]) count_k[f]++ }
        forelem (i ∈ pT.distinct(f)) R ∪= (f, Σ_k count_k[f])
    """
    p = orthogonalize(program, table, field, n_parts, mesh_axis=mesh_axis)
    p = iteration_space_expansion(p)
    p = loop_fusion(p)
    return p


# ---------------------------------------------------------------------------
# Name canonicalization (engine front door)
# ---------------------------------------------------------------------------


def canonicalize_array_names(program: Program) -> Program:
    """Rename every accumulator array to ``a0, a1, ...`` in order of first
    appearance.

    Frontends invent their own internal array names ('agg0' from SQL, 'acc'
    from the MapReduce spec); the names carry no semantics, but they leak
    into the program fingerprint and would split the plan cache between
    frontends.  After canonicalization, the same logical query submitted
    via SQL or MapReduce prints — and therefore fingerprints — identically.
    Result multisets, scalars and loop variables are left untouched (they
    are part of the program's observable interface)."""
    mapping: Dict[str, str] = {}

    def arr(name: str) -> str:
        if name not in mapping:
            mapping[name] = f"a{len(mapping)}"
        return mapping[name]

    def rw_expr(e: Expr) -> Expr:
        if isinstance(e, ArrayRead):
            return ArrayRead(arr(e.array), rw_expr(e.key))
        if isinstance(e, BinOp):
            return BinOp(e.op, rw_expr(e.lhs), rw_expr(e.rhs))
        if isinstance(e, TupleExpr):
            return TupleExpr(tuple(rw_expr(el) for el in e.elements))
        return e

    def rw_ix(ix: IndexSet) -> IndexSet:
        if isinstance(ix, Filtered):
            return Filtered(ix.table, rw_expr(ix.predicate), rw_ix(ix.base))
        if isinstance(ix, FieldMatch):
            return FieldMatch(ix.table, ix.field, rw_expr(ix.value))
        if isinstance(ix, Blocked):
            return Blocked(rw_ix(ix.base), ix.n_parts, ix.part_var)
        return ix

    def rw_stmt(s: Stmt) -> Stmt:
        if isinstance(s, Forelem):
            return Forelem(s.loopvar, rw_ix(s.indexset), tuple(rw_stmt(x) for x in s.body))
        if isinstance(s, Forall):
            return Forall(s.partvar, s.n_parts, tuple(rw_stmt(x) for x in s.body), s.mesh_axis)
        if isinstance(s, ForValue):
            return ForValue(s.valvar, s.range_part, tuple(rw_stmt(x) for x in s.body))
        if isinstance(s, Accumulate):
            return Accumulate(arr(s.array), rw_expr(s.key), rw_expr(s.value), s.op, s.partitioned)
        if isinstance(s, ResultAppend):
            return ResultAppend(s.result, rw_expr(s.tuple_expr), s.partitioned)
        if isinstance(s, ScalarAssign):
            return ScalarAssign(s.var, rw_expr(s.expr), s.op)
        if isinstance(s, CombinePartials):
            return CombinePartials(arr(s.array), s.partvar, s.n_parts, s.op)
        return s

    return program.with_body([rw_stmt(s) for s in program.body])
