# Dependence and legality analysis over the forelem IR — the one dataflow
# module behind every pass and planner decision (paper §II: "Traditional
# analysis methods, such as Def-Use analysis" are what legalize the
# transformations of §III).
#
# Before this module the read/write-set and accumulate-op logic lived in
# three places (core/transforms.py, backends/codegen.required_columns and
# ad-hoc checks inside individual passes) and the planner *assumed* every
# (K, schedule) candidate was legal.  Here the same questions are answered
# once, from program semantics:
#
#   reads/writes      stmt_reads / stmt_writes / expr_array_reads
#   commutation       independent() — fail-CLOSED on unknown Stmt subtypes
#   op algebra        ACCUM_OPS: commutativity/associativity per accumulate
#                     op, is_mergeable() for partial-aggregation legality
#   loop-carried deps parallelization_hazards() — why a loop's iterations
#                     cannot run in arbitrary order
#   partitionability  partitionable() — proof (or counterexample list) that
#                     data-partitioned execution with partial merges
#                     preserves the program's semantics
#   column footprint  required_fields() — the table→columns map an executor
#                     must materialize (backends/codegen.required_columns is
#                     a thin wrapper over it)
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.core.ir import (
    Accumulate,
    ArrayRead,
    BinOp,
    CombinePartials,
    Expr,
    FieldMatch,
    Filtered,
    ForValue,
    Forall,
    Forelem,
    Program,
    ResultAppend,
    ScalarAssign,
    Stmt,
    TupleExpr,
    children,
    tables_read,
    walk,
)

# Every Stmt subtype this module understands.  ``independent`` (and through
# it reordering/fusion) refuses to reason about anything else: an unknown
# statement kind has unknown effects, so the only safe answer is "not
# independent" (fail closed).
KNOWN_STMTS: Tuple[type, ...] = (
    Forelem,
    Forall,
    ForValue,
    Accumulate,
    ResultAppend,
    ScalarAssign,
    CombinePartials,
)


# ---------------------------------------------------------------------------
# Accumulate-op algebra
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OpAlgebra:
    """Algebraic properties of an accumulation operator ``acc = op(acc, v)``.

    ``commutative`` + ``associative`` together legalize splitting the input
    multiset into arbitrary parts, accumulating partials and merging them in
    any order — the partitioned executor's whole execution model.
    Associativity alone only legalizes *order-preserving* block merges."""

    commutative: bool
    associative: bool
    idempotent: bool


# ``'∪'`` is the synthetic op stmt-level analysis assigns to ResultAppend
# (multiset union).  ``'first'`` (keep the first value seen per key) is the
# canonical NON-commutative accumulate: associative — (a·b)·c = a·(b·c) = a
# — but a·b ≠ b·a, so partials merged out of order change the answer.  Only
# the reference interpreter executes it; its role here is to make merge
# legality a real, testable question rather than a vacuous one.
ACCUM_OPS: Dict[str, OpAlgebra] = {
    "+": OpAlgebra(commutative=True, associative=True, idempotent=False),
    "max": OpAlgebra(commutative=True, associative=True, idempotent=True),
    "min": OpAlgebra(commutative=True, associative=True, idempotent=True),
    "first": OpAlgebra(commutative=False, associative=True, idempotent=True),
    "∪": OpAlgebra(commutative=True, associative=True, idempotent=False),
}

# Ops an Accumulate statement may carry (ResultAppend's '∪' is implicit).
ACCUMULATE_STMT_OPS: Tuple[str, ...] = ("+", "max", "min", "first")
SCALAR_ASSIGN_OPS: Tuple[str, ...] = ("=", "+")


def op_algebra(op: str) -> Optional[OpAlgebra]:
    """Algebraic classification of an accumulate op (None if unknown)."""
    return ACCUM_OPS.get(op)


def is_mergeable(op: str) -> bool:
    """True when per-partition partial accumulations under ``op`` can be
    merged in any order (commutative AND associative)."""
    a = ACCUM_OPS.get(op)
    return a is not None and a.commutative and a.associative


def merge_illegal_ops(ops: Iterable[str]) -> List[str]:
    """The subset of ``ops`` whose partials can NOT be merged across data
    partitions — each one is a reason to reject a partitioned/parallel
    candidate.  Unknown ops are included (fail closed)."""
    return sorted({op for op in ops if not is_mergeable(op)})


def fusion_illegal_ops(ops: Iterable[str]) -> List[str]:
    """The subset of ``ops`` the fused multi-aggregate segreduce kernel may
    NOT evaluate: the kernel's per-tile/per-chunk partial accumulators are
    re-merged under the op itself, so fusion requires the same
    commutative+associative algebra as cross-partition merging.  (The
    lowering additionally restricts fusion to the accumulator updates the
    kernel implements — backends.codegen.FUSABLE_AGG_OPS; this is the
    algebraic gate the planner checks before emitting fused-kernel
    candidates.)  Unknown ops are included (fail closed)."""
    return merge_illegal_ops(ops)


def accumulate_ops(stmts: Sequence[Stmt]) -> Set[str]:
    """Every Accumulate op appearing anywhere under ``stmts``."""
    return {s.op for s in walk(stmts) if isinstance(s, Accumulate)}


# ---------------------------------------------------------------------------
# Read / write sets
# ---------------------------------------------------------------------------


def expr_array_reads(e: Expr) -> Set[str]:
    """Names of intermediate arrays read by expression ``e``."""
    out: Set[str] = set()
    _expr_array_reads_into(e, out)
    return out


def _expr_array_reads_into(e: Expr, out: Set[str]) -> None:
    if isinstance(e, ArrayRead):
        out.add(e.array)
        _expr_array_reads_into(e.key, out)
    elif isinstance(e, BinOp):
        _expr_array_reads_into(e.lhs, out)
        _expr_array_reads_into(e.rhs, out)
    elif isinstance(e, TupleExpr):
        for el in e.elements:
            _expr_array_reads_into(el, out)


def _self_and_descendants(s: Stmt) -> List[Stmt]:
    return [s, *walk(children(s))]


def stmt_reads(s: Stmt) -> Set[str]:
    """Names (arrays, scalars) read anywhere under ``s``.  Privatized
    accumulators are tracked under their partitioned name ``arr_partvar``."""
    reads: Set[str] = set()
    for st in _self_and_descendants(s):
        if isinstance(st, Accumulate):
            _expr_array_reads_into(st.key, reads)
            _expr_array_reads_into(st.value, reads)
        elif isinstance(st, ResultAppend):
            _expr_array_reads_into(st.tuple_expr, reads)
        elif isinstance(st, ScalarAssign):
            _expr_array_reads_into(st.expr, reads)
            if st.op != "=":
                reads.add(st.var)
        elif isinstance(st, CombinePartials):
            reads.add(f"{st.array}_{st.partvar}")
        elif isinstance(st, Forelem):
            ix = st.indexset
            if isinstance(ix, FieldMatch):
                _expr_array_reads_into(ix.value, reads)
            if isinstance(ix, Filtered):
                _expr_array_reads_into(ix.predicate, reads)
    return reads


def stmt_writes(s: Stmt) -> Set[str]:
    """Names (arrays, results, scalars) written anywhere under ``s``."""
    writes: Set[str] = set()
    for st in _self_and_descendants(s):
        if isinstance(st, Accumulate):
            writes.add(f"{st.array}_{st.partitioned}" if st.partitioned else st.array)
        elif isinstance(st, ResultAppend):
            writes.add(f"{st.result}_{st.partitioned}" if st.partitioned else st.result)
        elif isinstance(st, ScalarAssign):
            writes.add(st.var)
        elif isinstance(st, CombinePartials):
            writes.add(st.array)
    return writes


def accum_ops(s: Stmt, name: str) -> Optional[Set[str]]:
    """The set of ops used to write ``name`` under ``s``, or None when a
    non-accumulating write (ResultAppend-combine / ScalarAssign '=') makes
    the writes order-sensitive."""
    ops: Set[str] = set()
    for st in _self_and_descendants(s):
        if isinstance(st, Accumulate):
            nm = f"{st.array}_{st.partitioned}" if st.partitioned else st.array
            if nm == name:
                ops.add(st.op)
        elif isinstance(st, ResultAppend):
            nm = f"{st.result}_{st.partitioned}" if st.partitioned else st.result
            if nm == name:
                ops.add("∪")  # multiset union — commutative, still fusible
        elif isinstance(st, ScalarAssign) and st.var == name:
            if st.op == "=":
                return None
            ops.add(st.op)
        elif isinstance(st, CombinePartials) and st.array == name:
            return None
    return ops


def unknown_stmts(s: Stmt) -> List[Stmt]:
    """Statements under ``s`` (inclusive) whose type this module does not
    model.  Non-empty ⇒ effects are unknown ⇒ dependence answers must be
    conservative.  Exact-type matching on purpose: a *subclass* of a known
    statement may override semantics, so it is treated as unknown too."""
    return [st for st in _self_and_descendants(s) if type(st) not in KNOWN_STMTS]


def independent(a: Stmt, b: Stmt) -> bool:
    """True if ``a`` and ``b`` can be reordered (no RAW/WAR/WAW hazards).

    Accumulations into the same array with the same commutative+associative
    op commute — what legalizes the fusion in the paper's §III-A4 example.
    Fails CLOSED: any statement kind this module cannot model makes the
    pair non-independent."""
    if unknown_stmts(a) or unknown_stmts(b):
        return False
    ra, wa = stmt_reads(a), stmt_writes(a)
    rb, wb = stmt_reads(b), stmt_writes(b)
    if (wa & rb) or (wb & ra):
        return False
    for name in wa & wb:
        # write-write is OK only if both sides *accumulate* into the shared
        # name with one identical op whose algebra commutes
        ops_a = accum_ops(a, name)
        ops_b = accum_ops(b, name)
        if ops_a is None or ops_b is None or ops_a != ops_b or len(ops_a) != 1:
            return False
        if not is_mergeable(next(iter(ops_a))):
            return False
    return True


# ---------------------------------------------------------------------------
# Loop-carried dependences / partitionability
# ---------------------------------------------------------------------------


def _expr_reads_excluding_reduction(s: Stmt) -> Set[str]:
    """Reads under ``s`` excluding each ScalarAssign's implicit self-read
    (``s += e`` is a reduction, not a cross-iteration hazard)."""
    reads: Set[str] = set()
    for st in _self_and_descendants(s):
        if isinstance(st, Accumulate):
            _expr_array_reads_into(st.key, reads)
            _expr_array_reads_into(st.value, reads)
        elif isinstance(st, ResultAppend):
            _expr_array_reads_into(st.tuple_expr, reads)
        elif isinstance(st, ScalarAssign):
            _expr_array_reads_into(st.expr, reads)
        elif isinstance(st, CombinePartials):
            reads.add(f"{st.array}_{st.partvar}")
        elif isinstance(st, Forelem):
            ix = st.indexset
            if isinstance(ix, FieldMatch):
                _expr_array_reads_into(ix.value, reads)
            if isinstance(ix, Filtered):
                _expr_array_reads_into(ix.predicate, reads)
    return reads


def parallelization_hazards(body: Sequence[Stmt]) -> List[str]:
    """Why the iterations of a loop with this ``body`` can NOT run in
    arbitrary order.  An empty list is the loop-carried-dependence proof
    obligation for parallelizing / partitioning that loop: every write is a
    mergeable accumulation and nothing written is also read."""
    hazards: List[str] = []
    for s in body:
        for st in unknown_stmts(s):
            hazards.append(f"unknown statement kind {type(st).__name__} (effects unmodeled)")
    if hazards:
        return hazards
    written: Set[str] = set()
    reads: Set[str] = set()
    ops_by_name: Dict[str, Optional[Set[str]]] = {}
    for s in body:
        for name in stmt_writes(s):
            written.add(name)
            ops = accum_ops(s, name)
            prev = ops_by_name.get(name, set())
            ops_by_name[name] = None if (ops is None or prev is None) else (prev | ops)
        reads |= _expr_reads_excluding_reduction(s)
    for name in sorted(written & reads):
        hazards.append(f"'{name}' is read after being written in the same iteration space")
    for name in sorted(written):
        ops = ops_by_name.get(name)
        if ops is None:
            hazards.append(f"'{name}' has a non-accumulating (order-sensitive) write")
            continue
        if len(ops) > 1:
            hazards.append(f"'{name}' is accumulated with mixed ops {sorted(ops)}")
            continue
        for op in merge_illegal_ops(ops):
            hazards.append(
                f"'{name}' is accumulated with non-commutative op {op!r} "
                "(partials cannot be merged in arbitrary order)"
            )
    return hazards


def partitionable(program: Program) -> Tuple[bool, List[str]]:
    """Proof that data-partitioned execution (split rows into parts,
    accumulate partials, merge) preserves this program's semantics.

    Returns ``(ok, reasons)``; ``reasons`` lists every counterexample found
    — exactly the diagnostics the planner attaches to rejected (K, schedule)
    candidates."""
    reasons = merge_illegal_ops(accumulate_ops(program.body))
    out = [
        f"accumulate op {op!r} is not commutative+associative — "
        "per-partition partials cannot be merged" for op in reasons
    ]
    for s in program.body:
        if isinstance(s, Forelem):
            for h in parallelization_hazards(s.body):
                if "accumulated with non-commutative" in h:
                    continue  # already reported via merge_illegal_ops
                out.append(f"loop over {s.indexset.table!r}: {h}")
    return (not out, out)


# ---------------------------------------------------------------------------
# Column footprint (shared with backends/codegen.required_columns)
# ---------------------------------------------------------------------------


def required_fields(program: Program, spec: Any = None) -> Dict[str, Set[str]]:
    """table → columns an executor must materialize to run ``program``:
    every field any expression or index set reads, plus — when an extracted
    ``ProgramSpec`` (duck-typed: ``aggs``/``joins`` attributes) is given —
    the key/probe columns its op shapes consume."""
    needed: Dict[str, Set[str]] = {}
    for t, fs in tables_read(program.body).items():
        needed.setdefault(t, set()).update(fs)
    if spec is not None:
        for agg in spec.aggs:
            needed.setdefault(agg.table, set()).add(agg.key_field)
        for j in spec.joins:
            needed.setdefault(j.probe_table, set()).add(j.probe_fk)
            needed.setdefault(j.build_table, set()).add(j.build_key)
            for ja in j.aggs:
                needed.setdefault(ja.key.table, set()).add(ja.key.field)
                for t, f in ja.value.fields_used():
                    needed.setdefault(t, set()).add(f)
    return needed
