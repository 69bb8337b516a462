# The forelem single intermediate representation (paper §II).
#
# Data is modeled as multisets of tuples; loops iterate (sub)sets of those
# multisets selected by *index sets*.  All frontends (SQL, MapReduce, the LM
# data pipeline) produce this AST; all optimization (loop transforms, query
# optimization, partitioning, distribution) happens on this AST; the
# backends (backends/torch_vec.py) turn it into executable PyTorch.
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Schemas / multisets
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TupleSchema:
    """Schema of the tuples stored in a multiset: ordered (name, dtype)."""

    fields: Tuple[Tuple[str, str], ...]  # (name, dtype-str) e.g. ("url", "key")

    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.fields)

    def dtype_of(self, name: str) -> str:
        for n, d in self.fields:
            if n == name:
                return d
        raise KeyError(f"no field {name!r} in schema {self.names()}")

    def has(self, name: str) -> bool:
        return any(n == name for n, _ in self.fields)


@dataclass(frozen=True)
class MultisetDecl:
    """Declaration of a multiset (a 'table') in the program."""

    name: str
    schema: TupleSchema


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


class Expr:
    def fields_used(self) -> List[Tuple[str, str]]:
        """(table, field) pairs read by this expression."""
        out: List[Tuple[str, str]] = []
        _collect_fields(self, out)
        return out


@dataclass(frozen=True)
class Const(Expr):
    value: Any


@dataclass(frozen=True)
class Var(Expr):
    """A scalar variable (loop value variable or program parameter)."""

    name: str


@dataclass(frozen=True)
class FieldRef(Expr):
    """``Table[i].field`` — field access through a loop variable."""

    table: str
    loopvar: str
    field: str


@dataclass(frozen=True)
class BinOp(Expr):
    op: str  # '+', '-', '*', '/', '==', '!=', '<', '<=', '>', '>=', 'and', 'or'
    lhs: Expr
    rhs: Expr


@dataclass(frozen=True)
class ArrayRead(Expr):
    """``arr[key]`` — read of an intermediate (associative) array."""

    array: str
    key: Expr


@dataclass(frozen=True)
class TupleExpr(Expr):
    elements: Tuple[Expr, ...]


def _collect_fields(e: Expr, out: List[Tuple[str, str]]) -> None:
    if isinstance(e, FieldRef):
        out.append((e.table, e.field))
    elif isinstance(e, BinOp):
        _collect_fields(e.lhs, out)
        _collect_fields(e.rhs, out)
    elif isinstance(e, TupleExpr):
        for el in e.elements:
            _collect_fields(el, out)
    elif isinstance(e, ArrayRead):
        _collect_fields(e.key, out)


# ---------------------------------------------------------------------------
# Index sets (paper §II: "index sets ... encapsulate how exactly the
# iteration is carried out")
# ---------------------------------------------------------------------------


class IndexSet:
    table: str


@dataclass(frozen=True)
class FullSet(IndexSet):
    """``pA`` — every tuple of the multiset."""

    table: str


@dataclass(frozen=True)
class FieldMatch(IndexSet):
    """``pA.field[v]`` — tuples whose ``field`` equals the value of ``v``."""

    table: str
    field: str
    value: Expr


@dataclass(frozen=True)
class Distinct(IndexSet):
    """``pA.distinct(field)`` — one representative tuple per distinct value."""

    table: str
    field: str


@dataclass(frozen=True)
class Filtered(IndexSet):
    """``pA | predicate`` — general selection (WHERE clauses)."""

    table: str
    predicate: Expr  # over FieldRef(table, loopvar='_', field)
    base: IndexSet = None  # optional stacked base

    def __post_init__(self):
        if self.base is None:
            object.__setattr__(self, "base", FullSet(self.table))


@dataclass(frozen=True)
class Blocked(IndexSet):
    """``p_k A`` — block ``k`` of ``n_parts`` of the base index set
    (direct data partitioning, paper §III-A1)."""

    base: IndexSet
    n_parts: int
    part_var: str  # name of the forall loop variable selecting the block

    @property
    def table(self) -> str:  # type: ignore[override]
        return self.base.table


# Value-range sets (for *indirect* partitioning): X = A.field


@dataclass(frozen=True)
class ValueRange:
    """``X = A.field`` — the multiset of values of ``field`` in A."""

    table: str
    field: str


@dataclass(frozen=True)
class RangePart:
    """``X_k`` — partition ``k`` of ``n_parts`` of a ValueRange."""

    base: ValueRange
    n_parts: int
    part_var: str


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------


class Stmt:
    pass


@dataclass(frozen=True)
class Forelem(Stmt):
    """``forelem (i; i ∈ indexset) body``"""

    loopvar: str
    indexset: IndexSet
    body: Tuple[Stmt, ...]


@dataclass(frozen=True)
class Forall(Stmt):
    """Parallel loop over partitions ``k = 1..N`` (paper §III-A1)."""

    partvar: str
    n_parts: int
    body: Tuple[Stmt, ...]
    # Which mesh axis this forall maps to after distribution (filled by
    # core.partition / core.distribution; None = not yet assigned).
    mesh_axis: Optional[str] = None


@dataclass(frozen=True)
class ForValue(Stmt):
    """``for (l ∈ X_k)`` — iterate the values of a range partition."""

    valvar: str
    range_part: RangePart
    body: Tuple[Stmt, ...]


@dataclass(frozen=True)
class Accumulate(Stmt):
    """``arr[key] op= value`` — associative-array accumulation.

    op ∈ {'+', 'max', 'min'};  ``count[x]++`` is op='+' with value Const(1).
    The per-partition variants (count_k) are expressed by ``partitioned``
    naming the forall partvar (paper §III-A4 example).
    """

    array: str
    key: Expr
    value: Expr
    op: str = "+"
    partitioned: Optional[str] = None  # partvar if this is arr_k


@dataclass(frozen=True)
class ResultAppend(Stmt):
    """``R = R ∪ (tuple)`` — append a tuple to a result multiset."""

    result: str
    tuple_expr: TupleExpr
    partitioned: Optional[str] = None


@dataclass(frozen=True)
class ScalarAssign(Stmt):
    """``s op= expr`` for scalar program variables (e.g. the avg example)."""

    var: str
    expr: Expr
    op: str = "+"  # '=' or '+'


@dataclass(frozen=True)
class CombinePartials(Stmt):
    """``arr[key] = Σ_k arr_k[key]`` — combine per-partition accumulators
    (the reduction step of the paper's parallelized URL-count)."""

    array: str
    partvar: str
    n_parts: int
    op: str = "+"


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Program:
    """A forelem program: multiset declarations + a statement list.

    ``results`` names the output multisets / scalars of the program.
    ``congruences`` records verified value-multiset congruences
    (frozenset({(table, field), (table, field)})) discovered by the
    distribution optimizer — the lowering may treat congruent value ranges
    as interchangeable partitionings.
    """

    tables: Tuple[MultisetDecl, ...]
    body: Tuple[Stmt, ...]
    results: Tuple[str, ...]
    params: Tuple[str, ...] = ()  # free scalar Vars (query parameters)
    name: str = "program"
    congruences: Tuple[Any, ...] = ()
    # Result post-ops (SQL ORDER BY / LIMIT — top-k queries): each order key
    # is (tuple position, descending); applied to every multiset result
    # after execution by both the reference interpreter and Plan.run.
    order_by: Tuple[Tuple[int, bool], ...] = ()
    limit: Optional[int] = None

    # -- convenience -------------------------------------------------------
    def table(self, name: str) -> MultisetDecl:
        for t in self.tables:
            if t.name == name:
                return t
        raise KeyError(f"no table {name!r}")

    def with_body(self, body: Sequence[Stmt]) -> "Program":
        return replace(self, body=tuple(body))


# ---------------------------------------------------------------------------
# Traversal / analysis helpers (Def-Use analysis, paper §II)
# ---------------------------------------------------------------------------


def children(stmt: Stmt) -> Tuple[Stmt, ...]:
    if isinstance(stmt, (Forelem, Forall, ForValue)):
        return stmt.body
    return ()


def with_children(stmt: Stmt, body: Sequence[Stmt]) -> Stmt:
    if isinstance(stmt, (Forelem, Forall, ForValue)):
        return dataclasses.replace(stmt, body=tuple(body))
    if body:
        raise ValueError(f"{type(stmt).__name__} takes no children")
    return stmt


def walk(stmts: Sequence[Stmt]):
    """Pre-order walk over a statement list."""
    for s in stmts:
        yield s
        yield from walk(children(s))


def arrays_defined(stmts: Sequence[Stmt]) -> Dict[str, List[Accumulate]]:
    out: Dict[str, List[Accumulate]] = {}
    for s in walk(stmts):
        if isinstance(s, Accumulate):
            out.setdefault(s.array, []).append(s)
    return out


def arrays_used(stmts: Sequence[Stmt]) -> Dict[str, int]:
    """Reads of intermediate arrays (ArrayRead) anywhere in expressions."""
    out: Dict[str, int] = {}

    def visit_expr(e: Expr) -> None:
        if isinstance(e, ArrayRead):
            out[e.array] = out.get(e.array, 0) + 1
            visit_expr(e.key)
        elif isinstance(e, BinOp):
            visit_expr(e.lhs)
            visit_expr(e.rhs)
        elif isinstance(e, TupleExpr):
            for el in e.elements:
                visit_expr(el)

    for s in walk(stmts):
        for e in _stmt_exprs(s):
            visit_expr(e)
    return out


def _stmt_exprs(s: Stmt) -> List[Expr]:
    if isinstance(s, Accumulate):
        return [s.key, s.value]
    if isinstance(s, ResultAppend):
        return [s.tuple_expr]
    if isinstance(s, ScalarAssign):
        return [s.expr]
    if isinstance(s, Forelem):
        out: List[Expr] = []
        ix = s.indexset
        if isinstance(ix, FieldMatch):
            out.append(ix.value)
        if isinstance(ix, Filtered):
            out.append(ix.predicate)
        return out
    return []


def tables_read(stmts: Sequence[Stmt]) -> Dict[str, set]:
    """table -> set of fields read anywhere (for dead-field pruning)."""
    out: Dict[str, set] = {}

    def note(table: str, fld: str) -> None:
        out.setdefault(table, set()).add(fld)

    def visit_expr(e: Expr) -> None:
        if isinstance(e, FieldRef):
            note(e.table, e.field)
        elif isinstance(e, BinOp):
            visit_expr(e.lhs)
            visit_expr(e.rhs)
        elif isinstance(e, TupleExpr):
            for el in e.elements:
                visit_expr(el)
        elif isinstance(e, ArrayRead):
            visit_expr(e.key)

    for s in walk(stmts):
        if isinstance(s, Forelem):
            ix = s.indexset
            base = ix
            while isinstance(base, Blocked):
                base = base.base
            if isinstance(base, FieldMatch):
                note(base.table, base.field)
                visit_expr(base.value)
            elif isinstance(base, Distinct):
                note(base.table, base.field)
            elif isinstance(base, Filtered):
                visit_expr(base.predicate)
                inner = base.base
                while isinstance(inner, Blocked):
                    inner = inner.base
                if isinstance(inner, Distinct):
                    note(inner.table, inner.field)
                elif isinstance(inner, FieldMatch):
                    note(inner.table, inner.field)
                    visit_expr(inner.value)
        if isinstance(s, ForValue):
            rp = s.range_part
            note(rp.base.table, rp.base.field)
        for e in _stmt_exprs(s):
            visit_expr(e)
    return out


def substitute_var(e: Expr, name: str, repl: Expr) -> Expr:
    """Substitute Var(name) -> repl inside expression e."""
    if isinstance(e, Var) and e.name == name:
        return repl
    if isinstance(e, BinOp):
        return BinOp(e.op, substitute_var(e.lhs, name, repl), substitute_var(e.rhs, name, repl))
    if isinstance(e, TupleExpr):
        return TupleExpr(tuple(substitute_var(el, name, repl) for el in e.elements))
    if isinstance(e, ArrayRead):
        return ArrayRead(e.array, substitute_var(e.key, name, repl))
    return e


# ---------------------------------------------------------------------------
# Pretty printer (used by tests, docs and the repr of Program)
# ---------------------------------------------------------------------------


def _expr_str(e: Expr) -> str:
    if isinstance(e, Const):
        return repr(e.value)
    if isinstance(e, Var):
        return e.name
    if isinstance(e, FieldRef):
        return f"{e.table}[{e.loopvar}].{e.field}"
    if isinstance(e, BinOp):
        return f"({_expr_str(e.lhs)} {e.op} {_expr_str(e.rhs)})"
    if isinstance(e, ArrayRead):
        return f"{e.array}[{_expr_str(e.key)}]"
    if isinstance(e, TupleExpr):
        return "(" + ", ".join(_expr_str(el) for el in e.elements) + ")"
    return repr(e)


def _ixset_str(ix: IndexSet) -> str:
    if isinstance(ix, FullSet):
        return f"p{ix.table}"
    if isinstance(ix, FieldMatch):
        return f"p{ix.table}.{ix.field}[{_expr_str(ix.value)}]"
    if isinstance(ix, Distinct):
        return f"p{ix.table}.distinct({ix.field})"
    if isinstance(ix, Filtered):
        return f"p{ix.table}|{_expr_str(ix.predicate)}"
    if isinstance(ix, Blocked):
        return f"p_{ix.part_var}({_ixset_str(ix.base)}; N={ix.n_parts})"
    return repr(ix)


def pretty(stmts: Sequence[Stmt], indent: int = 0) -> str:
    pad = "  " * indent
    out: List[str] = []
    for s in stmts:
        if isinstance(s, Forelem):
            out.append(f"{pad}forelem ({s.loopvar}; {s.loopvar} ∈ {_ixset_str(s.indexset)})")
            out.append(pretty(s.body, indent + 1))
        elif isinstance(s, Forall):
            ax = f" @{s.mesh_axis}" if s.mesh_axis else ""
            out.append(f"{pad}forall ({s.partvar} = 1; {s.partvar} <= {s.n_parts}; {s.partvar}++){ax}")
            out.append(pretty(s.body, indent + 1))
        elif isinstance(s, ForValue):
            rp = s.range_part
            out.append(
                f"{pad}for ({s.valvar} ∈ X_{rp.part_var})  # X = {rp.base.table}.{rp.base.field}, N={rp.n_parts}"
            )
            out.append(pretty(s.body, indent + 1))
        elif isinstance(s, Accumulate):
            arr = f"{s.array}_{s.partitioned}" if s.partitioned else s.array
            op = "++" if (isinstance(s.value, Const) and s.value.value == 1 and s.op == "+") else f" {s.op}= {_expr_str(s.value)}"
            out.append(f"{pad}{arr}[{_expr_str(s.key)}]{op}")
        elif isinstance(s, ResultAppend):
            res = f"{s.result}_{s.partitioned}" if s.partitioned else s.result
            out.append(f"{pad}{res} = {res} ∪ {_expr_str(s.tuple_expr)}")
        elif isinstance(s, ScalarAssign):
            out.append(f"{pad}{s.var} {s.op}= {_expr_str(s.expr)}")
        elif isinstance(s, CombinePartials):
            out.append(f"{pad}{s.array}[*] = combine_{s.op}(k=1..{s.n_parts}, {s.array}_{s.partvar}[*])")
        else:
            out.append(f"{pad}{s!r}")
    return "\n".join(x for x in out if x)


def apply_order_limit(p: Program, results: Dict[str, Any]) -> Dict[str, Any]:
    """Apply the program's ORDER BY / LIMIT post-ops to its multiset
    results (lists of tuples); scalar results pass through unchanged."""
    if not p.order_by and p.limit is None:
        return results
    out = dict(results)
    for name in p.results:
        v = out.get(name)
        if not isinstance(v, list):
            continue
        for pos, desc in reversed(p.order_by):
            v = sorted(v, key=lambda row: row[pos], reverse=desc)
        if p.limit is not None:
            v = v[: p.limit]
        out[name] = v
    return out


def program_str(p: Program) -> str:
    hdr = [f"program {p.name}  results={list(p.results)}"]
    if p.order_by or p.limit is not None:
        ob = ", ".join(f"#{i} {'desc' if d else 'asc'}" for i, d in p.order_by)
        hdr[0] += f"  order_by=[{ob}] limit={p.limit}"
    for t in p.tables:
        hdr.append(f"  multiset {t.name}({', '.join(f'{n}:{d}' for n, d in t.schema.fields)})")
    return "\n".join(hdr) + "\n" + pretty(p.body, 1)
