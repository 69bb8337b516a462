# IR verifier: every structural/scoping/typing invariant a well-formed
# forelem program must satisfy, checked in one pass so that a transform
# that corrupts the IR is caught at the pass boundary — not three passes
# later as a silently-wrong answer (the failure mode of the MIN/MAX and
# identity-padding bugs this repo previously shipped and hand-debugged).
#
# ``verify_program(p, pass_name=...)`` raises ``IRVerificationError`` naming
# the offending pass, statement and invariant.  ``core/passes.optimize``
# calls it after every pass when ``OptimizeOptions.verify_ir`` is on
# (default: the ``REPRO_VERIFY_IR`` environment variable, which tests and CI
# set to 1).
#
# Invariants (the names appear in error messages and are pinned by
# tests/test_analysis.py's corruption matrix):
#
#   duplicate-table          a table name declared twice
#   table-undeclared         index set / FieldRef over an undeclared table
#   field-missing            referenced field absent from the table schema
#   fieldref-scope           FieldRef loopvar unbound, or bound to a
#                            different table than the one it dereferences
#   var-unbound              Var not a param, binder or assigned scalar
#   array-undefined          ArrayRead of an array never written
#   read-before-combine      ArrayRead before the write (or the
#                            CombinePartials of a privatized accumulator)
#                            that defines it
#   partvar-unbound          partitioned write / Blocked / RangePart names
#                            no enclosing forall partvar
#   partition-mismatch       Blocked/RangePart n_parts differs from the
#                            binding forall's
#   combine-mismatch         CombinePartials with no matching privatized
#                            accumulate (array/partvar/op/n_parts)
#   nparts-invalid           Forall/Blocked/RangePart/CombinePartials with
#                            n_parts < 1
#   op-invalid               unknown Accumulate/ScalarAssign/BinOp operator
#   accumulate-op-conflict   one array accumulated with conflicting ops
#   predicate-not-bool       Filtered predicate of non-boolean type
#   type-mismatch            ill-typed BinOp / Accumulate operands (under
#                            the {any, num, bool, str} lattice; frontend
#                            schemas with dtype "any" check vacuously,
#                            Multiset.decl() schemas check for real)
#   result-unproduced        a declared result never written
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.ir import (
    Accumulate,
    ArrayRead,
    BinOp,
    Blocked,
    CombinePartials,
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
    ResultAppend,
    ScalarAssign,
    Stmt,
    TupleExpr,
    TupleSchema,
    Var,
    pretty,
    walk,
)

from .deps import ACCUMULATE_STMT_OPS, SCALAR_ASSIGN_OPS

# type lattice tags
ANY, NUM, BOOL, STR = "any", "num", "bool", "str"

_BINOP_OPS = ("+", "-", "*", "/", "==", "!=", "<", "<=", ">", ">=", "and", "or")
_COMPARISONS = ("==", "!=", "<", "<=", ">", ">=")
_ARITHMETIC = ("+", "-", "*", "/")


def verify_enabled(default: bool = False) -> bool:
    """Resolve the REPRO_VERIFY_IR environment toggle (tests/CI set it)."""
    v = os.environ.get("REPRO_VERIFY_IR")
    if v is None:
        return default
    return v.strip().lower() not in ("", "0", "false", "no", "off")


class IRVerificationError(Exception):
    """A pass left the IR ill-formed.  Carries enough context to act on:
    which pass produced the program, which statement is wrong, and which
    invariant it violates."""

    def __init__(
        self,
        invariant: str,
        message: str,
        *,
        pass_name: Optional[str] = None,
        stmt: Optional[Stmt] = None,
        program: Optional[Program] = None,
    ):
        self.invariant = invariant
        self.pass_name = pass_name
        self.stmt = stmt
        self.program = program
        where = f"after pass {pass_name!r}: " if pass_name else ""
        text = f"{where}invariant {invariant!r} violated: {message}"
        if stmt is not None:
            try:
                text += f"\n  at statement: {pretty([stmt]).strip()}"
            except Exception:
                text += f"\n  at statement: {stmt!r}"
        super().__init__(text)


def _dtype_tag(dt: str) -> str:
    """Map a schema dtype string onto the check lattice.  Frontend schemas
    say "any" (wildcard); ``Multiset.decl()`` schemas carry "key" (dict
    codes) or numpy dtype strings."""
    if dt == "any":
        return ANY
    if dt == "key":
        return NUM  # dictionary codes are integers
    if dt == "bool":
        return BOOL
    if dt.startswith(("int", "uint", "float", "complex")):
        return NUM
    if dt.startswith(("str", "object", "U", "<U", "S", "|S")):
        return STR
    return ANY  # unknown encodings stay unchecked rather than false-positive


class _Verifier:
    def __init__(self, program: Program, pass_name: Optional[str]):
        self.p = program
        self.pass_name = pass_name
        self.schemas: Dict[str, TupleSchema] = {}
        # arrays with an order-independent ("plain") definition available so
        # far in program order: unpartitioned Accumulate or CombinePartials
        self.available: Set[str] = set()
        # every write of each array anywhere (for array-undefined vs
        # read-before-combine discrimination)
        self.array_writes: Dict[str, List[Accumulate]] = {}
        self.combined: Set[str] = set()
        self.scalars: Set[str] = set()

    # -- error helper --------------------------------------------------------
    def fail(self, invariant: str, message: str, stmt: Optional[Stmt] = None) -> None:
        raise IRVerificationError(
            invariant, message, pass_name=self.pass_name, stmt=stmt, program=self.p
        )

    # -- entry ---------------------------------------------------------------
    def run(self) -> None:
        for decl in self.p.tables:
            if decl.name in self.schemas:
                self.fail("duplicate-table", f"table {decl.name!r} declared twice")
            self.schemas[decl.name] = decl.schema

        produced: Set[str] = set()
        for s in walk(self.p.body):
            if isinstance(s, Accumulate):
                self.array_writes.setdefault(s.array, []).append(s)
                produced.add(s.array)
            elif isinstance(s, CombinePartials):
                self.combined.add(s.array)
                produced.add(s.array)
            elif isinstance(s, ScalarAssign):
                self.scalars.add(s.var)
                produced.add(s.var)
            elif isinstance(s, ResultAppend):
                produced.add(s.result)
        for r in self.p.results:
            if r not in produced:
                self.fail("result-unproduced", f"declared result {r!r} is never produced")

        self._check_op_conflicts()
        env: Dict[str, Tuple[str, object]] = {name: ("param", None) for name in self.p.params}
        self._stmts(self.p.body, env)

    def _check_op_conflicts(self) -> None:
        ops_by_name: Dict[Tuple[str, Optional[str]], Set[str]] = {}
        for s in walk(self.p.body):
            if isinstance(s, Accumulate):
                ops_by_name.setdefault((s.array, s.partitioned), set()).add(s.op)
        for (array, part), ops in ops_by_name.items():
            if len(ops) > 1:
                nm = f"{array}_{part}" if part else array
                self.fail(
                    "accumulate-op-conflict",
                    f"array {nm!r} is accumulated with conflicting ops {sorted(ops)}",
                )

    # -- schema lookups ------------------------------------------------------
    def _schema(self, table: str, stmt: Optional[Stmt]) -> TupleSchema:
        sch = self.schemas.get(table)
        if sch is None:
            self.fail("table-undeclared", f"table {table!r} is not declared", stmt)
        return sch

    def _field_tag(self, table: str, fld: str, stmt: Optional[Stmt]) -> str:
        sch = self._schema(table, stmt)
        if not sch.has(fld):
            self.fail(
                "field-missing",
                f"table {table!r} has no field {fld!r} (schema: {list(sch.names())})",
                stmt,
            )
        return _dtype_tag(sch.dtype_of(fld))

    # -- statements ----------------------------------------------------------
    def _stmts(self, stmts: Sequence[Stmt], env: Dict[str, Tuple[str, object]]) -> None:
        for s in stmts:
            self._stmt(s, env)

    def _stmt(self, s: Stmt, env: Dict[str, Tuple[str, object]]) -> None:
        if isinstance(s, Forelem):
            self._indexset(s.indexset, env, s)
            table = s.indexset.table
            self._stmts(s.body, {**env, s.loopvar: ("loop", table)})
        elif isinstance(s, Forall):
            if s.n_parts < 1:
                self.fail("nparts-invalid", f"forall n_parts={s.n_parts} (must be >= 1)", s)
            self._stmts(s.body, {**env, s.partvar: ("part", s.n_parts)})
        elif isinstance(s, ForValue):
            rp = s.range_part
            if rp.n_parts < 1:
                self.fail("nparts-invalid", f"range partition n_parts={rp.n_parts}", s)
            self._partvar(rp.part_var, rp.n_parts, env, s, "range partition")
            tag = self._field_tag(rp.base.table, rp.base.field, s)
            self._stmts(s.body, {**env, s.valvar: ("val", tag)})
        elif isinstance(s, Accumulate):
            if s.op not in ACCUMULATE_STMT_OPS:
                self.fail(
                    "op-invalid",
                    f"accumulate op {s.op!r} (known: {list(ACCUMULATE_STMT_OPS)})",
                    s,
                )
            if s.partitioned is not None:
                self._partvar(s.partitioned, None, env, s, "privatized accumulate")
            self._expr(s.key, env, None, s)
            vtag = self._expr(s.value, env, None, s)
            if s.op in ("+", "max", "min") and vtag == STR:
                self.fail("type-mismatch", f"accumulate op {s.op!r} over a string value", s)
            # the write becomes an order-independent definition only when
            # it is not privatized (privatized partials need a combine)
            if s.partitioned is None:
                self.available.add(s.array)
        elif isinstance(s, ResultAppend):
            if s.partitioned is not None:
                self._partvar(s.partitioned, None, env, s, "partitioned result append")
            self._expr(s.tuple_expr, env, None, s)
        elif isinstance(s, ScalarAssign):
            if s.op not in SCALAR_ASSIGN_OPS:
                self.fail(
                    "op-invalid",
                    f"scalar op {s.op!r} (known: {list(SCALAR_ASSIGN_OPS)})",
                    s,
                )
            self._expr(s.expr, env, None, s)
        elif isinstance(s, CombinePartials):
            if s.n_parts < 1:
                self.fail("nparts-invalid", f"combine n_parts={s.n_parts}", s)
            defs = [
                a
                for a in self.array_writes.get(s.array, [])
                if a.partitioned == s.partvar
            ]
            if not defs:
                self.fail(
                    "combine-mismatch",
                    f"no privatized accumulate {s.array}_{s.partvar} to combine",
                    s,
                )
            if any(a.op != s.op for a in defs):
                self.fail(
                    "combine-mismatch",
                    f"combine op {s.op!r} differs from the accumulate op of "
                    f"{s.array}_{s.partvar}",
                    s,
                )
            foralls = [
                f
                for f in walk(self.p.body)
                if isinstance(f, Forall) and f.partvar == s.partvar
            ]
            if not any(f.n_parts == s.n_parts for f in foralls):
                self.fail(
                    "combine-mismatch",
                    f"combine over {s.n_parts} parts but forall({s.partvar}) has "
                    f"n_parts={[f.n_parts for f in foralls] or 'none'}",
                    s,
                )
            self.available.add(s.array)
        else:
            self.fail("op-invalid", f"unknown statement kind {type(s).__name__}", s)

    def _partvar(
        self,
        name: str,
        n_parts: Optional[int],
        env: Dict[str, Tuple[str, object]],
        stmt: Stmt,
        what: str,
    ) -> None:
        binding = env.get(name)
        if binding is None or binding[0] != "part":
            self.fail(
                "partvar-unbound",
                f"{what} names partition variable {name!r}, which no enclosing forall binds",
                stmt,
            )
        if n_parts is not None and binding[1] != n_parts:
            self.fail(
                "partition-mismatch",
                f"{what} splits {n_parts} ways but forall({name}) has n_parts={binding[1]}",
                stmt,
            )

    # -- index sets ----------------------------------------------------------
    def _indexset(self, ix: IndexSet, env: Dict[str, Tuple[str, object]], stmt: Stmt) -> None:
        if isinstance(ix, FullSet):
            self._schema(ix.table, stmt)
        elif isinstance(ix, FieldMatch):
            self._field_tag(ix.table, ix.field, stmt)
            self._expr(ix.value, env, None, stmt)
        elif isinstance(ix, Distinct):
            self._field_tag(ix.table, ix.field, stmt)
        elif isinstance(ix, Filtered):
            self._indexset(ix.base, env, stmt)
            if ix.base.table != ix.table:
                self.fail(
                    "fieldref-scope",
                    f"filtered set over {ix.table!r} stacked on a base over {ix.base.table!r}",
                    stmt,
                )
            ptag = self._expr(ix.predicate, env, ix.table, stmt)
            if ptag not in (BOOL, ANY):
                self.fail(
                    "predicate-not-bool",
                    f"filter predicate has type {ptag!r}, expected a boolean",
                    stmt,
                )
        elif isinstance(ix, Blocked):
            if ix.n_parts < 1:
                self.fail("nparts-invalid", f"blocked n_parts={ix.n_parts}", stmt)
            self._partvar(ix.part_var, ix.n_parts, env, stmt, "blocked index set")
            self._indexset(ix.base, env, stmt)
        else:
            self.fail("op-invalid", f"unknown index set kind {type(ix).__name__}", stmt)

    # -- expressions ---------------------------------------------------------
    def _expr(
        self,
        e: Expr,
        env: Dict[str, Tuple[str, object]],
        placeholder_table: Optional[str],
        stmt: Stmt,
    ) -> str:
        """Scope-check and type-infer an expression; returns a lattice tag.
        ``placeholder_table`` is the table a loopvar of ``'_'`` dereferences
        (set inside Filtered predicates only)."""
        if isinstance(e, Const):
            if isinstance(e.value, bool):
                return BOOL
            if isinstance(e.value, str):
                return STR
            if isinstance(e.value, (int, float)):
                return NUM
            return ANY
        if isinstance(e, Var):
            binding = env.get(e.name)
            if binding is None:
                if e.name in self.scalars:
                    return ANY
                self.fail(
                    "var-unbound",
                    f"variable {e.name!r} is not a parameter, binder or assigned scalar",
                    stmt,
                )
            kind, info = binding
            if kind == "val":
                return str(info)
            if kind in ("loop", "part"):
                return NUM  # row / partition indices
            return ANY
        if isinstance(e, FieldRef):
            if e.loopvar == "_":
                if placeholder_table is None:
                    self.fail(
                        "fieldref-scope",
                        "placeholder loopvar '_' used outside a filter predicate "
                        f"({e.table}[_].{e.field})",
                        stmt,
                    )
                if e.table != placeholder_table:
                    self.fail(
                        "fieldref-scope",
                        f"filter predicate over {placeholder_table!r} dereferences "
                        f"{e.table}[_].{e.field}",
                        stmt,
                    )
                return self._field_tag(e.table, e.field, stmt)
            binding = env.get(e.loopvar)
            if binding is None or binding[0] != "loop":
                self.fail(
                    "fieldref-scope",
                    f"loop variable {e.loopvar!r} of {e.table}[{e.loopvar}].{e.field} "
                    "is not bound by any enclosing forelem",
                    stmt,
                )
            if binding[1] != e.table:
                self.fail(
                    "fieldref-scope",
                    f"loop variable {e.loopvar!r} iterates {binding[1]!r} but is used to "
                    f"dereference {e.table!r}",
                    stmt,
                )
            return self._field_tag(e.table, e.field, stmt)
        if isinstance(e, ArrayRead):
            self._expr(e.key, env, placeholder_table, stmt)
            if e.array not in self.available:
                if e.array not in self.array_writes and e.array not in self.combined:
                    self.fail(
                        "array-undefined",
                        f"read of array {e.array!r}, which nothing in the program writes",
                        stmt,
                    )
                self.fail(
                    "read-before-combine",
                    f"read of array {e.array!r} before an order-independent definition "
                    "(privatized partials need a CombinePartials before first use)",
                    stmt,
                )
            return ANY
        if isinstance(e, BinOp):
            if e.op not in _BINOP_OPS:
                self.fail("op-invalid", f"unknown binary operator {e.op!r}", stmt)
            lt = self._expr(e.lhs, env, placeholder_table, stmt)
            rt = self._expr(e.rhs, env, placeholder_table, stmt)
            return self._binop_tag(e.op, lt, rt, stmt)
        if isinstance(e, TupleExpr):
            for el in e.elements:
                self._expr(el, env, placeholder_table, stmt)
            return ANY
        self.fail("op-invalid", f"unknown expression kind {type(e).__name__}", stmt)
        return ANY  # unreachable

    def _binop_tag(self, op: str, lt: str, rt: str, stmt: Stmt) -> str:
        operands = (lt, rt)
        if op in ("and", "or"):
            for t in operands:
                if t not in (BOOL, ANY):
                    self.fail(
                        "type-mismatch", f"{op!r} over a non-boolean operand ({t})", stmt
                    )
            return BOOL
        if op in _COMPARISONS:
            if STR in operands and (NUM in operands or BOOL in operands):
                self.fail(
                    "type-mismatch",
                    f"comparison {op!r} between a string and a number",
                    stmt,
                )
            return BOOL
        if op in _ARITHMETIC:
            if STR in operands:
                self.fail("type-mismatch", f"arithmetic {op!r} over a string operand", stmt)
            return NUM
        return ANY  # unreachable — op validated by caller


def verify_program(program: Program, *, pass_name: Optional[str] = None) -> Program:
    """Check every invariant; raises ``IRVerificationError`` on the first
    violation, naming ``pass_name`` as the producer of the bad program.
    Returns the program unchanged so call sites can chain it."""
    _Verifier(program, pass_name).run()
    return program
