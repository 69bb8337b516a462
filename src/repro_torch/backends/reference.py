# Reference executor backend — a direct (slow, Python) denotational
# semantics of the IR.  It is the oracle for every transform/lowering test
# and the fallback executor for program shapes the vectorized backends
# reject (e.g. string columns before data reformatting).
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

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
    Var,
    apply_order_limit,
)
from repro_torch.data.multiset import Database

from .codegen import _binop, _pyval
from .interface import register_backend


class ReferenceInterpreter:
    """Direct execution of the IR semantics.  O(rows × values) Python — used
    on small data by the tests as ground truth."""

    def __init__(self, db: Database, params: Optional[Dict[str, Any]] = None):
        self.db = db
        self.params = dict(params or {})

    # -- public --------------------------------------------------------------
    def run(self, program: Program) -> Dict[str, Any]:
        self.scalars: Dict[str, Any] = {}
        self.arrays: Dict[str, Dict[Any, Any]] = {}
        self.results: Dict[str, List[Tuple]] = {}
        self.value_rows: Dict[Tuple[str, str], Dict[Any, List[int]]] = {}
        env: Dict[str, Any] = dict(self.params)
        for s in program.body:
            self._exec(s, env)
        out: Dict[str, Any] = {}
        for r in program.results:
            if r in self.results:
                out[r] = self.results[r]
            elif r in self.scalars:
                out[r] = self.scalars[r]
            elif r in self.arrays:
                out[r] = dict(self.arrays[r])
            else:
                out[r] = []
        return apply_order_limit(program, out)

    # -- expression evaluation ------------------------------------------------
    def _eval(self, e: Expr, env: Dict[str, Any]) -> Any:
        if isinstance(e, Const):
            return e.value
        if isinstance(e, Var):
            if e.name in env:
                return env[e.name]
            if e.name in self.scalars:
                return self.scalars[e.name]
            raise KeyError(f"unbound Var {e.name!r}")
        if isinstance(e, FieldRef):
            row = env[e.loopvar]
            return _pyval(self.db[e.table].field(e.field)[row])
        if isinstance(e, ArrayRead):
            key = self._eval(e.key, env)
            return self.arrays.get(e.array, {}).get(key, 0)
        if isinstance(e, BinOp):
            l, r = self._eval(e.lhs, env), self._eval(e.rhs, env)
            return _binop(e.op, l, r)
        if isinstance(e, TupleExpr):
            return tuple(self._eval(el, env) for el in e.elements)
        raise TypeError(f"cannot eval {e!r}")

    # -- index-set iteration ----------------------------------------------------
    def _rows(self, ix: IndexSet, env: Dict[str, Any]) -> List[int]:
        if isinstance(ix, FullSet):
            return list(range(len(self.db[ix.table])))
        if isinstance(ix, FieldMatch):
            v = self._eval(ix.value, env)
            return list(self._rows_by_value(ix.table, ix.field).get(v, ()))
        if isinstance(ix, Distinct):
            col = self.db[ix.table].field(ix.field)
            vals = np.asarray(col)
            _, first = np.unique(vals, return_index=True)
            return sorted(int(i) for i in first)
        if isinstance(ix, Filtered):
            base_rows = self._rows(ix.base, env)
            out = []
            for i in base_rows:
                env2 = dict(env)
                env2["_"] = i
                if self._eval(ix.predicate, env2):
                    out.append(i)
            return out
        if isinstance(ix, Blocked):
            base_rows = self._rows(ix.base, env)
            k = env[ix.part_var]
            return [list(x) for x in np.array_split(base_rows, ix.n_parts)][k]
        raise TypeError(f"cannot iterate {ix!r}")

    def _rows_by_value(self, table: str, field: str) -> Dict[Any, List[int]]:
        """{value: the rows holding it, in order} of one column, built once
        a run: a FieldMatch looks its value up here instead of scanning the
        column (dict lookup matches as ``==`` does, NaN matching nothing)."""
        index = self.value_rows.get((table, field))
        if index is None:
            index = {}
            # tolist() gives the Python scalars _pyval gives
            for i, x in enumerate(np.asarray(self.db[table].field(field)).tolist()):
                index.setdefault(x, []).append(i)
            self.value_rows[(table, field)] = index
        return index

    # -- statements ----------------------------------------------------------
    def _exec(self, s: Stmt, env: Dict[str, Any]) -> None:
        if isinstance(s, Forelem):
            for i in self._rows(s.indexset, env):
                env2 = dict(env)
                env2[s.loopvar] = int(i)
                for st in s.body:
                    self._exec(st, env2)
        elif isinstance(s, Forall):
            for k in range(s.n_parts):
                env2 = dict(env)
                env2[s.partvar] = k
                for st in s.body:
                    self._exec(st, env2)
        elif isinstance(s, ForValue):
            rp = s.range_part
            col = np.asarray(self.db[rp.base.table].field(rp.base.field))
            values = np.unique(col)
            part = np.array_split(values, rp.n_parts)[env[rp.part_var]]
            for v in part:
                env2 = dict(env)
                env2[s.valvar] = _pyval(v)
                for st in s.body:
                    self._exec(st, env2)
        elif isinstance(s, Accumulate):
            name = s.array if s.partitioned is None else f"{s.array}@{env[s.partitioned]}"
            key = self._eval(s.key, env)
            val = self._eval(s.value, env)
            d = self.arrays.setdefault(name, {})
            if s.op == "+":
                d[key] = d.get(key, 0) + val
            elif s.op == "max":
                d[key] = max(d.get(key, -np.inf), val)
            elif s.op == "min":
                d[key] = min(d.get(key, np.inf), val)
            elif s.op == "first":
                # keep-first: associative but order-sensitive (not commutative),
                # so only the sequential oracle may execute it
                d.setdefault(key, val)
            else:
                raise ValueError(f"bad accumulate op {s.op}")
        elif isinstance(s, CombinePartials):
            combined: Dict[Any, Any] = {}
            for k in range(s.n_parts):
                for key, val in self.arrays.get(f"{s.array}@{k}", {}).items():
                    if s.op == "+":
                        combined[key] = combined.get(key, 0) + val
                    elif s.op == "max":
                        combined[key] = max(combined.get(key, -np.inf), val)
                    elif s.op == "min":
                        combined[key] = min(combined.get(key, np.inf), val)
                    elif s.op == "first":
                        combined.setdefault(key, val)
            self.arrays[s.array] = combined
        elif isinstance(s, ResultAppend):
            t = self._eval(s.tuple_expr, env)
            self.results.setdefault(s.result, []).append(t)
        elif isinstance(s, ScalarAssign):
            v = self._eval(s.expr, env)
            if s.op == "=":
                self.scalars[s.var] = v
            elif s.op == "+":
                self.scalars[s.var] = self.scalars.get(s.var, 0) + v
            else:
                raise ValueError(f"bad scalar op {s.op}")
        else:
            raise TypeError(f"cannot execute {s!r}")


class ReferencePlan:
    """``ExecutablePlan`` adapter over the interpreter: re-interprets the
    program against the bound Database on every ``run``."""

    def __init__(self, program: Program, db: Database):
        self.program = program
        self.db = db

    def run(
        self, params: Optional[Dict[str, Any]] = None, *, tracer: Any = None
    ) -> Dict[str, Any]:
        if tracer is None or not tracer.enabled:
            return ReferenceInterpreter(self.db, params).run(self.program)
        with tracer.span("reference.interpret"):
            return ReferenceInterpreter(self.db, params).run(self.program)


class ReferenceBackend:
    """Oracle backend: no codegen choices, no compilation — the IR's
    denotational semantics, executed directly."""

    name = "reference"

    def compile(self, program: Program, db: Database, choices: Any = None) -> ReferencePlan:
        return ReferencePlan(program, db)


register_backend(ReferenceBackend())
