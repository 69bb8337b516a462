# SQL frontend (paper §II, §IV): "SQL statements can be parsed into an AST
# automatically" — queries are *expanded into forelem loops* inside the
# application IR instead of being shipped to a DBMS.
#
# Supported subset (enough for every query in the paper + the benchmark
# suite):   SELECT <items> FROM <table> [alias] [, <table> [alias]]
#           [WHERE <pred>] [GROUP BY <col>]
# items:    col | tab.col | COUNT(col|*) | SUM(expr) | MIN/MAX(expr) | AVG(expr)
# pred:     conjunctions/disjunctions of comparisons over columns, numeric
#           literals, string literals and :params;  equi-join predicates
#           (a.x = b.y) become nested forelem loops (Fig. 1).
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.ir import (
    Accumulate,
    ArrayRead,
    BinOp,
    Const,
    Distinct,
    Expr,
    FieldMatch,
    FieldRef,
    Filtered,
    Forelem,
    FullSet,
    MultisetDecl,
    Program,
    ResultAppend,
    ScalarAssign,
    TupleExpr,
    TupleSchema,
    Var,
)

# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<str>'[^']*')
  | (?P<num>\d+\.\d+|\d+)
  | (?P<param>:\w+)
  | (?P<op><=|>=|!=|<>|=|<|>|\(|\)|,|\*|\+|-|/|\.)
  | (?P<word>\w+)
    """,
    re.VERBOSE,
)

_KEYWORDS = {
    "select", "from", "where", "group", "by", "and", "or", "as",
    "count", "sum", "min", "max", "avg", "join", "on",
    "order", "limit", "asc", "desc",
}


def tokenize(sql: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SQLError(f"bad token at {sql[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group()
        if kind == "ws":
            continue
        if kind == "word" and text.lower() in _KEYWORDS:
            out.append(("kw", text.lower()))
        else:
            out.append((kind, text))
    out.append(("eof", ""))
    return out


class SQLError(Exception):
    pass


# ---------------------------------------------------------------------------
# AST (SQL level — translated to forelem below)
# ---------------------------------------------------------------------------


@dataclass
class SelectItem:
    kind: str          # 'col' | 'agg'
    agg: Optional[str]  # count/sum/min/max/avg
    expr: Any          # ('col', tab_or_None, name) or arithmetic tree or '*'
    alias: Optional[str] = None


@dataclass
class Query:
    items: List[SelectItem]
    tables: List[Tuple[str, Optional[str]]]  # (table, alias)
    where: Optional[Any]
    group_by: Optional[Tuple[Optional[str], str]]  # (tab, col)
    # each entry is (key, desc) with key either (tab, col) or an
    # ('agg', name, arg_tree) for ORDER BY COUNT(...)-style keys
    order_by: Tuple[Tuple[Any, bool], ...] = field(default_factory=tuple)
    limit: Optional[int] = None


class Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str, text: Optional[str] = None) -> str:
        k, t = self.next()
        if k != kind or (text is not None and t != text):
            raise SQLError(f"expected {kind}:{text}, got {k}:{t}")
        return t

    def accept(self, kind: str, text: Optional[str] = None) -> bool:
        k, t = self.peek()
        if k == kind and (text is None or t == text):
            self.i += 1
            return True
        return False

    # -- grammar -------------------------------------------------------------
    def parse(self) -> Query:
        self.expect("kw", "select")
        items = [self.select_item()]
        while self.accept("op", ","):
            items.append(self.select_item())
        self.expect("kw", "from")
        tables = [self.table_ref()]
        while self.accept("op", ",") or self.accept("kw", "join"):
            tables.append(self.table_ref())
            if self.accept("kw", "on"):
                on = self.predicate()
                self._on_preds.append(on)
        where = None
        if self.accept("kw", "where"):
            where = self.predicate()
        group_by = None
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            group_by = self.column()
        order_by: List[Tuple[Any, bool]] = []
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                key = self.order_key()
                desc = False
                if self.accept("kw", "desc"):
                    desc = True
                elif self.accept("kw", "asc"):
                    desc = False
                order_by.append((key, desc))
                if not self.accept("op", ","):
                    break
        limit = None
        if self.accept("kw", "limit"):
            limit = int(self.expect("num"))
        self.expect("eof")
        for on in self._on_preds:
            where = on if where is None else ("and", where, on)
        return Query(items, tables, where, group_by, tuple(order_by), limit)

    _on_preds: List[Any]

    def parse_query(self) -> Query:
        self._on_preds = []
        return self.parse()

    def select_item(self) -> SelectItem:
        k, t = self.peek()
        if k == "kw" and t in ("count", "sum", "min", "max", "avg"):
            self.next()
            self.expect("op", "(")
            if t == "count" and self.accept("op", "*"):
                expr = "*"
            else:
                expr = self.arith()
            self.expect("op", ")")
            alias = None
            if self.accept("kw", "as"):
                alias = self.next()[1]
            return SelectItem("agg", t, expr, alias)
        expr = self.arith()
        alias = None
        if self.accept("kw", "as"):
            alias = self.next()[1]
        return SelectItem("col", None, expr, alias)

    def table_ref(self) -> Tuple[str, Optional[str]]:
        name = self.expect("word")
        k, t = self.peek()
        alias = None
        if k == "word":
            alias = self.next()[1]
        return (name, alias)

    def column(self) -> Tuple[Optional[str], str]:
        a = self.expect("word")
        if self.accept("op", "."):
            b = self.expect("word")
            return (a, b)
        return (None, a)

    def order_key(self) -> Any:
        """An ORDER BY key: a column, or an aggregate call matched against
        the select list (``ORDER BY COUNT(url)`` without an alias)."""
        k, t = self.peek()
        if k == "kw" and t in ("count", "sum", "min", "max", "avg"):
            self.next()
            self.expect("op", "(")
            if t == "count" and self.accept("op", "*"):
                expr: Any = "*"
            else:
                expr = self.arith()
            self.expect("op", ")")
            return ("agg", t, expr)
        return self.column()

    def atom(self) -> Any:
        k, t = self.peek()
        if k == "op" and t == "-":  # unary minus: -x ≡ 0 - x
            self.next()
            return ("-", ("lit", 0), self.atom())
        if k == "num":
            self.next()
            return ("lit", float(t) if "." in t else int(t))
        if k == "str":
            self.next()
            return ("lit", t[1:-1])
        if k == "param":
            self.next()
            return ("param", t[1:])
        if k == "op" and t == "(":
            self.next()
            e = self.arith()
            self.expect("op", ")")
            return e
        if k == "word":
            return ("col", *self.column())
        raise SQLError(f"bad atom {k}:{t}")

    def arith(self) -> Any:
        e = self.term()
        while True:
            k, t = self.peek()
            if k == "op" and t in ("+", "-"):
                self.next()
                e = (t, e, self.term())
            else:
                return e

    def term(self) -> Any:
        e = self.atom()
        while True:
            k, t = self.peek()
            if k == "op" and t in ("*", "/"):
                self.next()
                e = (t, e, self.atom())
            else:
                return e

    def predicate(self) -> Any:
        e = self.pred_and()
        while self.accept("kw", "or"):
            e = ("or", e, self.pred_and())
        return e

    def pred_and(self) -> Any:
        e = self.comparison()
        while self.accept("kw", "and"):
            e = ("and", e, self.comparison())
        return e

    def comparison(self) -> Any:
        l = self.arith()
        k, t = self.next()
        if k != "op" or t not in ("=", "!=", "<>", "<", "<=", ">", ">="):
            raise SQLError(f"bad comparison op {t}")
        op = {"=": "==", "<>": "!="}.get(t, t)
        r = self.arith()
        return (op, l, r)


def parse_sql(sql: str) -> Query:
    return Parser(tokenize(sql)).parse_query()


# ---------------------------------------------------------------------------
# Translation: SQL AST → forelem Program (paper §IV examples)
# ---------------------------------------------------------------------------


def _resolve(tab: Optional[str], col: str, tables: List[Tuple[str, Optional[str]]]) -> str:
    """alias/implicit table resolution → physical table name."""
    if tab is None:
        if len(tables) != 1:
            raise SQLError(f"ambiguous column {col} over {tables}")
        return tables[0][0]
    for name, alias in tables:
        if tab == alias or tab == name:
            return name
    raise SQLError(f"unknown table/alias {tab}")


def _to_expr(node: Any, loopvars: Dict[str, str], tables) -> Expr:
    """SQL expr tree → IR Expr; loopvars: physical table -> loop var."""
    if isinstance(node, tuple):
        if node[0] == "lit":
            return Const(node[1])
        if node[0] == "param":
            return Var(node[1])
        if node[0] == "col":
            _, tab, col = node
            pt = _resolve(tab, col, tables)
            return FieldRef(pt, loopvars[pt], col)
        op, l, r = node
        return BinOp(op, _to_expr(l, loopvars, tables), _to_expr(r, loopvars, tables))
    raise SQLError(f"bad expr {node!r}")


def _split_join_pred(pred: Any, tables) -> Tuple[List[Tuple[str, str, str, str]], Optional[Any]]:
    """Extract equi-join conditions (tabA, colA, tabB, colB) from an AND-tree;
    returns (joins, residual_pred)."""
    joins: List[Tuple[str, str, str, str]] = []

    def is_col(n):
        return isinstance(n, tuple) and n[0] == "col"

    def go(n) -> Optional[Any]:
        if isinstance(n, tuple) and n[0] == "and":
            l = go(n[1])
            r = go(n[2])
            if l is None:
                return r
            if r is None:
                return l
            return ("and", l, r)
        if isinstance(n, tuple) and n[0] == "==" and is_col(n[1]) and is_col(n[2]):
            ta = _resolve(n[1][1], n[1][2], tables)
            tb = _resolve(n[2][1], n[2][2], tables)
            if ta != tb:
                joins.append((ta, n[1][2], tb, n[2][2]))
                return None
        return n

    residual = go(pred) if pred is not None else None
    return joins, residual


def _resolve_order_limit(q: Query, tables) -> Tuple[Tuple[Tuple[int, bool], ...], Optional[int]]:
    """Map ORDER BY columns to select-item positions (result tuple slots).

    A key resolves against, in order: a select-item alias, a bare selected
    column, the argument column of a selected aggregate (so
    ``SELECT url, COUNT(url) AS c ... ORDER BY c`` and ``ORDER BY url``
    both work), or a matching unaliased aggregate call
    (``ORDER BY COUNT(url)``)."""
    out: List[Tuple[int, bool]] = []
    for key, desc in q.order_by:
        pos: Optional[int] = None
        if isinstance(key, tuple) and len(key) == 3 and key[0] == "agg":
            _, agg, arg = key
            for i, it in enumerate(q.items):
                if it.kind == "agg" and it.agg == agg and it.expr == arg:
                    pos = i
                    break
            if pos is None:
                raise SQLError(f"ORDER BY {agg.upper()}(...) is not in the select list")
            out.append((pos, desc))
            continue
        tab, col = key
        for i, it in enumerate(q.items):
            if tab is None and it.alias == col:
                pos = i
                break
        if pos is None:
            for i, it in enumerate(q.items):
                e = it.expr
                if isinstance(e, tuple) and e[0] == "col" and e[2] == col:
                    if tab is None or _resolve(tab, col, tables) == _resolve(e[1], e[2], tables):
                        pos = i
                        break
        if pos is None:
            raise SQLError(f"ORDER BY column {col!r} is not in the select list")
        out.append((pos, desc))
    return tuple(out), q.limit


def _pred_tables(node: Any, tables) -> Set[str]:
    """Physical tables referenced by a SQL predicate/expression tree."""
    out: Set[str] = set()

    def go(n: Any) -> None:
        if not isinstance(n, tuple):
            return
        if n[0] == "col":
            out.add(_resolve(n[1], n[2], tables))
        elif n[0] not in ("lit", "param"):
            for ch in n[1:]:
                go(ch)

    go(node)
    return out


def _groupby_parts(
    q: Query, lv: Dict[str, str], tables, gtab: str, gcol: str, readvar: str
) -> Tuple[List[Accumulate], List[Expr], Optional[str]]:
    """Accumulates for the scan/join loop + result-tuple reads for the
    distinct loop of a GROUP BY query.  Returns (accs, reads, count_array)
    where count_array names an accumulator that counts rows per group (for
    the presence guard), if the select list happens to produce one."""
    key = FieldRef(gtab, lv[gtab], gcol)
    rkey = FieldRef(gtab, readvar, gcol)
    accs: List[Accumulate] = []
    reads: List[Expr] = []
    count_arr: Optional[str] = None
    arr_i = 0
    for it in q.items:
        if it.kind == "col":
            e = _to_expr(it.expr, lv, tables)
            if not (isinstance(e, FieldRef) and e.table == gtab and e.field == gcol):
                raise SQLError("non-grouped bare column in GROUP BY select")
            reads.append(rkey)
        else:
            arr = f"agg{arr_i}"
            arr_i += 1
            if it.agg == "count":
                accs.append(Accumulate(arr, key, Const(1)))
                reads.append(ArrayRead(arr, rkey))
                count_arr = count_arr or arr
            elif it.agg in ("sum", "min", "max"):
                val = _to_expr(it.expr, lv, tables)
                op = {"sum": "+", "min": "min", "max": "max"}[it.agg]
                accs.append(Accumulate(arr, key, val, op))
                reads.append(ArrayRead(arr, rkey))
            elif it.agg == "avg":
                sarr, carr = f"agg{arr_i}s", f"agg{arr_i}c"
                accs.append(Accumulate(sarr, key, _to_expr(it.expr, lv, tables)))
                accs.append(Accumulate(carr, key, Const(1)))
                reads.append(BinOp("/", ArrayRead(sarr, rkey), ArrayRead(carr, rkey)))
                count_arr = count_arr or carr
            else:
                raise SQLError(f"agg {it.agg}")
    return accs, reads, count_arr


def _guarded_distinct(
    gtab: str, gcol: str, accs: List[Accumulate], count_arr: Optional[str], key: FieldRef
) -> Filtered:
    """Distinct index set over the group column, guarded so that groups
    with no contributing rows are omitted (SQL GROUP BY semantics under
    WHERE filters and joins).  Adds a hidden count accumulator when the
    select list does not already provide one."""
    if count_arr is None:
        count_arr = "__cnt"
        accs.append(Accumulate(count_arr, key, Const(1)))
    guard = BinOp(">", ArrayRead(count_arr, FieldRef(gtab, "_", gcol)), Const(0))
    return Filtered(gtab, guard, base=Distinct(gtab, gcol))


def sql_to_forelem(sql: str, schemas: Dict[str, Sequence[str]], name: Optional[str] = None) -> Program:
    """Compile a SQL string into a forelem Program.

    schemas: table -> field names (dtypes are refined from data at lowering).
    """
    q = parse_sql(sql)
    tables = q.tables
    order_by, limit = _resolve_order_limit(q, tables)
    decls = tuple(
        MultisetDecl(t, TupleSchema(tuple((f, "any") for f in schemas[t]))) for t, _ in tables
    )
    params: List[str] = sorted({m.group(1) for m in re.finditer(r":(\w+)", sql)})

    # ------- single-table queries ---------------------------------------------
    if len(tables) == 1:
        t = tables[0][0]
        lv = {t: "i"}
        pred = _to_pred(q.where, lv, tables)

        if q.group_by is not None:
            gtab = _resolve(q.group_by[0], q.group_by[1], tables)
            gcol = q.group_by[1]
            accs, reads, count_arr = _groupby_parts(q, lv, tables, gtab, gcol, "i")
            ix = FullSet(t) if pred is None else Filtered(t, pred)
            if pred is None:
                # an unfiltered scan touches every distinct key at least once
                dix: Any = Distinct(t, gcol)
            else:
                # WHERE may empty a group entirely — guard the distinct read
                dix = _guarded_distinct(gtab, gcol, accs, count_arr, FieldRef(gtab, "i", gcol))
            body: List[Any] = [
                Forelem("i", ix, tuple(accs)),
                Forelem("i", dix, (ResultAppend("R", TupleExpr(tuple(reads))),)),
            ]
            return Program(decls, tuple(body), ("R",), tuple(params), name or "sql_groupby",
                           order_by=order_by, limit=limit)

        # scalar aggregate (no GROUP BY) --------------------------------------
        if any(it.kind == "agg" for it in q.items):
            if order_by or limit is not None:
                raise SQLError("ORDER BY/LIMIT on a scalar aggregate")
            if len(q.items) != 1:
                raise SQLError("multiple scalar aggregates unsupported")
            it = q.items[0]
            if it.agg not in ("sum", "count", "avg"):
                raise SQLError(f"scalar agg {it.agg}")
            val = Const(1) if (it.agg == "count" or it.expr == "*") else _to_expr(it.expr, lv, tables)
            ix = FullSet(t) if pred is None else Filtered(t, pred)
            body2: List[Any] = [Forelem("i", ix, (ScalarAssign("scalar", val, "+"),))]
            if it.agg == "avg":
                body2 = [
                    Forelem("i", ix, (ScalarAssign("scalar", val, "+"), ScalarAssign("n", Const(1), "+"))),
                ]
                # final divide handled by consumer; expose both
                return Program(decls, tuple(body2), ("scalar", "n"), tuple(params), name or "sql_avg")
            return Program(decls, tuple(body2), ("scalar",), tuple(params), name or "sql_scalar")

        # plain select/project --------------------------------------------------
        items = tuple(_to_expr(it.expr, lv, tables) for it in q.items)
        ix = FullSet(t) if pred is None else Filtered(t, pred)
        body3 = (Forelem("i", ix, (ResultAppend("R", TupleExpr(items)),)),)
        return Program(decls, body3, ("R",), tuple(params), name or "sql_select",
                       order_by=order_by, limit=limit)

    # ------- two-table equi-join ------------------------------------------------
    if len(tables) == 2:
        joins, residual = _split_join_pred(q.where, tables)
        if len(joins) != 1:
            raise SQLError("exactly one equi-join condition supported")
        ta, ca, tb, cb = joins[0]
        probe_pred: Optional[Expr] = None
        if residual is not None:
            rtabs = _pred_tables(residual, tables)
            if rtabs <= {tb}:
                # the equi-join was written with the filtered table on the
                # right — orient the nest so it drives the probe side
                ta, ca, tb, cb = tb, cb, ta, ca
            elif not rtabs <= {ta}:
                raise SQLError(
                    "residual join predicates may only reference one of the "
                    f"joined tables, got {sorted(rtabs)}"
                )
            probe_pred = _to_pred(residual, {ta: "_"}, tables)
        lv = {ta: "i", tb: "j"}
        outer_ix = FullSet(ta) if probe_pred is None else Filtered(ta, probe_pred)
        inner_match = FieldMatch(tb, cb, FieldRef(ta, "i", ca))

        # GROUP BY over the join: aggregate over the joined row pairs, then
        # read out one tuple per present group (paper §IV star-schema shape).
        if q.group_by is not None:
            gtab = _resolve(q.group_by[0], q.group_by[1], tables)
            gcol = q.group_by[1]
            accs, reads, count_arr = _groupby_parts(q, lv, tables, gtab, gcol, "g")
            # a join can leave any group unmatched — always guard
            dix = _guarded_distinct(gtab, gcol, accs, count_arr, FieldRef(gtab, lv[gtab], gcol))
            body4: Tuple[Any, ...] = (
                Forelem("i", outer_ix, (Forelem("j", inner_match, tuple(accs)),)),
                Forelem("g", dix, (ResultAppend("R", TupleExpr(tuple(reads))),)),
            )
            return Program(decls, body4, ("R",), tuple(params), name or "sql_join_groupby",
                           order_by=order_by, limit=limit)

        if any(it.kind == "agg" for it in q.items):
            raise SQLError("aggregates over a join require GROUP BY")

        items = tuple(_to_expr(it.expr, lv, tables) for it in q.items)
        body5 = (
            Forelem(
                "i",
                outer_ix,
                (Forelem("j", inner_match, (ResultAppend("R", TupleExpr(items)),)),),
            ),
        )
        return Program(decls, body5, ("R",), tuple(params), name or "sql_join",
                       order_by=order_by, limit=limit)

    raise SQLError(">2 tables unsupported")


def _to_pred(where: Any, loopvars: Dict[str, str], tables) -> Optional[Expr]:
    if where is None:
        return None
    # predicates in Filtered index sets use the placeholder loopvar '_'
    ph = {t: "_" for t in loopvars}
    return _to_expr(where, ph, tables)
