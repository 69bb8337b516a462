# Shared codegen machinery for executor backends (paper §II Fig. 1,
# §III-B): pattern extraction from forelem programs into a ``ProgramSpec``
# (the op-shapes the frontends produce), plus the helpers every backend
# needs — scalar coercion, binop semantics (Python and torch), accumulate-op
# identities, and multiset-result densification.
#
# Backends consume the *same* spec: index sets encapsulate what is
# iterated; each backend chooses how (reference interpretation, vectorized
# PyTorch, future partitioned lowerings).
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.ir import (
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
    IndexSet,
    Program,
    ResultAppend,
    ScalarAssign,
    Stmt,
    TupleExpr,
    Var,
)


class UnsupportedProgram(Exception):
    pass


# ===========================================================================
# Pattern extraction for vectorized lowering
# ===========================================================================


@dataclass
class AggSpec:
    """arr[key_field of table] op= value_expr   (+ presence counting)."""

    array: str
    table: str
    key_field: str
    value: Expr
    op: str
    filter_pred: Optional[Expr] = None  # from Filtered base index sets
    # rows restricted to those whose `member_field` value occurs in the
    # value range of (member_table, member_src_field) — arises when a loop
    # matching on field B was fused under a ForValue ranging over field A.
    member_filter: Optional[Tuple[str, str, str]] = None


# Accumulate ops the fused segreduce kernel evaluates in one pass.  Anything
# else (e.g. 'first') stays on the per-aggregate paths.
FUSABLE_AGG_OPS = ("+", "max", "min")


def _reads_arrays(e: Expr) -> bool:
    if isinstance(e, ArrayRead):
        return True
    if isinstance(e, BinOp):
        return _reads_arrays(e.lhs) or _reads_arrays(e.rhs)
    return False


def fused_agg_groups(aggs: Sequence[AggSpec]) -> List[List[int]]:
    """Partition the fusable aggregates into groups that one fused-kernel
    launch can evaluate together: same source table, same GROUP-BY key and
    same row predicate (filter + member filter), so the group shares one
    hit/mask matrix and one presence histogram.  Returns index lists into
    ``aggs`` in insertion order.  Left out (evaluated per-aggregate, in
    statement order): non-fusable ops, and aggregates whose value expression
    reads another accumulator array — hoisting those into a group would
    reorder them across their producers."""
    groups: Dict[Tuple, List[int]] = {}
    for i, a in enumerate(aggs):
        if a.op not in FUSABLE_AGG_OPS or _reads_arrays(a.value):
            continue
        sig = (a.table, a.key_field, repr(a.filter_pred), a.member_filter)
        groups.setdefault(sig, []).append(i)
    return list(groups.values())


@dataclass
class DistinctReadSpec:
    """forelem (i ∈ pT.distinct(f)) R ∪= tuple(field / ArrayRead items).

    ``filter_pred`` is the presence guard of a Filtered-over-Distinct index
    set (e.g. ``cnt[f] > 0`` emitted by the SQL frontend so that groups with
    no surviving rows are omitted — SQL GROUP BY semantics)."""

    result: str
    table: str
    field: str
    items: Tuple[Expr, ...]
    filter_pred: Optional[Expr] = None


@dataclass
class ScalarReduceSpec:
    var: str
    table: str
    expr: Expr
    match_field: Optional[str]
    match_value: Optional[Expr]
    filter_pred: Optional[Expr]


@dataclass
class FilterProjectSpec:
    result: str
    table: str
    items: Tuple[Expr, ...]
    filter_pred: Optional[Expr]


@dataclass
class JoinAgg:
    """``arr[key] op= value`` over the joined (probe, build) row pairs —
    GROUP BY over a two-table join.  ``key`` is a FieldRef on either side."""

    array: str
    key: FieldRef
    value: Expr
    op: str


@dataclass
class JoinSpec:
    """forelem (i ∈ pA) forelem (j ∈ pB.key[A[i].fk]) BODY

    BODY is either a single ResultAppend (materialized equi-join; ``result``
    and ``items`` are set) or a list of Accumulates (join-then-aggregate;
    ``aggs`` is set and ``result`` is None).  ``probe_filter`` restricts the
    probe side (a Filtered outer index set — WHERE over the probe table)."""

    result: Optional[str]
    probe_table: str
    probe_fk: str
    build_table: str
    build_key: str
    items: Tuple[Expr, ...]
    probe_var: str
    build_var: str
    probe_filter: Optional[Expr] = None
    aggs: Tuple[JoinAgg, ...] = ()


@dataclass
class ProgramSpec:
    aggs: List[AggSpec]
    distinct_reads: List[DistinctReadSpec]
    scalar_reduces: List[ScalarReduceSpec]
    filter_projects: List[FilterProjectSpec]
    joins: List[JoinSpec]
    n_parts: int  # parallelism declared by forall loops (1 = sequential)
    mesh_axis: Optional[str]


def extract_spec(program: Program) -> ProgramSpec:
    congruence_set = set(program.congruences)
    aggs: List[AggSpec] = []
    dreads: List[DistinctReadSpec] = []
    sreds: List[ScalarReduceSpec] = []
    fprojs: List[FilterProjectSpec] = []
    joins: List[JoinSpec] = []
    n_parts = 1
    mesh_axis: Optional[str] = None

    def base_of(ix: IndexSet) -> IndexSet:
        while isinstance(ix, Blocked):
            ix = ix.base
        return ix

    def handle_forelem(fe: Forelem, valvar_field: Optional[Tuple[str, str]] = None) -> None:
        """valvar_field = (valvar_name, field) when nested under ForValue."""
        nonlocal aggs, dreads, sreds, fprojs, joins
        ix = base_of(fe.indexset)
        filt = None
        table = ix.table
        if isinstance(ix, Filtered):
            filt = ix.predicate
        # Determine effective iteration: FieldMatch with Var bound by the
        # surrounding ForValue means "full table, partitioned by that field"
        # — i.e. a plain scan once re-serialized.
        match_field: Optional[str] = None
        match_value: Optional[Expr] = None
        member_filter: Optional[Tuple[str, str, str]] = None
        if isinstance(ix, FieldMatch):
            if (
                valvar_field is not None
                and isinstance(ix.value, Var)
                and ix.value.name == valvar_field[0]
            ):
                if ix.field == valvar_field[1]:
                    pass  # partitioned full scan
                else:
                    # fused under a congruent value range: if congruence is
                    # recorded, this is still a full scan; otherwise restrict
                    # rows to those whose value occurs in the range.
                    pair = frozenset({(table, ix.field), (valvar_field[2], valvar_field[1])})
                    if pair in congruence_set:
                        pass
                    else:
                        member_filter = (ix.field, valvar_field[2], valvar_field[1])
            else:
                match_field, match_value = ix.field, ix.value

        for st in fe.body:
            if isinstance(st, Accumulate):
                key = st.key
                if not (isinstance(key, FieldRef) and key.loopvar == fe.loopvar and key.table == table):
                    raise UnsupportedProgram(f"accumulate key {key!r}")
                if match_field is not None:
                    raise UnsupportedProgram("accumulate under residual FieldMatch")
                aggs.append(AggSpec(st.array, table, key.field, st.value, st.op, filt, member_filter))
            elif isinstance(st, ScalarAssign) and st.op == "+":
                sreds.append(ScalarReduceSpec(st.var, table, st.expr, match_field, match_value, filt))
            elif isinstance(st, ResultAppend):
                if isinstance(ix, Distinct):
                    dreads.append(DistinctReadSpec(st.result, table, ix.field, st.tuple_expr.elements))
                elif isinstance(ix, Filtered) and isinstance(ix.base, Distinct):
                    # guarded distinct read: pT.distinct(f) | pred  (the SQL
                    # frontend's presence guard for filtered / joined GROUP BY)
                    dreads.append(
                        DistinctReadSpec(st.result, table, ix.base.field, st.tuple_expr.elements, filt)
                    )
                elif match_field is None:
                    reads: Set[str] = set()
                    for el in st.tuple_expr.elements:
                        _collect_array_reads(el, reads)
                    if reads:
                        raise UnsupportedProgram("projection reading arrays outside distinct loop")
                    fprojs.append(FilterProjectSpec(st.result, table, st.tuple_expr.elements, filt))
                else:
                    raise UnsupportedProgram("result append under FieldMatch (use join form)")
            elif isinstance(st, Forelem):
                # join: inner loop with FieldMatch on outer's field
                iix = base_of(st.indexset)
                if (
                    isinstance(iix, FieldMatch)
                    and isinstance(iix.value, FieldRef)
                    and iix.value.loopvar == fe.loopvar
                ):
                    inner_appends = [x for x in st.body if isinstance(x, ResultAppend)]
                    inner_accs = [x for x in st.body if isinstance(x, Accumulate)]
                    if len(inner_appends) == 1 and len(st.body) == 1:
                        ra = inner_appends[0]
                        joins.append(
                            JoinSpec(
                                ra.result,
                                probe_table=table,
                                probe_fk=iix.value.field,
                                build_table=iix.table,
                                build_key=iix.field,
                                items=ra.tuple_expr.elements,
                                probe_var=fe.loopvar,
                                build_var=st.loopvar,
                                probe_filter=filt,
                            )
                        )
                    elif inner_accs and len(inner_accs) == len(st.body):
                        # join-then-aggregate: GROUP BY over a two-table join
                        jaggs: List[JoinAgg] = []
                        for acc in inner_accs:
                            key = acc.key
                            on_probe = (
                                isinstance(key, FieldRef)
                                and key.loopvar == fe.loopvar
                                and key.table == table
                            )
                            on_build = (
                                isinstance(key, FieldRef)
                                and key.loopvar == st.loopvar
                                and key.table == iix.table
                            )
                            if not (on_probe or on_build):
                                raise UnsupportedProgram(f"join-aggregate key {key!r}")
                            jaggs.append(JoinAgg(acc.array, key, acc.value, acc.op))
                        joins.append(
                            JoinSpec(
                                None,
                                probe_table=table,
                                probe_fk=iix.value.field,
                                build_table=iix.table,
                                build_key=iix.field,
                                items=(),
                                probe_var=fe.loopvar,
                                build_var=st.loopvar,
                                probe_filter=filt,
                                aggs=tuple(jaggs),
                            )
                        )
                    else:
                        raise UnsupportedProgram("join inner body")
                else:
                    raise UnsupportedProgram(f"nested forelem {iix!r}")
            else:
                raise UnsupportedProgram(f"statement {st!r}")

    def visit(stmts: Sequence[Stmt], valvar_field=None) -> None:
        nonlocal n_parts, mesh_axis
        for s in stmts:
            if isinstance(s, Forall):
                n_parts = max(n_parts, s.n_parts)
                if s.mesh_axis:
                    mesh_axis = s.mesh_axis
                visit(s.body, valvar_field)
            elif isinstance(s, ForValue):
                visit(s.body, (s.valvar, s.range_part.base.field, s.range_part.base.table))
            elif isinstance(s, Forelem):
                handle_forelem(s, valvar_field)
            elif isinstance(s, CombinePartials):
                pass  # implicit in vectorized execution
            elif isinstance(s, ScalarAssign) and s.op == "=":
                pass  # initialization; arrays start at 0
            else:
                raise UnsupportedProgram(f"top-level {s!r}")

    visit(program.body)
    return ProgramSpec(aggs, dreads, sreds, fprojs, joins, n_parts, mesh_axis)


def required_columns(program: Program, spec: ProgramSpec) -> Dict[str, Set[str]]:
    """table -> columns an executor must materialize to run ``spec``: every
    field the program reads plus the key/probe columns the extracted op
    shapes consume.  Thin wrapper over ``repro_torch.analysis.deps.required_fields``
    (the one dataflow module), so the input surfaces of the backends cannot
    drift apart."""
    from repro_torch.analysis.deps import required_fields

    return required_fields(program, spec)


def _collect_array_reads(e: Expr, out: Set[str]) -> None:
    if isinstance(e, ArrayRead):
        out.add(e.array)
    elif isinstance(e, BinOp):
        _collect_array_reads(e.lhs, out)
        _collect_array_reads(e.rhs, out)
    elif isinstance(e, TupleExpr):
        for el in e.elements:
            _collect_array_reads(el, out)


# ===========================================================================
# Scalar / array helpers shared by the backends
# ===========================================================================


def _pyval(v: Any) -> Any:
    if isinstance(v, (np.generic,)):
        return v.item()
    return v


def _binop(op: str, l: Any, r: Any) -> Any:
    if op == "+":
        return l + r
    if op == "-":
        return l - r
    if op == "*":
        return l * r
    if op == "/":
        return l / r
    if op == "==":
        return l == r
    if op == "!=":
        return l != r
    if op == "<":
        return l < r
    if op == "<=":
        return l <= r
    if op == ">":
        return l > r
    if op == ">=":
        return l >= r
    if op == "and":
        return bool(l) and bool(r)
    if op == "or":
        return bool(l) or bool(r)
    raise ValueError(f"bad op {op}")


def _torch_binop(op: str, l, r):
    if op == "+":
        return l + r
    if op == "-":
        return l - r
    if op == "*":
        return l * r
    if op == "/":
        return l / r
    if op == "==":
        return l == r
    if op == "!=":
        return l != r
    if op == "<":
        return l < r
    if op == "<=":
        return l <= r
    if op == ">":
        return l > r
    if op == ">=":
        return l >= r
    if op == "and":
        return l & r
    if op == "or":
        return l | r
    raise ValueError(op)


def _op_identity(op: str, dtype) -> Any:
    """Identity element of an accumulate op for `dtype` — what masked-out /
    padded rows must contribute so they cannot perturb any segment."""
    if op == "+":
        return 0
    if op not in ("max", "min"):
        raise UnsupportedProgram(f"no identity element for accumulate op {op!r}")
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        return info.min if op == "max" else info.max
    return -torch.inf if op == "max" else torch.inf


def cols_len_shape(cols, table) -> Tuple[int]:
    anyc = next(iter(cols[table].values()))
    return (anyc.shape[0],)


def _host(t: Any) -> np.ndarray:
    """A tensor's values as a numpy array on the host (``.cpu()`` first:
    numpy cannot read device memory; sub-f32 floats widen to f32, which
    numpy can hold and which keeps their values)."""
    if isinstance(t, torch.Tensor):
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def _densify(v: Any) -> Any:
    if isinstance(v, dict) and "columns" in v:
        present = _host(v["present"])
        cols = [_host(c) for c in v["columns"]]
        cols = [np.broadcast_to(c, present.shape) if c.ndim == 0 else c for c in cols]
        idx = np.nonzero(present)[0]
        # tolist() yields the same Python scalars as _pyval, without a
        # Python-level step per cell
        return list(zip(*(c[idx].tolist() for c in cols))) if cols else [() for _ in idx]
    if isinstance(v, torch.Tensor):
        return _pyval(_host(v)[()])
    return v
