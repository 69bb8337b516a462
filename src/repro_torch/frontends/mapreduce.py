# MapReduce frontend (paper §IV): MapReduce-like problems expressed on the
# single intermediate.  Two levels are provided:
#
#   1. A *declarative* MR spec (key expr / value expr / reduction op) that
#      translates exactly onto the forelem IR — this is the class of MR
#      programs the paper shows are equivalent to the two-adjacent-loop
#      forelem shape.
#   2. A *faithful Hadoop-style executor* (`run_python_mapreduce`) that runs
#      arbitrary Python map/reduce functions with materialized intermediate
#      (key, value) pairs and a shuffle phase — used as the baseline in the
#      Fig. 2 benchmark.
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Sequence, Tuple

from repro_torch.core.ir import (
    Accumulate,
    ArrayRead,
    Const,
    Distinct,
    Expr,
    FieldRef,
    Forelem,
    FullSet,
    MultisetDecl,
    Program,
    ResultAppend,
    TupleExpr,
    TupleSchema,
)

# ---------------------------------------------------------------------------
# 1. Declarative MR → forelem
# ---------------------------------------------------------------------------


@dataclass
class MapReduceSpec:
    """map: for each row of `table`, emit (row.key_field, value) where value
    is Const(1) (count-style) or another field (sum-style).
    reduce: fold emitted values per unique key with `reduce_op`."""

    table: str
    key_field: str
    value: Expr  # Const(1) or FieldRef(table, 'i', field)
    reduce_op: str = "+"  # '+', 'max', 'min'
    name: str = "mapreduce"

    @staticmethod
    def count(table: str, key_field: str, name: str = "mr_count") -> "MapReduceSpec":
        """Word-count shape: emit (row.key_field, 1), reduce with '+'."""
        return MapReduceSpec(table, key_field, Const(1), "+", name)

    @staticmethod
    def aggregate(
        table: str, key_field: str, value_field: str, reduce_op: str = "+",
        name: str = "mr_aggregate",
    ) -> "MapReduceSpec":
        """Sum/min/max-by-key shape: emit (row.key_field, row.value_field),
        reduce with ``reduce_op``."""
        return MapReduceSpec(
            table, key_field, FieldRef(table, "i", value_field), reduce_op, name
        )


def mapreduce_to_forelem(spec: MapReduceSpec, schema: Sequence[str]) -> Program:
    """The paper's mapping: 'two adjacent forelem loops where the former
    loop stores values in an array subscripted by a field of the array being
    iterated, and the latter loop accesses elements of this array'."""
    decls = (MultisetDecl(spec.table, TupleSchema(tuple((f, "any") for f in schema))),)
    key = FieldRef(spec.table, "i", spec.key_field)
    body = (
        Forelem("i", FullSet(spec.table), (Accumulate("acc", key, spec.value, spec.reduce_op),)),
        Forelem(
            "i",
            Distinct(spec.table, spec.key_field),
            (ResultAppend("R", TupleExpr((key, ArrayRead("acc", key)))),),
        ),
    )
    return Program(decls, body, ("R",), (), spec.name)


# ---------------------------------------------------------------------------
# 2. Faithful Hadoop-style execution (benchmark baseline)
# ---------------------------------------------------------------------------


def run_python_mapreduce(
    map_fn: Callable[[Any, Any], Iterable[Tuple[Any, Any]]],
    reduce_fn: Callable[[Any, List[Any]], Iterable[Tuple[Any, Any]]],
    inputs: Iterable[Tuple[Any, Any]],
    num_reducers: int = 1,
) -> List[Tuple[Any, Any]]:
    """Materialized-intermediate MapReduce with an explicit shuffle phase —
    the execution model of Hadoop (used as the Fig. 2 baseline; no fusion,
    no dictionary encoding, every pair materialized)."""
    # map phase: materialize ALL intermediate pairs (this is the point)
    intermediate: List[Tuple[Any, Any]] = []
    for k, v in inputs:
        for ik, iv in map_fn(k, v):
            intermediate.append((ik, iv))
    # shuffle phase: hash-partition to reducers, then group by key
    buckets: List[Dict[Any, List[Any]]] = [defaultdict(list) for _ in range(num_reducers)]
    for ik, iv in intermediate:
        buckets[hash(ik) % num_reducers][ik].append(iv)
    # reduce phase
    out: List[Tuple[Any, Any]] = []
    for b in buckets:
        for ik in sorted(b.keys(), key=repr):
            for ok, ov in reduce_fn(ik, b[ik]):
                out.append((ok, ov))
    return out


def wordcount_map(_key: Any, line: str) -> Iterable[Tuple[str, int]]:
    for w in line.split():
        yield (w, 1)


def count_reduce(key: Any, values: List[Any]) -> Iterable[Tuple[Any, int]]:
    # the paper's reduce: "count = 0; for v in values: count++"
    count = 0
    for _v in values:
        count += 1
    yield (key, count)


def sum_reduce(key: Any, values: List[Any]) -> Iterable[Tuple[Any, Any]]:
    total = 0
    for v in values:
        total += v
    yield (key, total)
