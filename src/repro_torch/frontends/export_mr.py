# The inverse mapping of paper §IV: "In general, two adjacent forelem loops
# where the former loop stores values in an array subscripted by a field of
# the array being iterated, and the latter loop accesses elements of this
# array, can be written as a MapReduce program."
#
# Given a forelem Program of that shape, emit (a) executable map/reduce
# Python functions and (b) MapReduce pseudocode in the paper's style.
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Tuple

from repro_torch.core.ir import Const, FieldRef, Program
from repro_torch.backends import UnsupportedProgram, extract_spec


@dataclass
class MRProgram:
    map_fn: Callable[[Any, Dict[str, Any]], Iterable[Tuple[Any, Any]]]
    reduce_fn: Callable[[Any, List[Any]], Iterable[Tuple[Any, Any]]]
    table: str
    pseudocode: str


class NotMapReduceShape(Exception):
    pass


def forelem_to_mapreduce(program: Program) -> MRProgram:
    """Detect the two-adjacent-loop shape and synthesize the MR program."""
    try:
        spec = extract_spec(program)
    except UnsupportedProgram as e:
        raise NotMapReduceShape(str(e))
    if len(spec.aggs) != 1 or len(spec.distinct_reads) != 1 or spec.joins or spec.filter_projects:
        raise NotMapReduceShape("need exactly one aggregate + one distinct-read")
    agg = spec.aggs[0]
    dr = spec.distinct_reads[0]
    if (agg.table, agg.key_field) != (dr.table, dr.field):
        raise NotMapReduceShape("aggregate key and distinct field differ")
    if agg.op != "+":
        raise NotMapReduceShape("only '+' reductions map to the paper's examples")

    key_field = agg.key_field
    is_count = isinstance(agg.value, Const)
    const_val = agg.value.value if is_count else None
    val_field = agg.value.field if isinstance(agg.value, FieldRef) else None
    if not is_count and val_field is None:
        raise NotMapReduceShape(f"value expr {agg.value!r} not a field/const")

    def map_fn(_key: Any, row: Dict[str, Any]) -> Iterable[Tuple[Any, Any]]:
        # paper: "Instead of writing to a global array, emitIntermediate is
        # called ... tuples (access[i].url, 1) are generated, where the 1 is
        # a dummy value"
        yield (row[key_field], const_val if is_count else row[val_field])

    if is_count and const_val == 1:

        def reduce_fn(key: Any, values: List[Any]) -> Iterable[Tuple[Any, Any]]:
            count = 0
            for _v in values:
                count += 1
            yield (key, count)

        reduce_body = "  count = 0\n  for v in values:\n    count++\n  emit(key, count)"
    else:

        def reduce_fn(key: Any, values: List[Any]) -> Iterable[Tuple[Any, Any]]:
            total = 0
            for v in values:
                total += v
            yield (key, total)

        reduce_body = "  total = 0\n  for v in values:\n    total += v\n  emit(key, total)"

    emit_val = "1" if is_count else f"a.{val_field}"
    pseudocode = (
        "map(key, value):\n"
        f"  # value represents content of {agg.table} table\n"
        f"  {agg.table.lower()} = value\n"
        f"  for a in {agg.table.lower()}:\n"
        f"    emitIntermediate(a.{key_field}, {emit_val})\n\n"
        f"reduce(key, values):\n{reduce_body}\n"
    )
    return MRProgram(map_fn, reduce_fn, agg.table, pseudocode)
