# Data partitioning (paper §III-A1): direct (loop blocking over the index
# set) and indirect (blocking over the value range of a field), plus the
# mapping of ``forall`` loops onto mesh axes.
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from .ir import Blocked, ForValue, Forall, Forelem, Program, Stmt, children, walk, with_children
from . import transforms as T


@dataclass(frozen=True)
class Partitioning:
    """How a forall distributes work: direct row-blocking of a table, or
    indirect value-range partitioning on (table, field)."""

    kind: str  # 'direct' | 'indirect'
    table: str
    field: Optional[str]
    n_parts: int
    mesh_axis: Optional[str] = None

    def key(self) -> Tuple:
        return (self.kind, self.table, self.field)


def partition_direct(program: Program, n_parts: int, mesh_axis: Optional[str] = None) -> Program:
    """pA = p1A ∪ … ∪ pNA ; outermost loop becomes forall (paper §III-A1)."""
    return T.loop_blocking(program, n_parts, mesh_axis=mesh_axis)


def partition_indirect(
    program: Program, table: str, field: str, n_parts: int, mesh_axis: Optional[str] = None
) -> Program:
    """X = A.field ; X = X1 ∪ … ∪ XN (paper §III-A1, indirect)."""
    return T.orthogonalize(program, table, field, n_parts, mesh_axis=mesh_axis)


def forall_partitionings(program: Program) -> List[Tuple[Forall, Partitioning]]:
    """Identify the partitioning used by each forall in the program."""
    out: List[Tuple[Forall, Partitioning]] = []
    for s in walk(program.body):
        if not isinstance(s, Forall):
            continue
        part: Optional[Partitioning] = None
        for c in walk(s.body):
            if isinstance(c, ForValue) and c.range_part.part_var == s.partvar:
                vr = c.range_part.base
                part = Partitioning("indirect", vr.table, vr.field, s.n_parts, s.mesh_axis)
                break
            if isinstance(c, Forelem):
                ix = c.indexset
                if isinstance(ix, Blocked) and ix.part_var == s.partvar:
                    part = Partitioning("direct", ix.table, None, s.n_parts, s.mesh_axis)
                    break
        if part is not None:
            out.append((s, part))
    return out


def assign_mesh_axis(program: Program, axis: str) -> Program:
    """Stamp every un-assigned forall with a mesh axis (the codegen stage
    maps these onto shard_map axes)."""

    def rewrite(stmts: Sequence[Stmt]) -> List[Stmt]:
        out: List[Stmt] = []
        for s in stmts:
            if isinstance(s, Forall) and s.mesh_axis is None:
                s = dataclasses.replace(s, mesh_axis=axis, body=tuple(rewrite(s.body)))
            elif children(s):
                s = with_children(s, rewrite(children(s)))
            out.append(s)
        return out

    return program.with_body(rewrite(program.body))
