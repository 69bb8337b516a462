# Data distribution selection (paper §III-A4): "all parallel loops in the
# application are considered to choose the actual distribution of the data
# ... in optimizing the final data distribution, this communication should
# be minimized as much as possible."
#
# Two instantiations live here:
#   1. The forelem-level optimizer: detects partitioning conflicts between
#      adjacent foralls on the same multiset, and resolves them by statement
#      reordering + Loop Fusion (the paper's two-aggregate example),
#      including the congruence-witnessed case (A.field1 ≡ A.field2).
#   2. A generic chain sharding solver (Viterbi DP) that the LM launcher
#      uses to pick tensor shardings that minimize modeled resharding cost
#      between consecutive program stages — the same §III-A4 objective
#      applied to the training/serving computation graph.
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from .ir import ForValue, Program, Stmt, ValueRange, children, with_children
from . import transforms as T
from .partition import Partitioning, forall_partitionings

Congruence = FrozenSet[Tuple[str, str]]  # {(table, field), (table, field)}


# ===========================================================================
# 1. Forelem-level distribution optimization
# ===========================================================================


@dataclass
class DistributionReport:
    conflicts_before: int
    conflicts_after: int
    fusions_applied: int
    redistribution_bytes_avoided: int


def partition_conflicts(program: Program, sizes: Optional[Dict[str, int]] = None) -> List[Tuple[Partitioning, Partitioning]]:
    """Adjacent foralls that touch the same table with *different*
    partitionings ⇒ a data redistribution would be required between them.
    Even equal value-multisets on different fields conflict (paper: 'the
    fact that the column contents are equal does not imply the column
    contents are in the same order')."""
    parts = [p for _, p in forall_partitionings(program)]
    out = []
    for a, b in zip(parts, parts[1:]):
        if a.table == b.table and a.key() != b.key():
            out.append((a, b))
    return out


def verify_congruence(db, table_a: str, field_a: str, table_b: str, field_b: str) -> bool:
    """Witness that two value ranges are the same multiset (enables the
    paper's second fusion: Table.field1 = Table.field2)."""
    va = np.sort(np.asarray(db[table_a].field(field_a)))
    vb = np.sort(np.asarray(db[table_b].field(field_b)))
    return va.shape == vb.shape and bool(np.all(va == vb))


def _fuse_forvalues_congruent(program: Program, congruences: Set[Congruence]) -> Tuple[Program, int]:
    """Fuse adjacent ForValue loops whose ranges are congruent (after the
    forall-level fusion has put them next to each other)."""
    fusions = 0

    def congruent(a: ValueRange, b: ValueRange) -> bool:
        if a == b:
            return True
        return frozenset({(a.table, a.field), (b.table, b.field)}) in congruences

    def rewrite(stmts: Sequence[Stmt]) -> List[Stmt]:
        nonlocal fusions
        out: List[Stmt] = []
        i = 0
        stmts = list(stmts)
        while i < len(stmts):
            s = stmts[i]
            if (
                isinstance(s, ForValue)
                and i + 1 < len(stmts)
                and isinstance(stmts[i + 1], ForValue)
                and s.range_part.n_parts == stmts[i + 1].range_part.n_parts
                and congruent(s.range_part.base, stmts[i + 1].range_part.base)
                and T.independent(s, stmts[i + 1])
            ):
                nxt = stmts[i + 1]
                nb = T._rename_loopvar(list(nxt.body), nxt.valvar, s.valvar)
                nb = T._rename_loopvar(nb, nxt.range_part.part_var, s.range_part.part_var)
                out.append(ForValue(s.valvar, s.range_part, tuple(list(s.body) + nb)))
                fusions += 1
                i += 2
                continue
            if children(s):
                s = with_children(s, rewrite(children(s)))
            out.append(s)
            i += 1
        return out

    return program.with_body(rewrite(program.body)), fusions


def optimize_distribution(
    program: Program,
    db=None,
    congruences: Optional[Set[Congruence]] = None,
    sizes: Optional[Dict[str, int]] = None,
) -> Tuple[Program, DistributionReport]:
    """The §III-A4 pipeline: reorder statements so conflicting foralls become
    adjacent and fusible, apply Loop Fusion at the forall level, then (when a
    congruence witness exists) fuse the inner value loops too, so both
    aggregates use one partitioning and no redistribution happens."""
    congruences = set(congruences or ())
    if db is not None:
        # auto-discover congruences between conflicting partitionings
        for a, b in partition_conflicts(program):
            if a.kind == b.kind == "indirect" and a.field and b.field:
                try:
                    if verify_congruence(db, a.table, a.field, b.table, b.field):
                        congruences.add(frozenset({(a.table, a.field), (b.table, b.field)}))
                except Exception:
                    pass

    before = len(partition_conflicts(program, sizes))
    fused = T.loop_fusion(program, reorder=True)
    fused, n_inner = _fuse_forvalues_congruent(fused, congruences)
    fused = T.loop_fusion(fused, reorder=True)
    if congruences:
        # record the witnesses on the program so the lowering may treat the
        # congruent value ranges as interchangeable (full-scan) partitionings
        fused = dataclasses.replace(
            fused, congruences=tuple(set(fused.congruences) | congruences)
        )
    after = len(partition_conflicts(fused, sizes))

    avoided_bytes = 0
    if sizes:
        for a, _b in partition_conflicts(program, sizes)[: before - after]:
            avoided_bytes += sizes.get(a.table, 0)
    report = DistributionReport(before, after, n_inner, avoided_bytes)
    return fused, report


# ===========================================================================
# 2. Generic chain sharding solver (used by the LM launcher)
# ===========================================================================


@dataclass(frozen=True)
class ShardingOption:
    """One candidate distribution for a program stage: a mapping of the
    stage's logical tensor axes to mesh axes, plus a modeled per-step
    execution cost (collectives *inside* the stage, seconds)."""

    name: str
    assignment: Tuple[Tuple[str, Optional[str]], ...]  # logical axis -> mesh axis
    internal_cost: float = 0.0

    def as_dict(self) -> Dict[str, Optional[str]]:
        return dict(self.assignment)


@dataclass
class Stage:
    """A stage in the computation chain (a 'loop' in the paper's sense)."""

    name: str
    options: List[ShardingOption]
    # tensor volume (bytes) flowing from the previous stage into this one —
    # used to price a resharding if the boundary layouts differ.
    boundary_bytes: float = 0.0


def resharding_cost(prev: ShardingOption, cur: ShardingOption, boundary_bytes: float, link_bw: float) -> float:
    """If the boundary tensor's layout differs, it must be redistributed —
    modeled as an all-to-all of the boundary bytes over the slow link."""
    if prev.assignment == cur.assignment:
        return 0.0
    return boundary_bytes / max(link_bw, 1.0)


def solve_chain(stages: List[Stage], link_bw: float = 50e9) -> Tuple[List[ShardingOption], float]:
    """Viterbi DP over the stage chain minimizing Σ internal + resharding
    costs — the compile-time 'multiple data decompositions considered'
    (paper §III-A: 'allowing multiple data decompositions to be considered
    at compile time')."""
    if not stages:
        return [], 0.0
    # DP tables
    costs: List[List[float]] = [[opt.internal_cost for opt in stages[0].options]]
    back: List[List[int]] = [[-1] * len(stages[0].options)]
    for si in range(1, len(stages)):
        st = stages[si]
        row: List[float] = []
        brow: List[int] = []
        for oi, opt in enumerate(st.options):
            best, bidx = float("inf"), -1
            for pi, popt in enumerate(stages[si - 1].options):
                c = costs[si - 1][pi] + resharding_cost(popt, opt, st.boundary_bytes, link_bw) + opt.internal_cost
                if c < best:
                    best, bidx = c, pi
            row.append(best)
            brow.append(bidx)
        costs.append(row)
        back.append(brow)
    # backtrack
    last = int(np.argmin(costs[-1]))
    total = costs[-1][last]
    choice = [last]
    for si in range(len(stages) - 1, 0, -1):
        last = back[si][last]
        choice.append(last)
    choice.reverse()
    return [stages[i].options[choice[i]] for i in range(len(stages))], float(total)
