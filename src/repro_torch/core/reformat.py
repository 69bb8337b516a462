# Automatic data reformatting (paper §III-C1): "the compiler is equipped
# with tools ... to automatically generate new data structures to store
# re-formatted data for optimized future processing."
#
# The planner inspects the *program* (Def-Use over table fields) and the
# *data* (column encodings) and emits a reformat plan:
#   - dictionary-encode string key columns ("integer keyed" in Fig. 2),
#   - prune fields the program never reads ("removing unused structure
#     fields"),
#   - compress arithmetic-progression columns to range descriptions,
# amortized against an estimated reuse count (the paper: "if the data is
# going to be processed multiple times in the future, it will pay off").
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


from repro_torch.data.multiset import CompressedRangeColumn, Database, PlainColumn
from .ir import Program, tables_read


@dataclass
class ReformatAction:
    table: str
    action: str  # 'dict_encode' | 'prune' | 'compress_range'
    fields: Tuple[str, ...]
    bytes_before: int
    bytes_after: int


@dataclass
class ReformatPlan:
    actions: List[ReformatAction]
    # one-off cost (bytes moved) vs per-run benefit (bytes saved per scan)
    oneoff_bytes: int
    per_run_bytes_saved: int

    def worthwhile(self, expected_runs: int) -> bool:
        """Paper: 'Reformatting all data for a small optimization is
        prohibitively expensive ... if the data is going to be processed
        multiple times in the future, it will pay off.'"""
        return self.per_run_bytes_saved * expected_runs > self.oneoff_bytes


def plan_reformat(program: Program, db: Database) -> ReformatPlan:
    used = tables_read(program.body)
    actions: List[ReformatAction] = []
    oneoff = 0
    saved = 0
    for tname, ms in db.tables.items():
        fields_used = used.get(tname, set())
        if not fields_used:
            continue
        # 1. prune dead fields
        dead = [f for f in ms.field_names() if f not in fields_used]
        if dead:
            b0 = ms.nbytes
            pruned = ms.reformat_prune([f for f in ms.field_names() if f in fields_used])
            actions.append(ReformatAction(tname, "prune", tuple(dead), b0, pruned.nbytes))
            saved += b0 - pruned.nbytes
        # 2. dictionary-encode object (string) columns that are used
        enc_fields = [
            f
            for f in fields_used
            if f in ms.columns
            and isinstance(ms.columns[f], PlainColumn)
            and (ms.columns[f].values.dtype == object or ms.columns[f].values.dtype.kind in "US")
        ]
        if enc_fields:
            b0 = sum(ms.columns[f].nbytes for f in enc_fields)
            enc = ms.reformat_dict_encode(enc_fields)
            b1 = sum(enc.columns[f].nbytes for f in enc_fields)
            actions.append(ReformatAction(tname, "dict_encode", tuple(enc_fields), b0, b1))
            oneoff += b0  # one full scan to build the dictionary
            saved += max(0, b0 - b1)
        # 3. compress range columns
        rng_fields = []
        b0 = b1 = 0
        comp = ms.reformat_compress_ranges()
        for f in fields_used:
            if f in comp.columns and isinstance(comp.columns[f], CompressedRangeColumn) and not isinstance(
                ms.columns[f], CompressedRangeColumn
            ):
                rng_fields.append(f)
                b0 += ms.columns[f].nbytes
                b1 += comp.columns[f].nbytes
        if rng_fields:
            actions.append(ReformatAction(tname, "compress_range", tuple(rng_fields), b0, b1))
            saved += b0 - b1
    return ReformatPlan(actions, oneoff, saved)


def apply_reformat(
    plan: ReformatPlan,
    db: Database,
    include: Tuple[str, ...] = ("prune", "dict_encode", "compress_range"),
) -> Database:
    # carry the owner's epoch salt: reformatting must not silently rewind
    # the stats epoch of a database whose owner bumped it
    out = Database(epoch_salt=getattr(db, "_epoch_salt", 0))
    for tname, ms in db.tables.items():
        cur = ms
        for a in plan.actions:
            if a.table != tname or a.action not in include:
                continue
            if a.action == "prune":
                keep = [f for f in cur.field_names() if f not in a.fields]
                cur = cur.reformat_prune(keep)
            elif a.action == "dict_encode":
                cur = cur.reformat_dict_encode(a.fields)
            elif a.action == "compress_range":
                cur = cur.reformat_compress_ranges()
        out.add(cur)
    return out


def auto_reformat(
    program: Program, db: Database, expected_runs: int = 10, persist_prune: bool = False
) -> Tuple[Database, ReformatPlan]:
    """One-call planner+applier with the amortization gate.

    Pruning is reported in the plan but NOT persisted by default: the
    planner only sees *this* program's Def-Use, while the database may
    serve later queries that read the other fields (the paper's session
    model).  Callers that own the full workload pass persist_prune=True."""
    plan = plan_reformat(program, db)
    if plan.worthwhile(expected_runs):
        include = ("prune", "dict_encode", "compress_range") if persist_prune else (
            "dict_encode", "compress_range")
        return apply_reformat(plan, db, include), plan
    return db, plan
