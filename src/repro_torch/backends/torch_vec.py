# Vectorized PyTorch executor backend: pattern-directed lowering of forelem
# programs to tensor code with selectable index-set materialization methods
# (the Fig. 1 'nested loop' vs 'hash table' choice becomes
# scatter/one-hot/sort/hand-written CUDA kernel) and selectable parallel
# execution of foralls (one program, or N row blocks reduced apart and
# merged).  The code runs eagerly on the device the choices name.
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.ir import (
    ArrayRead,
    BinOp,
    Const,
    Expr,
    FieldRef,
    Program,
    Var,
    apply_order_limit,
)
from repro_torch.data.multiset import Database, DictColumn

from repro_torch.kernels.segreduce import ops as segops
from repro_torch.kernels.segreduce.ref import ordered_reduce, ordered_scatter

from .codegen import (
    FUSABLE_AGG_OPS,
    DistinctReadSpec,
    JoinSpec,
    UnsupportedProgram,
    _densify,
    _op_identity,
    _torch_binop,
    cols_len_shape,
    extract_spec,
    fused_agg_groups,
    required_columns,
)
from .dtypes import column_tensor, const_dtype, scalar_sum, scalar_tensor
from .interface import register_backend

# engine accumulate-op spelling -> segreduce kernel spelling
_KERNEL_OPS = {"+": "sum", "max": "max", "min": "min"}


@dataclass
class CodegenChoices:
    """The Fig. 1 decision: how index sets are materialized and how foralls
    execute.

    agg_method: 'dense'   — scatter into a dense accumulator (requires
                             dictionary-encoded integer keys; the analogue
                             of the paper's hash table),
                'onehot'  — one-hot × values matrix product histogram,
                'sort'    — stable sort + segment reduction (tree-index
                             analogue),
                'kernel'  — the hand-written segreduce kernel (CUDA on the
                             card, its plain PyTorch version on the CPU).
    parallel:   'none'    — single-program,
                'vmap'    — N-way partitioned execution on one device: the
                             rows are cut into N blocks, each reduced on its
                             own, and the partials merged under the op.
                'shard_map' is the JAX package's SPMD mode over a device
                mesh; it has no counterpart here and raises.
    join_method: 'auto'   — unique-lookup when the build key is unique on
                             the actual data, expansion otherwise,
                'lookup'  — one searchsorted probe, one match per probe row
                             (requires a key-unique build side),
                'expand'  — stable sort + searchsorted(left/right) + gather
                             expansion to max key multiplicity (general
                             duplicate-key equi-join).
    device:     where the plan's tensors live ('cuda', 'cuda:1', 'cpu').
    """

    agg_method: str = "dense"
    parallel: str = "none"
    join_method: str = "auto"
    device: str = "cuda"


def _in_key_space(keys: torch.Tensor, num_keys: int) -> torch.Tensor:
    """Rows whose key lies in [0, num_keys).  XLA's segment ops and the
    segreduce kernel drop the others, so the JAX package's 'jax' backend
    returns no group for a negative key (its ReferenceInterpreter keeps
    those groups: 45 against 40 on keys drawn from [-5, 40)); every
    aggregation path here drops them too, masking before the scatter so
    that no out-of-range index reaches ``index_add_``."""
    return (keys >= 0) & (keys < num_keys)


def _segment_reduce(keys: torch.Tensor, values: torch.Tensor, num_keys: int, op: str) -> torch.Tensor:
    """XLA's segment_sum/max/min: a dense (num_keys,) table in the values'
    dtype, empty segments holding the op's identity, rows with a key
    outside [0, num_keys) dropped."""
    ident = _op_identity(op, values.dtype)
    out = torch.full((num_keys,), ident, dtype=values.dtype, device=values.device)
    inside = _in_key_space(keys, num_keys)
    idx = torch.where(inside, keys, 0).long()
    values = torch.where(inside, values, ident)
    if op == "+":
        return out.index_add_(0, idx, values)
    if op in ("max", "min"):  # -0.0 below +0.0, a NaN wins (kernels.segreduce.ref)
        return ordered_scatter(out, idx, values, op)
    raise UnsupportedProgram(op)


def _member(values: torch.Tensor, members: torch.Tensor) -> torch.Tensor:
    """``torch.isin(values, members)`` by a sort and a binary search, which
    never waits on the device (``isin`` may, to size a ``unique``), so a
    chunk kernel captured in a CUDA graph can hold it."""
    if members.shape[0] == 0:
        return torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    s = torch.sort(members).values
    pos = torch.clamp(torch.searchsorted(s, values), max=s.shape[0] - 1)
    return s[pos] == values


class TorchLowering:
    """Compile a forelem Program into a callable over column tensors."""

    def __init__(self, program: Program, db: Database, choices: Optional[CodegenChoices] = None):
        self.program = program
        self.db = db
        self.choices = choices or CodegenChoices()
        self.device = torch.device(self.choices.device)
        if self.choices.parallel == "shard_map":
            raise UnsupportedProgram(
                "parallel='shard_map' runs SPMD over a JAX device mesh; it has no "
                "counterpart on one GPU — use 'none' or 'vmap'"
            )
        self.spec = extract_spec(program)
        # Max build-side key multiplicity per join, from the actual data at
        # compile time.  It sizes the static gather-expansion (probe_rows ×
        # M output slots); M == 1 degenerates to the unique-lookup plan and
        # M == 0 marks an empty build side (all probes miss).
        self.join_multiplicity: List[int] = []
        for j in self.spec.joins:
            if j.build_table in db and len(db[j.build_table]):
                bk = np.asarray(db[j.build_table].field(j.build_key))
                _, counts = np.unique(bk, return_counts=True)
                mult = int(counts.max()) if len(counts) else 0
            else:
                mult = 0 if j.build_table in db else 1
            if self.choices.join_method == "lookup" and mult > 1:
                raise UnsupportedProgram(
                    f"join_method='lookup' but build side {j.build_table}.{j.build_key} "
                    "has duplicate keys — use 'expand' or 'auto'"
                )
            self.join_multiplicity.append(mult)
        # key-space sizes for dense accumulators (dictionary-encoded columns)
        self.num_keys: Dict[Tuple[str, str], int] = {}
        for agg in self.spec.aggs:
            self.num_keys[(agg.table, agg.key_field)] = self._key_space(agg.table, agg.key_field)
        for dr in self.spec.distinct_reads:
            self.num_keys[(dr.table, dr.field)] = self._key_space(dr.table, dr.field)
        for j in self.spec.joins:
            for ja in j.aggs:
                self.num_keys[(ja.key.table, ja.key.field)] = self._key_space(
                    ja.key.table, ja.key.field
                )
        # Fused-kernel groups: aggregates one fused segreduce launch
        # evaluates together under agg_method='kernel' (same table / GROUP-BY
        # key / row predicate, so they share one mask and presence pass).
        self.fused_groups: List[List[int]] = (
            fused_agg_groups(self.spec.aggs) if self.choices.agg_method == "kernel" else []
        )
        # Loud method fallbacks: when a requested agg_method cannot evaluate
        # an op, _aggregate downgrades that aggregate to 'dense' — the notes
        # here are surfaced by the optimizer into the trace and the
        # decision's rejections so the downgrade is never silent.
        self.method_notes: List[str] = []
        if self.choices.agg_method in ("onehot", "kernel"):
            supported = ("+",) if self.choices.agg_method == "onehot" else FUSABLE_AGG_OPS
            labelled = [
                (f"agg {a.array}[{a.table}.{a.key_field}]", a.op) for a in self.spec.aggs
            ] + [
                (f"join-agg {ja.array}[{ja.key.table}.{ja.key.field}]", ja.op)
                for j in self.spec.joins
                for ja in j.aggs
            ]
            for label, op in labelled:
                if op not in supported:
                    self.method_notes.append(
                        f"{label}: op {op!r} unsupported by "
                        f"agg_method={self.choices.agg_method!r} — "
                        "this aggregate falls back to 'dense'"
                    )

    def _key_space(self, table: str, fld: str) -> int:
        col = self.db[table].columns[fld]
        if isinstance(col, DictColumn):
            return col.num_keys
        vals = np.asarray(col.materialize())
        if vals.dtype == object:
            raise UnsupportedProgram(
                f"column {table}.{fld} holds strings — apply data reformatting "
                "(dictionary encoding) before lowering, or use the reference backend"
            )
        if not np.issubdtype(vals.dtype, np.integer):
            raise UnsupportedProgram(f"non-integer key column {table}.{fld}")
        num_keys = int(vals.max()) + 1 if len(vals) else 1
        if num_keys >= 2**31:
            # the tables are indexed by int32 keys; the JAX package raises
            # OverflowError here too, before any work
            raise OverflowError(
                f"key column {table}.{fld} holds {num_keys - 1}, beyond int32 group keys"
            )
        return num_keys

    def _scalar(self, value: Any) -> torch.Tensor:
        return scalar_tensor(value, self.device)

    # -- expression → tensors --------------------------------------------------
    def _vec(self, e: Expr, cols: Dict[str, Dict[str, torch.Tensor]], table: str, arrays: Dict[str, torch.Tensor]):
        if isinstance(e, Const):
            return self._scalar(e.value)
        if isinstance(e, Var):
            params = cols.get("__params__", {})
            if e.name in params:
                return params[e.name]
            raise UnsupportedProgram(f"free Var {e.name} in vectorized expr")
        if isinstance(e, FieldRef):
            return cols[e.table][e.field]
        if isinstance(e, ArrayRead):
            key = self._vec(e.key, cols, table, arrays)
            return arrays[e.array][key.long()]
        if isinstance(e, BinOp):
            l = self._vec(e.lhs, cols, table, arrays)
            r = self._vec(e.rhs, cols, table, arrays)
            return _torch_binop(e.op, l, r)
        raise UnsupportedProgram(f"cannot vectorize {e!r}")

    def _pred_mask(self, pred: Optional[Expr], cols, table) -> Optional[torch.Tensor]:
        if pred is None:
            return None
        # predicates use loopvar '_'
        return self._vec(pred, cols, table, {})

    # -- aggregation kernels ----------------------------------------------------
    def _aggregate(self, keys, values, num_keys: int, op: str):
        method = self.choices.agg_method
        # Per-op downgrades are recorded in self.method_notes (built at
        # lowering time) and surfaced by the optimizer — not silent.
        if op != "+" and method == "onehot":
            method = "dense"
        if op not in FUSABLE_AGG_OPS and method == "kernel":
            method = "dense"
        if method == "dense":
            return _segment_reduce(keys, values, num_keys, op)
        if method == "onehot":
            inside = _in_key_space(keys, num_keys)
            oh = F.one_hot(torch.where(inside, keys, 0).long(), num_keys).to(values.dtype)
            values = torch.where(inside, values, 0)
            if values.dtype.is_floating_point:
                return oh.T @ values
            # integer matrix products do not exist on CUDA: multiply and sum
            # in the values' own dtype (int32 wraps, as the reference's dot)
            return torch.sum(oh * values[:, None], dim=0, dtype=values.dtype)
        if method == "sort":
            order = torch.argsort(keys, stable=True)
            return _segment_reduce(keys[order], values[order], num_keys, op)
        if method == "kernel":
            return segops.segreduce(keys, values, num_keys, op=_KERNEL_OPS[op])
        raise ValueError(f"bad agg method {method}")

    # -- shared per-op input preparation ----------------------------------------
    #
    # These encapsulate the masking discipline (masked/padded rows must
    # contribute the op *identity*, funneled to key 0) so every aggregation
    # goes through one implementation.

    def _agg_value(self, value: Expr, keys, cols, table: str, arrays):
        if isinstance(value, Const):
            return torch.full(keys.shape, value.value, dtype=const_dtype(value.value), device=self.device)
        return torch.broadcast_to(self._vec(value, cols, table, arrays), keys.shape).contiguous()

    def _row_mask(self, agg, cols) -> Optional[torch.Tensor]:
        mask = self._pred_mask(agg.filter_pred, cols, agg.table)
        if agg.member_filter is not None:
            mf, mt, mfld = agg.member_filter
            member = _member(cols[agg.table][mf], cols[mt][mfld])
            mask = member if mask is None else (mask & member)
        return mask

    def agg_inputs(self, agg, cols, arrays):
        """(keys, values, presence-ones, mask) for one AggSpec over ``cols``."""
        keys = cols[agg.table][agg.key_field]
        values = self._agg_value(agg.value, keys, cols, agg.table, arrays)
        mask = self._row_mask(agg, cols)
        if mask is not None:
            # masked-out rows must contribute the op's *identity* —
            # funneling them into segment 0 with value 0 corrupts that
            # segment's max/min whenever its true extremum is beyond 0
            values = torch.where(mask, values, _op_identity(agg.op, values.dtype))
            keys = torch.where(mask, keys, 0)
        ones = torch.ones(keys.shape, dtype=torch.int32, device=self.device)
        if mask is not None:
            ones = torch.where(mask, ones, 0)
        return keys, values, ones, mask

    def fused_agg_inputs(self, aggs, cols, arrays):
        """(keys, value-column tuple, combined row mask) for a fused
        aggregate group (one entry of ``self.fused_groups``).  Unlike
        ``agg_inputs`` the mask is NOT pre-applied: the fused kernel
        evaluates it in-pass, giving masked rows each op's identity."""
        first = aggs[0]
        keys = cols[first.table][first.key_field]
        mask = self._row_mask(first, cols)
        if mask is not None:
            mask = torch.broadcast_to(mask, keys.shape).contiguous()
        values = tuple(self._agg_value(a.value, keys, cols, a.table, arrays) for a in aggs)
        return keys, values, mask

    def join_agg_inputs(self, ja, j: JoinSpec, jr: "_JoinRows", cols):
        """(keys, values, presence-ones) for one JoinAgg over the joined
        row pairs ``jr`` (absent slots contribute the op identity)."""
        keys = self._join_gather(ja.key, j, jr, cols)
        if isinstance(ja.value, Const):
            values = torch.full(
                keys.shape, ja.value.value, dtype=const_dtype(ja.value.value), device=self.device
            )
        else:
            values = torch.broadcast_to(self._join_gather(ja.value, j, jr, cols), keys.shape)
        values = torch.where(jr.present, values, _op_identity(ja.op, values.dtype))
        keys = torch.where(jr.present, keys, 0)
        ones = jr.present.to(torch.int32)
        return keys, values, ones

    # -- per-chunk kernel entry points (bucketed, captured) ------------------------
    #
    # The partitioned backend (backends/partitioned.py) pads each chunk's
    # row count up to a small geometric set of shape buckets and, on a CUDA
    # device, captures these functions in one CUDA graph per (kernel,
    # bucket): shapes are static per bucket, so one capture serves every
    # chunk that lands in the same bucket.  Rows at index >= ``n_valid`` are
    # padding; they contribute the accumulate op's *identity* (the masking
    # discipline above) so they can never perturb a segment, and padded
    # join/projection slots carry present=False.  ``n_valid`` is a 0-d int32
    # tensor on the plan's device, compared on the device, so a captured
    # graph reads each chunk's count instead of baking in the first one's.

    def _valid(self, m: int, n_valid: torch.Tensor) -> torch.Tensor:
        return torch.arange(m, dtype=torch.int32, device=self.device) < n_valid

    def chunk_agg_fn(self, agg, with_presence: bool = True) -> Callable:
        """(padded chunk cols, n_valid, env, arrays) -> (partial acc,
        presence partial or None).

        ``with_presence=False`` skips the presence histogram scatter — the
        partitioned runner passes it when the presence of an *unfiltered*
        aggregation is already memoized from a previous run (it is a pure
        function of the key column)."""
        nk = self.num_keys[(agg.table, agg.key_field)]

        def fn(chunk_cols, n_valid, env, arrays):
            cols = dict(env)
            cols[agg.table] = chunk_cols
            keys, values, ones, _ = self.agg_inputs(agg, cols, arrays)
            valid = self._valid(keys.shape[0], n_valid)
            keys = torch.where(valid, keys, 0)
            values = torch.where(valid, values, _op_identity(agg.op, values.dtype))
            acc = self._aggregate(keys, values, nk, agg.op)
            if not with_presence:
                return acc, None
            ones = torch.where(valid, ones, 0)
            return acc, self._aggregate(keys, ones, nk, "+")

        return fn

    def chunk_fused_agg_fn(self, aggs, with_presence: bool = True) -> Callable:
        """(padded chunk cols, n_valid, env, arrays) -> (tuple of partial
        accumulators — one per aggregate in the group, input dtypes
        preserved — and the presence partial or None).

        The fused variant of ``chunk_agg_fn``: the whole aggregate group
        runs in ONE fused segreduce launch per chunk (filter mask, padding
        mask and every accumulator in a single data pass); the partitioned
        runner merges the multi-accumulator state across chunks element-wise
        under each aggregate's own op."""
        first = aggs[0]
        nk = self.num_keys[(first.table, first.key_field)]
        ops = tuple(_KERNEL_OPS[a.op] for a in aggs)

        def fn(chunk_cols, n_valid, env, arrays):
            cols = dict(env)
            cols[first.table] = chunk_cols
            keys, values, mask = self.fused_agg_inputs(aggs, cols, arrays)
            valid = self._valid(keys.shape[0], n_valid)
            mask = valid if mask is None else (mask & valid)
            return segops.fused_segreduce(keys, values, ops, nk, mask=mask, with_presence=with_presence)

        return fn

    def chunk_reduce_fn(self, sr) -> Callable:
        """(padded chunk cols, n_valid, env, arrays) -> partial scalar sum."""

        def fn(chunk_cols, n_valid, env, arrays):
            cols = dict(env)
            cols[sr.table] = chunk_cols
            m = cols_len_shape(cols, sr.table)[0]
            expr = self._vec(sr.expr, cols, sr.table, arrays)
            mask = self._valid(m, n_valid)
            if sr.match_field is not None:
                mv = sr.match_value
                mval = self._scalar(mv.value) if isinstance(mv, Const) else cols["__params__"][mv.name]
                mask = mask & (cols[sr.table][sr.match_field] == mval)
            pmask = self._pred_mask(sr.filter_pred, cols, sr.table)
            if pmask is not None:
                mask = mask & pmask
            vals = torch.broadcast_to(expr, (m,))
            return scalar_sum(torch.where(mask, vals, 0))

        return fn

    def chunk_project_fn(self, fp) -> Callable:
        """(padded chunk cols, n_valid, env) -> (item columns, present mask)."""

        def fn(chunk_cols, n_valid, env):
            cols = dict(env)
            cols[fp.table] = chunk_cols
            m = cols_len_shape(cols, fp.table)[0]
            mask = self._pred_mask(fp.filter_pred, cols, fp.table)
            valid = self._valid(m, n_valid)
            mask = valid if mask is None else (mask & valid)
            items = tuple(
                torch.broadcast_to(self._vec(el, cols, fp.table, {}), (m,)).contiguous()
                for el in fp.items
            )
            return items, mask

        return fn

    def chunk_join_fn(self, j: JoinSpec, mult: int, with_presence: bool = True) -> Callable:
        """(padded probe cols, n_valid_probe, sorted+padded build cols,
        sorted build keys, n_valid_build, env) -> join-agg partials (one
        (acc, presence-or-None) pair per JoinAgg), or (item columns,
        present, probe_idx) for a materialized join.

        The build side arrives already gathered into sorted-key order (the
        host sorts once per partition), so the ``order`` mapping is the
        identity.  ``with_presence=False`` skips the group-presence
        scatters (memoized across runs for filter-free joins, exactly like
        the single-table aggregation presence)."""

        def fn(probe_cols, n_valid_probe, build_cols, sorted_keys, n_valid_build, env):
            cols = dict(env)
            cols[j.probe_table] = probe_cols
            cols[j.build_table] = build_cols
            ident = torch.arange(sorted_keys.shape[0], device=self.device)
            jr = self._join_rows(
                j, mult, cols, build_sorted=(ident, sorted_keys), n_valid_build=n_valid_build
            )
            n = cols_len_shape(cols, j.probe_table)[0]
            valid = self._valid(n, n_valid_probe)
            jr.present = jr.present & (valid if jr.probe_idx is None else valid[jr.probe_idx])
            if j.aggs:
                outs = []
                for ja in j.aggs:
                    nk = self.num_keys[(ja.key.table, ja.key.field)]
                    keys, values, ones = self.join_agg_inputs(ja, j, jr, cols)
                    outs.append(
                        (
                            self._aggregate(keys, values, nk, ja.op),
                            self._aggregate(keys, ones, nk, "+") if with_presence else None,
                        )
                    )
                return tuple(outs)
            items = tuple(
                torch.broadcast_to(self._join_gather(el, j, jr, cols), jr.present.shape).contiguous()
                for el in j.items
            )
            return items, jr.present, jr.probe_idx

        return fn

    # -- build the callable -------------------------------------------------------
    def build(self) -> Callable[[Dict[str, Dict[str, torch.Tensor]]], Dict[str, Any]]:
        spec = self.spec

        def run(cols: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Any]:
            arrays: Dict[str, torch.Tensor] = {}
            presence: Dict[Tuple[str, str], torch.Tensor] = {}
            out: Dict[str, Any] = {}

            # --- aggregations ------------------------------------------------
            # Under agg_method='kernel' (sequential), each fused group runs
            # as ONE fused segreduce launch — mask, every accumulator and
            # the presence histogram in a single data pass — at the position
            # of its first member; everything else keeps the per-aggregate
            # path (vmap partials merge per-op downstream).
            fused_at: Dict[int, List[int]] = {}
            if self.fused_groups and self.choices.parallel == "none":
                fused_at = {g[0]: g for g in self.fused_groups}
            fused_members = {i for g in fused_at.values() for i in g}
            for ai, agg in enumerate(spec.aggs):
                nk = self.num_keys[(agg.table, agg.key_field)]
                group = fused_at.get(ai)
                if group is not None:
                    gaggs = [spec.aggs[i] for i in group]
                    keys, values, mask = self.fused_agg_inputs(gaggs, cols, arrays)
                    accs, pres = segops.fused_segreduce(
                        keys, values, tuple(_KERNEL_OPS[a.op] for a in gaggs), nk, mask=mask
                    )
                    for a, acc in zip(gaggs, accs):
                        arrays[a.array] = acc
                    presence[(agg.table, agg.key_field)] = pres
                    continue
                if ai in fused_members:
                    continue  # evaluated with its group above
                safe_keys, values, ones, mask = self.agg_inputs(agg, cols, arrays)
                arrays[agg.array] = self._parallel_aggregate(safe_keys, values, nk, agg.op)
                presence[(agg.table, agg.key_field)] = self._parallel_aggregate(safe_keys, ones, nk, "+")

            # --- joins (unique-lookup or duplicate-key expansion) -------------
            # Before distinct reads: join-aggregates fill `arrays`/`presence`
            # that the guarded distinct-read result loops consume.
            for j, mult in zip(spec.joins, self.join_multiplicity):
                jr = self._join_rows(j, mult, cols)
                if j.aggs:
                    for ja in j.aggs:
                        nk = self.num_keys[(ja.key.table, ja.key.field)]
                        safe_keys, values, ones = self.join_agg_inputs(ja, j, jr, cols)
                        arrays[ja.array] = self._aggregate(safe_keys, values, nk, ja.op)
                        presence[(ja.key.table, ja.key.field)] = self._aggregate(
                            safe_keys, ones, nk, "+"
                        )
                else:
                    items = tuple(self._join_gather(el, j, jr, cols) for el in j.items)
                    out[j.result] = {"columns": items, "present": jr.present}

            # --- scalar reductions -------------------------------------------
            for sr in spec.scalar_reduces:
                expr = self._vec(sr.expr, cols, sr.table, arrays)
                mask = None
                if sr.match_field is not None:
                    mv = sr.match_value
                    if isinstance(mv, Const):
                        mval = self._scalar(mv.value)
                    elif isinstance(mv, Var):
                        mval = cols["__params__"][mv.name]
                    else:
                        raise UnsupportedProgram(f"match value {mv!r}")
                    mask = cols[sr.table][sr.match_field] == mval
                pmask = self._pred_mask(sr.filter_pred, cols, sr.table)
                if pmask is not None:
                    mask = pmask if mask is None else (mask & pmask)
                vals = torch.broadcast_to(expr, cols_len_shape(cols, sr.table))
                if mask is not None:
                    vals = torch.where(mask, vals, 0)
                out[sr.var] = scalar_sum(vals)

            # --- distinct reads (group-by result construction) -----------------
            for dr in spec.distinct_reads:
                nk = self.num_keys[(dr.table, dr.field)]
                pres = presence.get((dr.table, dr.field))
                if pres is None:
                    keys = cols[dr.table][dr.field]
                    ones = torch.ones(keys.shape, dtype=torch.int32, device=self.device)
                    pres = _segment_reduce(keys, ones, nk, "+")
                key_ids = torch.arange(nk, dtype=torch.int32, device=self.device)
                items = []
                for el in dr.items:
                    items.append(self._vec_distinct(el, dr, key_ids, arrays, cols))
                present = pres > 0
                if dr.filter_pred is not None:
                    guard = self._vec_distinct(dr.filter_pred, dr, key_ids, arrays, cols)
                    present = present & guard.to(torch.bool)
                out[dr.result] = {"columns": tuple(items), "present": present}

            # --- filter/project -------------------------------------------------
            for fp in spec.filter_projects:
                mask = self._pred_mask(fp.filter_pred, cols, fp.table)
                items = tuple(self._vec(el, cols, fp.table, arrays) for el in fp.items)
                n = cols_len_shape(cols, fp.table)[0]
                if mask is None:
                    mask = torch.ones((n,), dtype=torch.bool, device=self.device)
                out[fp.result] = {"columns": items, "present": mask}

            return out

        return run

    # distinct-read item: FieldRef(table,i,field) -> key ids;
    # ArrayRead(arr, FieldRef(...field)) -> arrays[arr][key_ids]
    def _vec_distinct(self, e: Expr, dr: DistinctReadSpec, key_ids, arrays, cols):
        if isinstance(e, FieldRef):
            if e.field == dr.field:
                return key_ids
            raise UnsupportedProgram("distinct read of a non-key field")
        if isinstance(e, ArrayRead):
            return arrays[e.array][self._vec_distinct(e.key, dr, key_ids, arrays, cols).long()]
        if isinstance(e, BinOp):
            return _torch_binop(
                e.op,
                self._vec_distinct(e.lhs, dr, key_ids, arrays, cols),
                self._vec_distinct(e.rhs, dr, key_ids, arrays, cols),
            )
        if isinstance(e, Const):
            return self._scalar(e.value)
        raise UnsupportedProgram(f"distinct item {e!r}")

    # -- parallel aggregation (the forall execution strategies) -----------------
    def _parallel_aggregate(self, keys, values, nk: int, op: str):
        if self.choices.parallel == "none" or self.spec.n_parts <= 1:
            return self._aggregate(keys, values, nk, op)
        if self.choices.parallel != "vmap":
            raise ValueError(f"bad parallel {self.choices.parallel}")
        n = self.spec.n_parts
        pad = (-len(keys)) % n
        if pad:
            keys = torch.cat([keys, torch.zeros((pad,), dtype=keys.dtype, device=keys.device)])
            # pad with the op identity, not 0 — a padded 0 lands in segment 0
            # and corrupts its max/min exactly like an unmasked filtered row
            fill = torch.full((pad,), _op_identity(op, values.dtype), dtype=values.dtype, device=values.device)
            values = torch.cat([values, fill])
        # N row blocks, each reduced on its own, then merged under the op
        partials = torch.stack(
            [self._aggregate(k, v, nk, op) for k, v in zip(keys.reshape(n, -1), values.reshape(n, -1))]
        )
        if op == "+":
            return partials.sum(0, dtype=partials.dtype)
        return ordered_reduce(partials, 0, op)

    # -- equi-join engine --------------------------------------------------------
    #
    # The build side is sorted once (stably, so matches keep build-row
    # order); probes binary-search it.  With a key-unique build side one
    # searchsorted gives the single candidate row ('lookup').  With
    # duplicate keys the [left, right) searchsorted pair bounds each probe's
    # match run, and the output is expanded to the static shape
    # (probe_rows × M) where M is the max key multiplicity measured at
    # compile time ('expand'); absent slots are masked out.

    def _join_rows(
        self, j: JoinSpec, mult: int, cols, build_sorted=None, n_valid_build=None
    ) -> "_JoinRows":
        """``build_sorted`` is an optional precomputed ``(order, sorted_keys)``
        of the build side in ``cols`` — chunked executors that probe the same
        build partition many times pass it to sort once per partition.

        ``n_valid_build`` (a 0-d tensor) marks the build side as *padded*:
        only the first ``n_valid_build`` sorted rows are real (the rest carry
        a maximal key sentinel), so match runs are clipped to it.  Padding
        sorts to the end, which keeps every real match run inside the valid
        prefix even when real keys equal the sentinel value."""
        bk = cols[j.build_table][j.build_key]
        pk = cols[j.probe_table][j.probe_fk]
        n_probe = pk.shape[0]
        pmask = self._pred_mask(j.probe_filter, cols, j.probe_table)
        if bk.shape[0] == 0 or mult == 0:
            # empty build side: every probe misses (never index into the
            # zero-length build columns)
            return _JoinRows(
                None,
                torch.zeros((n_probe,), dtype=torch.int32, device=self.device),
                torch.zeros((n_probe,), dtype=torch.bool, device=self.device),
                True,
            )
        if build_sorted is not None:
            order, sk = build_sorted
        else:
            order = torch.argsort(bk, stable=True)
            sk = bk[order]
        expand = self.choices.join_method == "expand" or mult > 1
        if not expand:
            pos = torch.clip(torch.searchsorted(sk, pk), 0, sk.shape[0] - 1)
            present = sk[pos] == pk
            if n_valid_build is not None:
                present = present & (pos < n_valid_build)
            if pmask is not None:
                present = present & pmask
            return _JoinRows(None, order[pos], present, False)
        lo = torch.searchsorted(sk, pk, side="left")
        hi = torch.searchsorted(sk, pk, side="right")
        if n_valid_build is not None:
            lo = torch.minimum(lo, n_valid_build)
            hi = torch.minimum(hi, n_valid_build)
        counts = hi - lo
        slots = torch.arange(mult, device=self.device)
        pos = torch.clip(lo[:, None] + slots[None, :], 0, sk.shape[0] - 1)  # (n_probe, M)
        present = slots[None, :] < counts[:, None]
        if pmask is not None:
            present = present & pmask[:, None]
        probe_idx = torch.arange(n_probe, device=self.device)[:, None].expand(n_probe, mult).reshape(-1)
        return _JoinRows(probe_idx, order[pos.reshape(-1)], present.reshape(-1), False)

    def _join_gather(self, e: Expr, j: JoinSpec, jr: "_JoinRows", cols):
        """Vectorize an expression over the joined (probe, build) row pairs."""
        if isinstance(e, FieldRef):
            if e.loopvar == j.probe_var:
                col = cols[j.probe_table][e.field]
                return col if jr.probe_idx is None else col[jr.probe_idx]
            if e.loopvar == j.build_var:
                col = cols[j.build_table][e.field]
                if jr.empty_build:
                    col = torch.zeros((1,), dtype=col.dtype, device=self.device)
                return col[jr.build_rows]
            raise UnsupportedProgram(f"join item var {e.loopvar}")
        if isinstance(e, Const):
            return self._scalar(e.value)
        if isinstance(e, Var):
            params = cols.get("__params__", {})
            if e.name in params:
                return params[e.name]
            raise UnsupportedProgram(f"free Var {e.name} in join expr")
        if isinstance(e, BinOp):
            return _torch_binop(
                e.op, self._join_gather(e.lhs, j, jr, cols), self._join_gather(e.rhs, j, jr, cols)
            )
        raise UnsupportedProgram(f"join item {e!r}")


@dataclass
class _JoinRows:
    """Row pairing produced by the join engine, in static (padded) shape.

    probe_idx is None when output slots align 1:1 with probe rows (lookup
    path / empty build); otherwise it gathers the probe side into the
    expanded (probe_rows × M) slot space."""

    probe_idx: Optional[torch.Tensor]
    build_rows: torch.Tensor
    present: torch.Tensor
    empty_build: bool


# ===========================================================================
# Plan — user-facing compiled program
# ===========================================================================


class Plan:
    """A compiled forelem program.  ``run(params)`` executes on the bound
    Database and densifies multiset results back to Python tuples (for
    comparison with the reference interpreter); ``fn`` is the raw callable
    over column tensors.

    The input columns are copied to the plan's device once, at the first
    run, and kept there: a plan is bound to one stats epoch, and a Session
    compiles a new plan when its data changes."""

    def __init__(self, program: Program, db: Database, choices: Optional[CodegenChoices] = None):
        self.program = program
        self.db = db
        self.lowering = TorchLowering(program, db, choices)
        self.device = self.lowering.device
        self.fn = self.lowering.build()
        # (table, field) -> (host column object, its device tensor)
        self._resident: Dict[Tuple[str, str], Tuple[Any, torch.Tensor]] = {}

    def input_columns(self) -> Dict[str, Dict[str, torch.Tensor]]:
        cols: Dict[str, Dict[str, torch.Tensor]] = {}
        needed = required_columns(self.program, self.lowering.spec)
        for t, fields in needed.items():
            if t not in self.db:
                continue
            ms = self.db[t]
            cols[t] = {}
            for f in fields:
                if f not in ms.columns:
                    continue
                host = ms.columns[f]
                held = self._resident.get((t, f))
                if held is None or held[0] is not host:
                    held = (host, column_tensor(ms.field(f), self.device))
                    self._resident[(t, f)] = held
                cols[t][f] = held[1]
        return cols

    def _inputs(self, params: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        cols: Dict[str, Any] = self.input_columns()
        if params:
            cols["__params__"] = {k: scalar_tensor(v, self.device) for k, v in params.items()}
        return cols

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(
        self, params: Optional[Dict[str, Any]] = None, *, tracer: Any = None
    ) -> Dict[str, Any]:
        if tracer is None or not tracer.enabled:
            raw = self.fn(self._inputs(params))
            out = {k: _densify(v) for k, v in raw.items() if k in self.program.results}
            return apply_order_limit(self.program, out)
        with tracer.span("torch.upload"):
            cols = self._inputs(params)
            self._sync()
        with tracer.span("torch.compute"):
            raw = self.fn(cols)
            self._sync()  # traced runs attribute device time here
        with tracer.span("densify"):
            out = {k: _densify(v) for k, v in raw.items() if k in self.program.results}
            return apply_order_limit(self.program, out)


class TorchBackend:
    """The default production backend: vectorized PyTorch execution with
    the full ``CodegenChoices`` strategy space."""

    name = "torch"

    def compile(self, program: Program, db: Database, choices: Optional[CodegenChoices] = None) -> Plan:
        return Plan(program, db, choices)


register_backend(TorchBackend())
