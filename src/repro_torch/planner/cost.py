# Cost model over the lowering's real strategy space (backends/torch_vec.py):
#
#   * index-set materialization for aggregations ("agg_method"):
#       dense   — scatter into a dense accumulator,
#       onehot  — one-hot × values matrix product (rows × keys work!),
#       sort    — stable argsort + sorted segment reduction,
#       kernel  — the segreduce kernel: hand-written CUDA on the card, its
#                 plain PyTorch version on the CPU — the device term below
#                 prices whichever of the two the plan will run,
#   * parallel execution of foralls: none / vmap,
#   * partition-field choice for indirect partitioning (skew-aware).
#
# Units are abstract "element-ops" (1.0 ≈ one streaming element visit).
# The coefficients are the JAX package's, which were fitted on its CPU
# backend; ``calibrate()`` re-measures the aggregation ones with torch ops
# on a given device.
from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.backends import FUSABLE_AGG_OPS, JoinSpec, ProgramSpec, fused_agg_groups

from .cardinality import CardinalityEstimator
from .feedback import ObservedProfile
from .stats import DbStats


@dataclass(frozen=True)
class CostCoefficients:
    c_scan: float = 1.0          # stream one element (mask eval, projection)
    c_dense: float = 2.5         # scatter-add per element
    c_onehot: float = 0.08       # per cell of the rows×keys one-hot matmul
    c_sort: float = 1.2          # per element per log2(rows) of argsort
    c_kernel: float = 2.0        # per element inside the compiled kernel
    c_kernel_fallback: float = 2.2     # ... in its plain version (CPU)
    c_kernel_fixed: float = 2e4  # kernel launch / trace overhead
    c_kernel_agg: float = 0.7    # per element per EXTRA fused aggregate —
    #                              another accumulator update inside the one
    #                              pass, not another pass over the data
    c_combine: float = 1.5       # per accumulator cell when merging partials
    c_shard_fixed: float = 5e4   # shard_map trace/collective setup
    c_join_probe: float = 3.0    # searchsorted probe per row
    c_output: float = 1.0        # materializing one output cell
    # -- partitioned execution (backends/partitioned.py) --------------------
    # Re-calibrated for the bucketed-jit + async runtime: a dispatch is one
    # jitted kernel call pulled by a pooled worker (was 6e3 when every
    # chunk ran ~30 eager jnp ops serially); the XLA compile is paid once
    # per (kernel, shape bucket) and amortizes across a plan's lifetime.
    c_part_launch: float = 1.2e3   # per-chunk dispatch of a jitted chunk kernel
    c_part_compile: float = 2.5e4  # one-time compile per (kernel, shape bucket)
    c_mem_rows: float = 1e6      # rows whose working set fits device memory
    c_mem_penalty: float = 4.0   # per element beyond c_mem_rows (spill/paging)


def default_coefficients(backend: Optional[str] = None) -> CostCoefficients:
    return CostCoefficients()


class CostModel:
    """Costs an extracted ``ProgramSpec`` under concrete codegen choices."""

    def __init__(
        self,
        stats: DbStats,
        coeffs: Optional[CostCoefficients] = None,
        device: str = "cuda",
        profile: Optional[ObservedProfile] = None,
    ):
        self.stats = stats
        self.coeffs = coeffs or default_coefficients()
        self.device = str(device)
        self.profile = profile
        self.est = CardinalityEstimator(stats, profile)

    # -- aggregation --------------------------------------------------------
    def _kernel_per_elem(self) -> float:
        """Per-element cost of the segreduce kernel path as the plan will run
        it (kernels/segreduce/ops.py): the CUDA kernel for a CUDA device, the
        plain PyTorch version on the CPU."""
        c = self.coeffs
        if self.device.startswith("cuda"):
            return c.c_kernel
        return c.c_kernel_fallback

    def agg_cost(self, rows: float, num_keys: float, method: str, op: str) -> float:
        c = self.coeffs
        # These downgrades mirror torch_vec._aggregate exactly (and the
        # lowering records them in method_notes): cost what actually runs.
        if op != "+" and method == "onehot":
            method = "dense"
        if op not in FUSABLE_AGG_OPS and method == "kernel":
            method = "dense"
        if method == "dense":
            return rows * c.c_dense + num_keys * c.c_output
        if method == "onehot":
            return rows * num_keys * c.c_onehot + num_keys * c.c_output
        if method == "sort":
            return rows * c.c_sort * max(1.0, math.log2(max(2.0, rows))) + rows * c.c_dense
        if method == "kernel":
            return c.c_kernel_fixed + rows * self._kernel_per_elem() + num_keys * c.c_output
        raise ValueError(f"bad agg method {method}")

    def fused_agg_cost(self, rows: float, num_keys: float, n_aggs: int) -> float:
        """One fused kernel launch evaluating ``n_aggs`` accumulators plus
        presence in a SINGLE data pass: one launch fee and one streaming
        scan are amortized over the whole group — each extra aggregate
        adds only an in-pass accumulator update (c_kernel_agg), not
        another pass — versus n_aggs full launches+scans unfused."""
        c = self.coeffs
        return (
            c.c_kernel_fixed
            + rows * self._kernel_per_elem()
            + rows * max(0, n_aggs - 1) * c.c_kernel_agg
            + n_aggs * num_keys * c.c_output
        )

    def agg_units(self, spec: ProgramSpec, agg_method: str) -> List[Tuple[bool, List[int]]]:
        """Aggregation costing units, (is_fused, agg indices): under
        'kernel' each fused group (backends.codegen.fused_agg_groups — the
        same partition the lowering executes) is ONE unit costed by
        ``fused_agg_cost``; everything else is per-aggregate."""
        if agg_method == "kernel":
            groups = fused_agg_groups(spec.aggs)
            cover = {i for g in groups for i in g}
            units = [(True, g) for g in groups] + [
                (False, [i]) for i in range(len(spec.aggs)) if i not in cover
            ]
            units.sort(key=lambda u: u[1][0])
            return units
        return [(False, [i]) for i in range(len(spec.aggs))]

    def parallel_cost(
        self, base_cost: float, rows: float, num_keys: float, parallel: str, n_parts: int
    ) -> float:
        """Cost of executing an aggregation under a forall strategy."""
        c = self.coeffs
        if parallel == "none" or n_parts <= 1:
            return base_cost
        # per-partition work is ~1/n of the rows term but every partition
        # pays the full key-space combine; on a single device (vmap) the
        # partition work is emulated, not truly parallel.
        combine = n_parts * num_keys * c.c_combine
        if parallel == "vmap":
            return base_cost + combine
        if parallel == "shard_map":
            speedup = max(1, n_parts)
            return base_cost / speedup + combine + c.c_shard_fixed
        raise ValueError(f"bad parallel {parallel}")

    # -- partitioned execution ----------------------------------------------
    def memory_penalty(self, resident_rows: float) -> float:
        """Penalty for a working set exceeding device memory: monolithic
        execution keeps every row resident; partitioned execution only one
        chunk (≈ rows / K), which is what makes larger-than-memory tables a
        *costed* reason to partition."""
        c = self.coeffs
        return max(0.0, resident_rows - c.c_mem_rows) * c.c_mem_penalty

    def est_chunks(self, schedule: str, n_partitions: int, rows: float) -> float:
        """Expected dispatch count of a schedule policy over K partitions
        (sched/loop_schedule.py): static pre-blocks ≈ one chunk per
        partition; fixed uses rows/(8K)-sized chunks; guided (GSS) starts at
        remaining/K and decays geometrically."""
        if rows <= 0:
            return 0.0
        K = max(1, n_partitions)
        if schedule == "fixed":
            return 8.0 * K
        if schedule in ("guided", "gss"):
            return max(float(K), K * math.log2(max(2.0, rows / K)))
        if schedule == "static":
            return float(K)
        raise ValueError(f"unknown schedule {schedule!r}")

    def est_buckets(self, schedule: str, n_partitions: int, rows: float) -> float:
        """Distinct shape buckets a schedule's chunk sizes touch — each one
        costs one XLA compile (backends/partitioned.py pads chunks to a
        geometric bucket set).  Static and fixed produce (nearly) equal
        chunk sizes → one bucket; guided's geometrically decaying sizes
        cross ~log2(rows/K) buckets."""
        if rows <= 0:
            return 0.0
        if schedule in ("guided", "gss"):
            return 1.0 + math.log2(max(2.0, rows / max(1, n_partitions)))
        return 1.0

    def _compile_discount(self) -> float:
        """Scale on the per-bucket compile term when a feedback profile
        reports the jit cache's measured hit rate: a plan whose buckets are
        already compiled (hit rate → 1) pays almost no compile cost on the
        next run, so re-planning should not over-penalize bucket-rich
        schedules that are in fact warm."""
        if self.profile is None:
            return 1.0
        return max(0.1, 1.0 - float(self.profile.jit_hit_rate))

    def _compile_cost(self, schedule: str, n_partitions: int, rows: float) -> float:
        return (
            self.est_buckets(schedule, n_partitions, rows)
            * self.coeffs.c_part_compile
            * self._compile_discount()
        )

    def partition_skew(
        self, table: str, partition_field: Optional[Tuple[str, str]], n_partitions: int, schedule: str
    ) -> float:
        """Hash-partitioning on a skewed field leaves one partition with
        most of the rows.  A static schedule dispatches it as one block
        (full skew penalty); the self-scheduling policies break it into
        shrinking chunks that rebalance, retaining only a fraction of it.

        With a feedback profile the *measured* max/mean row ratio replaces
        the stats-derived estimate: the observed ratio directly bounds the
        static-schedule makespan inflation (the heaviest partition runs
        obs× the even share), clamped at K (perfect serialization)."""
        base = None
        if self.profile is not None and partition_field is not None:
            obs = self.profile.row_skew.get(f"{partition_field[0]}.{partition_field[1]}")
            if obs is not None:
                base = 1.0 + min(float(n_partitions) - 1.0, max(0.0, float(obs) - 1.0))
        if base is None:
            base = self._skew_penalty(table, partition_field, "partitioned", n_partitions)
        if schedule == "static":
            return base
        # self-scheduling re-chunks the heavy partition into shrinking
        # pieces, so most of the imbalance is recovered (§III-A2)
        return 1.0 + (base - 1.0) * 0.15

    def spec_cost_partitioned(
        self,
        spec: ProgramSpec,
        agg_method: str,
        n_partitions: int,
        schedule: str,
        partition_field: Optional[Tuple[str, str]] = None,
        join_method: str = "auto",
    ) -> Tuple[float, List[Tuple[str, float]]]:
        """Cost of executing the spec on the partitioned backend: the same
        per-operator kernel work as the monolithic plan, plus the shuffle
        pass, per-chunk launch overhead and per-chunk accumulator combine —
        against the bounded per-chunk working set (memory penalty on
        rows/K instead of rows)."""
        c = self.coeffs
        K = max(1, n_partitions)
        breakdown: List[Tuple[str, float]] = []

        for fused, idxs in self.agg_units(spec, agg_method):
            aggs = [spec.aggs[i] for i in idxs]
            agg = aggs[0]
            rows = float(self.stats.n_rows(agg.table))
            nk = float(self.stats.key_space(agg.table, agg.key_field))
            if fused:
                # one chunk-kernel dispatch per chunk serves the WHOLE
                # group: single scan + launch, amortized (fused_agg_cost);
                # the per-accumulator merge work is not amortized
                base = self.fused_agg_cost(rows, nk, len(aggs)) + rows * c.c_scan
                mdesc = f"kernel(fused, {len(aggs)} aggs)"
            else:
                base = self.agg_cost(rows, nk, agg_method, agg.op) + rows * c.c_scan
                mdesc = agg_method
            nch = self.est_chunks(schedule, K, rows)
            # skew is priced on the field the runtime actually hashes on:
            # the backend always prefers the op's own key column
            # (PartitionedPlan._partition_key_for), not the global choice
            pf = (agg.table, agg.key_field)
            total = (
                base * self.partition_skew(agg.table, pf, K, schedule)
                + rows * c.c_scan                     # hash + shuffle pass
                + nch * c.c_part_launch               # jitted chunk dispatches
                + self._compile_cost(schedule, K, rows)
                + nch * nk * len(aggs) * c.c_combine  # partial-accumulator merges
                + self.memory_penalty(rows / K)       # per-chunk working set
            )
            name = "+".join(a.array for a in aggs)
            breakdown.append(
                (f"agg {name}[{agg.table}.{agg.key_field}] ({mdesc}, K={K}, {schedule})", total)
            )

        for sr in spec.scalar_reduces:
            rows = float(self.stats.n_rows(sr.table))
            nch = self.est_chunks(schedule, K, rows)
            breakdown.append(
                (
                    f"reduce {sr.var} over {sr.table} (K={K})",
                    rows * c.c_scan
                    + nch * c.c_part_launch
                    + self._compile_cost(schedule, K, rows),
                )
            )

        for dr in spec.distinct_reads:
            nk = float(self.stats.key_space(dr.table, dr.field))
            breakdown.append(
                (f"distinct {dr.table}.{dr.field}", nk * c.c_output * max(1, len(dr.items)))
            )

        for fp in spec.filter_projects:
            rows = float(self.stats.n_rows(fp.table))
            sel = self.est.selectivity(fp.filter_pred, fp.table)
            nch = self.est_chunks(schedule, K, rows)
            breakdown.append(
                (
                    f"filter/project {fp.table} (K={K})",
                    rows * c.c_scan
                    + sel * rows * c.c_output * max(1, len(fp.items))
                    + nch * c.c_part_launch
                    + self._compile_cost(schedule, K, rows),
                )
            )

        for j in spec.joins:
            method = self.resolve_join_method(j, join_method)
            probe = float(self.stats.n_rows(j.probe_table))
            build = float(self.stats.n_rows(j.build_table))
            nch = self.est_chunks(schedule, K, probe)
            cost = (
                self.join_cost(j, method, agg_method)
                * self.partition_skew(j.probe_table, (j.probe_table, j.probe_fk), K, schedule)
                + (probe + build) * c.c_scan          # shuffle both sides on the key
                + nch * c.c_part_launch
                + self._compile_cost(schedule, K, probe)
                + self.memory_penalty((probe + build) / K)
            )
            if j.aggs:
                nk = sum(
                    float(self.stats.key_space(ja.key.table, ja.key.field)) for ja in j.aggs
                )
                cost += nch * nk * c.c_combine
            kind = "join⋈agg" if j.aggs else "join"
            breakdown.append(
                (f"{kind} {j.probe_table}⋈{j.build_table} ({method}, K={K}, {schedule})", cost)
            )

        return sum(x for _, x in breakdown), breakdown

    # -- joins ---------------------------------------------------------------
    def resolve_join_method(self, j: JoinSpec, requested: str) -> str:
        """'auto' → unique-lookup only when the build key is *provably*
        unique (full-scan stats); sampled/unknown stats fall back to the
        always-correct expansion lowering."""
        if requested in ("lookup", "expand"):
            return requested
        fs = self.stats.field(j.build_table, j.build_key)
        return "lookup" if (fs is not None and fs.is_unique is True) else "expand"

    def join_cost(self, j: JoinSpec, method: str, agg_method: str) -> float:
        """Cost of one equi-join under a lowering method, including the
        aggregation over the joined pairs for join-then-aggregate specs."""
        c = self.coeffs
        probe = float(self.stats.n_rows(j.probe_table))
        build = float(self.stats.n_rows(j.build_table))
        sort_cost = build * c.c_sort * max(1.0, math.log2(max(2.0, build)))
        if method == "lookup":
            slots = probe
            probe_cost = probe * c.c_join_probe
        else:
            # two binary searches + gather-expansion to probe × max-multiplicity
            m = self.est.join_expansion_factor(j.build_table, j.build_key)
            slots = probe * m
            probe_cost = probe * 2.0 * c.c_join_probe + slots * c.c_scan
        cost = sort_cost + probe_cost
        if j.aggs:
            for ja in j.aggs:
                nk = float(self.stats.key_space(ja.key.table, ja.key.field))
                cost += self.agg_cost(slots, nk, agg_method, ja.op) + slots * c.c_scan
        else:
            cost += slots * c.c_output * max(1, len(j.items))
        return cost

    # -- whole-spec cost -----------------------------------------------------
    def spec_cost(
        self,
        spec: ProgramSpec,
        agg_method: str,
        parallel: str,
        n_parts: int,
        partition_field: Optional[Tuple[str, str]] = None,
        join_method: str = "auto",
    ) -> Tuple[float, List[Tuple[str, float]]]:
        """Total estimated cost + per-operator breakdown."""
        c = self.coeffs
        breakdown: List[Tuple[str, float]] = []

        # fusion requires sequential execution — under vmap/shard_map the
        # lowering runs the per-aggregate parallel path, so cost that
        units = (
            self.agg_units(spec, agg_method)
            if parallel == "none"
            else [(False, [i]) for i in range(len(spec.aggs))]
        )
        for fused, idxs in units:
            aggs = [spec.aggs[i] for i in idxs]
            agg = aggs[0]
            # filtered rows still stream through the vectorized kernel with
            # zero weight, so the filter does not shrink the aggregate cost
            rows = float(self.stats.n_rows(agg.table))
            num_keys = float(self.stats.key_space(agg.table, agg.key_field))
            if fused:
                base = self.fused_agg_cost(rows, num_keys, len(aggs))
                mdesc = f"kernel(fused, {len(aggs)} aggs)"
            else:
                base = self.agg_cost(rows, num_keys, agg_method, agg.op)
                mdesc = agg_method
            base += rows * c.c_scan  # key/value/mask streaming (once per unit)
            total = self.parallel_cost(base, rows, num_keys, parallel, n_parts)
            total *= self._skew_penalty(agg.table, partition_field, parallel, n_parts)
            # monolithic execution keeps the whole table resident (shard_map
            # splits it across the mesh); the partitioned backend's bounded
            # chunks are the costed alternative (spec_cost_partitioned)
            total += self.memory_penalty(
                rows / n_parts if parallel == "shard_map" else rows
            )
            name = "+".join(a.array for a in aggs)
            breakdown.append((f"agg {name}[{agg.table}.{agg.key_field}] ({mdesc})", total))

        for sr in spec.scalar_reduces:
            rows = float(self.stats.n_rows(sr.table))
            breakdown.append((f"reduce {sr.var} over {sr.table}", rows * c.c_scan))

        for dr in spec.distinct_reads:
            nk = float(self.stats.key_space(dr.table, dr.field))
            breakdown.append((f"distinct {dr.table}.{dr.field}", nk * c.c_output * max(1, len(dr.items))))

        for fp in spec.filter_projects:
            rows = float(self.stats.n_rows(fp.table))
            sel = self.est.selectivity(fp.filter_pred, fp.table)
            breakdown.append(
                (f"filter/project {fp.table}", rows * c.c_scan + sel * rows * c.c_output * max(1, len(fp.items)))
            )

        for j in spec.joins:
            method = self.resolve_join_method(j, join_method)
            cost = self.join_cost(j, method, agg_method)
            cost += self.memory_penalty(
                float(self.stats.n_rows(j.probe_table)) + float(self.stats.n_rows(j.build_table))
            )
            kind = "join⋈agg" if j.aggs else "join"
            breakdown.append(
                (f"{kind} {j.probe_table}⋈{j.build_table} ({method})", cost)
            )

        return sum(x for _, x in breakdown), breakdown

    def _skew_penalty(
        self,
        table: str,
        partition_field: Optional[Tuple[str, str]],
        parallel: str,
        n_parts: int,
    ) -> float:
        """Indirect partitioning on a skewed field leaves one partition with
        most of the rows: the parallel win degrades toward serial."""
        if parallel == "none" or n_parts <= 1 or partition_field is None:
            return 1.0
        fs = self.stats.field(partition_field[0], partition_field[1])
        if fs is None:
            return 1.0
        uniform = 1.0 / max(1, fs.n_distinct)
        skew = fs.most_common_frac / max(uniform, 1e-12)
        # skew==1 → balanced → no penalty; heavy skew asymptotes to n_parts
        return 1.0 + min(float(n_parts) - 1.0, math.log2(max(1.0, skew)) * 0.25)


def calibrate(
    n_rows: int = 200_000, n_keys: int = 1_024, repeats: int = 3, device: str = "cuda"
) -> CostCoefficients:
    """Fit the aggregation coefficients to ``device`` by timing the same
    tensor ops the lowering emits (bench_fig2-style).  Returns scaled
    coefficients with the dense scatter-add as the 1-element-op anchor."""
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    keys = torch.from_numpy(rng.integers(0, n_keys, n_rows)).to(device)
    vals = torch.ones(n_rows, dtype=torch.float32, device=device)

    def sync() -> None:
        if keys.device.type == "cuda":
            torch.cuda.synchronize(keys.device)

    def best(f) -> float:
        f(keys, vals)  # warm-up
        sync()
        t = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            f(keys, vals)
            sync()
            t = min(t, time.perf_counter() - t0)
        return t

    def dense(k, v):
        return torch.zeros(n_keys, dtype=v.dtype, device=v.device).index_add_(0, k, v)

    def onehot(k, v):
        return F.one_hot(k, n_keys).to(v.dtype).T @ v

    def sort(k, v):
        order = torch.argsort(k, stable=True)
        return dense(k[order], v[order])

    t_dense = best(dense)
    t_onehot = best(onehot)
    t_sort = best(sort)

    unit = t_dense / n_rows / 2.5  # keep c_dense at its default anchor
    base = default_coefficients()
    return replace(
        base,
        c_onehot=max(1e-4, t_onehot / (n_rows * n_keys) / unit),
        c_sort=max(0.1, t_sort / (n_rows * max(1.0, math.log2(n_rows))) / unit),
    )
