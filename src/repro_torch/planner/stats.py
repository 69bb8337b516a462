# Table statistics for the cost-based planner.
#
# Statistics are collected from the live ``Database``/``Multiset`` columns
# (the compiler owns the physical layout, §III-C1, so it can afford to scan
# it): row counts, per-field distinct counts, min/max, and an equi-width
# histogram per numeric field.  ``DbStats.epoch`` is the cheap fingerprint
# from ``Database.stats_epoch()`` — plans cached against it are invalidated
# when the underlying data changes.
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.data.multiset import Database, DictColumn, Multiset

DEFAULT_BUCKETS = 16
# Cap on rows scanned per column when collecting statistics; larger tables
# are sampled with a fixed stride so collection stays O(max_rows).
DEFAULT_MAX_ROWS = 250_000


@dataclass(frozen=True)
class FieldStats:
    """Statistics of one column (on its *computational* view: dictionary
    codes for DictColumns, raw values otherwise)."""

    name: str
    n_rows: int
    n_distinct: int
    is_numeric: bool
    vmin: Optional[float] = None
    vmax: Optional[float] = None
    # equi-width histogram over [vmin, vmax] (numeric fields only)
    hist_counts: Tuple[int, ...] = ()
    hist_edges: Tuple[float, ...] = ()
    # frequency of the most common value / n_rows — skew signal for
    # partition-field choice (1/n_distinct for perfectly uniform data)
    most_common_frac: float = 0.0
    # Exact key-uniqueness (True/False) when the full column was scanned;
    # None when the column was sampled.  The unique-lookup join lowering is
    # only valid when this is provably True; otherwise the planner costs
    # the duplicate-key expansion lowering.
    is_unique: Optional[bool] = None
    # Largest number of rows sharing one value (exact on a full scan,
    # scaled estimate when sampled).  The expansion join's static output is
    # probe_rows × this — the key-multiplicity fan-out bound.
    max_multiplicity: int = 1

    def range_fraction(self, lo: float, hi: float) -> float:
        """Estimated fraction of rows with value in [lo, hi] (clipped)."""
        if not self.hist_counts or self.n_rows == 0:
            return 1.0
        total = sum(self.hist_counts)
        if total == 0:
            return 0.0
        edges = self.hist_edges
        acc = 0.0
        for i, c in enumerate(self.hist_counts):
            b_lo, b_hi = edges[i], edges[i + 1]
            if b_hi < lo or b_lo > hi:
                continue
            width = max(b_hi - b_lo, 1e-12)
            ov = max(0.0, min(hi, b_hi) - max(lo, b_lo))
            acc += c * min(1.0, ov / width)
        return min(1.0, acc / total)


@dataclass(frozen=True)
class TableStats:
    table: str
    n_rows: int
    fields: Dict[str, FieldStats] = field(default_factory=dict)

    def field_stats(self, name: str) -> Optional[FieldStats]:
        return self.fields.get(name)


@dataclass(frozen=True)
class DbStats:
    tables: Dict[str, TableStats]
    epoch: str

    def table(self, name: str) -> Optional[TableStats]:
        return self.tables.get(name)

    def field(self, table: str, name: str) -> Optional[FieldStats]:
        ts = self.tables.get(table)
        return ts.fields.get(name) if ts else None

    def n_rows(self, table: str) -> int:
        ts = self.tables.get(table)
        return ts.n_rows if ts else 0

    def n_distinct(self, table: str, name: str) -> int:
        fs = self.field(table, name)
        if fs is None:
            return max(1, self.n_rows(table))
        return max(1, fs.n_distinct)

    def max_multiplicity(self, table: str, name: str) -> int:
        """Largest per-value row count of a column (≥ 1) — bounds the
        expanded output of a duplicate-key join built on it."""
        fs = self.field(table, name)
        if fs is None:
            return max(1, self.n_rows(table))
        return max(1, fs.max_multiplicity)

    def key_space(self, table: str, name: str) -> int:
        """Size of the dense accumulator the lowering will allocate for this
        key column: ``max_value + 1`` for integer columns (lower.py
        ``_key_space``), NOT the distinct count — sparse key domains (e.g.
        HTTP status codes) make these very different, and the one-hot /
        combine costs scale with this, not with n_distinct."""
        fs = self.field(table, name)
        if fs is None:
            return max(1, self.n_rows(table))
        if fs.is_numeric and fs.vmax is not None and fs.vmax >= 0:
            return int(fs.vmax) + 1
        return max(1, fs.n_distinct)


def _estimate_max_multiplicity(counts: np.ndarray, scale: float, unique: Optional[bool]) -> int:
    """Scaled estimate of the largest per-value row count.  A singleton max
    in a strided sample must NOT be inflated by the stride — that would
    report multiplicity ≈ stride for unique keys and skew join costing —
    and proven uniqueness pins it to 1."""
    if len(counts) == 0:
        return 0
    if unique is True:
        return 1
    cmax = int(counts.max())
    if cmax <= 1:
        return 1
    return int(round(cmax * scale))


def _field_stats(name: str, ms: Multiset, n_buckets: int, max_rows: int) -> FieldStats:
    col = ms.columns[name]
    vals = np.asarray(col.materialize())
    n = len(vals)
    if n > max_rows:
        stride = max(1, n // max_rows)
        sample = vals[::stride]
    else:
        sample = vals
    scale = n / max(1, len(sample))

    full_scan = len(sample) == n

    if sample.dtype == object or sample.dtype.kind in "US":
        uniq, counts = np.unique(sample.astype(str), return_counts=True)
        unique = (len(uniq) == n) if full_scan else None
        return FieldStats(
            name=name,
            n_rows=n,
            n_distinct=int(round(len(uniq))),
            is_numeric=False,
            most_common_frac=float(counts.max() / max(1, len(sample))) if len(counts) else 0.0,
            is_unique=unique,
            max_multiplicity=_estimate_max_multiplicity(counts, scale, unique),
        )

    uniq, counts = np.unique(sample, return_counts=True)
    n_distinct = len(uniq)
    unique = (n_distinct == n) if full_scan else None
    if isinstance(col, DictColumn):
        # dict_encode builds the dictionary with np.unique over the full
        # column, so its size is the exact distinct count even when the
        # codes were sampled — and proves key-uniqueness exactly
        n_distinct = max(1, col.num_keys)
        unique = col.num_keys == n
    vmin = float(sample.min()) if len(sample) else None
    vmax = float(sample.max()) if len(sample) else None
    hist_counts: Tuple[int, ...] = ()
    hist_edges: Tuple[float, ...] = ()
    if len(sample) and vmin is not None and vmax is not None and vmax > vmin:
        counts_h, edges = np.histogram(sample.astype(np.float64), bins=n_buckets, range=(vmin, vmax))
        hist_counts = tuple(int(round(c * scale)) for c in counts_h)
        hist_edges = tuple(float(e) for e in edges)
    return FieldStats(
        name=name,
        n_rows=n,
        n_distinct=int(n_distinct),
        is_numeric=True,
        vmin=vmin,
        vmax=vmax,
        hist_counts=hist_counts,
        hist_edges=hist_edges,
        most_common_frac=float(counts.max() / max(1, len(sample))) if len(counts) else 0.0,
        is_unique=unique,
        max_multiplicity=_estimate_max_multiplicity(counts, scale, unique),
    )


def collect_table_stats(
    ms: Multiset, n_buckets: int = DEFAULT_BUCKETS, max_rows: int = DEFAULT_MAX_ROWS
) -> TableStats:
    fields = {name: _field_stats(name, ms, n_buckets, max_rows) for name in ms.field_names()}
    return TableStats(ms.name, len(ms), fields)


def collect_stats(
    db: Database, n_buckets: int = DEFAULT_BUCKETS, max_rows: int = DEFAULT_MAX_ROWS
) -> DbStats:
    """Scan (or stride-sample) every column of every table once."""
    tables = {name: collect_table_stats(ms, n_buckets, max_rows) for name, ms in db.tables.items()}
    return DbStats(tables, epoch=db.stats_epoch())
