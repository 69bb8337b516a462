# Columnar storage for multisets of tuples (paper §III-C1: the compiler owns
# the physical layout — row files, column stores, compressed columns,
# dictionary encoding).
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # imported lazily in decl(): repro_torch.core.__init__ pulls in
    # the lowering, which imports this module back (cycle)
    from repro_torch.core.ir import MultisetDecl, TupleSchema

# ---------------------------------------------------------------------------
# Column encodings
# ---------------------------------------------------------------------------


@dataclass
class PlainColumn:
    """Physically stored values (numpy array; ints/floats — or object array
    of strings for the *unreformatted* 'hadoop layout' baseline)."""

    values: np.ndarray

    def __len__(self) -> int:
        return len(self.values)

    def materialize(self) -> np.ndarray:
        return self.values

    @property
    def nbytes(self) -> int:
        if self.values.dtype == object:
            return int(sum(map(len, map(str, self.values.tolist()))))
        return int(self.values.nbytes)


@dataclass
class CompressedRangeColumn:
    """A column enumerating a range is not physically stored in full; only a
    description (start, step, length) is stored and reconstructed on read
    (paper §III-C1 'compressed column schemes')."""

    start: int
    step: int
    length: int
    dtype: Any = np.int32

    def __len__(self) -> int:
        return self.length

    def materialize(self) -> np.ndarray:
        return (self.start + self.step * np.arange(self.length)).astype(self.dtype)

    @property
    def nbytes(self) -> int:
        return 24  # the description only


@dataclass
class DictColumn:
    """Dictionary-encoded column: integer codes + a value dictionary
    (paper §IV: 'the strings ... have been replaced with integer keys ...
    the data model has been made relational')."""

    codes: np.ndarray  # int32 codes
    dictionary: np.ndarray  # code -> original value (object array ok)

    def __len__(self) -> int:
        return len(self.codes)

    def materialize(self) -> np.ndarray:
        return self.codes  # compute on codes; decode() recovers values

    def decode(self) -> np.ndarray:
        return self.dictionary[self.codes]

    @property
    def num_keys(self) -> int:
        return int(len(self.dictionary))

    @property
    def nbytes(self) -> int:
        d = sum(len(str(v)) for v in self.dictionary) if self.dictionary.dtype == object else self.dictionary.nbytes
        return int(self.codes.nbytes) + int(d)


Column = Any  # PlainColumn | CompressedRangeColumn | DictColumn


def dict_encode(values: np.ndarray) -> DictColumn:
    values = np.asarray(values)
    if values.dtype == object:
        vals = values.tolist()
        if all(type(v) is str for v in vals):
            # np.unique sorts an object array one Python comparison at a time
            # (~5 s for 2M urls); the sorted set of its strings is the same
            # dictionary, and each string's place in it the same code
            dictionary = sorted(set(vals))
            index = {v: i for i, v in enumerate(dictionary)}
            codes = np.fromiter(map(index.__getitem__, vals), dtype=np.int32, count=len(vals))
            return DictColumn(codes, np.array(dictionary, dtype=object))
    dictionary, codes = np.unique(values, return_inverse=True)
    return DictColumn(codes.astype(np.int32), dictionary)


# ---------------------------------------------------------------------------
# Multiset (columnar table)
# ---------------------------------------------------------------------------


class Multiset:
    """A multiset of tuples, stored column-wise."""

    # monotonic creation counter: a process-unique identity for each
    # Multiset (unlike id(), never reused after garbage collection) —
    # owners use it to detect table swaps cheaply
    _next_uid = 0

    def __init__(self, name: str, columns: Dict[str, Column]):
        self.name = name
        self.columns = dict(columns)
        Multiset._next_uid += 1
        self.uid = Multiset._next_uid
        lens = {len(c) for c in columns.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged columns in multiset {name}: {lens}")
        self._len = lens.pop() if lens else 0

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_records(name: str, records: Sequence[Tuple], fields: Sequence[str]) -> "Multiset":
        cols: Dict[str, Column] = {}
        for i, f in enumerate(fields):
            vals = [r[i] for r in records]
            arr = np.array(vals)
            cols[f] = PlainColumn(arr)
        return Multiset(name, cols)

    @staticmethod
    def from_columns(name: str, **cols: np.ndarray) -> "Multiset":
        return Multiset(name, {k: PlainColumn(np.asarray(v)) for k, v in cols.items()})

    # -- access -------------------------------------------------------------
    def __len__(self) -> int:
        return self._len

    def field(self, name: str) -> np.ndarray:
        """Materialized computational view of a column (codes for dict cols)."""
        return self.columns[name].materialize()

    def field_names(self) -> List[str]:
        return list(self.columns)

    def decl(self) -> "MultisetDecl":
        from repro_torch.core.ir import MultisetDecl, TupleSchema

        fields = []
        for n, c in self.columns.items():
            arr = c.materialize() if not isinstance(c, DictColumn) else c.codes
            dt = "key" if isinstance(c, DictColumn) else str(np.asarray(arr).dtype)
            fields.append((n, dt))
        return MultisetDecl(self.name, TupleSchema(tuple(fields)))

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns.values())

    # -- statistics hooks (planner) -----------------------------------------
    def fingerprint(self) -> str:
        """Cheap, deterministic content fingerprint.

        Hashes the schema (names, encodings, dtypes, lengths, byte sizes)
        plus content checksums: full-column sum/min/max and a strided value
        sample for numeric columns (vectorized numpy — microseconds per
        million rows), the range description only for compressed-range
        columns.  This catches mid-column edits, not just head/tail ones;
        adversarially constructed collisions (e.g. swapping two equal-sum
        values that the stride misses) remain possible, so the plan cache
        trades that sliver of risk for skipping replanning+recompilation."""
        h = hashlib.sha1()
        h.update(self.name.encode())
        h.update(str(self._len).encode())
        for n in sorted(self.columns):
            c = self.columns[n]
            h.update(n.encode())
            h.update(type(c).__name__.encode())
            h.update(str(c.nbytes).encode())
            if isinstance(c, CompressedRangeColumn):
                # the description IS the content — O(1), no materialization
                h.update(f"{c.start}:{c.step}:{c.length}:{c.dtype}".encode())
                continue
            vals = c.codes if isinstance(c, DictColumn) else np.asarray(c.materialize())
            h.update(str(vals.dtype).encode())
            if len(vals):
                stride = max(1, len(vals) // 64)
                sample = vals[::stride][:64]
                if vals.dtype == object or vals.dtype.kind in "US":
                    h.update("|".join(str(v) for v in sample).encode())
                else:
                    h.update(np.ascontiguousarray(sample).tobytes())
                    h.update(str(vals.sum(dtype=np.int64) if np.issubdtype(vals.dtype, np.integer)
                              else vals.sum(dtype=np.float64)).encode())
                    h.update(f"{vals.min()}:{vals.max()}".encode())
            if isinstance(c, DictColumn):
                d = c.dictionary
                ds = d[:: max(1, len(d) // 16)][:16]
                h.update(f"{len(d)}|".encode() + "|".join(str(v) for v in ds).encode())
        return h.hexdigest()

    # -- reformatting (paper §III-C1) ---------------------------------------
    def reformat_dict_encode(self, fields: Optional[Sequence[str]] = None) -> "Multiset":
        """Replace string/object columns (or the given fields) by
        dictionary-encoded integer-key columns."""
        out: Dict[str, Column] = {}
        for n, c in self.columns.items():
            sel = fields is None or n in fields
            if sel and isinstance(c, PlainColumn) and (
                c.values.dtype == object or c.values.dtype.kind in "US"
            ):
                out[n] = dict_encode(c.values)
            elif sel and fields is not None and n in fields and isinstance(c, PlainColumn):
                out[n] = dict_encode(c.values)
            else:
                out[n] = c
        return Multiset(self.name, out)

    def reformat_prune(self, keep: Sequence[str]) -> "Multiset":
        """Drop dead fields (paper: 'removing unused structure fields')."""
        return Multiset(self.name, {n: c for n, c in self.columns.items() if n in keep})

    def reformat_compress_ranges(self) -> "Multiset":
        """Detect arithmetic-progression integer columns and store only the
        range description."""
        out: Dict[str, Column] = {}
        for n, c in self.columns.items():
            out[n] = c
            if isinstance(c, PlainColumn) and np.issubdtype(c.values.dtype, np.integer) and len(c) >= 2:
                v = c.values
                step = int(v[1]) - int(v[0])
                if np.all(np.diff(v) == step):
                    out[n] = CompressedRangeColumn(int(v[0]), step, len(v), v.dtype)
        return Multiset(self.name, out)


class Database:
    """Named multisets — the program's data environment."""

    def __init__(self, tables: Optional[Dict[str, Multiset]] = None, epoch_salt: int = 0):
        self.tables: Dict[str, Multiset] = dict(tables or {})
        # Mixed into ``stats_epoch``: bumped by owners (e.g. the engine's
        # Session) on table replacement so that a swap to content the cheap
        # fingerprint cannot distinguish still lands in a fresh epoch.
        self._epoch_salt = int(epoch_salt)

    def add(self, ms: Multiset) -> "Database":
        self.tables[ms.name] = ms
        return self

    def bump_epoch(self) -> None:
        """Force the next ``stats_epoch`` into a new value (mutation marker)."""
        self._epoch_salt += 1

    def __getitem__(self, name: str) -> Multiset:
        return self.tables[name]

    def __contains__(self, name: str) -> bool:
        return name in self.tables

    def decls(self) -> Tuple[MultisetDecl, ...]:
        return tuple(ms.decl() for ms in self.tables.values())

    def stats_epoch(self) -> str:
        """Fingerprint of the whole database: changes whenever tables are
        added, dropped, reformatted, or their contents change.  Plan-cache
        entries are keyed on this epoch (planner/cache.py)."""
        h = hashlib.sha1()
        h.update(str(self._epoch_salt).encode())
        for name in sorted(self.tables):
            h.update(self.tables[name].fingerprint().encode())
        return h.hexdigest()


def database_from_columns(tables: Dict[str, Dict[str, np.ndarray]]) -> Database:
    """A Database of plain columns, one table per entry of ``tables``
    (name -> {field: values}) — the same numpy columns another caller hands
    to the JAX package's ``Database``, so both packages hold the same data."""
    db = Database()
    for name, cols in tables.items():
        db.add(Multiset.from_columns(name, **cols))
    return db
