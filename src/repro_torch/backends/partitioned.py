# Partitioned executor backend (paper §III-A: "many traditional compiler
# techniques for parallelization such as data distribution and loop
# scheduling ... can be re-used"): execute a compiled plan over
# hash/range-partitioned tables in bounded-memory chunks.
#
# Data distribution: each table an operator iterates is split into K
# partitions — hash-partitioned on the planner-chosen partition field (or
# the operator's own key/join column) when one is available, range
# (row-block) partitioned otherwise.  Equi-joins shuffle *both* sides with
# the same hash of the join key, so co-partitioned matches never cross a
# partition boundary and each partition joins independently.
#
# Loop scheduling: the dispatch order and chunk sizes over the partitioned
# iteration space come from ``repro_torch.sched.loop_schedule``
# ``ChunkPolicy`` objects (static / fixed / guided self-scheduling, §III-A2)
# — a chunk never crosses a partition boundary, so skewed partitions are
# simply broken into more chunks and load-balance across workers.
#
# Chunk kernels are *bucketed and captured* (``jit_chunks``): each chunk's
# row count is padded up to a small geometric set of shape buckets (with
# the accumulate op's identity in the padding, TorchLowering's masking
# discipline), and on a CUDA device each (kernel, bucket) signature is
# captured once in a CUDA graph with static input buffers and a private
# memory pool; every later chunk of that signature copies its inputs in and
# replays the graph, so a chunk costs one graph launch instead of one launch
# per tensor op.  Capture/hit/overflow counters are recorded per dispatch.
# With ``async_dispatch`` a small thread worker pool pulls chunks from a
# shared queue, each worker on its own CUDA stream: chunk k+1's host-side
# slice/pad and its upload from pinned memory overlap chunk k's kernels,
# and the self-scheduling policies become real wall-clock load balancing
# instead of a modeled dispatch order.
#
# Each chunk runs through the *existing* torch_vec kernels (TorchLowering's
# aggregation and join engines, the segreduce kernel under
# agg_method='kernel'); partial aggregates are merged with the accumulate
# op's own reduction (+/max/min re-aggregation) in chunk order
# (deterministic — results are bit-identical with async on or off wherever
# the chunk kernels are), streaming results concatenate, and group read-out
# happens once over the merged accumulators.  Tables stay host-resident
# (numpy; the storage layer), and only one chunk's padded column slices plus
# the dense accumulators are uploaded to the device at a time.
from __future__ import annotations

import os
import threading
import time
import weakref
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.ir import Const, Program, apply_order_limit
from repro_torch.data.multiset import Database
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.sched.fault_tolerant import (
    ChunkRetryExceeded,
    FaultStats,
    RetryPolicy,
    StragglerDetector,
)
from repro_torch.sched.loop_schedule import busy_times, make_policy, simulate_schedule, worker_imbalance

from repro_torch.kernels.segreduce import ops as segops
from repro_torch.kernels.segreduce.ref import ordered_combine

from .codegen import _densify, _host, required_columns
from .dtypes import column_tensor, host_array, host_dtype, host_tensor, scalar_sum, torch_dtype
from .interface import register_backend
from .torch_vec import _KERNEL_OPS, CodegenChoices, TorchLowering, _segment_reduce

SCHEDULES = ("static", "fixed", "guided")
# accepted alternate spellings (sched/loop_schedule.py's own policy names)
_SCHEDULE_ALIASES = {"gss": "guided"}


def normalize_schedule(name: str) -> str:
    """Canonical schedule-policy name; raises ValueError for names the
    partitioned backend does not execute (validate knobs *early* — at
    Session construction / optimize entry — not after planning)."""
    name = _SCHEDULE_ALIASES.get(name, name)
    if name not in SCHEDULES:
        raise ValueError(
            f"unknown schedule {name!r}; expected one of {SCHEDULES} (or 'gss')"
        )
    return name

# multiplicative hash mix (Knuth/Fibonacci): decorrelates partition ids
# from arithmetic key patterns; int64 wraparound is intentional
_HASH_MIX = np.int64(0x9E3779B1)


def hash_partition(values: np.ndarray, k: int) -> np.ndarray:
    """Deterministic partition id per value in [0, k).  Both sides of an
    equi-join use this same function, which is what makes co-partitioned
    joins local to a partition."""
    v = np.asarray(values).astype(np.int64, copy=False)
    return np.mod(v * _HASH_MIX, np.int64(max(1, k)))


# ---------------------------------------------------------------------------
# Shape buckets
# ---------------------------------------------------------------------------

BUCKET_MIN = 1024
# sub-octave bucket fractions: {0.625, 0.75, 0.875, 1.0} × 2^k — four
# buckets per power of two keep the whole set geometric (≲ 4·log2(rows)
# buckets can ever exist) with padding waste ≤ 25% worst-case (a row
# count just past a power of two pads to 0.625·2^(k+1)), ~11% on average
_BUCKET_FRACS = (10, 12, 14)  # sixteenths of the next power of two


def bucket_rows(n: int, min_bucket: int = BUCKET_MIN) -> int:
    """Smallest shape bucket ≥ ``n``.  Chunk kernels are captured once per
    bucket, so every chunk whose row count falls in the same bucket replays
    one CUDA graph; the geometric spacing bounds both the number of
    possible captures and the padding overhead."""
    if n <= min_bucket:
        return min_bucket
    p = 1 << int(n - 1).bit_length()  # next power of two ≥ n
    for frac in _BUCKET_FRACS:
        b = (p >> 4) * frac
        if b >= n and b >= min_bucket:
            return b
    return p


def _key_sentinel(dtype) -> Any:
    """Padding value for a *sorted build key* column: the dtype's maximum,
    so padded rows sort after every real row and searchsorted match runs
    stay inside the valid prefix (clipped by n_valid_build)."""
    if np.issubdtype(dtype, np.integer):
        return np.iinfo(dtype).max
    return np.inf


def _padded_slice(a: np.ndarray, idx: np.ndarray, m: int, fill=0, pinned: bool = False) -> torch.Tensor:
    """``a[idx]`` in the column's tensor dtype (backends/dtypes.py), padded
    with ``fill`` up to ``m`` rows, as a host tensor — in pinned memory when
    ``pinned``, so that its copy to the card need not wait."""
    n = idx.shape[0]
    dt = host_dtype(a.dtype)
    if pinned:
        buf = torch.empty((m,), dtype=torch_dtype(dt), pin_memory=True)
        out = host_array(buf, dt)
    else:
        out = np.empty((m,), dt)
        buf = host_tensor(out)
    out[:n] = a[idx]
    out[n:] = fill
    return buf


def _tensor_leaves(tree: Any) -> List[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


@dataclass
class JitCacheStats:
    """Chunk-kernel capture cache counters for one plan (all kernels pooled)."""

    compiles: int = 0    # dispatches that hit a fresh (kernel, bucket) signature: captures
    hits: int = 0        # dispatches served by an already-captured bucket
    overflows: int = 0   # dispatches run eagerly because the cache was full

    @property
    def hit_rate(self) -> float:
        total = self.compiles + self.hits + self.overflows
        return self.hits / total if total else 0.0


# ``torch.cuda.Stream()`` hands out the streams of a fixed pool in turn (32
# for each priority and device), so a stream made for a capture can be the
# very stream another worker runs on: that worker's launches would be
# captured into the graph, and its replays refused while the capture lasts.
# Workers take the default priority's pool (``StreamHandoff.new_stream``);
# every capture runs on one stream of the high priority's pool, which no
# worker takes, one capture in the process at a time.
_CAPTURE_LOCK = threading.Lock()
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream chunk kernels are captured on, on ``device``."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    with _CAPTURE_LOCK:
        stream = _CAPTURE_STREAMS.get(index)
        if stream is None:
            stream = torch.cuda.Stream(index, priority=-1)
            if stream.priority >= 0:
                raise RuntimeError("the card offers one stream priority: no stream is left for captures")
            _CAPTURE_STREAMS[index] = stream
    return stream


class _Graph:
    """One CUDA graph of a chunk kernel at one input signature: static input
    buffers, the captured work over them in a private memory pool, and its
    static outputs.

    A replay overwrites the static inputs and outputs, so every use copies
    its inputs in, replays and clones the outputs out under ``lock``, and
    the next use, possibly on another worker's stream, waits on the device
    for the previous one to finish (``done``) before it copies in.  Inputs
    that are the very tensor copied in last time (side-table columns and
    build sides, which the plan caches and never writes) are not copied
    again."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.lock = threading.Lock()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_in: List[torch.Tensor] = []
        self.static_out: Any = None
        self.src: List[Any] = []
        self.done: Optional[torch.cuda.Event] = None
        self.launches: Dict[str, int] = {}  # segreduce launches one replay makes

    def run(self, fn: Callable, args: Tuple) -> Any:
        leaves, spec = pytree.tree_flatten(args)
        with self.lock:
            stream = torch.cuda.current_stream()
            if self.graph is None:
                self._capture(fn, leaves, spec, stream)
            else:
                stream.wait_event(self.done)
                tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
                for i, (x, buf) in enumerate(zip(tensors, self.static_in)):
                    if self.src[i]() is not x:
                        buf.copy_(x)
                        self.src[i] = weakref.ref(x)
            self.graph.replay()
            segops.add_replay(self.launches)
            out = pytree.tree_map(
                lambda t: t.clone() if isinstance(t, torch.Tensor) else t, self.static_out
            )
            self.done.record(stream)
        return out

    def _capture(self, fn: Callable, leaves: List[Any], spec: Any, stream) -> None:
        static_leaves = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
        static_args = pytree.tree_unflatten(static_leaves, spec)
        # one eager run first: it loads the kernel libraries and sets their
        # launch attributes, none of which may happen inside a capture
        fn(*static_args)
        capture = capture_stream(stream.device)
        if capture.cuda_stream == stream.cuda_stream:
            raise RuntimeError(f"chunk kernel {self.name} would be captured on its caller's stream")
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, torch.cuda.stream(capture), segops.capturing() as launches:
            capture.wait_stream(stream)
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn(*static_args)
            except BaseException as e:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is void either way; ``e`` is the cause
                raise RuntimeError(f"CUDA graph capture of chunk kernel {self.name} failed") from e
            graph.capture_end()
            stream.wait_stream(capture)
        self.graph = graph
        self.static_in = [x for x in static_leaves if isinstance(x, torch.Tensor)]
        self.src = [weakref.ref(x) for x in leaves if isinstance(x, torch.Tensor)]
        self.static_out = out
        self.launches = dict(launches)
        self.done = torch.cuda.Event()


class _JitKernel:
    """One chunk kernel with shape-bucket accounting and a *bounded* capture
    cache: the first call at a new padded-shape signature captures it (on a
    CUDA device: one CUDA graph, ``_Graph``; counted as a compile); past
    ``cap`` distinct signatures new shapes run eagerly, counted as
    overflows, instead of growing the cache without bound.  On the CPU the
    same bookkeeping runs the eager function.  A failed capture raises."""

    def __init__(
        self, name: str, fn: Callable, stats: JitCacheStats, cap: int = 64,
        device: torch.device = torch.device("cpu"),
    ):
        self.name = name
        self._eager = fn
        self._sigs: Dict[Tuple, Optional[_Graph]] = {}
        self.stats = stats
        self.cap = cap
        self.device = device
        # pooled workers call concurrently: the signature table and the
        # shared counters must not race (each graph has its own lock)
        self._lock = threading.Lock()

    def __call__(self, *args) -> Tuple[Any, bool]:
        """Returns (result, compiled_now)."""
        sig = tuple(
            (tuple(x.shape), str(x.dtype)) if isinstance(x, torch.Tensor) else (type(x).__name__,)
            for x in pytree.tree_leaves(args)
        )
        cuda = self.device.type == "cuda"
        with self._lock:
            if sig in self._sigs:
                self.stats.hits += 1
                compiled, graph = False, self._sigs[sig]
            elif len(self._sigs) >= self.cap:
                self.stats.overflows += 1
                return self._eager(*args), False
            else:
                graph = self._sigs[sig] = _Graph(f"{self.name}{list(sig)}") if cuda else None
                self.stats.compiles += 1
                compiled = True
        if graph is None:
            return self._eager(*args), compiled
        try:
            return graph.run(self._eager, args), compiled
        except RuntimeError:
            if compiled:
                with self._lock:
                    self._sigs.pop(sig, None)
            raise

    @property
    def n_buckets(self) -> int:
        return len(self._sigs)


class StreamHandoff:
    """The stream discipline of chunks run on worker threads.

    Each worker runs its chunks on its own CUDA stream.  That stream first
    waits for the caller's stream as it stood when the op was dispatched
    (query parameters and earlier accumulators are made there); a chunk's
    results are handed back after an event sync on the worker's stream
    (the counterpart of ``jax.block_until_ready``), and marked as used by
    the caller's stream, so the allocator does not recycle them while the
    caller's merges still read them.  On the CPU all of this is a no-op."""

    def __init__(self, device: Optional[torch.device]) -> None:
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.device = torch.device(device) if device is not None else None
        if self.cuda:
            self.caller = torch.cuda.current_stream(self.device)
            self.ready = torch.cuda.Event()
            self.ready.record(self.caller)

    def new_stream(self) -> Optional[torch.cuda.Stream]:
        # the default priority's pool: captures keep the high one (``capture_stream``)
        return torch.cuda.Stream(self.device, priority=0) if self.cuda else None

    @contextmanager
    def on(self, stream: Optional[torch.cuda.Stream]) -> Iterator[None]:
        if not self.cuda:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            stream.wait_event(self.ready)
            yield

    def finish(self, stream: Optional[torch.cuda.Stream], result: Any) -> None:
        if not self.cuda:
            return
        ev = torch.cuda.Event()
        ev.record(stream)
        ev.synchronize()
        for t in _tensor_leaves(result):
            if t.device.type == "cuda":
                t.record_stream(self.caller)


@dataclass
class PartitionedChoices:
    """Strategy knobs of the partitioned backend: the wrapped torch_vec
    choices (which kernels run per chunk, on which device) plus the
    data-distribution, loop-scheduling and dispatch decisions."""

    base: CodegenChoices = field(default_factory=CodegenChoices)
    n_partitions: int = 4
    schedule: str = "static"          # 'static' | 'fixed' | 'guided'
    partition_field: Optional[Tuple[str, str]] = None  # (table, field)
    # bucketed captured chunk kernels (pad to shape buckets, capture once
    # per bucket).  Off = the eager per-chunk path (the differential anchor).
    jit_chunks: bool = True
    # overlap host-side slice/upload of chunk k+1 with chunk k's device
    # execution via a thread worker pool, one CUDA stream each (off here —
    # the low-level API is the serial oracle; the engine's OptimizeOptions
    # defaults it on)
    async_dispatch: bool = False
    n_workers: int = 0                # 0 = auto: min(max(2, K), cpu_count, 8)
    jit_cache_cap: int = 64           # bounded capture cache (overflow → eager)


@dataclass
class ChunkDispatch:
    """One dispatched chunk (the backend's observable schedule).  The
    timing fields are filled in as the chunk executes: ``t_ms`` is the
    measured wall-clock (dispatch-to-complete under async_dispatch, where
    each worker waits on its own stream for its chunk; dispatch-side time
    on the serial path, which only waits at merge barriers)."""

    op: str
    partition: int
    rows: int
    worker: int
    bucket: int = 0          # padded row count the kernel ran at (0 = eager)
    build_bucket: int = 0    # padded build-side rows (join kernels only)
    t_ms: float = 0.0
    compiled: bool = False   # this dispatch captured a fresh CUDA graph
    queue_ms: float = 0.0    # dispatch-start → execution-start wait
    n_aggs: int = 1          # accumulators this dispatch produced
    fused: bool = False      # fused multi-aggregate kernel (one data pass)
    start: int = 0           # chunk offset in the op's partitioned iteration space
    attempt: int = 0         # retries consumed (fault-tolerant dispatch)
    speculated: bool = False  # a backup copy was launched for this chunk
    # this chunk was produced by a mid-run skew split (``SplitPolicy``) —
    # sub-chunks are never split again, so one pathological partition
    # splits exactly once per op instead of recursing
    split_child: bool = False

    def trace_attrs(self) -> Dict[str, Any]:
        """The fields a per-chunk ``dispatch`` span carries — the trace is
        a superset view of the dispatch log, so the two can be checked
        against each other."""
        return {
            "op": self.op,
            "partition": self.partition,
            "rows": self.rows,
            "worker": self.worker,
            "bucket": self.bucket,
            "build_bucket": self.build_bucket,
            "t_ms": self.t_ms,
            "compiled": self.compiled,
            "queue_ms": self.queue_ms,
            "n_aggs": self.n_aggs,
            "fused": self.fused,
            "start": self.start,
            "attempt": self.attempt,
            "speculated": self.speculated,
        }


@dataclass
class SplitPolicy:
    """Mid-run skew mitigation (adaptive re-optimization's runtime half):
    when one partition's measured chunk time exceeds ``threshold_factor`` ×
    the mean of the other completed chunks, that partition's *remaining*
    chunks are split into guided-policy-sized sub-chunks before dispatch,
    so a pathological partition load-balances across workers within the
    run instead of waiting for the next plan.

    Each split records a ``replan.split`` span and bumps the
    ``replan.splits`` metric.  Sub-chunks are exact: partials still merge
    in chunk order under the accumulate op's own (commutative+associative)
    reduction and streaming rows are re-sorted by original row index, so
    results stay bit-identical to the unsplit plan wherever the chunk
    kernels' sums are order-independent (integers; floats are the op's own
    rounding of another grouping of the same rows).

    Applies to the plan's local dispatch paths (serial and per-query
    pool); the serving engine's ``SharedChunkPool`` executes chunk sets
    verbatim and does not split."""

    # a completed chunk slower than factor × mean-of-other-completed flags
    # its partition (0.0 = flag every partition once min_completed is met)
    threshold_factor: float = 4.0
    # never split chunks smaller than this — sub-chunks below the shape-
    # bucket floor would all pad back up to BUCKET_MIN and gain nothing
    min_rows: int = 2 * BUCKET_MIN
    # completed chunks required before the mean is trustworthy
    min_completed: int = 2


class _SplitState:
    """Per-op bookkeeping for ``SplitPolicy``: completed-chunk times and
    the set of partitions flagged as slow.  Callers synchronize access
    (the pool path mutates it under its Condition lock)."""

    def __init__(self) -> None:
        self.times: List[float] = []
        self.slow: set = set()

    def note_complete(self, d: ChunkDispatch, sp: Optional[SplitPolicy]) -> None:
        if sp is None:
            return
        self.times.append(d.t_ms)
        n = len(self.times)
        if n <= sp.min_completed:
            return
        mean_others = max((sum(self.times) - d.t_ms) / (n - 1), 1e-9)
        if d.t_ms > sp.threshold_factor * mean_others:
            self.slow.add(d.partition)


@dataclass
class _Layout:
    """A table's K-way partitioning: row indices grouped by partition id
    plus the K+1 prefix bounds into that grouping."""

    order: np.ndarray
    bounds: np.ndarray
    mode: str  # 'hash(<field>)' | 'range'

    def rows(self, p: int) -> np.ndarray:
        return self.order[self.bounds[p]: self.bounds[p + 1]]


class PartitionedPlan:
    """A compiled forelem program bound to partitioned data.  ``run``
    executes chunk-by-chunk and merges partials; results are densified
    exactly like the torch backend's ``Plan.run``."""

    def __init__(
        self,
        program: Program,
        db: Database,
        choices: Optional[PartitionedChoices] = None,
    ):
        if choices is None:
            choices = PartitionedChoices()
        elif isinstance(choices, CodegenChoices):
            choices = PartitionedChoices(base=choices)
        choices = replace(choices, schedule=normalize_schedule(choices.schedule))
        self.program = program
        self.db = db
        self.choices = choices
        self.k = max(1, int(choices.n_partitions))
        # per-chunk kernels come from the existing vectorized lowering; the
        # forall strategy inside a chunk is always 'none' (the partitioned
        # runner IS the parallel execution strategy)
        self.lowering = TorchLowering(program, db, replace(choices.base, parallel="none"))
        self.spec = self.lowering.spec
        self.device = self.lowering.device
        # numpy view of every needed column (sliced per chunk at run time)
        self._cols_np: Dict[str, Dict[str, np.ndarray]] = {}
        needed = required_columns(program, self.spec)
        pf = choices.partition_field
        if pf is not None and pf[0] in db and pf[1] in db[pf[0]].columns:
            needed.setdefault(pf[0], set()).add(pf[1])
        for t, fields in needed.items():
            if t not in db:
                continue
            ms = db[t]
            self._cols_np[t] = {
                f: np.asarray(ms.field(f)) for f in fields if f in ms.columns
            }
        self._layouts: Dict[Tuple[str, Optional[str]], _Layout] = {}
        # Per-run observable state is *thread-keyed*: a cached plan is shared
        # across tenant sessions, and the serving engine runs the same plan
        # concurrently from many threads — each run's dispatch log must not
        # clobber another's (``dispatch_log`` resolves to the calling
        # thread's run, falling back to the most recent run anywhere).
        self._tls = threading.local()
        self._last_log: List[ChunkDispatch] = []
        self._last_run_ms: float = 0.0
        # run-time serving attachments — configured by the Session/server
        # after compile (never part of the plan fingerprint): chunk-level
        # fault tolerance, a shared cross-query chunk executor, and the
        # metrics registry fault/dispatch events feed
        self.fault: Optional[RetryPolicy] = None
        self.fault_stats = FaultStats()
        self.chunk_executor: Any = None
        self.metrics_registry: Any = None
        # mid-run skew mitigation (None = off); attached by the Session
        # when feedback is enabled — like ``fault``, never part of the plan
        # fingerprint and never a result-changing knob
        self.split: Optional[SplitPolicy] = None
        # bucketed captured chunk kernels: one _JitKernel per extracted op,
        # built lazily, shared counters in jit_stats (per plan); creation is
        # locked — concurrent first runs must not build the same kernel twice
        self.jit_stats = JitCacheStats()
        self._kernels: Dict[Tuple, _JitKernel] = {}
        self._kernels_lock = threading.Lock()
        self._dev_cols: Dict[Tuple[str, str], torch.Tensor] = {}
        self._dev_lock = threading.Lock()
        # run-invariant presence of *unfiltered* aggregations: a pure
        # histogram of the key column, memoized across run() calls — a
        # chunked runner owns its intermediates between runs.  Keyed like
        # ``presence``; invalidated with the plan (Session recompiles on
        # any table swap / epoch bump).
        self._presence_cache: Dict[Tuple, Any] = {}
        # per-partition build sides (sliced + sorted (+ padded, captured
        # path)) are run-invariant too: dimension-sized, kept device-resident
        # across runs (the *probe* side stays chunked — it is the big one)
        self._build_cache: Dict[Tuple, Any] = {}

    # -- per-run observable state (thread-keyed; see __init__) ---------------
    @property
    def dispatch_log(self) -> List[ChunkDispatch]:
        log = getattr(self._tls, "log", None)
        return log if log is not None else self._last_log

    @dispatch_log.setter
    def dispatch_log(self, value: List[ChunkDispatch]) -> None:
        self._tls.log = value
        self._last_log = value

    @property
    def last_run_ms(self) -> float:
        ms = getattr(self._tls, "run_ms", None)
        return ms if ms is not None else self._last_run_ms

    @last_run_ms.setter
    def last_run_ms(self, value: float) -> None:
        self._tls.run_ms = value
        self._last_run_ms = value

    # -- data distribution ---------------------------------------------------
    def _table_len(self, table: str) -> int:
        return len(self.db[table]) if table in self.db else 0

    def _partition_key_for(self, table: str, preferred: Optional[str]) -> Optional[str]:
        """Column to hash-partition ``table`` on: the operator's preferred
        key column, else the planner-chosen partition field when it lives on
        this table; None → range partitioning."""
        if preferred is not None and preferred in self._cols_np.get(table, {}):
            return preferred
        pf = self.choices.partition_field
        if pf is not None and pf[0] == table and pf[1] in self._cols_np.get(table, {}):
            return pf[1]
        return None

    def _layout(self, table: str, key_field: Optional[str]) -> _Layout:
        ck = (table, key_field)
        cached = self._layouts.get(ck)
        if cached is not None:
            return cached
        n = self._table_len(table)
        if key_field is None or self.k == 1:
            # range distribution: contiguous row blocks
            bounds = np.array([(i * n) // self.k for i in range(self.k + 1)], np.int64)
            layout = _Layout(np.arange(n, dtype=np.int64), bounds, "range")
        else:
            pid = hash_partition(self._cols_np[table][key_field], self.k)
            # a stable sort of small ids: through int16 numpy sorts by radix,
            # in one pass, and the order is the same
            narrow = pid.astype(np.int16) if self.k <= np.iinfo(np.int16).max else pid
            order = np.argsort(narrow, kind="stable").astype(np.int64)
            bounds = np.searchsorted(pid[order], np.arange(self.k + 1)).astype(np.int64)
            layout = _Layout(order, bounds, f"hash({key_field})")
        self._layouts[ck] = layout
        return layout

    # -- loop scheduling -----------------------------------------------------
    def _policy(self, total: int):
        """The ChunkPolicy actually executed — shared with the ANALYZE
        replay (``runtime_report``), which must simulate the *same* policy.
        Guided GSS is floored at 1/(16K) of the iteration space: finer
        chunks cannot improve balance beyond ~1/16 of a worker's share, but
        every extra size decade costs more dispatches and more shape
        buckets (= graph captures)."""
        kw = {}
        if self.choices.schedule == "guided":
            kw["min_chunk"] = max(1, total // (16 * self.k))
        return make_policy(self.choices.schedule, total, self.k, **kw)

    def _chunks(self, layout: _Layout, op: str) -> List[Tuple[int, np.ndarray, ChunkDispatch]]:
        """Chunk the partitioned iteration space under the configured
        ``ChunkPolicy``.  Chunks are clipped at partition boundaries (a
        chunk must see exactly one partition's rows — joins depend on it),
        so a skewed partition simply yields more chunks."""
        total = int(layout.bounds[-1])
        if total == 0:
            return []
        policy = self._policy(total)
        policy.reset()
        out: List[Tuple[int, np.ndarray, ChunkDispatch]] = []
        pos, w, p = 0, 0, 0
        while pos < total:
            while layout.bounds[p + 1] <= pos:
                p += 1
            size = policy.next_chunk(total - pos, self.k, w % self.k, [])
            size = max(1, min(size, int(layout.bounds[p + 1]) - pos))
            d = ChunkDispatch(op, p, size, w % self.k, start=pos)
            out.append((p, layout.order[pos: pos + size], d))
            self.dispatch_log.append(d)
            pos += size
            w += 1
        return out

    def partition_row_counts(self) -> Dict[str, np.ndarray]:
        """Measured per-partition row counts of every hash layout this plan
        materialized, keyed ``"table.field"`` — the feedback loop's
        observed row skew (planner/feedback.py ``extract_profile``).  Range
        layouts are omitted: they are even by construction."""
        out: Dict[str, np.ndarray] = {}
        for (table, fld), layout in self._layouts.items():
            if fld is not None and layout.mode.startswith("hash"):
                out[f"{table}.{fld}"] = np.diff(layout.bounds)
        return out

    # -- mid-run skew splitting (SplitPolicy) ---------------------------------
    def _split_chunk(
        self, ch: Tuple[int, np.ndarray, ChunkDispatch]
    ) -> List[Tuple[int, np.ndarray, ChunkDispatch]]:
        """Split one pending chunk of a flagged partition into guided-size
        sub-chunks (geometrically decaying, floored at 1/(4K) of the chunk
        — coarser than the global guided floor: these pieces only need to
        spread ONE partition's tail across the pool)."""
        p, idx, d = ch
        total = int(idx.shape[0])
        policy = make_policy("guided", total, self.k, min_chunk=max(1, total // (4 * self.k)))
        policy.reset()
        subs: List[Tuple[int, np.ndarray, ChunkDispatch]] = []
        pos, w = 0, 0
        while pos < total:
            size = max(1, min(policy.next_chunk(total - pos, self.k, w % self.k, []), total - pos))
            sd = replace(
                d,
                rows=size,
                start=d.start + pos,
                t_ms=0.0,
                queue_ms=0.0,
                bucket=0,
                compiled=False,
                attempt=0,
                speculated=False,
                split_child=True,
            )
            subs.append((p, idx[pos: pos + size], sd))
            pos += size
            w += 1
        return subs

    def _log_replace(self, old: ChunkDispatch, subs: List[ChunkDispatch]) -> None:
        """Splice a split chunk's sub-dispatches into the dispatch log in
        place of the original entry (the log stays a faithful record of
        what actually executed, in schedule order)."""
        log = self.dispatch_log
        for j in range(len(log) - 1, -1, -1):
            if log[j] is old:
                log[j: j + 1] = subs
                return
        log.extend(subs)

    def _note_split(
        self, d: ChunkDispatch, subs: List[Tuple[int, np.ndarray, ChunkDispatch]], tr, op_id
    ) -> None:
        if self.metrics_registry is not None:
            self.metrics_registry.inc("replan.splits")
        if tr.enabled:
            s = tr.start(
                "replan.split",
                parent=op_id,
                op=d.op,
                partition=d.partition,
                rows=d.rows,
                n_subchunks=len(subs),
            )
            tr.end(s)

    def _split_eligible(self, d: ChunkDispatch, st: "_SplitState") -> bool:
        sp = self.split
        return (
            sp is not None
            and not d.split_child
            and d.partition in st.slow
            and d.rows >= sp.min_rows
        )

    # -- chunk uploads -----------------------------------------------------------
    def _upload(self, a: np.ndarray, idx: np.ndarray, m: int, fill=0) -> torch.Tensor:
        """``a[idx]`` padded to ``m`` rows on the plan's device.  On a CUDA
        device the slice is cut into pinned memory and copied without
        waiting (the caching host allocator keeps the pinned block until the
        copy has run), so the host can slice the next chunk while this one
        is still in flight."""
        if self.device.type != "cuda":
            return _padded_slice(a, idx, m, fill)
        return _padded_slice(a, idx, m, fill, pinned=True).to(self.device, non_blocking=True)

    def _n_valid(self, n: int) -> torch.Tensor:
        return torch.full((), n, dtype=torch.int32, device=self.device)

    def _slice(self, table: str, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        n = int(idx.shape[0])
        return {f: self._upload(a, idx, n) for f, a in self._cols_np.get(table, {}).items()}

    def _padded_chunk(
        self, table: str, idx: np.ndarray, d: ChunkDispatch
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One chunk's column slices padded up to the row-count bucket,
        plus the n_valid tensor the kernel masks with."""
        n = int(idx.shape[0])
        m = bucket_rows(n)
        d.bucket = m
        chunk = {f: self._upload(a, idx, m) for f, a in self._cols_np.get(table, {}).items()}
        return chunk, self._n_valid(n)

    def _publish(self) -> None:
        """Wait for the current stream before a tensor made on it is cached
        for every worker's stream to read."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # -- kernel env ------------------------------------------------------------
    def _dev_col(self, t: str, f: str) -> torch.Tensor:
        key = (t, f)
        with self._dev_lock:
            arr = self._dev_cols.get(key)
            if arr is None:
                arr = column_tensor(self._cols_np[t][f], self.device)
                self._publish()
                self._dev_cols[key] = arr
        return arr

    def _kernel_env(
        self, exprs, table: str, pcols: Dict[str, Any], extra: Tuple[Tuple[str, str], ...] = ()
    ) -> Dict[str, Dict[str, Any]]:
        """Device-resident environment a chunk kernel needs besides the
        chunk itself: query params plus any side-table columns the
        expressions read outside the chunked ``table`` (member-filter
        ranges, dimension columns).  Uploaded once per plan — side tables
        have fixed shapes, so they never cause a recapture."""
        env: Dict[str, Dict[str, Any]] = {"__params__": dict(pcols)}
        pairs = list(extra)
        for e in exprs:
            if e is not None:
                pairs.extend(e.fields_used())
        for t, f in pairs:
            if t != table and t in self._cols_np and f in self._cols_np[t]:
                env.setdefault(t, {})[f] = self._dev_col(t, f)
        return env

    def _kernel(self, key: Tuple, build: Callable[[], Callable]) -> _JitKernel:
        kern = self._kernels.get(key)
        if kern is None:
            with self._kernels_lock:
                kern = self._kernels.get(key)
                if kern is None:
                    kern = self._kernels[key] = _JitKernel(
                        f"{key[0]}[{key[1]}]", build(), self.jit_stats,
                        self.choices.jit_cache_cap, self.device,
                    )
        return kern

    # -- dispatch --------------------------------------------------------------
    def _n_workers(self) -> int:
        if self.choices.n_workers > 0:
            return self.choices.n_workers
        return min(max(2, self.k), os.cpu_count() or 1, 8)

    def _dispatch(
        self,
        chunks: List[Tuple[int, np.ndarray, ChunkDispatch]],
        work,
        tr=NULL_TRACER,
    ) -> List[Any]:
        """Run ``work`` over every chunk and return results in chunk order
        (partials are always merged in that order, so async execution is
        bit-identical to serial).  Serial mode leaves the device's own
        stream order to pipeline and only waits at merge barriers; async
        mode runs a worker pool where each worker, on its own CUDA stream,
        pulls its next chunk only after its previous one finished on the
        device — the ChunkPolicy's dispatch order becomes real load
        balancing, and one worker's host-side slice/pad/upload overlaps
        another's device execution.

        With an enabled tracer, one ``dispatch:<op>`` span wraps the whole
        op and each chunk emits a ``dispatch`` span carrying the
        ``ChunkDispatch`` fields — attached to the op span by *explicit*
        parent id, because worker threads have no span stack to inherit
        from.

        Fault tolerance (paper §III-A3, hybrid scheduling): when a
        ``RetryPolicy`` is attached (``self.fault``), a failing chunk is
        re-queued up to ``max_retries`` times instead of killing the query,
        and — in the pool path — a chunk running longer than the straggler
        threshold gets one speculative backup; the first finisher wins.
        Results stay bit-identical to serial because partials are still
        merged in chunk order regardless of which attempt produced them.
        When a ``chunk_executor`` is attached (the serving engine's shared
        pool), the whole chunk set is delegated to it instead of spinning a
        per-query pool."""
        results: List[Any] = [None] * len(chunks)
        if not chunks:
            return results
        traced = tr.enabled
        op_span = tr.start(f"dispatch:{chunks[0][2].op}", n_chunks=len(chunks)) if traced else None
        op_id = op_span.id if traced else None
        t_disp0 = time.perf_counter()
        nw = self._n_workers()
        fault = self.fault
        try:
            if self.chunk_executor is not None:
                return self.chunk_executor.run_chunks(
                    chunks,
                    work,
                    tr=tr,
                    op_id=op_id,
                    fault=fault,
                    fault_stats=self.fault_stats,
                    metrics=self.metrics_registry,
                    device=self.device,
                )
            st = _SplitState()
            if not self.choices.async_dispatch or nw <= 1 or len(chunks) <= 1:
                # index-based loop: a mid-run split splices sub-chunks into
                # ``chunks``/``results`` at the current position, so the
                # caller's positional zip over (chunks, results) stays valid
                i = 0
                while i < len(chunks):
                    ch = chunks[i]
                    d = ch[2]
                    if self._split_eligible(d, st):
                        subs = self._split_chunk(ch)
                        if len(subs) > 1:
                            chunks[i: i + 1] = subs
                            results[i: i + 1] = [None] * len(subs)
                            self._log_replace(d, [s[2] for s in subs])
                            self._note_split(d, subs, tr, op_id)
                            ch = chunks[i]
                            d = ch[2]
                    t0 = time.perf_counter()
                    d.queue_ms = (t0 - t_disp0) * 1e3
                    while True:
                        if traced:
                            s = tr.start("dispatch", parent=op_id, seq=i)
                        try:
                            if fault is not None and fault.fault_hook is not None:
                                fault.fault_hook(d)
                            results[i] = work(ch)
                        except BaseException as e:
                            if traced:
                                tr.end(s, error=type(e).__name__)
                            if fault is not None and fault.retryable(d.attempt):
                                d.attempt += 1
                                self._note_retry(d, tr, op_id)
                                continue
                            if fault is not None:
                                self.fault_stats.bump("failed")
                                raise ChunkRetryExceeded(
                                    f"chunk {d.op}[p{d.partition}] failed after "
                                    f"{d.attempt + 1} attempts"
                                ) from e
                            raise
                        d.t_ms = (time.perf_counter() - t0) * 1e3
                        if traced:
                            tr.end(s, **d.trace_attrs())
                        break
                    st.note_complete(d, self.split)
                    i += 1
                return results
            return self._dispatch_pool(
                chunks, work, results, tr, traced, op_id, t_disp0, nw, fault, st
            )
        finally:
            if traced:
                tr.end(op_span)

    def _note_retry(self, d: ChunkDispatch, tr, op_id) -> None:
        self.fault_stats.bump("retries")
        if self.metrics_registry is not None:
            self.metrics_registry.inc("serve.chunk.retries")
        if tr.enabled:
            s = tr.start(
                "fault.retry", parent=op_id, op=d.op, partition=d.partition, attempt=d.attempt
            )
            tr.end(s)

    def _dispatch_pool(
        self,
        chunks: List[Tuple[int, np.ndarray, ChunkDispatch]],
        work,
        results: List[Any],
        tr,
        traced: bool,
        op_id,
        t_disp0: float,
        nw: int,
        fault,
        st: Optional["_SplitState"] = None,
    ) -> List[Any]:
        """The local worker-pool path of ``_dispatch``: a Condition-guarded
        work queue (instead of a shared iterator) so failed chunks can be
        re-queued, idle workers can launch speculative backups for
        stragglers, and a flagged-slow partition's pending chunks can be
        split (``SplitPolicy``) before dispatch.  Split sub-chunks are
        appended to ``chunks``/``results`` (the first sub-chunk keeps the
        original slot) — legal because every partial merge op is
        commutative+associative, which K>1 execution already requires."""
        n = len(chunks)
        pending: deque = deque(enumerate(chunks))
        done = [False] * n
        inflight: Dict[int, float] = {}
        speculated: set = set()
        errors: List[BaseException] = []
        cv = threading.Condition()
        detector = (
            StragglerDetector(fault.straggler_factor, fault.min_completed)
            if fault is not None and fault.speculate
            else None
        )
        if st is None:
            st = _SplitState()
        state = {"ndone": 0, "total": n}
        handoff = StreamHandoff(self.device)

        def runner(w: int) -> None:
            stream = handoff.new_stream()
            while True:
                item = None
                backup = False
                with cv:
                    while True:
                        if errors or state["ndone"] >= state["total"]:
                            return
                        if pending:
                            item = pending.popleft()
                            i0, ch0 = item
                            if done[i0]:
                                item = None
                                continue
                            d0 = ch0[2]
                            if self._split_eligible(d0, st) and d0.attempt == 0:
                                subs = self._split_chunk(ch0)
                                if len(subs) > 1:
                                    base = len(chunks)
                                    chunks[i0] = subs[0]
                                    chunks.extend(subs[1:])
                                    results.extend([None] * (len(subs) - 1))
                                    done.extend([False] * (len(subs) - 1))
                                    for kk in reversed(range(len(subs) - 1)):
                                        pending.appendleft((base + kk, subs[kk + 1]))
                                    state["total"] += len(subs) - 1
                                    self._log_replace(d0, [s[2] for s in subs])
                                    self._note_split(d0, subs, tr, op_id)
                                    item = (i0, subs[0])
                            break
                        if detector is not None:
                            thr = detector.threshold_ms()
                            now = time.perf_counter()
                            cand = None
                            if thr is not None:
                                for j, tj in inflight.items():
                                    if (
                                        not done[j]
                                        and j not in speculated
                                        and (now - tj) * 1e3 >= thr
                                    ):
                                        cand = j
                                        break
                            if cand is not None:
                                speculated.add(cand)
                                item = (cand, chunks[cand])
                                backup = True
                                break
                        cv.wait(timeout=0.005)
                i, ch = item
                d = ch[2]
                t0 = time.perf_counter()
                with cv:
                    if backup:
                        d.speculated = True
                        self.fault_stats.bump("speculated")
                        if self.metrics_registry is not None:
                            self.metrics_registry.inc("serve.chunk.speculated")
                    else:
                        inflight.setdefault(i, t0)
                        if d.queue_ms == 0.0:
                            d.queue_ms = (t0 - t_disp0) * 1e3
                if traced:
                    s = tr.start("dispatch", parent=op_id, seq=i, worker=w)
                try:
                    # a speculative backup skips the fault hook: it models a
                    # retry on a different (healthy) worker
                    if fault is not None and fault.fault_hook is not None and not backup:
                        fault.fault_hook(d)
                    with handoff.on(stream):
                        r = work(ch)
                    handoff.finish(stream, r)
                except BaseException as e:
                    if traced:
                        tr.end(s, error=type(e).__name__)
                    with cv:
                        if done[i]:
                            cv.notify_all()
                            continue
                        if fault is not None and fault.retryable(d.attempt):
                            d.attempt += 1
                            pending.append((i, ch))
                            self._note_retry(d, tr, op_id)
                        else:
                            if fault is not None:
                                self.fault_stats.bump("failed")
                                err: BaseException = ChunkRetryExceeded(
                                    f"chunk {d.op}[p{d.partition}] failed after "
                                    f"{d.attempt + 1} attempts"
                                )
                                err.__cause__ = e
                            else:
                                err = e
                            errors.append(err)
                        cv.notify_all()
                    continue
                t_ms = (time.perf_counter() - t0) * 1e3
                with cv:
                    if done[i]:
                        # lost the first-finisher race against a backup (or
                        # the primary) — identical deterministic result, so
                        # dropping it is safe; count the wasted work
                        self.fault_stats.bump("wasted")
                        cv.notify_all()
                        if traced:
                            tr.end(s, wasted=True, seq=i)
                        continue
                    done[i] = True
                    state["ndone"] += 1
                    results[i] = r
                    d.worker = w
                    d.t_ms = t_ms
                    inflight.pop(i, None)
                    if detector is not None:
                        detector.record(t_ms)
                    st.note_complete(d, self.split)
                    cv.notify_all()
                if traced:
                    tr.end(s, **d.trace_attrs())

        threads = [
            threading.Thread(target=runner, args=(w,), daemon=True)
            for w in range(min(nw, n))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results

    # -- partial merging -----------------------------------------------------
    @staticmethod
    def _merge(acc, part, op: str):
        if acc is None:
            return part
        if op == "+":
            return acc + part  # int32 wraps, as the JAX package's
        if op in ("max", "min"):
            return ordered_combine(acc, part, op)  # -0.0 below +0.0, a NaN wins
        raise ValueError(f"bad merge op {op}")

    # -- execution -------------------------------------------------------------
    def run(
        self, params: Optional[Dict[str, Any]] = None, *, tracer: Any = None
    ) -> Dict[str, Any]:
        tr = tracer if tracer is not None else NULL_TRACER
        t_run0 = time.perf_counter()
        low = self.lowering
        spec = self.spec
        use_jit = self.choices.jit_chunks
        self.dispatch_log = []
        pcols = {k: low._scalar(v) for k, v in (params or {}).items()}
        arrays: Dict[str, Any] = {}
        presence: Dict[Tuple[str, str], Any] = {}
        out: Dict[str, Any] = {}

        def zeros(nk: int) -> torch.Tensor:
            return torch.zeros((nk,), dtype=torch.int32, device=self.device)

        # --- aggregations: per-chunk partials, merged with the op ----------
        # Dispatch *units*: under agg_method='kernel' each fused group
        # (same table / GROUP-BY key / row predicate — codegen.
        # fused_agg_groups) runs as ONE unit whose chunk kernel produces
        # every accumulator of the group plus presence in a single data
        # pass; each partial's multi-accumulator state is merged
        # element-wise under its own op.  Uncovered aggregates keep the
        # per-aggregate kernel.  Units run at their first member's
        # statement position, so earlier-array reads stay ordered.
        fused_cover = {i for g in low.fused_groups for i in g}
        units = [(True, g) for g in low.fused_groups] + [
            (False, [ai]) for ai in range(len(spec.aggs)) if ai not in fused_cover
        ]
        units.sort(key=lambda u: u[1][0])
        for use_fused, idxs in units:
            gaggs = [spec.aggs[i] for i in idxs]
            agg = gaggs[0]
            nk = low.num_keys[(agg.table, agg.key_field)]
            layout = self._layout(agg.table, self._partition_key_for(agg.table, agg.key_field))
            opname = "agg:" + "+".join(a.array for a in gaggs)
            chunks = self._chunks(layout, opname)
            for _, _, d in chunks:
                d.n_aggs, d.fused = len(gaggs), use_fused
            pkey = ("agg", agg.table, agg.key_field)
            cacheable = agg.filter_pred is None and agg.member_filter is None
            cached_pres = self._presence_cache.get(pkey) if cacheable else None
            need_pres = cached_pres is None
            extra = ()
            if agg.member_filter is not None:
                mf, mt, mfld = agg.member_filter
                extra = ((mt, mfld),)
            env = self._kernel_env(
                tuple(a.value for a in gaggs) + (agg.filter_pred,), agg.table, pcols, extra,
            )
            snap = dict(arrays)  # aggs may read arrays of *earlier* aggs
            if use_jit:
                kern = self._kernel(
                    ("agg", tuple(idxs), need_pres),
                    lambda gs=tuple(gaggs), a=agg, uf=use_fused, wp=need_pres: (
                        low.chunk_fused_agg_fn(gs, with_presence=wp)
                        if uf
                        else low.chunk_agg_fn(a, with_presence=wp)
                    ),
                )

                def work(ch, _k=kern, _e=env, _a=snap, _t=agg.table):
                    _, idx, d = ch
                    chunk, nv = self._padded_chunk(_t, idx, d)
                    res, d.compiled = _k(chunk, nv, _e, _a)
                    return res
            elif use_fused:
                gops = tuple(_KERNEL_OPS[a.op] for a in gaggs)

                def work(ch, _gaggs=gaggs, _gops=gops, _nk=nk, _np=need_pres, _t=agg.table,
                         _e=env, _a=snap):
                    _, idx, d = ch
                    c2 = dict(_e)
                    c2[_t] = self._slice(_t, idx)
                    keys, values, mask = low.fused_agg_inputs(_gaggs, c2, _a)
                    return segops.fused_segreduce(
                        keys, values, _gops, _nk, mask=mask, with_presence=_np
                    )
            else:

                def work(ch, _agg=agg, _nk=nk, _np=need_pres, _e=env, _a=snap):
                    _, idx, d = ch
                    c2 = dict(_e)
                    c2[_agg.table] = self._slice(_agg.table, idx)
                    keys, values, ones, _ = low.agg_inputs(_agg, c2, _a)
                    return (
                        low._aggregate(keys, values, _nk, _agg.op),
                        low._aggregate(keys, ones, _nk, "+") if _np else None,
                    )

            accs: List[Any] = [None] * len(gaggs)
            pres = None
            for part in self._dispatch(chunks, work, tr):
                paccs = part[0] if use_fused else (part[0],)
                for i, (a, p) in enumerate(zip(gaggs, paccs)):
                    accs[i] = self._merge(accs[i], p, a.op)
                if need_pres:
                    pres = self._merge(pres, part[1], "+")
            if not need_pres:
                pres = cached_pres
            if accs[0] is None:  # empty table: identity accumulators
                accs = [zeros(nk) for _ in gaggs]
                pres = zeros(nk)
            if cacheable and need_pres:
                self._presence_cache[pkey] = pres
            for a, acc in zip(gaggs, accs):
                arrays[a.array] = acc
            presence[(agg.table, agg.key_field)] = pres

        # --- joins: shuffle-on-key, each partition joins locally ------------
        for ji, (j, mult) in enumerate(zip(spec.joins, low.join_multiplicity)):
            probe_layout = self._layout(j.probe_table, self._partition_key_for(j.probe_table, j.probe_fk))
            build_layout = self._layout(j.build_table, self._partition_key_for(j.build_table, j.build_key))
            co_partitioned = probe_layout.mode.startswith("hash") and build_layout.mode.startswith("hash")
            chunks = self._chunks(probe_layout, f"join:{j.probe_table}⋈{j.build_table}")
            # a partition's build side is probed by every chunk of that
            # partition (and by every run): slice + sort (+ pad, captured
            # path) it once per plan, not per chunk
            build_cache = self._build_cache
            build_lock = threading.Lock()
            # group presence of a *filter-free* join is run-invariant (the
            # match structure depends only on the data); memoized like the
            # single-table aggregation presence, namespaced per join
            jpkeys = [("join", ji, ja.key.table, ja.key.field) for ja in j.aggs]
            j_cacheable = bool(j.aggs) and j.probe_filter is None
            need_pres = not (
                j_cacheable and all(pk in self._presence_cache for pk in jpkeys)
            )
            jexprs = list(j.items) + [j.probe_filter]
            for ja in j.aggs:
                jexprs.extend((ja.value, ja.key))
            env = self._kernel_env(jexprs, j.probe_table, pcols)
            env.pop(j.build_table, None)  # the (padded) build side is an arg

            if use_jit:
                kern = self._kernel(
                    ("join", ji, need_pres),
                    lambda jj=j, m=mult, wp=need_pres: low.chunk_join_fn(jj, m, with_presence=wp),
                )

                def build_side_padded(p: int, _j=j, _ji=ji):
                    key = (_ji, True, p if co_partitioned else -1)
                    with build_lock:
                        hit = build_cache.get(key)
                    if hit is not None:
                        return hit
                    # co-partitioned: only partition p of the build side can
                    # match; otherwise (range-partitioned probe) every build
                    # row is a candidate and the build side is broadcast
                    bidx = build_layout.rows(p) if co_partitioned else build_layout.order
                    n = int(bidx.shape[0])
                    mb = bucket_rows(n)
                    bnp = self._cols_np.get(_j.build_table, {})
                    bk = bnp.get(_j.build_key)
                    if bk is not None and n:
                        bidx = bidx[np.argsort(bk[bidx], kind="stable")]
                    bcols = {f: self._upload(a, bidx, mb) for f, a in bnp.items()}
                    if bk is not None:
                        sk = self._upload(bk, bidx, mb, fill=_key_sentinel(host_dtype(bk.dtype)))
                    else:
                        sk = torch.full((mb,), _key_sentinel(np.int32), dtype=torch.int32, device=self.device)
                    hit = (bcols, sk, self._n_valid(n))
                    self._publish()
                    with build_lock:
                        build_cache[key] = hit
                    return hit

                def work(ch, _k=kern, _e=env, _j=j):
                    p, idx, d = ch
                    bcols, sk, nvb = build_side_padded(p)
                    chunk, nv = self._padded_chunk(_j.probe_table, idx, d)
                    d.build_bucket = int(sk.shape[0])
                    res, d.compiled = _k(chunk, nv, bcols, sk, nvb, _e)
                    return res
            else:

                def build_side(p: int, _j=j, _ji=ji):
                    key = (_ji, False, p if co_partitioned else -1)
                    with build_lock:
                        hit = build_cache.get(key)
                    if hit is None:
                        bidx = build_layout.rows(p) if co_partitioned else build_layout.order
                        bcols = self._slice(_j.build_table, bidx)
                        bk = bcols.get(_j.build_key)
                        if bk is not None and bk.shape[0]:
                            order = torch.argsort(bk, stable=True)
                            hit = (bcols, (order, bk[order]))
                        else:
                            hit = (bcols, None)
                        self._publish()
                        with build_lock:
                            build_cache[key] = hit
                    return hit

                def work(ch, _j=j, _m=mult, _np=need_pres, _e=env):
                    p, idx, d = ch
                    bcols, bsorted = build_side(p)
                    c2 = dict(_e)
                    c2[_j.probe_table] = self._slice(_j.probe_table, idx)
                    c2[_j.build_table] = bcols
                    jr = low._join_rows(_j, _m, c2, build_sorted=bsorted)
                    if _j.aggs:
                        outs = []
                        for ja in _j.aggs:
                            nk = low.num_keys[(ja.key.table, ja.key.field)]
                            keys, values, ones = low.join_agg_inputs(ja, _j, jr, c2)
                            outs.append(
                                (
                                    low._aggregate(keys, values, nk, ja.op),
                                    low._aggregate(keys, ones, nk, "+") if _np else None,
                                )
                            )
                        return tuple(outs)
                    items = tuple(low._join_gather(el, _j, jr, c2) for el in _j.items)
                    return items, jr.present, jr.probe_idx

            parts = self._dispatch(chunks, work, tr)
            if j.aggs:
                jaccs: Dict[str, Any] = {}
                jpres: Dict[Tuple, Any] = {}
                for part in parts:
                    for ja, pk, (a_, p_) in zip(j.aggs, jpkeys, part):
                        jaccs[ja.array] = self._merge(jaccs.get(ja.array), a_, ja.op)
                        if need_pres:
                            jpres[pk] = self._merge(jpres.get(pk), p_, "+")
                if not need_pres:
                    jpres = {pk: self._presence_cache[pk] for pk in jpkeys}
                elif j_cacheable and parts:
                    self._presence_cache.update(jpres)
                for ja, pk in zip(j.aggs, jpkeys):
                    nk = low.num_keys[(ja.key.table, ja.key.field)]
                    arrays[ja.array] = jaccs[ja.array] if ja.array in jaccs else zeros(nk)
                    presence[(ja.key.table, ja.key.field)] = jpres.get(pk, zeros(nk))
            else:
                # (original probe row, emitted tuple): chunks arrive in hash-
                # partition order, but the visible row order must not depend
                # on the (K, schedule) choice — restore probe-row-major order
                # (the torch backend's emission order) before returning.
                # stable: within one probe row, match slots keep their
                # sorted-build emission order — identical to the torch backend
                rows_out: List[Tuple[int, Tuple]] = []
                for (_, idx, _d), part in zip(chunks, parts):
                    items, present, probe_idx = part
                    chunk_rows = _densify({"columns": items, "present": present})
                    sel = np.nonzero(_host(present))[0]
                    local_probe = _host(probe_idx)[sel] if probe_idx is not None else sel
                    rows_out.extend(zip(idx[local_probe].tolist(), chunk_rows))
                out[j.result] = [r for _, r in sorted(rows_out, key=lambda t: t[0])]

        # --- scalar reductions: chunked partial sums -------------------------
        for si, sr in enumerate(spec.scalar_reduces):
            layout = self._layout(sr.table, self._partition_key_for(sr.table, None))
            chunks = self._chunks(layout, f"reduce:{sr.var}")
            env = self._kernel_env((sr.expr, sr.filter_pred), sr.table, pcols)
            snap = dict(arrays)
            if use_jit:
                kern = self._kernel(("reduce", si), lambda s=sr: low.chunk_reduce_fn(s))

                def work(ch, _k=kern, _e=env, _a=snap, _t=sr.table):
                    _, idx, d = ch
                    chunk, nv = self._padded_chunk(_t, idx, d)
                    res, d.compiled = _k(chunk, nv, _e, _a)
                    return res
            else:

                def work(ch, _sr=sr, _e=env, _a=snap):
                    _, idx, d = ch
                    c2 = dict(_e)
                    c2[_sr.table] = self._slice(_sr.table, idx)
                    expr = low._vec(_sr.expr, c2, _sr.table, _a)
                    mask = None
                    if _sr.match_field is not None:
                        mv = _sr.match_value
                        if isinstance(mv, Const):
                            mval = low._scalar(mv.value)
                        else:
                            mval = c2["__params__"][mv.name]
                        mask = c2[_sr.table][_sr.match_field] == mval
                    pmask = low._pred_mask(_sr.filter_pred, c2, _sr.table)
                    if pmask is not None:
                        mask = pmask if mask is None else (mask & pmask)
                    vals = torch.broadcast_to(expr, (int(idx.shape[0]),))
                    if mask is not None:
                        vals = torch.where(mask, vals, 0)
                    return scalar_sum(vals)

            total = None
            for part in self._dispatch(chunks, work, tr):
                total = self._merge(total, part, "+")
            out[sr.var] = total if total is not None else torch.zeros((), dtype=torch.int32)

        # --- distinct reads: one read-out over the MERGED accumulators ------
        for dr in spec.distinct_reads:
            nk = low.num_keys[(dr.table, dr.field)]
            pres = presence.get((dr.table, dr.field))
            if pres is None:
                keys = self._dev_col(dr.table, dr.field)
                pres = _segment_reduce(keys, torch.ones_like(keys), nk, "+")
            key_ids = torch.arange(nk, dtype=torch.int32, device=self.device)
            items = tuple(low._vec_distinct(el, dr, key_ids, arrays, {}) for el in dr.items)
            present = pres > 0
            if dr.filter_pred is not None:
                guard = low._vec_distinct(dr.filter_pred, dr, key_ids, arrays, {})
                present = present & guard.to(torch.bool)
            out[dr.result] = _densify({"columns": items, "present": present})

        # --- filter/project: streaming chunks, concatenated ------------------
        for fi, fp in enumerate(spec.filter_projects):
            layout = self._layout(fp.table, self._partition_key_for(fp.table, None))
            chunks = self._chunks(layout, f"project:{fp.result}")
            env = self._kernel_env(list(fp.items) + [fp.filter_pred], fp.table, pcols)
            if use_jit:
                kern = self._kernel(("project", fi), lambda f=fp: low.chunk_project_fn(f))

                def work(ch, _k=kern, _e=env, _t=fp.table):
                    _, idx, d = ch
                    chunk, nv = self._padded_chunk(_t, idx, d)
                    res, d.compiled = _k(chunk, nv, _e)
                    return res
            else:

                def work(ch, _fp=fp, _e=env, _a=dict(arrays)):
                    _, idx, d = ch
                    c2 = dict(_e)
                    c2[_fp.table] = self._slice(_fp.table, idx)
                    mask = low._pred_mask(_fp.filter_pred, c2, _fp.table)
                    items = tuple(low._vec(el, c2, _fp.table, _a) for el in _fp.items)
                    if mask is None:
                        mask = torch.ones((int(idx.shape[0]),), dtype=torch.bool, device=self.device)
                    return items, mask

            rows_out = []
            for (_, idx, _d), part in zip(chunks, self._dispatch(chunks, work, tr)):
                items, mask = part
                chunk_rows = _densify({"columns": items, "present": mask})
                sel = np.nonzero(_host(mask))[0]
                rows_out.extend(zip(idx[sel].tolist(), chunk_rows))
            # original row order, independent of the partitioning
            out[fp.result] = [r for _, r in sorted(rows_out, key=lambda t: t[0])]

        final = {k: _densify(v) for k, v in out.items() if k in self.program.results}
        result = apply_order_limit(self.program, final)
        self.last_run_ms = (time.perf_counter() - t_run0) * 1e3
        return result

    # -- introspection -------------------------------------------------------
    def runtime_report(self) -> Dict[str, Any]:
        """Measured execution profile of the last ``run()``: per-op chunk
        timings with the achieved worker imbalance, the same measured
        per-chunk costs replayed through ``sched.simulate_schedule`` under
        the configured policy (modeled imbalance — what EXPLAIN ANALYZE
        puts next to the planner's skew estimate), and the chunk-kernel
        capture-cache counters.

        Always well-formed: a plan that was built but never run — or ran
        over a 0-row table, so no chunk was ever dispatched — reports
        ``ran=False`` with an empty ``ops`` list instead of degenerating."""
        return self._build_report(self.dispatch_log)

    def report_from_trace(self, trace: Any) -> Dict[str, Any]:
        """The same runtime report, re-expressed over a ``QueryTrace``'s
        per-chunk ``dispatch`` spans instead of the plan's own dispatch
        log — EXPLAIN ANALYZE consumes the trace, so the log is a
        cross-checkable view rather than the only source of truth."""
        dispatches = [
            ChunkDispatch(
                op=r.get("op", "?"),
                partition=int(r.get("partition", 0)),
                rows=int(r.get("rows", 0)),
                worker=int(r.get("worker", 0)),
                bucket=int(r.get("bucket", 0)),
                build_bucket=int(r.get("build_bucket", 0)),
                t_ms=float(r.get("t_ms", 0.0)),
                compiled=bool(r.get("compiled", False)),
                queue_ms=float(r.get("queue_ms", 0.0)),
                n_aggs=int(r.get("n_aggs", 1)),
                fused=bool(r.get("fused", False)),
                start=int(r.get("start", 0)),
                attempt=int(r.get("attempt", 0)),
                speculated=bool(r.get("speculated", False)),
            )
            for r in trace.dispatch_records()
        ]
        return self._build_report(dispatches)

    def _build_report(self, dispatches: List[ChunkDispatch]) -> Dict[str, Any]:
        per_op: Dict[str, List[ChunkDispatch]] = {}
        for d in dispatches:
            per_op.setdefault(d.op, []).append(d)
        ops = []
        for op, ds in per_op.items():
            busy = busy_times((d.worker, d.t_ms) for d in ds)
            entry: Dict[str, Any] = {
                "op": op,
                "n_chunks": len(ds),
                "rows": int(sum(d.rows for d in ds)),
                "t_ms": float(sum(d.t_ms for d in ds)),
                "achieved_imbalance": worker_imbalance(busy),
            }
            total = sum(d.rows for d in ds)
            if total and all(d.t_ms >= 0.0 for d in ds) and any(d.t_ms > 0 for d in ds):
                iter_costs = np.concatenate(
                    [np.full(d.rows, d.t_ms / max(1, d.rows)) for d in ds]
                )
                sim = simulate_schedule(self._policy(total), iter_costs, self.k)
                entry["modeled_imbalance"] = sim.imbalance()
                entry["modeled_makespan_ms"] = float(sim.makespan)
            ops.append(entry)
        return {
            "k": self.k,
            "schedule": self.choices.schedule,
            "async_dispatch": bool(self.choices.async_dispatch),
            "n_workers": self._n_workers() if self.choices.async_dispatch else 1,
            "jit_chunks": bool(self.choices.jit_chunks),
            "wall_ms": self.last_run_ms,
            "ran": bool(dispatches),
            "n_dispatches": len(dispatches),
            "queue_wait_ms": float(sum(d.queue_ms for d in dispatches)),
            "worker_busy_ms": float(sum(d.t_ms for d in dispatches)),
            "ops": ops,
            "jit": {
                "compiles": self.jit_stats.compiles,
                "hits": self.jit_stats.hits,
                "overflows": self.jit_stats.overflows,
                "hit_rate": self.jit_stats.hit_rate,
                "kernels": len(self._kernels),
                "buckets": int(sum(k.n_buckets for k in self._kernels.values())),
            },
        }

    def describe(self) -> str:
        pf = self.choices.partition_field
        pfs = f"{pf[0]}.{pf[1]}" if pf else "-"
        return (
            f"partition={pfs} K={self.k} schedule={self.choices.schedule} "
            f"chunks={len(self.dispatch_log)} jit={'on' if self.choices.jit_chunks else 'off'} "
            f"async={'on' if self.choices.async_dispatch else 'off'}"
        )


class PartitionedBackend:
    """Planner-driven data distribution + loop scheduling over the torch_vec
    kernels: the third registered executor."""

    name = "partitioned"

    def compile(
        self, program: Program, db: Database, choices: Any = None
    ) -> PartitionedPlan:
        return PartitionedPlan(program, db, choices)


register_backend(PartitionedBackend())
