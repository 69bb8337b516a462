# The hand-written CUDA segmented-reduction kernel (csrc/segreduce.cu): its
# ctypes binding and the launch that sizes the per-warp tables.  The build
# (nvcc at first use into ``build/kernels/``, keyed by a hash of the source)
# is the shared helper in ``kernels/_build.py``.  Nothing here runs at
# import time: the CPU tests import this module on machines that have no
# nvcc and no card.
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from .._build import CudaLibrary
from .ref import OPS

SOURCE = Path(__file__).resolve().parent / "csrc" / "segreduce.cu"

MAX_AGGS = 16            # SEG_MAX_AGGS in the source: aggregates per launch
WARPS_PER_BLOCK = 8      # SEG_WARPS_PER_BLOCK in the source
TILE_ROWS = 4096         # SEG_ORD_TILE in the source: rows of a regime-1 histogram or scatter block
ORD_WARPS = 8            # SEG_ORD_THREADS / 32 in the source: warps of those blocks
PART_TILE = 8192         # SEG_PART_TILE in the source: rows of a regime-3 scatter block
ROWS_PER_WARP_MIN = 1024  # fewer rows per warp buy nothing but table traffic
BLOCKS_PER_SM = 4
GROUP = 32               # SEG_GROUP in the source: children of a node of regime 1's prefix tree
# Regime 1: the most rows one fold block takes at once (a longer key range
# is cut into pieces, joined by a tree), so that no skew of the keys makes
# one block fold more.
PIECE_ROWS = 16384
# Regime 1: where N rows times R key ranges is at most this many, the call
# is one launch in which every range's block reads all N rows
# (seg_ordered_small), and not the three passes of the partition: the one
# launch costs about what the rows its blocks read do, the partition a
# fixed few microseconds more.  scripts/segreduce_shapes.py on an NVIDIA
# H100 80GB HBM3 (700 W), device ms from a CUDA graph: the two tie at 1,954
# ranges x 2,048 rows (0.0508 each); at 98 ranges the one launch leads at
# 32,768 rows (0.0256 against 0.0293) and trails at 65,536 (0.0414 against
# 0.0301).
SMALL_READS = 4_000_000

_VTYPES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
_OPCODES = {op: i for i, op in enumerate(OPS)}  # sum 0, max 1, min 2


class _SegParams(ctypes.Structure):
    """Field for field the ``SegParams`` struct of csrc/segreduce.cu."""

    _fields_ = [
        ("keys", ctypes.c_void_p),
        ("mask", ctypes.c_void_p),
        ("vals", ctypes.c_void_p * MAX_AGGS),
        ("out", ctypes.c_void_p * MAX_AGGS),
        ("presence", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p),
        ("counts", ctypes.c_void_p),
        ("bucket_start", ctypes.c_void_p),
        ("part_keys", ctypes.c_void_p),
        ("part_vals", ctypes.c_void_p),
        ("n_rows", ctypes.c_int64),
        ("rows_per_warp", ctypes.c_int64),
        ("num_keys", ctypes.c_int32),
        ("n_aggs", ctypes.c_int32),
        ("with_presence", ctypes.c_int32),
        ("n_warps", ctypes.c_int32),
        ("regime", ctypes.c_int32),
        ("device", ctypes.c_int32),
        ("n_buckets", ctypes.c_int32),
        ("keys_per_bucket", ctypes.c_int32),
        ("n_tiles", ctypes.c_int32),
        ("reduce_warps", ctypes.c_int32),
        ("n_blocks", ctypes.c_int32),
        ("atomic_smem", ctypes.c_int32),
        ("vtype", ctypes.c_int32 * MAX_AGGS),
        ("op", ctypes.c_int32 * MAX_AGGS),
        ("part_off", ctypes.c_void_p),
        ("part_ranges", ctypes.c_void_p),
        ("bucket_shift", ctypes.c_int32),
        ("tile_prefix", ctypes.c_void_p),
        ("partials", ctypes.c_void_p),
        ("piece_rows", ctypes.c_int32),
        ("small_n", ctypes.c_int32),
    ]


def _configure(lib: ctypes.CDLL) -> None:
    lib.segreduce_launch.argtypes = [ctypes.POINTER(_SegParams), ctypes.c_void_p]
    lib.segreduce_launch.restype = ctypes.c_int
    lib.segreduce_smem_limit.argtypes = [ctypes.c_int]
    lib.segreduce_smem_limit.restype = ctypes.c_int


LIBRARY = CudaLibrary("segreduce", SOURCE, _configure)


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    return LIBRARY.load()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class Layout:
    """How one launch splits its work (see the source's design note).

    regime 0 (a float sum, small K): ``n_warps`` warps (whole blocks), each
    reducing ``rows_per_warp`` rows into a table of all K keys in shared
    memory.
    regime 1 (a float sum, large K): ``n_buckets`` key ranges of
    2^``bucket_shift`` keys, folded by blocks of ``reduce_warps`` warps;
    with ``small`` (N at most ``small_limit(n_buckets)``), one launch of one
    block a range over every row; else a histogram and a scatter of
    ``n_tiles`` tiles of TILE_ROWS rows partition the rows by range, and
    ``n_blocks`` fold blocks take pieces of at most ``piece_rows`` rows.
    regime 2 (no float sum: small K, one table, or fewer rows than keys):
    ``n_blocks`` blocks of atomics, into a table of all K keys in shared
    memory each, added into the outputs, when ``atomic_smem``, else straight
    into the outputs.
    regime 3 (no float sum, large K): a histogram of ``n_blocks`` blocks and
    a scatter of ``n_tiles`` tiles of PART_TILE rows partition the rows into
    ``n_buckets`` ranges of 2^``bucket_shift`` keys; one block a range
    folds them in shared memory.
    ``scratch_words``: the 32-bit words of the ``scratch`` table the launch
    allocates (regime 0's per-block tables)."""

    regime: int
    n_warps: int = 0
    rows_per_warp: int = 0
    n_buckets: int = 0
    keys_per_bucket: int = 0
    n_tiles: int = 0
    reduce_warps: int = 0
    n_blocks: int = 0
    atomic_smem: bool = False
    bucket_shift: int = 0
    scratch_words: int = 0
    piece_rows: int = 0
    small: bool = False


def table_layout(
    n: int, num_keys: int, n_tables: int, smem_limit: int, n_sms: int, float_sum: bool = True
) -> Layout:
    """The layout of one launch over ``n`` rows, ``num_keys`` keys and
    ``n_tables`` accumulator columns (aggregates plus presence);
    ``float_sum`` says whether any aggregate is a floating-point sum."""
    if not float_sum:
        # tables of every key that leave room for four blocks an SM take the
        # rows directly; past that limit the rows are partitioned by key
        # range first, whatever their order, when there are at least two
        # tables and as many rows as keys.  The partition's passes cost
        # about what one L2 atomic a row does, so with one table, or fewer
        # rows than keys, the rows go straight into the outputs.
        atomic_smem = n_tables * num_keys * 4 <= smem_limit // 4
        if atomic_smem or n_tables < 2 or n < num_keys:
            return direct_layout(n, n_sms, atomic_smem)
        return partition_layout(n, num_keys, n_tables, smem_limit, n_sms)
    per_key = WARPS_PER_BLOCK * n_tables * 4  # shared bytes per key of a block
    if num_keys * per_key <= smem_limit:
        n_blocks = max(1, min(n_sms * BLOCKS_PER_SM, _ceil_div(n, WARPS_PER_BLOCK * ROWS_PER_WARP_MIN)))
        n_warps = n_blocks * WARPS_PER_BLOCK
        rows_per_warp = 32 * max(1, _ceil_div(_ceil_div(max(n, 1), n_warps), 32))
        return Layout(0, n_warps=n_warps, rows_per_warp=rows_per_warp,
                      scratch_words=n_blocks * n_tables * num_keys)
    return ordered_layout(n, num_keys, n_tables, smem_limit, n_sms)


def small_limit(n_buckets: int) -> int:
    """The most rows regime 1 takes in one launch over ``n_buckets`` ranges."""
    return SMALL_READS // n_buckets


def ordered_layout(n: int, num_keys: int, n_tables: int, smem_limit: int, n_sms: int) -> Layout:
    """Regime 1: ranges of a power of two of keys (at most 2^16, the 16-bit
    key offsets), the widest whose per-warp tables (and the fold's copy of
    where the ranges and their pieces start) leave room for two fold blocks
    of eight warps an SM; wider (one block, then fewer warps) only when the
    ranges would be too many for the scatter's shared memory.  At most
    ``small_limit`` rows take the one-launch path.  The fold's grid is what
    fits on the card at once, and no more than there can be pieces."""
    for warps, room in ((WARPS_PER_BLOCK, smem_limit // 2), (WARPS_PER_BLOCK, smem_limit),
                        (4, smem_limit), (2, smem_limit), (1, smem_limit)):
        widest = min(1 << 16, room // (warps * n_tables * 4))
        if widest < 1:
            continue
        shift = widest.bit_length() - 1
        n_buckets = _ceil_div(num_keys, 1 << shift)
        fold_bytes = ordered_fold_smem_bytes(warps, n_tables, shift, n_buckets)
        if (n_buckets < 1 << 16 and fold_bytes <= room
                and ordered_scatter_smem_bytes(n_buckets) <= smem_limit):
            fold_blocks = n_sms * max(1, min(2048 // (32 * warps), smem_limit // fold_bytes))
            return Layout(
                1, n_buckets=n_buckets, keys_per_bucket=1 << shift, bucket_shift=shift,
                n_tiles=max(1, _ceil_div(n, TILE_ROWS)), reduce_warps=warps,
                n_blocks=min(fold_blocks, max_pieces(n, n_buckets)), piece_rows=PIECE_ROWS,
                small=n <= small_limit(n_buckets),
            )
    raise ValueError(
        f"num_keys={num_keys} with {n_tables} accumulator columns is beyond the "
        "segreduce kernel's key ranges"
    )


def max_pieces(n: int, n_buckets: int) -> int:
    """The most pieces regime 1's fold can cut ``n`` rows over ``n_buckets``
    ranges into: every range a piece of fewer than PIECE_ROWS rows, and the
    rest whole pieces."""
    return _ceil_div(n, PIECE_ROWS) + n_buckets


def piece_cuts(counts: Sequence[int], piece_rows: int = PIECE_ROWS) -> list:
    """Regime 1's pieces, as the source's histogram cuts them: range b's
    c = counts[b] rows (placed after the rows of ranges before it) make
    max(1, ceil(c / piece_rows)) pieces, piece i of np holding its rows
    [c i // np, c (i + 1) // np).  A list of (range, first row, end row)
    in piece order: fixed by the counts alone."""
    cuts, start = [], 0
    for b, c in enumerate(counts):
        np_ = max(1, _ceil_div(c, piece_rows))
        cuts.extend((b, start + c * i // np_, start + c * (i + 1) // np_) for i in range(np_))
        start += c
    return cuts


def tile_levels(n_tiles: int) -> list:
    """Nodes a level of regime 1's prefix tree over ``n_tiles`` tiles: a
    node a tile, then a node a GROUP nodes of the level below, up to one."""
    levels = [n_tiles]
    while levels[-1] > 1:
        levels.append(_ceil_div(levels[-1], GROUP))
    return levels


def scratch(lay: Layout, n: int, n_values: int, n_tables: int) -> dict:
    """{SegParams field: (elements, torch dtype)} of the scratch a launch of
    ``lay`` allocates: regime 0's per-block tables; regime 1's counters
    (part_ranges: range and piece starts, the fold's ticket, a counter a
    node of the prefix tree above the tiles, a counter a piece), the
    prefix tree (a row of ranges a node), 16-bit key offsets and value
    words of the partitioned rows, and a folded table a piece; regime 3's
    counters, key offsets and value words.  Regime 1's one-launch path and
    regime 2 take none."""
    if lay.regime == 0:
        return {"scratch": (lay.scratch_words, torch.int32)}
    if lay.regime == 3:
        return {
            "part_ranges": (2 * lay.n_buckets + 2, torch.int32),
            "part_off": (n, torch.int16),
            "part_vals": (n_values * n, torch.int32),
        }
    if lay.regime == 1 and not lay.small:
        pieces = max_pieces(n, lay.n_buckets)
        levels = tile_levels(lay.n_tiles)
        return {
            "part_ranges": (2 * lay.n_buckets + 3 + sum(levels[1:]) + pieces, torch.int32),
            "tile_prefix": (sum(levels) * lay.n_buckets, torch.int32),
            "part_off": (n, torch.int16),
            "part_vals": (n_values * n, torch.int32),
            "partials": (pieces * n_tables * lay.keys_per_bucket, torch.int32),
        }
    return {}


def direct_layout(n: int, n_sms: int, atomic_smem: bool) -> Layout:
    """Regime 2: a block of 256 threads every 256 rows, at most eight an SM."""
    return Layout(2, n_blocks=max(1, min(n_sms * 8, _ceil_div(n, 256))), atomic_smem=atomic_smem)


def partition_layout(n: int, num_keys: int, n_tables: int, smem_limit: int, n_sms: int) -> Layout:
    """Regime 3: ranges of a power of two of keys (at most 2^16, the 16-bit
    key offsets), the widest that give every SM two ranges to fold and
    whose tables leave room for four folding blocks an SM, else for one."""
    for room in (smem_limit // 4, smem_limit):
        widest = min(1 << 16, room // (n_tables * 4), _ceil_div(num_keys, 2 * n_sms))
        if widest < 1:
            continue
        shift = widest.bit_length() - 1
        n_buckets = _ceil_div(num_keys, 1 << shift)
        if part_scatter_smem_bytes(n_buckets) <= smem_limit:
            return Layout(
                3, n_buckets=n_buckets, keys_per_bucket=1 << shift, bucket_shift=shift,
                n_tiles=max(1, _ceil_div(n, PART_TILE)),
                n_blocks=max(1, min(4 * n_sms, _ceil_div(n, PART_TILE))),
            )
    raise ValueError(
        f"num_keys={num_keys} with {n_tables} accumulator columns is beyond the "
        "segreduce kernel's key ranges"
    )


def part_scatter_smem_bytes(n_buckets: int) -> int:
    """Shared memory of regime 3's scatter: two arrays of the ranges; for
    every row of its tile, its range and key offset (16 bits each; later a
    value column's 32-bit word, staged), and its place; the range and key
    offset of every place (16 bits each); and the scan's own (static)
    shared arrays."""
    return 2 * n_buckets * 4 + 5 * PART_TILE * 2 + 256


def ordered_scatter_smem_bytes(n_buckets: int) -> int:
    """Shared memory of regime 1's scatter: every warp's rows a range, and
    two arrays of the ranges; for every row of its tile, a listed key (later
    a value column's staged word), its row, its place, and a place's range
    and key offset (16 bits each); and the static shared words (the scan's
    among them)."""
    return (ORD_WARPS + 2) * n_buckets * 4 + TILE_ROWS * (4 + 4 * 2) + 256


def ordered_fold_smem_bytes(warps: int, n_tables: int, shift: int, n_buckets: int) -> int:
    """Shared memory of regime 1's fold (and one-launch) block: a table of
    2^shift keys a warp and table, where each range and its pieces start,
    and the static shared words."""
    return (warps * n_tables * 4 << shift) + 2 * (n_buckets + 1) * 4 + 64


def launch(
    keys: torch.Tensor,
    values: Sequence[torch.Tensor],
    ops: Sequence[str],
    num_keys: int,
    mask: Optional[torch.Tensor],
    with_presence: bool,
    lib: CudaLibrary = LIBRARY,
    layout: Optional[Layout] = None,
    scratch_spec: Optional[dict] = None,
) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor]]:
    """One launch of the kernel on CUDA tensors the caller has checked:
    keys int32 (N,), mask bool (N,) or None, at most MAX_AGGS value columns
    of (N,) in the types of ``_VTYPES``, all contiguous on one device.
    Outputs and scratch are allocated here; the kernel runs on the
    device's current stream.  ``lib``, ``layout`` and ``scratch_spec`` (as
    ``scratch`` returns it) name another build, its layout and its scratch
    (an earlier source, timed beside this one); by default this source,
    ``table_layout`` and ``scratch``."""
    lib = lib.load()
    device = keys.device
    index = device.index if device.index is not None else torch.cuda.current_device()
    n = int(keys.shape[0])
    n_tables = len(values) + (1 if with_presence else 0)
    props = torch.cuda.get_device_properties(index)
    float_sum = any(op == "sum" and v.dtype.is_floating_point for v, op in zip(values, ops))
    lay = layout or table_layout(
        n, num_keys, n_tables, lib.segreduce_smem_limit(index), props.multi_processor_count,
        float_sum,
    )
    outs = tuple(torch.empty((num_keys,), dtype=v.dtype, device=device) for v in values)
    pres = torch.empty((num_keys,), dtype=torch.int32, device=device) if with_presence else None

    spec = scratch(lay, n, len(values), n_tables) if scratch_spec is None else scratch_spec
    buffers = {field: torch.empty((count,), dtype=dtype, device=device)
               for field, (count, dtype) in spec.items() if count}

    p = _SegParams()
    p.keys = keys.data_ptr()
    p.mask = mask.data_ptr() if mask is not None else None
    for i, (v, o, op) in enumerate(zip(values, outs, ops)):
        p.vals[i] = v.data_ptr()
        p.out[i] = o.data_ptr()
        p.vtype[i] = _VTYPES[v.dtype]
        p.op[i] = _OPCODES[op]
    p.presence = pres.data_ptr() if pres is not None else None
    for field, t in buffers.items():
        setattr(p, field, t.data_ptr())
    p.n_rows = n
    p.rows_per_warp = lay.rows_per_warp
    p.num_keys = num_keys
    p.n_aggs = len(values)
    p.with_presence = int(with_presence)
    p.n_warps = lay.n_warps
    p.regime = lay.regime
    p.device = index
    p.n_buckets = lay.n_buckets
    p.keys_per_bucket = lay.keys_per_bucket
    p.n_tiles = lay.n_tiles
    p.reduce_warps = lay.reduce_warps
    p.n_blocks = lay.n_blocks
    p.atomic_smem = int(lay.atomic_smem)
    p.bucket_shift = lay.bucket_shift
    p.piece_rows = lay.piece_rows
    p.small_n = int(lay.small)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.segreduce_launch(ctypes.byref(p), stream)
    if rc != 0:
        raise RuntimeError(f"segreduce kernel launch failed with cudaError {rc}")
    return outs, pres
