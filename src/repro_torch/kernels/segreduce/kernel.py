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
TILE_ROWS = 8192         # SEG_TILE_ROWS in the source: rows a partition warp takes
PART_TILE = 8192         # SEG_PART_TILE in the source: rows of a regime-3 scatter block
ROWS_PER_WARP_MIN = 1024  # fewer rows per warp buy nothing but table traffic
BLOCKS_PER_SM = 4

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
    regime 1 (a float sum, large K): ``n_tiles`` tiles of TILE_ROWS rows
    partitioned into ``n_buckets`` key ranges of ``keys_per_bucket`` keys,
    one block of ``reduce_warps`` warps a range.
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
    # key ranges as wide as shared memory allows, but narrow enough to give
    # every SM two ranges to reduce; fewer warps a range (wider tables) only
    # when the ranges would be too many for the scatter's shared memory
    for warps in (WARPS_PER_BLOCK, 4, 2, 1):
        widest = smem_limit // (warps * n_tables * 4)
        keys_per_bucket = max(32, min(widest, _ceil_div(num_keys, 2 * n_sms)))
        n_buckets = _ceil_div(num_keys, keys_per_bucket)
        if scatter_smem_bytes(n_buckets) <= smem_limit:
            return Layout(
                1, n_buckets=n_buckets, keys_per_bucket=keys_per_bucket,
                n_tiles=max(1, _ceil_div(n, TILE_ROWS)), reduce_warps=warps,
            )
    raise ValueError(
        f"num_keys={num_keys} with {n_tables} accumulator columns is beyond the "
        "segreduce kernel's key ranges"
    )


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


def scatter_smem_bytes(n_buckets: int) -> int:
    """Shared memory of the partition scatter: per-warp bucket counts, two
    bucket arrays, a count, the tile's row order, and the scan's own
    (static) shared arrays."""
    return (WARPS_PER_BLOCK * n_buckets + 2 * n_buckets + 1) * 4 + TILE_ROWS * 2 + 256


def launch(
    keys: torch.Tensor,
    values: Sequence[torch.Tensor],
    ops: Sequence[str],
    num_keys: int,
    mask: Optional[torch.Tensor],
    with_presence: bool,
    lib: CudaLibrary = LIBRARY,
    layout: Optional[Layout] = None,
) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor]]:
    """One launch of the kernel on CUDA tensors the caller has checked:
    keys int32 (N,), mask bool (N,) or None, at most MAX_AGGS value columns
    of (N,) in the types of ``_VTYPES``, all contiguous on one device.
    Outputs and scratch are allocated here; the kernel runs on the
    device's current stream.  ``lib`` and ``layout`` name another build and
    its layout (an earlier source, timed beside this one); by default this
    source and ``table_layout``."""
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

    def words(count: int) -> torch.Tensor:
        return torch.empty((count,), dtype=torch.int32, device=device)

    scratch = {"scratch": words(lay.scratch_words)} if lay.scratch_words else {}
    if lay.regime == 3:
        scratch.update({
            "part_ranges": words(2 * lay.n_buckets + 2),
            "part_off": torch.empty((n,), dtype=torch.int16, device=device),
            "part_vals": words(len(values) * n),
        })
    elif lay.regime == 1:
        scratch.update({
            "counts": words(lay.n_tiles * lay.n_buckets),
            "bucket_start": words(lay.n_buckets + 1),
            "part_keys": words(n),
            "part_vals": words(len(values) * n),
        })

    p = _SegParams()
    p.keys = keys.data_ptr()
    p.mask = mask.data_ptr() if mask is not None else None
    for i, (v, o, op) in enumerate(zip(values, outs, ops)):
        p.vals[i] = v.data_ptr()
        p.out[i] = o.data_ptr()
        p.vtype[i] = _VTYPES[v.dtype]
        p.op[i] = _OPCODES[op]
    p.presence = pres.data_ptr() if pres is not None else None
    for field, t in scratch.items():
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
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.segreduce_launch(ctypes.byref(p), stream)
    if rc != 0:
        raise RuntimeError(f"segreduce kernel launch failed with cudaError {rc}")
    return outs, pres
