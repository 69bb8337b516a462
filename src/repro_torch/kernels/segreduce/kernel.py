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
    regime 2 (no float sum): ``n_blocks`` blocks of atomics, into per-block
    tables in shared memory when ``atomic_smem``."""

    regime: int
    n_warps: int = 0
    rows_per_warp: int = 0
    n_buckets: int = 0
    keys_per_bucket: int = 0
    n_tiles: int = 0
    reduce_warps: int = 0
    n_blocks: int = 0
    atomic_smem: bool = False


def table_layout(
    n: int, num_keys: int, n_tables: int, smem_limit: int, n_sms: int, float_sum: bool = True
) -> Layout:
    """The layout of one launch over ``n`` rows, ``num_keys`` keys and
    ``n_tables`` accumulator columns (aggregates plus presence);
    ``float_sum`` says whether any aggregate is a floating-point sum."""
    if not float_sum:
        n_blocks = max(1, min(n_sms * 8, _ceil_div(n, 256 * 16)))
        return Layout(2, n_blocks=n_blocks, atomic_smem=n_tables * num_keys * 4 <= smem_limit // 4)
    per_key = WARPS_PER_BLOCK * n_tables * 4  # shared bytes per key of a block
    if num_keys * per_key <= smem_limit:
        n_blocks = max(1, min(n_sms * BLOCKS_PER_SM, _ceil_div(n, WARPS_PER_BLOCK * ROWS_PER_WARP_MIN)))
        n_warps = n_blocks * WARPS_PER_BLOCK
        rows_per_warp = 32 * max(1, _ceil_div(_ceil_div(max(n, 1), n_warps), 32))
        return Layout(0, n_warps=n_warps, rows_per_warp=rows_per_warp)
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
) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor]]:
    """One launch of the kernel on CUDA tensors the caller has checked:
    keys int32 (N,), mask bool (N,) or None, at most MAX_AGGS value columns
    of (N,) in the types of ``_VTYPES``, all contiguous on one device.
    Outputs and scratch are allocated here; the kernel runs on the
    device's current stream."""
    lib = library()
    device = keys.device
    index = device.index if device.index is not None else torch.cuda.current_device()
    n = int(keys.shape[0])
    n_tables = len(values) + (1 if with_presence else 0)
    props = torch.cuda.get_device_properties(index)
    float_sum = any(op == "sum" and v.dtype.is_floating_point for v, op in zip(values, ops))
    lay = table_layout(
        n, num_keys, n_tables, lib.segreduce_smem_limit(index), props.multi_processor_count,
        float_sum,
    )
    outs = tuple(torch.empty((num_keys,), dtype=v.dtype, device=device) for v in values)
    pres = torch.empty((num_keys,), dtype=torch.int32, device=device) if with_presence else None

    def words(count: int) -> torch.Tensor:
        return torch.empty((count,), dtype=torch.int32, device=device)

    if lay.regime == 0:
        scratch = {"scratch": words(lay.n_warps // WARPS_PER_BLOCK * n_tables * num_keys)}
    elif lay.regime == 2:
        scratch = {"scratch": words(n_tables * num_keys)}
    else:
        scratch = {
            "counts": words(lay.n_tiles * lay.n_buckets),
            "bucket_start": words(lay.n_buckets + 1),
            "part_keys": words(n),
            "part_vals": words(len(values) * n),
        }

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
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.segreduce_launch(ctypes.byref(p), stream)
    if rc != 0:
        raise RuntimeError(f"segreduce kernel launch failed with cudaError {rc}")
    return outs, pres
