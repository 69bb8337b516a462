# The hand-written CUDA WKV6 kernel (csrc/wkv6.cu): its ctypes binding, the
# split of the work (chunk length and sequence segments) and one launch; and
# its gradient (csrc/wkv6_bwd.cu): its binding, workspace and one backward
# (``launch_bwd``).
# The build (nvcc at first use into ``build/kernels/``, keyed by a hash of
# the source) is the shared helper in ``kernels/_build.py``.
# Nothing here runs at import time.
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .._build import CudaLibrary
from .ref import CHUNK

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
BWD_SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6_bwd.cu"

# The head sizes the kernel is built for (rwkv6's 64, its reduced configs'
# 16).  Its chunk length (L in the source) is ref.CHUNK, which the plain twin
# of its arithmetic shares: L = 32 lost to L = 16 in both of the chunked
# kernel's first designs at rwkv6-3b's shapes (twice the within-chunk exps a
# token, half the blocks an SM; PERF.md §6) and is not built.
HEAD_SIZES = (16, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The segment rule: one segment wherever the heads give every SM
# FILL_ONE_PASS blocks (a serving batch: cutting 8 x 40 heads in two lost
# 11% to the states pass; the card holds three blocks of the scan an SM at
# K = 64 in bf16, ``library_info``), else segments until they give FILL
# blocks an SM (one long prompt: 26-33 segments of 1 x 16384 were the
# fastest; PERF.md §6), none shorter than MIN_SEGMENT_CHUNKS chunks.
FILL_ONE_PASS = 2
FILL = 8
MIN_SEGMENT_CHUNKS = 8


def configure_launches(lib: ctypes.CDLL) -> None:
    """Binds the one-pass and the segmented launch, which this source and
    the per-token scan before it both have with these C signatures."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.wkv6_launch.restype = ctypes.c_int
    lib.wkv6_launch_segmented.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p, p, i, p]
    lib.wkv6_launch_segmented.restype = ctypes.c_int


def _configure(lib: ctypes.CDLL) -> None:
    configure_launches(lib)
    i = ctypes.c_int
    lib.wkv6_info.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.wkv6_info.restype = ctypes.c_int


LIBRARY = CudaLibrary("wkv6", SOURCE, _configure)


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    return LIBRARY.load()


def library_info(dtype: torch.dtype, K: int, with_y: bool = True, device: int = 0) -> dict:
    """What one instance of the chunked kernel takes on the card, read back
    from the library: registers a thread, dynamic shared bytes a block,
    blocks resident on an SM, spilled bytes a thread.  ``with_y`` False is
    the states pass."""
    out = (ctypes.c_int * 4)()
    rc = library().wkv6_info(_DTYPES[dtype], K, CHUNK, int(with_y), device, out)
    if rc != 0:
        raise RuntimeError(f"wkv6_info failed with cudaError {rc}")
    return {"registers": out[0], "smem": out[1], "blocks_per_sm": out[2], "spill_bytes": out[3]}


def segment_length(S: int, n_seg: int) -> int:
    """Tokens of each of ``n_seg`` segments of S (the last may be shorter):
    a multiple of the chunk length."""
    per = -(-max(S, 1) // n_seg)
    return -(-per // CHUNK) * CHUNK


def segments(B: int, H: int, S: int, K: int, sms: int) -> int:
    """How many segments the sequence is cut into, each run by its own
    blocks from the state the segments before it leave (see the source):
    one wherever the B * H heads give each of the card's ``sms`` SMs
    FILL_ONE_PASS blocks; otherwise as many as give each FILL, but no
    segment shorter than MIN_SEGMENT_CHUNKS chunks and none empty (the count
    is that of segments of ``segment_length`` tokens)."""
    del K  # the rule is the same for both head sizes
    heads = max(B * H, 1)
    if heads >= FILL_ONE_PASS * sms:
        return 1
    want = -(-FILL * sms // heads)
    most = max(S, 1) // (MIN_SEGMENT_CHUNKS * CHUNK)
    n = max(1, min(want, most))
    return -(-max(S, 1) // segment_length(S, n))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernel copies its inputs in 16-byte pieces."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    S0: Optional[torch.Tensor], lib: CudaLibrary = LIBRARY, n_seg: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch on CUDA tensors the caller has checked: r, k, v (B, S, H,
    K) of one type of ``_DTYPES``, log_w (B, S, H, K) f32, S0 (B, H, K, K)
    f32 or None, all contiguous on one device.  u is taken in f32.  The
    outputs and the segments' workspace are allocated here; the kernels run
    on the current stream.  ``lib`` and ``n_seg`` name another build and a
    segment count; by default this source and ``segments``."""
    if r.dtype not in _DTYPES:
        raise TypeError(f"the wkv6 kernel takes float32 or bfloat16 r, k and v, not {r.dtype}")
    B, S, H, K = r.shape
    if K not in HEAD_SIZES:
        raise ValueError(f"head size {K} is not one of the wkv6 kernel's {HEAD_SIZES}")
    r, k, v, log_w = (_aligned(t) for t in (r, k, v, log_w))
    u32 = u.to(torch.float32).contiguous()
    y = torch.empty((B, S, H, K), dtype=torch.float32, device=r.device)
    s_out = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    device = r.device.index if r.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    sms = torch.cuda.get_device_properties(r.device).multi_processor_count
    n_seg = segments(B, H, S, K, sms) if n_seg is None else n_seg
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u32.data_ptr(),
            None if S0 is None else S0.data_ptr(), y.data_ptr(), s_out.data_ptr(), _DTYPES[r.dtype],
            B, S, H, K, CHUNK)
    if n_seg == 1:
        rc = lib.load().wkv6_launch(*args, device, stream)
    else:
        states = torch.empty((B, H, n_seg, K, K), dtype=torch.float32, device=r.device)
        decay = torch.empty((B, H, n_seg, K), dtype=torch.float32, device=r.device)
        rc = lib.load().wkv6_launch_segmented(
            *args, n_seg, segment_length(S, n_seg), states.data_ptr(), decay.data_ptr(), device, stream,
        )
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed with cudaError {rc}")
    return y, s_out


def _configure_bwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, p, p, p, ctypes.c_int64,
                                    i, i, i, i, i, i, i, i, i, p]
    lib.wkv6_bwd_launch.restype = ctypes.c_int
    lib.wkv6_bwd_info.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.wkv6_bwd_info.restype = ctypes.c_int


BWD_LIBRARY = CudaLibrary("wkv6_bwd", BWD_SOURCE, _configure_bwd)

# The backward's segment: the tokens one block of its chunk pass walks, and
# the most it takes: two groups of BWD_NC = 4 chunks in the source, whose
# states it keeps in shared memory (the rebuild runs again from the
# segment's first state for the second group).  Eight chunks give the 2 x
# 40 heads of rwkv6-3b's training microbatch 1,280 blocks at 2048 tokens,
# and half the states pass and carries of segments of four.
BWD_SEGMENT = 8 * CHUNK


def bwd_segments(S: int, seg_len: int = BWD_SEGMENT) -> int:
    """How many segments of ``seg_len`` tokens the backward cuts S into (one
    for S = 0)."""
    return max(1, -(-S // seg_len))


def bwd_work_floats(B: int, S: int, H: int, K: int, seg_len: int = BWD_SEGMENT) -> int:
    """f32 workspace of one backward (csrc/wkv6_bwd.cu's ``work``, which
    refuses less): each segment's state and its gradient (B, H, n_seg, K,
    K) each, its decay (B, H, n_seg, K) and du's (b, segment) partials (B,
    n_seg, H, K)."""
    n_seg = bwd_segments(S, seg_len)
    return 2 * B * H * n_seg * K * K + 2 * B * H * n_seg * K


def bwd_library_info(dtype: torch.dtype, K: int, chunks: bool = True, device: int = 0) -> dict:
    """What one instance of the backward's chunk pass (``chunks``) or its
    states pass takes on the card, read back from the library: registers a
    thread, dynamic shared bytes a block, blocks resident on an SM, spilled
    bytes a thread."""
    out = (ctypes.c_int * 4)()
    rc = BWD_LIBRARY.load().wkv6_bwd_info(_DTYPES[dtype], K, int(chunks), device, out)
    if rc != 0:
        raise RuntimeError(f"wkv6_bwd_info failed with cudaError {rc}")
    return {"registers": out[0], "smem": out[1], "blocks_per_sm": out[2], "spill_bytes": out[3]}


def launch_bwd(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    S0: Optional[torch.Tensor], dy: torch.Tensor, dS_out: Optional[torch.Tensor],
    lib: CudaLibrary = BWD_LIBRARY, seg_len: int = BWD_SEGMENT,
) -> Tuple[torch.Tensor, ...]:
    """One backward on CUDA tensors the caller has checked: r, k, v (B, S,
    H, K) of one type of ``_DTYPES``, K in HEAD_SIZES, log_w and dy (B, S,
    H, K) f32, u (H, K) f32 or bf16, S0 and dS_out (B, H, K, K) f32 or None,
    all contiguous on one device, over segments of ``seg_len`` tokens (a
    multiple of CHUNK up to BWD_SEGMENT).  The outputs and the workspace
    (``bwd_work_floats``) are allocated here; the kernels run on the current
    stream.  Returns (dr, dk, dv) in r's type, dlog_w f32, du in u's type
    and dS0 f32."""
    if r.dtype not in _DTYPES or u.dtype not in _DTYPES:
        raise TypeError(f"the wkv6 backward takes float32 or bfloat16 r, k, v and u, not {r.dtype}, {u.dtype}")
    B, S, H, K = r.shape
    if K not in HEAD_SIZES:
        raise ValueError(f"head size {K} is not one of the wkv6 backward's {HEAD_SIZES}")
    if seg_len % CHUNK or not 0 < seg_len <= BWD_SEGMENT:
        raise ValueError(f"the wkv6 backward's segment is a multiple of {CHUNK} up to {BWD_SEGMENT}, not {seg_len}")
    r, k, v, log_w, dy = (_aligned(t) for t in (r, k, v, log_w, dy))
    u32 = u.to(torch.float32).contiguous()
    n_work = bwd_work_floats(B, S, H, K, seg_len)
    work = torch.empty(n_work, dtype=torch.float32, device=r.device)
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dlog_w = torch.empty((B, S, H, K), dtype=torch.float32, device=r.device)
    du = torch.empty((H, K), dtype=u.dtype, device=r.device)
    dS0 = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    device = r.device.index if r.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = lib.load().wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u32.data_ptr(),
        None if S0 is None else S0.data_ptr(), dy.data_ptr(), None if dS_out is None else dS_out.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlog_w.data_ptr(), du.data_ptr(), dS0.data_ptr(),
        work.data_ptr(), n_work, _DTYPES[r.dtype], _DTYPES[u.dtype], B, S, H, K, bwd_segments(S, seg_len),
        seg_len, device, stream,
    )
    if rc != 0:
        raise RuntimeError(f"wkv6 backward kernel launch failed with cudaError {rc}")
    return dr, dk, dv, dlog_w, du, dS0
