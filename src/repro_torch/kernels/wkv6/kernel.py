# The hand-written CUDA WKV6 kernel (csrc/wkv6.cu): its ctypes binding, the
# split of the work (row split and sequence segments) and one launch.  The
# build (nvcc at first use into ``build/kernels/``, keyed by a hash of the
# source) is the shared helper in ``kernels/_build.py``.
# Nothing here runs at import time.
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .._build import CudaLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"

# The head sizes the kernel is built for (rwkv6's 64, its reduced configs'
# 16) and the row splits (KS in the source) built for each, fewest first.
ROW_SPLITS = {16: (4,), 64: (4, 8, 16)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


TOKENS_STAGED = 16  # WKV_TT in the source: a segment is a multiple of it
# Blocks of 64 threads an SM holds at K = 64: a thread of the scan needs
# 200-255 registers.
BLOCKS_PER_SM = 4


def configure_single(lib: ctypes.CDLL) -> None:
    """Binds the one-pass launch (every build of the source has it)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.wkv6_launch.restype = ctypes.c_int


def _configure(lib: ctypes.CDLL) -> None:
    configure_single(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_launch_segmented.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p, p, i, p]
    lib.wkv6_launch_segmented.restype = ctypes.c_int


LIBRARY = CudaLibrary("wkv6", SOURCE, _configure)


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    return LIBRARY.load()


def columns_per_thread(K: int) -> int:
    """C in the source: 4, so that each read of r, k and w feeds four state
    columns; 1 at K = 16, whose row slices would otherwise be one row."""
    return 1 if K == 16 else 4


def _blocks(B: int, H: int, K: int, ks: int) -> int:
    """Blocks of one pass of the scan over B * H heads at row split ks."""
    return B * H * K * ks // (64 * columns_per_thread(K))


def row_split(B: int, H: int, K: int, sms: int) -> int:
    """Threads that share the columns of a head's state, each with K / KS of
    its rows (KS in the source).  A block of 64 threads owns 64 C / KS
    columns, so a larger KS gives more, thinner blocks: the fewest built
    split that gives two blocks for each of the card's ``sms`` SMs, else the
    most (one long prompt, where B * H is small).  At K = 64 a thread needs
    200-255 registers, so four blocks fill an SM, and a grid of more than
    four blocks per SM runs in two waves."""
    splits = ROW_SPLITS[K]
    for ks in splits:
        if _blocks(B, H, K, ks) >= 2 * sms:
            return ks
    return splits[-1]


def segment_length(S: int, n_seg: int) -> int:
    """Tokens of each of ``n_seg`` segments of S (the last may be shorter):
    a multiple of the tokens the scan stages at a time."""
    per = -(-max(S, 1) // n_seg)
    return -(-per // TOKENS_STAGED) * TOKENS_STAGED


def segments(B: int, H: int, S: int, K: int, sms: int) -> int:
    """How many segments the sequence is cut into, each scanned by its own
    blocks from the state the segments before it leave (see the source).
    One wherever the heads give the card's ``sms`` SMs two blocks each at
    the fewest row split (a batch of prompts); otherwise (one long prompt)
    as many as fill the card in one wave, BLOCKS_PER_SM blocks an SM.  No
    segment is empty: the count is that of segments of
    ``segment_length`` tokens."""
    per_seg = _blocks(B, H, K, ROW_SPLITS[K][0])
    if per_seg >= 2 * sms:
        return 1
    n = max(1, BLOCKS_PER_SM * sms // per_seg)
    return -(-max(S, 1) // segment_length(S, n))


def launch(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    S0: Optional[torch.Tensor], lib: CudaLibrary = LIBRARY, n_seg: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch on CUDA tensors the caller has checked: r, k, v (B, S, H,
    K) of one type of ``_DTYPES``, log_w (B, S, H, K) f32, S0 (B, H, K, K)
    f32 or None, all contiguous on one device.  u is taken in f32.  The
    outputs and the segments' workspace are allocated here; the kernels run
    on the current stream.  ``lib`` and ``n_seg`` name another build and a
    segment count (an earlier source, timed beside this one, takes
    ``n_seg=1``); by default this source and ``segments``."""
    if r.dtype not in _DTYPES:
        raise TypeError(f"the wkv6 kernel takes float32 or bfloat16 r, k and v, not {r.dtype}")
    B, S, H, K = r.shape
    if K not in ROW_SPLITS:
        raise ValueError(f"head size {K} is not one of the wkv6 kernel's {tuple(ROW_SPLITS)}")
    u32 = u.to(torch.float32).contiguous()
    y = torch.empty((B, S, H, K), dtype=torch.float32, device=r.device)
    s_out = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    device = r.device.index if r.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    sms = torch.cuda.get_device_properties(r.device).multi_processor_count
    n_seg = segments(B, H, S, K, sms) if n_seg is None else n_seg
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u32.data_ptr(),
            None if S0 is None else S0.data_ptr(), y.data_ptr(), s_out.data_ptr(), _DTYPES[r.dtype],
            B, S, H, K)
    if n_seg == 1:
        rc = lib.load().wkv6_launch(*args, row_split(B, H, K, sms), device, stream)
    else:
        states = torch.empty((B, H, n_seg, K, K), dtype=torch.float32, device=r.device)
        decay = torch.empty((B, H, n_seg, K), dtype=torch.float32, device=r.device)
        rc = lib.load().wkv6_launch_segmented(
            *args, ROW_SPLITS[K][0], n_seg, segment_length(S, n_seg), states.data_ptr(), decay.data_ptr(),
            device, stream,
        )
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed with cudaError {rc}")
    return y, s_out
