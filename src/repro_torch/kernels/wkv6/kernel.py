# The hand-written CUDA WKV6 kernel (csrc/wkv6.cu): its ctypes binding and
# one launch.  The build (nvcc at first use into ``build/kernels/``, keyed by
# a hash of the source) is the shared helper in ``kernels/_build.py``.
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


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.wkv6_launch.restype = ctypes.c_int


LIBRARY = CudaLibrary("wkv6", SOURCE, _configure)


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    return LIBRARY.load()


def columns_per_thread(K: int) -> int:
    """C in the source: 4, so that each read of r, k and w feeds four state
    columns; 1 at K = 16, whose row slices would otherwise be one row."""
    return 1 if K == 16 else 4


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
        if B * H * K * ks // (64 * columns_per_thread(K)) >= 2 * sms:
            return ks
    return splits[-1]


def launch(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    S0: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch on CUDA tensors the caller has checked: r, k, v (B, S, H,
    K) of one type of ``_DTYPES``, log_w (B, S, H, K) f32, S0 (B, H, K, K)
    f32 or None, all contiguous on one device.  u is taken in f32.  The
    outputs are allocated here; the kernel runs on the current stream."""
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
    rc = library().wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u32.data_ptr(),
        None if S0 is None else S0.data_ptr(), y.data_ptr(), s_out.data_ptr(), _DTYPES[r.dtype],
        B, S, H, K, row_split(B, H, K, torch.cuda.get_device_properties(r.device).multi_processor_count),
        device, stream,
    )
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed with cudaError {rc}")
    return y, s_out
