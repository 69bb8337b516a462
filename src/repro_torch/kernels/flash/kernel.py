# The hand-written CUDA flash-attention forward kernel (csrc/flash_fwd.cu):
# its ctypes binding and one launch.  The build (nvcc at first use into
# ``build/kernels/``, keyed by a hash of the source) is the shared helper in
# ``kernels/_build.py``.  Nothing here runs at import time.
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from .._build import CudaLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"

HEAD_DIMS = (32, 64, 128, 256)  # the head dims the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _configure(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, f, f, i, p]
    lib.flash_fwd_launch.restype = ctypes.c_int


LIBRARY = CudaLibrary("flash_fwd", SOURCE, _configure)


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    return LIBRARY.load()


def padded_head_dim(d: int) -> int:
    for size in HEAD_DIMS:
        if d <= size:
            return size
    raise ValueError(f"head_dim {d} is beyond the flash kernel's {HEAD_DIMS[-1]}")


def launch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool, window: int, scale: float, logit_softcap: float,
) -> torch.Tensor:
    """One launch on CUDA tensors the caller has checked: q (B, Sq, H, D),
    k and v (B, Sk, Hkv, D), contiguous, of one type of ``_DTYPES``, on one
    device.  A head dim the kernel is not built for is zero-padded up to the
    next one (the padded features add exact zeros to every score) and the
    output cut back.  The output is allocated here; the kernel runs on the
    current stream."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash kernel takes float32 or bfloat16, not {q.dtype}")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    Dp = padded_head_dim(D)
    if Dp != D:
        q, k, v = (F.pad(t, (0, Dp - D)) for t in (q, k, v))
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("the flash kernel takes tensors aligned to 16 bytes")
    out = torch.empty((B, Sq, H, Dp), dtype=q.dtype, device=q.device)
    device = q.device.index if q.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = library().flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        B, Sq, Sk, H, Hkv, Dp, int(causal), int(window), float(scale), float(logit_softcap),
        device, stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash kernel launch failed with cudaError {rc}")
    return out if Dp == D else out[..., :D]
