# The token-by-token WKV6 backward of commit 1812a4f (its
# src/repro_torch/kernels/wkv6/csrc/wkv6_bwd.cu), bound beside the chunked
# kernel for the comparisons of scripts/wkv6_bwd_shapes.py (--walk-source)
# and scripts/wkv6_train_sensitivity.py.  Its C interface lacks the segment
# count and length, and its workspace holds the states every 8 tokens and
# per-slice partials.
#
#   git show 1812a4f:src/repro_torch/kernels/wkv6/csrc/wkv6_bwd.cu > build/wkv6_bwd_walk.cu
import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv6 import kernel


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_bwd_launch.argtypes = [p] * 15 + [ctypes.c_int64] + [i] * 7 + [p]
    lib.wkv6_bwd_launch.restype = ctypes.c_int


def library(source: str) -> _build.CudaLibrary:
    """The walk built from ``source``, loaded."""
    lib = _build.variant(kernel.BWD_LIBRARY, "wkv6_bwd_walk", source, _configure)
    lib.load()
    return lib


def launch(lib, r, k, v, lw, u, s0, dy, ds):
    """One backward of the walk, as kernel.launch_bwd takes and returns it."""
    B, S, H, K = r.shape
    n_work = B * H * (-(-S // 8)) * K * K + 3 * (K // 16) * B * S * H * K + B * (K // 16) * H * K
    work = torch.empty(n_work, dtype=torch.float32, device=r.device)
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dlw = torch.empty_like(lw)
    du = torch.empty_like(u)
    ds0 = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    dtypes = {torch.float32: 0, torch.bfloat16: 1}
    rc = lib.load().wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.float().contiguous().data_ptr(),
        None if s0 is None else s0.data_ptr(), dy.data_ptr(), None if ds is None else ds.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(), du.data_ptr(), ds0.data_ptr(),
        work.data_ptr(), n_work, dtypes[r.dtype], dtypes[u.dtype], B, S, H, K, r.device.index or 0,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the walk's launch failed with cudaError {rc}")
    return dr, dk, dv, dlw, du, ds0
