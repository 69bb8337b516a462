# The hand-written CUDA flash-attention kernels: the forward
# (csrc/flash_fwd.cu), its ctypes binding, one launch (with each row's
# log-sum-exp when a gradient will need it), and the bf16 kernel's tile
# configuration (``TILES``, the source's ``WgCfg``; the library reports its
# own through ``library_config``); and the backward (csrc/flash_bwd.cu),
# its binding and one launch (``launch_bwd``).  Both sources include
# csrc/flash_common.cuh.  The build (nvcc at first use into
# ``build/kernels/``, keyed by a hash of the source and its headers) is the
# shared helper in ``kernels/_build.py``.  Nothing here runs at import time.
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from .._build import CudaLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
BWD_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_bwd.cu"

HEAD_DIMS = (32, 64, 128, 256)  # the head dims the kernel is built for
# the head dims the backward takes: 16 padded to 32, and 80 (hubert-xlarge)
# and 112 (zamba2-7b's shared blocks) padded to 128
BWD_HEAD_DIMS = (16, 32, 64, 80, 112, 128, 256)
_BWD_BUILT = (32, 64, 128, 256)  # the head dims the backward library is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# The bf16 kernel (flash_fwd_wgmma_kernel) at each head dim: a block of
# THREADS threads (a producer warpgroup and two consumer warpgroups of 64
# query rows) owns q_block queries and walks kv_block keys a tile through a
# ring of `stages` k and v tiles in shared memory; setmaxnreg gives the
# producer and each consumer thread the registers named here.
THREADS = 384
PRODUCER_REGS, CONSUMER_REGS = 24, 240
TILES = {
    32: dict(q_block=128, kv_block=128, stages=2),
    64: dict(q_block=128, kv_block=128, stages=2),
    128: dict(q_block=128, kv_block=128, stages=2),
    256: dict(q_block=128, kv_block=80, stages=2),
}
SMEM_LIMIT = 232448  # shared memory a block may use on an H100
REGISTER_FILE = 65536  # 32-bit registers of an SM


def smem_bytes(d: int) -> int:
    """Shared memory of one block at head dim d: 1024 bytes of alignment
    slack, the q tile, the k and v ring in bf16, and 8 bytes per mbarrier."""
    t = TILES[d]
    return 1024 + 2 * d * (t["q_block"] + 2 * t["stages"] * t["kv_block"]) + 8 * (1 + 4 * t["stages"])


def registers_per_block() -> int:
    """Registers of one block after setmaxnreg: 128 producer threads and 256
    consumer threads."""
    return 128 * PRODUCER_REGS + 256 * CONSUMER_REGS


def configure_launch(lib: ctypes.CDLL) -> None:
    """Binds the launch alone (an earlier build of the source may lack
    ``flash_fwd_config``)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, f, f, i, p]
    lib.flash_fwd_launch.restype = ctypes.c_int


def _configure(lib: ctypes.CDLL) -> None:
    configure_launch(lib)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd_lse_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, f, i, p]
    lib.flash_fwd_lse_launch.restype = ctypes.c_int
    lib.flash_fwd_config.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.flash_fwd_config.restype = ctypes.c_int


LIBRARY = CudaLibrary("flash_fwd", SOURCE, _configure)


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    return LIBRARY.load()


def library_config(d: int) -> dict:
    """The bf16 kernel's configuration at head dim d as the built library
    states it, in TILES' terms."""
    out = (ctypes.c_int * 7)()
    rc = library().flash_fwd_config(d, out)
    if rc != 0:
        raise ValueError(f"the flash library is not built for head dim {d}")
    return dict(q_block=out[0], kv_block=out[1], stages=out[2], smem=out[3], threads=out[4],
                producer_regs=out[5], consumer_regs=out[6])


def ptxas_report(d: int, lib: CudaLibrary = LIBRARY) -> list:
    """nvcc's -Xptxas -v lines (registers, spills, barriers) for the bf16
    kernel's instances at head dim d; empty when this process loaded the
    library from an earlier build."""
    out, keep = [], False
    for line in lib.ptxas_log.splitlines():
        if "Compiling entry" in line:
            keep = f"flash_fwd_wgmma_kernelILi{d}E" in line
        if keep and ("Compiling entry" in line or "Used" in line or "spill" in line):
            out.append(line.split("info    : ")[-1].strip())
    return out


def padded_head_dim(d: int) -> int:
    for size in HEAD_DIMS:
        if d <= size:
            return size
    raise ValueError(f"head_dim {d} is beyond the flash kernel's {HEAD_DIMS[-1]}")


def launch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool, window: int, scale: float, logit_softcap: float, lib: CudaLibrary = LIBRARY,
    with_lse: bool = False,
):
    """One launch on CUDA tensors the caller has checked: q (B, Sq, H, D),
    k and v (B, Sk, Hkv, D), contiguous, of one type of ``_DTYPES``, on one
    device.  A head dim the kernel is not built for is zero-padded up to the
    next one (the padded features add exact zeros to every score) and the
    output cut back.  The output is allocated here; the kernel runs on the
    current stream.  ``lib`` is the library that launches it (a ``variant``
    when timing one).  With ``with_lse`` (bf16 only) it returns (out, lse):
    lse (B, H, Sq) f32 is each row's log-sum-exp of its scaled (and capped)
    scores in natural-log units, +inf for a row that sees no key, which the
    backward reads."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash kernel takes float32 or bfloat16, not {q.dtype}")
    if with_lse and q.dtype != torch.bfloat16:
        raise TypeError(f"the flash kernel returns row statistics in bfloat16 only, not {q.dtype}")
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
    args = (B, Sq, Sk, H, Hkv, Dp, int(causal), int(window), float(scale), float(logit_softcap), device, stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    lse = None
    if with_lse:
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        rc = lib.load().flash_fwd_lse_launch(*ptrs, lse.data_ptr(), _DTYPES[q.dtype], *args)
    else:
        rc = lib.load().flash_fwd_launch(*ptrs, _DTYPES[q.dtype], *args)
    if rc != 0:
        what = f"CUresult {rc - 1000} encoding a tensor map" if rc >= 1000 else f"cudaError {rc}"
        raise RuntimeError(f"flash kernel launch failed with {what}")
    out = out if Dp == D else out[..., :D]
    return (out, lse) if with_lse else out


def _configure_bwd(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, f, i, p]
    lib.flash_bwd_launch.restype = ctypes.c_int


BWD_LIBRARY = CudaLibrary("flash_bwd", BWD_SOURCE, _configure_bwd)


def bwd_work_floats(B: int, S: int, H: int, Hkv: int, D: int) -> int:
    """f32 scratch of one backward launch (csrc/flash_bwd.cu's ``work``):
    delta (B * H * S, rounded up to a multiple of 4), then, when the G =
    H / Hkv query heads of a kv head are more than one, their partial dk
    and dv (B * S * H * D each), which the dkv launch writes and a third
    launch sums."""
    return -(-B * H * S // 4) * 4 + (2 * B * S * H * D if H != Hkv else 0)


def launch_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, *, causal: bool, window: int, scale: float, logit_softcap: float,
    lib: CudaLibrary = BWD_LIBRARY,
) -> tuple:
    """One backward on CUDA tensors the caller has checked: bf16 q, out,
    dout (B, S, H, D) and k, v (B, S, Hkv, D), contiguous, on one device, D
    in BWD_HEAD_DIMS, and the forward's lse (B, H, S) f32 (``launch(...,
    with_lse=True)``).  A head dim the library is not built for (16, 80,
    112) is zero-padded to the next one it is (the padded features add
    zeros to every score, to delta and to dq, dk, dv's padded columns) and
    cut back.  dq, dk, dv and
    the scratch (``bwd_work_floats``) are allocated here; the kernels run on
    the current stream.  Returns (dq, dk, dv) in bf16."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"the flash backward takes the forward's lse ({B}, {H}, {S}) f32, not "
                         f"{tuple(lse.shape)} {lse.dtype}")
    Dp = next(d for d in _BWD_BUILT if d >= D)
    if Dp != D:
        q, k, v, out, dout = (F.pad(t, (0, Dp - D)) for t in (q, k, v, out, dout))
    out = out.contiguous()  # a caller's view of the forward's output (as its head-dim slice) is copied
    work = torch.empty(bwd_work_floats(B, S, H, Hkv, Dp), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    device = q.device.index if q.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.load().flash_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), work.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, Hkv, Dp, int(causal), int(window),
        float(scale), float(logit_softcap), device, stream,
    )
    if rc != 0:
        what = f"CUresult {rc - 1000} encoding a tensor map" if rc >= 1000 else f"cudaError {rc}"
        raise RuntimeError(f"flash backward kernel launch failed with {what}")
    if Dp != D:
        return tuple(t[..., :D].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv
