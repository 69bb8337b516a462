# Public wrapper of the flash-attention kernels.  A tensor on the CPU goes
# to the plain PyTorch versions (ref.flash_attention_plain, and
# ref.flash_attention_bwd_plain for the gradient); a tensor on a CUDA device
# goes to the hand-written CUDA kernels (kernel.py, csrc/flash_fwd.cu and
# csrc/flash_bwd.cu) or raises.  There is no fallback from the card to the
# plain versions.  When q, k or v requires grad, the call goes through the
# autograd Function ``FlashAttention``: its forward kernel also returns each
# row's log-sum-exp, which its backward kernel reads.  Without a gradient
# (serving) the forward launches without it.  On the meta device (the dry
# run, launch/dryrun.py) each route returns outputs of the card path's
# shapes and types and computes nothing: it reports the call, the kernel's
# products and its bytes to the active op counter (roofline/op_count.py).
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import kernel
from .ref import flash_attention_bwd_plain, flash_attention_plain

# Launches of the CUDA kernels, so a run can show that its attention and its
# gradient went through them: LAUNCHES counts the forward, BWD_LAUNCHES the
# backward.  Only the CUDA path counts; the plain versions on the CPU launch
# nothing.  PLAIN_BWD_CALLS counts the plain backward's calls, so a run on
# the card can show it never took one.  LAUNCHES_BY_DIM and
# BWD_LAUNCHES_BY_DIM split the two counts by the caller's head dim.
LAUNCHES = 0
BWD_LAUNCHES = 0
PLAIN_BWD_CALLS = 0
LAUNCHES_BY_DIM: dict = {}
BWD_LAUNCHES_BY_DIM: dict = {}


def reset_launches() -> None:
    global LAUNCHES, BWD_LAUNCHES, PLAIN_BWD_CALLS
    LAUNCHES = BWD_LAUNCHES = PLAIN_BWD_CALLS = 0
    LAUNCHES_BY_DIM.clear()
    BWD_LAUNCHES_BY_DIM.clear()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B, Sq, H, D) and k, v (B, Sk, Hkv, D)")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} disagree")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of {k.shape[2]} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v differ in type: {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.dtype.is_floating_point:
        raise TypeError(f"flash_attention takes floating-point tensors, not {q.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k and v lie on {q.device}, {k.device} and {v.device}")


def unmasked_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Query-key pairs the mask leaves, summed over the query rows (queries
    aligned to the end of the keys)."""
    q = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(q + 1, sk) if causal else np.full(sq, sk, np.int64)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _meta_forward(q, k, v, causal, window, with_lse):
    """The meta route of the forward: what kernel.launch allocates (the
    zero-padded copies of a head dim the kernel is not built for, the
    output, lse), and the call reported with its products, 4 D FLOPs a head
    and unmasked pair (q.k^T and p.v, the count of the kernel's bound in
    PERF.md), and its bytes (q, k, v, out and lse)."""
    from repro_torch.roofline import op_count

    B, Sq, H, D = q.shape
    flops = 4.0 * D * unmasked_pairs(Sq, k.shape[1], causal, window) * B * H
    nbytes = 2 * _nbytes(q) + 2 * _nbytes(k) + 4 * B * H * Sq * int(with_lse)
    Dp = kernel.padded_head_dim(D)
    if Dp != D:
        q, k, v = (F.pad(t, (0, Dp - D)) for t in (q, k, v))
    out = torch.empty((B, Sq, H, Dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    op_count.report_kernel("flash_attention", flops, nbytes)
    out = out if Dp == D else out[..., :D]
    return (out, lse) if with_lse else out


def _meta_backward(q, k, v, out, lse, dout, causal, window) -> tuple:
    """The meta route of the backward: what kernel.launch_bwd allocates
    (the padded copies, the scratch of ``bwd_work_floats``, dq, dk, dv), and
    the call reported with the gradient's five products (s recomputed, dp,
    dq, dk, dv: 10 D FLOPs a head and unmasked pair, the count of the
    backward's bound) and its bytes."""
    from repro_torch.roofline import op_count

    B, S, H, D = q.shape
    Hkv = k.shape[2]
    flops = 10.0 * D * unmasked_pairs(S, S, causal, window) * B * H
    nbytes = 4 * _nbytes(q) + 4 * _nbytes(k) + _nbytes(lse)  # q, out, dout, dq; k, v, dk, dv; lse
    Dp = next(d for d in kernel._BWD_BUILT if d >= D)
    if Dp != D:
        q, k, v, out, dout = (F.pad(t, (0, Dp - D)) for t in (q, k, v, out, dout))
    out = out.contiguous()
    work = torch.empty(kernel.bwd_work_floats(B, S, H, Hkv, Dp), dtype=torch.float32, device=q.device)
    grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    op_count.report_kernel("flash_attention_bwd", flops, nbytes)
    del work, out
    if Dp != D:
        return tuple(t[..., :D].contiguous() for t in grads)
    return grads


def _forward(q, k, v, causal, window, scale, logit_softcap, with_lse: bool = False):
    """The output, or with ``with_lse`` (out, lse): on the card lse is the
    kernel's (B, H, Sq) row statistics; on the CPU None, since the plain
    backward recomputes them."""
    global LAUNCHES
    if q.device.type == "meta":
        return _meta_forward(q, k, v, causal, window, with_lse)
    if q.device.type == "cpu":
        out = flash_attention_plain(
            q, k, v, causal=causal, window=window, scale=scale, logit_softcap=logit_softcap
        )
        return (out, None) if with_lse else out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on the CPU, a CUDA device or meta, not {q.device}")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("flash_attention takes contiguous tensors on CUDA")
    res = kernel.launch(q, k, v, causal=causal, window=window, scale=scale, logit_softcap=logit_softcap,
                        with_lse=with_lse)
    LAUNCHES += 1
    LAUNCHES_BY_DIM[q.shape[3]] = LAUNCHES_BY_DIM.get(q.shape[3], 0) + 1
    return res


def _check_grad(q: torch.Tensor, k: torch.Tensor) -> None:
    """The cases the gradient takes: queries and keys of one length, and on
    the card bf16 at a head dim the backward kernel is built for."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"the flash gradient takes queries and keys of one length (training), "
                         f"not Sq={q.shape[1]} and Sk={k.shape[1]}")
    if q.device.type == "cuda":
        if q.dtype != torch.bfloat16:
            raise TypeError(f"the flash backward kernel is built for bfloat16, not {q.dtype}")
        if q.shape[3] not in kernel.BWD_HEAD_DIMS:
            raise ValueError(f"the flash backward kernel is built for head dims {kernel.BWD_HEAD_DIMS}, "
                             f"not {q.shape[3]}")


def _backward(q, k, v, out, lse, dout, causal, window, scale, logit_softcap) -> tuple:
    global BWD_LAUNCHES, PLAIN_BWD_CALLS
    kw = dict(causal=causal, window=window, scale=scale, logit_softcap=logit_softcap)
    if q.device.type == "meta":
        return _meta_backward(q, k, v, out, lse, dout.contiguous(), causal, window)
    if q.device.type == "cpu":
        PLAIN_BWD_CALLS += 1
        return flash_attention_bwd_plain(q, k, v, dout, out, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention's gradient runs on the CPU, a CUDA device or meta, not {q.device}")
    grads = kernel.launch_bwd(q, k, v, out, dout.contiguous(), lse, **kw)
    BWD_LAUNCHES += 1
    BWD_LAUNCHES_BY_DIM[q.shape[3]] = BWD_LAUNCHES_BY_DIM.get(q.shape[3], 0) + 1
    return grads


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: the forward kernel (or, on the CPU, its
    plain version) forward, the backward kernel (on the CPU its plain
    version) backward.  The output is saved for the backward's delta, and
    on the card the forward's row statistics (lse) for its p; under remat
    the recomputed forward takes both anew."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, logit_softcap):
        out, lse = _forward(q, k, v, causal, window, scale, logit_softcap, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = (causal, window, scale, logit_softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout, *ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float = 1.0,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Attention of q (B, Sq, H, D) over k, v (B, Sk, Hkv, D): scale, then
    softcap when ``logit_softcap`` > 0, then the mask (causal, and the last
    ``window`` positions when ``window`` > 0, with queries aligned to the end
    of the keys), online softmax in f32.  Output (B, Sq, H, D) in q's type.
    Differentiable in q, k and v (``FlashAttention``) when Sq == Sk."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        _check_grad(q, k)
        return FlashAttention.apply(q, k, v, causal, window, scale, logit_softcap)
    return _forward(q, k, v, causal, window, scale, logit_softcap)
