# Public wrapper of the WKV6 recurrence kernels.  A tensor on the CPU goes to
# the plain PyTorch versions (ref.wkv6_plain, and ref.wkv6_bwd_plain for the
# gradient); a tensor on a CUDA device goes to the hand-written CUDA kernels
# (kernel.py, csrc/wkv6.cu and csrc/wkv6_bwd.cu) or raises.  There is no
# fallback from the card to the plain versions.  When an input requires
# grad, the call goes through the autograd Function ``WKV6``; without a
# gradient (serving) the forward launches alone.  On the meta device (the
# dry run, launch/dryrun.py) each route returns outputs of the card path's
# shapes and types and computes nothing: it reports the call, the kernel's
# products and its bytes to the active op counter (roofline/op_count.py).
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernel
from .ref import wkv6_bwd_plain, wkv6_plain

# Launches of the CUDA kernels, so a run can show that its time-mix and its
# gradient went through them: LAUNCHES counts the forward, BWD_LAUNCHES the
# backward.  Only the CUDA path counts; the plain versions on the CPU launch
# nothing.  PLAIN_BWD_CALLS counts the plain backward's calls, so a run on
# the card can show it never took one.
LAUNCHES = 0
BWD_LAUNCHES = 0
PLAIN_BWD_CALLS = 0
# the SMs of the card the meta route reckons (H100 SXM5), which decide the
# forward's segments
H100_SMS = 132


def reset_launches() -> None:
    global LAUNCHES, BWD_LAUNCHES, PLAIN_BWD_CALLS
    LAUNCHES = BWD_LAUNCHES = PLAIN_BWD_CALLS = 0


def _check(r, k, v, log_w, u, S0) -> None:
    if r.dim() != 4:
        raise ValueError("wkv6 takes r, k, v and log_w of shape (B, S, H, K)")
    B, _, H, K = r.shape
    for name, t in (("k", k), ("v", v), ("log_w", log_w)):
        if t.shape != r.shape:
            raise ValueError(f"r {tuple(r.shape)} and {name} {tuple(t.shape)} disagree")
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u {tuple(u.shape)} is not (H, K) = ({H}, {K})")
    if S0 is not None and tuple(S0.shape) != (B, H, K, K):
        raise ValueError(f"S0 {tuple(S0.shape)} is not (B, H, K, K) = ({B}, {H}, {K}, {K})")
    if not (r.dtype == k.dtype == v.dtype) or not r.dtype.is_floating_point:
        raise TypeError(f"r, k and v take one floating type, not {r.dtype}, {k.dtype}, {v.dtype}")
    if log_w.dtype != torch.float32 or (S0 is not None and S0.dtype != torch.float32):
        raise TypeError("wkv6 takes log_w and S0 in float32")
    if not u.dtype.is_floating_point:
        raise TypeError(f"u takes a floating type, not {u.dtype}")
    devices = {t.device for t in (r, k, v, log_w, u) + (() if S0 is None else (S0,))}
    if len(devices) != 1:
        raise ValueError(f"wkv6's inputs lie on {sorted(map(str, devices))}")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _meta_forward(r, k, v, log_w, u, S0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The meta route of the forward: what kernel.launch allocates (u in
    f32, y, the final state, and the segments' states where an H100's SMs
    cut the sequence), and the call reported with its products, the state's
    share of y and its update, two K x K products a token and head (4 K^2
    FLOPs, the tensor-core count of the kernel's bound in PERF.md; split
    TF32's three passes a product not counted), and its bytes."""
    from repro_torch.roofline import op_count

    B, S, H, K = r.shape
    u32 = u.to(torch.float32).contiguous()
    y = torch.empty((B, S, H, K), dtype=torch.float32, device=r.device)
    s_out = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    n_seg = kernel.segments(B, H, S, K, H100_SMS)
    parts = () if n_seg == 1 else (torch.empty((B, H, n_seg, K, K), dtype=torch.float32, device=r.device),
                                   torch.empty((B, H, n_seg, K), dtype=torch.float32, device=r.device))
    op_count.report_kernel("wkv6", 4.0 * K * K * B * S * H, _nbytes(r, k, v, log_w, u, S0, y, s_out))
    del u32, parts
    return y, s_out


def _meta_backward(r, k, v, log_w, u, S0, dy, dS_out) -> tuple:
    """The meta route of the backward: what kernel.launch_bwd allocates (u
    in f32, the workspace of ``bwd_work_floats``, the gradients), and the
    call reported with the gradient's five K x K products a token and head
    (10 K^2 FLOPs, the tensor-core count of the backward's bound) and its
    bytes."""
    from repro_torch.roofline import op_count

    B, S, H, K = r.shape
    u32 = u.to(torch.float32).contiguous()
    work = torch.empty(kernel.bwd_work_floats(B, S, H, K), dtype=torch.float32, device=r.device)
    grads = (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
             torch.empty((B, S, H, K), dtype=torch.float32, device=r.device),
             torch.empty((H, K), dtype=u.dtype, device=r.device),
             torch.empty((B, H, K, K), dtype=torch.float32, device=r.device))
    op_count.report_kernel("wkv6_bwd", 10.0 * K * K * B * S * H,
                           _nbytes(r, k, v, log_w, u, S0, dy, dS_out, *grads))
    del u32, work
    return grads


def _forward(r, k, v, log_w, u, S0) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    if r.device.type == "meta":
        return _meta_forward(r, k, v, log_w, u, S0)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, log_w, u, S0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on the CPU, a CUDA device or meta, not {r.device}")
    for t in (r, k, v, log_w) + (() if S0 is None else (S0,)):
        if not t.is_contiguous():
            raise ValueError("wkv6 takes contiguous tensors on CUDA")
    out = kernel.launch(r, k, v, log_w, u, S0)
    LAUNCHES += 1
    return out


def _check_grad(r: torch.Tensor, u: torch.Tensor) -> None:
    """The cases the gradient takes on the card: a head size and types the
    backward kernel is built for.  (On the CPU the plain backward takes
    any.)"""
    if r.device.type != "cuda":
        return
    if r.shape[3] not in kernel.HEAD_SIZES:
        raise ValueError(f"the wkv6 backward kernel is built for head sizes {kernel.HEAD_SIZES}, not {r.shape[3]}")
    if r.dtype not in kernel._DTYPES or u.dtype not in kernel._DTYPES:
        raise TypeError(f"the wkv6 backward kernel is built for float32 and bfloat16, not r {r.dtype}, u {u.dtype}")


def _backward(r, k, v, log_w, u, S0, dy, dS_out) -> tuple:
    """(dr, dk, dv, dlog_w, du, dS0): dr, dk, dv in r's type, dlog_w f32,
    du in u's type, dS0 f32."""
    global BWD_LAUNCHES, PLAIN_BWD_CALLS
    if r.device.type == "cpu":
        PLAIN_BWD_CALLS += 1
        dt = torch.float64 if r.dtype == torch.float64 else torch.float32
        dr, dk, dv, dlw, du, ds0 = wkv6_bwd_plain(r, k, v, log_w, u, S0, dy.to(dt), dS_out, dtype=dt)
        return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlw.to(log_w.dtype), du.to(u.dtype), ds0
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"wkv6's gradient runs on the CPU, a CUDA device or meta, not {r.device}")
    dS_out = None if dS_out is None else dS_out.float().contiguous()
    if r.device.type == "meta":
        return _meta_backward(r, k, v, log_w, u, S0, dy.float().contiguous(), dS_out)
    grads = kernel.launch_bwd(r, k, v, log_w, u, S0, dy.float().contiguous(), dS_out)
    BWD_LAUNCHES += 1
    return grads


class WKV6(torch.autograd.Function):
    """The WKV6 recurrence with its gradient: the forward kernel (on the
    CPU its plain version) forward, the backward kernel (on the CPU its
    plain version) backward, which rebuilds the states from r, k, v, log_w
    and S0.  Under remat the recomputed forward launches anew."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, S0):
        y, s_out = _forward(r, k, v, log_w, u, S0)
        ctx.save_for_backward(r, k, v, log_w, u, S0)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, dS_out):
        r, k, v, log_w, u, S0 = ctx.saved_tensors
        dr, dk, dv, dlw, du, ds0 = _backward(r, k, v, log_w, u, S0, dy, dS_out)
        return dr, dk, dv, dlw, du, (ds0 if S0 is not None and ctx.needs_input_grad[5] else None)


def wkv6(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    S0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence over r, k, v, log_w (B, S, H, K) with bonus u
    (H, K) from the state S0 (B, H, K, K; zeros when None).  Returns y
    (B, S, H, K) and the final state (B, H, K, K), both f32.
    Differentiable in every input (``WKV6``) when grad mode is on; on the
    card it raises where the backward kernel cannot take the case."""
    _check(r, k, v, log_w, u, S0)
    inputs = (r, k, v, log_w, u) + (() if S0 is None else (S0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        _check_grad(r, u)
        return WKV6.apply(r, k, v, log_w, u, S0)
    return _forward(r, k, v, log_w, u, S0)
