# Public wrapper of the WKV6 recurrence kernel.  A tensor on the CPU goes to
# the plain PyTorch version (ref.wkv6_plain); a tensor on a CUDA device goes
# to the hand-written CUDA kernel (kernel.py, csrc/wkv6.cu) or raises.  There
# is no fallback from the card to the plain version.
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernel
from .ref import wkv6_plain

# Launches of the CUDA kernel, so a run can show that its time-mix went
# through the kernel.  Only the CUDA path counts; the plain version on the
# CPU launches nothing.
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


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


def wkv6(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    S0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence over r, k, v, log_w (B, S, H, K) with bonus u
    (H, K) from the state S0 (B, H, K, K; zeros when None).  Returns y
    (B, S, H, K) and the final state (B, H, K, K), both f32."""
    global LAUNCHES
    _check(r, k, v, log_w, u, S0)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, log_w, u, S0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on the CPU or a CUDA device, not {r.device}")
    for t in (r, k, v, log_w) + (() if S0 is None else (S0,)):
        if not t.is_contiguous():
            raise ValueError("wkv6 takes contiguous tensors on CUDA")
    out = kernel.launch(r, k, v, log_w, u, S0)
    LAUNCHES += 1
    return out
