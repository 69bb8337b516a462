# Public wrapper of the flash-attention forward kernel.  A tensor on the CPU
# goes to the plain PyTorch version (ref.flash_attention_plain); a tensor on
# a CUDA device goes to the hand-written CUDA kernel (kernel.py,
# csrc/flash_fwd.cu) or raises.  There is no fallback from the card to the
# plain version.
from __future__ import annotations

import torch

from . import kernel
from .ref import flash_attention_plain

# Launches of the CUDA kernel, so a run can show that its attention went
# through the kernel.  Only the CUDA path counts; the plain version on the
# CPU launches nothing.
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


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
    of the keys), online softmax in f32.  Output (B, Sq, H, D) in q's type."""
    global LAUNCHES
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, scale=scale, logit_softcap=logit_softcap
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on the CPU or a CUDA device, not {q.device}")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("flash_attention takes contiguous tensors on CUDA")
    out = kernel.launch(q, k, v, causal=causal, window=window, scale=scale, logit_softcap=logit_softcap)
    LAUNCHES += 1
    return out
