# Plain PyTorch versions of flash attention.
#
# ``attention_ref`` is the naive materialised-softmax oracle of the JAX
# package (kernels/flash/ref.py).  ``flash_attention_plain`` is the flash
# kernel's plain version: a blockwise online softmax after the JAX package's
# ``flash_attention_jnp``, with the kernel's signature (sliding window,
# queries aligned to the end of the keys) and the kernel's masking (masked
# p is 0; rows with no unmasked key give 0).  It never materialises Sq x Sk,
# so it serves at full size, where attention_ref at B=8, S=2048, H=16 would
# hold 2 GB of f32 scores per layer.  ``agreement`` is the tolerance the
# kernel is held to against it.
from __future__ import annotations

import torch

from .._agreement import agreement as _agreement

NEG_INF = -2.0e38

# What the hand-written kernel is held to against flash_attention_plain.
# Per element, |got - want| <= rtol * |want| + atol_frac * rms(want's row):
# rtol is the JAX package's kernel-test tolerance, and the absolute part
# follows the scale of the element's output row (one query and head, over
# the head dim; about 1/sqrt(n) for n visible keys of unit values), so it
# stays well below a typical element of every row and a dropped or
# mis-masked key tile shows.  Over the whole output,
# ||got - want|| / ||want|| <= rel.
KERNEL_TOL = {
    torch.float32: dict(rtol=2e-3, atol_frac=1e-3, rel=1e-4),
    torch.bfloat16: dict(rtol=3e-2, atol_frac=5e-2, rel=1e-2),
}


def agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The kernel's output ``got`` against the plain version's ``want``
    under KERNEL_TOL for ``want``'s type (``kernels._agreement``)."""
    return _agreement(got, want, KERNEL_TOL[want.dtype])


def attention_ref(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,          # 0 = unlimited; else last `window` positions
    scale: float = 1.0,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if logit_softcap > 0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    q_ids = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)  # align ends (decode-style)
    k_ids = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_ids <= q_ids
    if window > 0:
        mask &= (q_ids - k_ids) < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully-masked rows
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def key_range(q_lo: int, q_hi: int, sq: int, sk: int, causal: bool, window: int) -> tuple:
    """[k_lo, k_hi): the keys that some query row in [q_lo, q_hi) may see."""
    off = sk - sq
    k_hi = min(sk, q_hi - 1 + off + 1) if causal else sk
    k_lo = max(0, q_lo + off - window + 1) if window > 0 else 0
    return k_lo, k_hi


def flash_attention_plain(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float = 1.0,
    logit_softcap: float = 0.0,
    q_block: int = 512,
    kv_block: int = 512,
) -> torch.Tensor:
    """Online-softmax attention in (q_block x kv_block) tiles, in f32, cast
    to q's dtype at the end.  Key tiles that no query of a q tile may see
    are skipped: they would leave the running max, sum and accumulator
    exactly as they are."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    off = Sk - Sq
    dev = q.device
    kf = k.float()
    vf = v.float()
    out = torch.zeros((B, Sq, H, D), dtype=torch.float32, device=dev)
    for q_lo in range(0, Sq, q_block):
        q_hi = min(q_lo + q_block, Sq)
        qt = q[:, q_lo:q_hi].float().reshape(B, q_hi - q_lo, Hkv, G, D)
        m = torch.full((B, Hkv, G, q_hi - q_lo), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, q_hi - q_lo, D), dtype=torch.float32, device=dev)
        q_ids = torch.arange(q_lo, q_hi, device=dev)[:, None] + off
        k_lo, k_hi = key_range(q_lo, q_hi, Sq, Sk, causal, window)
        for t_lo in range((k_lo // kv_block) * kv_block, k_hi, kv_block):
            t_hi = min(t_lo + kv_block, Sk)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qt, kf[:, t_lo:t_hi]) * scale
            if logit_softcap > 0:
                s = logit_softcap * torch.tanh(s / logit_softcap)
            k_ids = torch.arange(t_lo, t_hi, device=dev)[None, :]
            mask = torch.ones((q_hi - q_lo, t_hi - t_lo), dtype=torch.bool, device=dev)
            if causal:
                mask &= k_ids <= q_ids
            if window > 0:
                mask &= (q_ids - k_ids) < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(mask, p, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vf[:, t_lo:t_hi])
            m = m_new
        lsafe = torch.where(l == 0, 1.0, l)
        o = acc / lsafe[..., None]  # (B, Hkv, G, qb, D)
        out[:, q_lo:q_hi] = o.permute(0, 3, 1, 2, 4).reshape(B, q_hi - q_lo, H, D)
    return out.to(q.dtype)
