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
# kernel is held to against it.  ``flash_attention_lse_plain`` is each
# row's log-sum-exp, which the forward kernel returns for the backward.
# ``flash_attention_bwd_plain`` is the backward kernel's plain version: dq,
# dk and dv written out (not autograd), and ``bwd_agreement`` its
# tolerance.
from __future__ import annotations

from typing import Optional, Tuple

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


# What the backward kernel's dq, dk and dv (bf16) are held to against
# flash_attention_bwd_plain run in float64 on the same bf16 inputs and the
# same forward output (the function the kernel computes: the backward of
# the attention whose output it is given): the forward's bf16 limits
# (KERNEL_TOL) per element, |got - want| <= rtol * |want| + atol_frac *
# rms(want's row) + floor_frac * rms(want over the tensor); and ||got -
# want|| / ||want|| <= rel.  The kernel rounds p and ds to bf16 as operands
# of its products (relative 2^-9 each) and its results to bf16.  The floor
# is for rows that cancel to zero (dq of a query that sees one key: p = 1
# whatever the score, so ds = dp - delta = 0), where f32 sums may leave a
# residue far below the tensor's scale.  A sequence of one token has dq
# and dk zero throughout, where neither form has a scale.
BWD_TOL = dict(rtol=3e-2, atol_frac=5e-2, floor_frac=1e-3, rel=1e-2)
# Against the exact gradient (autograd of attention_ref, or the plain
# version given no output), only the relative norm is held: delta =
# rowsum(dout * out) comes from the forward's bf16 output, and its
# rounding moves every ds of a row by the same amount, an error of the
# row's terms' scale that a row whose gradient cancels (a peaked softmax)
# does not share; on the card such elements read up to 40x the
# per-element limit while the relative norm read 0.0025-0.0028 (NVIDIA
# H100 80GB HBM3, chip_smoke.py phase 14).
BWD_EXACT_REL = 1e-2


def agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The kernel's output ``got`` against the plain version's ``want``
    under KERNEL_TOL for ``want``'s type (``kernels._agreement``)."""
    return _agreement(got, want, KERNEL_TOL[want.dtype])


def bwd_agreement(got: tuple, want: tuple) -> dict:
    """The backward kernel's (dq, dk, dv) against the plain version's under
    BWD_TOL: ``ok`` when all three agree, the readings the worst of the
    three."""
    parts = [_agreement(g, w, BWD_TOL) for g, w in zip(got, want)]
    return {"ok": all(a["ok"] for a in parts),
            **{x: max(a[x] for a in parts) for x in ("worst", "rel", "max_abs_err")}}


def bwd_exact_agreement(got: tuple, want: tuple) -> dict:
    """The backward kernel's (dq, dk, dv) against the exact gradient: ``ok``
    when each relative Frobenius error is at most BWD_EXACT_REL."""
    rel = 0.0
    for g, w in zip(got, want):
        norm_w = float(torch.linalg.vector_norm(w.double()))
        diff = float(torch.linalg.vector_norm(g.double() - w.double()))
        rel = max(rel, diff / norm_w if norm_w > 0 else (0.0 if diff == 0 else float("inf")))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    return {"ok": finite and rel <= BWD_EXACT_REL, "rel": rel}


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


def flash_attention_lse_plain(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,
    scale: float = 1.0,
    logit_softcap: float = 0.0,
    q_block: int = 512,
) -> torch.Tensor:
    """(B, H, Sq): log of the sum over each row's unmasked keys of
    exp(score), the scores scaled, then softcapped, then masked as in
    flash_attention_plain; natural-log units, f32 (float64 for float64
    inputs); +inf for a row that sees no key (its p is 0 in the backward)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    dev = q.device
    kf = k.to(ct)
    lse = torch.full((B, Hkv, G, Sq), float("inf"), dtype=ct, device=dev)
    for q_lo in range(0, Sq, q_block):
        q_hi = min(q_lo + q_block, Sq)
        k_lo, k_hi = key_range(q_lo, q_hi, Sq, Sk, causal, window)
        if k_hi <= k_lo:
            continue
        qt = q[:, q_lo:q_hi].to(ct).reshape(B, q_hi - q_lo, Hkv, G, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qt, kf[:, k_lo:k_hi]) * scale
        if logit_softcap > 0:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        q_ids = torch.arange(q_lo, q_hi, device=dev)[:, None] + (Sk - Sq)
        k_ids = torch.arange(k_lo, k_hi, device=dev)[None, :]
        mask = torch.ones((q_hi - q_lo, k_hi - k_lo), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_ids <= q_ids
        if window > 0:
            mask &= (q_ids - k_ids) < window
        l = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
        lse[..., q_lo:q_hi] = torch.where(torch.isneginf(l), float("inf"), l)
    return lse.reshape(B, H, Sq)


def flash_attention_bwd_plain(
    q: torch.Tensor,     # (B, S, H, D)
    k: torch.Tensor,     # (B, S, Hkv, D)
    v: torch.Tensor,
    dout: torch.Tensor,  # (B, S, H, D), the output's gradient
    out: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float = 1.0,
    logit_softcap: float = 0.0,
    q_block: int = 512,
    lse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of the forward's attention, written out, in f32 (float64
    for float64 inputs), cast to q's dtype at the end.  A q tile at a time:
    each row's softmax over the keys its tile may see (p = exp(s - lse)
    when the rows' log-sum-exp ``lse`` (B, H, S) is given), then
    dv += p^T dout, dp = dout v^T, ds = p (dp - delta) with delta =
    rowsum(dout * out) (out recomputed here when not given), times the
    softcap's derivative 1 - (s / c)^2, dq = scale ds k and dk += scale
    ds^T q; the G query heads of a kv head sum into its dk and dv.  Queries
    and keys are of one length (training)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    if k.shape[1] != S:
        raise ValueError(f"the backward takes queries and keys of one length, not {S} and {k.shape[1]}")
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    dev = q.device
    qf = q.to(ct).reshape(B, S, Hkv, G, D)
    kf, vf = k.to(ct), v.to(ct)
    df = dout.to(ct).reshape(B, S, Hkv, G, D)
    dq = torch.zeros((B, S, Hkv, G, D), dtype=ct, device=dev)
    dk = torch.zeros((B, S, Hkv, D), dtype=ct, device=dev)
    dv = torch.zeros_like(dk)
    for q_lo in range(0, S, q_block):
        q_hi = min(q_lo + q_block, S)
        k_lo, k_hi = key_range(q_lo, q_hi, S, S, causal, window)
        qt, dot = qf[:, q_lo:q_hi], df[:, q_lo:q_hi]
        kt, vt = kf[:, k_lo:k_hi], vf[:, k_lo:k_hi]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qt, kt) * scale
        th = None
        if logit_softcap > 0:
            th = torch.tanh(s / logit_softcap)
            s = logit_softcap * th
        q_ids = torch.arange(q_lo, q_hi, device=dev)[:, None]
        k_ids = torch.arange(k_lo, k_hi, device=dev)[None, :]
        mask = torch.ones((q_hi - q_lo, k_hi - k_lo), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_ids <= q_ids
        if window > 0:
            mask &= (q_ids - k_ids) < window
        s = torch.where(mask, s, NEG_INF)
        if lse is None:
            p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
            l = p.sum(dim=-1, keepdim=True)
            p = p / torch.where(l == 0, 1.0, l)
        else:
            lt = lse[:, :, q_lo:q_hi].to(ct).reshape(B, Hkv, G, q_hi - q_lo, 1)
            p = torch.where(mask, torch.exp(s - lt), 0.0)
        if out is None:
            o = torch.einsum("bhgqk,bkhd->bqhgd", p, vt)
        else:
            o = out[:, q_lo:q_hi].to(ct).reshape(B, q_hi - q_lo, Hkv, G, D)
        delta = (dot * o).sum(dim=-1).permute(0, 2, 3, 1)  # (B, Hkv, G, q)
        dv[:, k_lo:k_hi] += torch.einsum("bhgqk,bqhgd->bkhd", p, dot)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dot, vt)
        ds = p * (dp - delta[..., None])
        if th is not None:
            ds = ds * (1 - th * th)
        dq[:, q_lo:q_hi] = torch.einsum("bhgqk,bkhd->bqhgd", ds, kt) * scale
        dk[:, k_lo:k_hi] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qt) * scale
    return dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
