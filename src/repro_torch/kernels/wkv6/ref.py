# Plain PyTorch versions of the WKV6 recurrence (RWKV6 "Finch" time-mix).
#
# ``wkv6_scan`` is the exact per-token scan of the JAX package's
# ``kernels/wkv6/ref.py::wkv6_ref`` and ``models/rwkv6._wkv_scan``: the
# oracle, and the decode step.  ``wkv6_plain`` is the exact chunked form of
# ``models/rwkv6._wkv_chunked`` (the algebra ``wkv6_pallas`` computes), plus
# the carried state: the CUDA kernel's plain version, which the ``ops``
# wrapper takes for a tensor on the CPU.  ``wkv6_segmented_plain`` is the
# kernel's sequence-parallel algebra (segment states, carry, rescan) written
# plainly, so that the decomposition can be checked without a card.
# ``wkv6_chunked_split_plain`` is the CUDA kernel's own arithmetic on the CPU:
# the chunked form in log2 units, chunks of CHUNK tokens, with its products
# taken in split TF32 (``split_tf32``: three products of TF32 parts, cut as
# the tensor cores read them), over segments as the kernel cuts them.
# ``tf32_round`` is cvt.rna.tf32.f32's rounding, for comparison.
# ``agreement`` is the tolerance the kernel is held to against wkv6_plain.
# ``wkv6_bwd_plain`` is the recurrence's gradient walked back token by token
# (the JAX package takes it by autodiff of ``_wkv_chunked``): the backward
# kernel's plain version, and in float64 its yardstick (``bwd_agreement``).
# ``wkv6_bwd_chunked_split_plain`` is the backward kernel's own arithmetic on
# the CPU: the chunked gradient in log2 units, its products in split TF32,
# dlog_w from its four direct terms, over segments with both carries.
#
# Recurrence, per head (k, r in R^K, v in R^V, w_t = e^{log_w_t} in (0, 1]^K,
# u in R^K):
#   y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
#   S_t = diag(w_t) S_{t-1} + k_t v_t^T
# Every exponent either form takes is <= 0, so a strong decay can only
# underflow to an exact 0, never overflow.
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .._agreement import agreement as _agreement

# What the hand-written kernel is held to against wkv6_plain, for y and for
# the final state alike (``kernels._agreement``: per element rtol * |want|
# plus atol_frac * the rms of want's row, a row being one token and head of
# y or one key row of the state; rel over the whole tensor).  rtol is the
# JAX package's kernel-test tolerance.  The kernel scans token by token and
# the plain version chunk by chunk, so their f32 roundings part as the
# state accumulates.  Read on an H100: see PERF.md.  The limits reject a
# dropped token, a lost bonus term or a wrong decay.
KERNEL_TOL = dict(rtol=2e-3, atol_frac=1e-3, rel=1e-4)


# What the backward kernel (csrc/wkv6_bwd.cu) is held to against
# wkv6_bwd_plain run in float64, for each of its outputs (dr, dk, dv,
# dlog_w, du, dS0; ``kernels._agreement``: a row is one token and head of
# dr, dk, dv, dlog_w, one head of du, one key row of dS0), by the output's
# type.  The kernel takes the chunked gradient in f32 with its products in
# split TF32 (``wkv6_bwd_chunked_split_plain``), the plain version walks
# token by token in f32; their errors against float64 grow with the length
# and the weakness of the decay (the state and its gradient sum ~1 / (1 -
# w) tokens).  A bf16 output (dr, dk, dv for bf16 r, k, v; du for a bf16 u)
# is also rounded once: half a unit of its last place is 2^-8 of it at most.
# Each element may also differ by scale_frac of the magnitudes of the terms
# it sums (``wkv6_bwd_plain(..., with_scales=True)``): a real layer's
# gradient cancels, dlog_w to 1e-5 of its terms (dy is orthogonal to the
# normed y), where f32 keeps ~1e-6 of them (read on an H100, phase 18: the
# kernel 9e-6, the plain version in f32 on the same inputs 9e-6, both past
# the other limits).  Read on an H100: see PERF.md.  The limits reject a
# dropped token's gradient, a lost bonus term and a decay off by one token,
# on random inputs and on inputs whose gradients cancel
# (tests/test_torch_wkv6_grad.py).
BWD_TOL = {
    torch.float32: dict(rtol=1e-3, atol_frac=1e-3, floor_frac=1e-5, scale_frac=2e-5, rel=1e-4),
    torch.bfloat16: dict(rtol=8e-3, atol_frac=2e-3, floor_frac=1e-4, scale_frac=2e-5, rel=4e-3),
}
BWD_NAMES = ("dr", "dk", "dv", "dlog_w", "du", "dS0")


def agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The kernel's ``got`` against the plain version's ``want`` under
    KERNEL_TOL (``kernels._agreement``)."""
    return _agreement(got, want, KERNEL_TOL)


def bwd_agreement(got: tuple, want: tuple, scales: tuple = None) -> dict:
    """The backward's outputs ``got`` against ``want`` (wkv6_bwd_plain in
    float64), output by output under BWD_TOL for its type (an f64 ``got``
    under f32's), with the terms' magnitudes ``scales`` when given
    (``wkv6_bwd_plain(..., with_scales=True)``): ``ok`` when all agree,
    with each output's reading under its name and the worst of them."""
    scales = scales if scales is not None else (None,) * len(BWD_NAMES)
    parts = {n: _agreement(g, w, BWD_TOL[torch.bfloat16 if g.dtype == torch.bfloat16 else torch.float32], sc)
             for n, g, w, sc in zip(BWD_NAMES, got, want, scales)}
    return dict(ok=all(p["ok"] for p in parts.values()), worst=max(p["worst"] for p in parts.values()),
                rel=max(p["rel"] for p in parts.values()),
                max_abs_err=max(p["max_abs_err"] for p in parts.values()), parts=parts)


def _zero_state(r: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    B, _, H, K = r.shape
    return torch.zeros((B, H, K, K), dtype=dtype, device=r.device)


def wkv6_scan(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    S0: Optional[torch.Tensor] = None, dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact recurrence, one token at a time.  r/k/v/log_w: (B, S, H, K);
    u: (H, K); S0: (B, H, K, K) or None (zeros).  Returns y (B, S, H, K) and
    the final state (B, H, K, K), both in ``dtype``: f32, as the model
    computes it, or f64, a witness of which of two f32 results rounds
    less."""
    B, S, H, K = r.shape
    state = _zero_state(r, dtype) if S0 is None else S0.to(dtype)
    u_ = u.to(dtype)[None, :, :, None]
    ys = []
    for t in range(S):
        rt, kt, vt = r[:, t].to(dtype), k[:, t].to(dtype), v[:, t].to(dtype)
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, state + u_ * kv))
        state = torch.exp(log_w[:, t].to(dtype))[..., None] * state + kv
    if not ys:
        return torch.zeros((B, 0, H, K), dtype=dtype, device=r.device), state
    return torch.stack(ys, dim=1), state


def wkv6_plain(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    S0: Optional[torch.Tensor] = None, chunk: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked form, exact in log space: within a chunk of L tokens the
    pairwise decay e^{cum_{i-1} - cum_j} (j < i) and the carry e^{total -
    cum_j} have exponents <= 0.  The ragged tail is padded with k = v = 0
    and log_w = 0, which changes neither y nor the state.  Returns y
    (B, S, H, K) and the final state (B, H, K, K), both f32 (f64 for f64
    inputs, which the gradient's checks take)."""
    B, S, H, K = r.shape
    dt = torch.float64 if r.dtype == torch.float64 else torch.float32
    state = _zero_state(r, dt) if S0 is None else S0.to(dt)
    if S == 0:
        return torch.zeros((B, 0, H, K), dtype=dt, device=r.device), state
    L = min(chunk, S)
    pad = (-S) % L
    n = (S + pad) // L

    def prep(t):
        return F.pad(t.to(dt), (0, 0, 0, 0, 0, pad)).reshape(B, n, L, H, K)

    r_, k_, v_, lw = prep(r), prep(k), prep(v), prep(log_w)
    cum = torch.cumsum(lw, dim=2)                                    # inclusive, <= 0
    cum_q = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], dim=2)  # cum_{i-1}
    total = cum[:, :, -1]                                            # (B, n, H, K)
    u32 = u.to(dt)
    idx = torch.arange(L, device=r.device)
    lower = (idx[None, :] < idx[:, None])[None, :, :, None, None]   # (1, L, L, 1, 1): j < i
    ys = []
    for c in range(n):
        rc, kc, vc = r_[:, c], k_[:, c], v_[:, c]                    # (B, L, H, K)
        cumc, cumqc, totc = cum[:, c], cum_q[:, c], total[:, c]
        ld = cumqc[:, :, None] - cumc[:, None, :]                    # (B, L, L, H, K)
        D = torch.where(lower, torch.exp(torch.where(lower, ld, 0.0)), 0.0)
        A = (rc[:, :, None] * kc[:, None] * D).sum(-1)               # (B, i, j, H)
        y = torch.einsum("bijh,bjhv->bihv", A, vc)
        y = y + (rc * u32 * kc).sum(-1, keepdim=True) * vc           # the bonus, on the diagonal
        y = y + torch.einsum("bihk,bhkv->bihv", rc * torch.exp(cumqc), state)
        kv_seg = torch.einsum("bjhk,bjhv->bhkv", kc * torch.exp(totc[:, None] - cumc), vc)
        state = torch.exp(totc)[..., None] * state + kv_seg
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, n * L, H, K)[:, :S]
    return y, state


LOG2E = 1.4426950408889634
CHUNK = 16  # the CUDA kernel's chunk length (L in csrc/wkv6.cu)
# wkv6_bwd_plain keeps the state every STRETCH tokens and batches each
# stretch's sums
STRETCH = 64


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest,
    ties away from zero, keeping 10 explicit mantissa bits (the low 13 bits
    of the result are zero).  Subnormals round alike; +-inf stay; a NaN
    stays a NaN.  Adding half a unit of the kept bits to the bit pattern and
    clearing the rest rounds the magnitude half-up whatever the sign, since
    f32 is sign and magnitude."""
    x = x.to(torch.float32).contiguous()
    bits = (x.view(torch.int32) + 0x1000) & -0x2000
    return torch.where(torch.isnan(x), x, bits.view(torch.float32))


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """x (f32) as a tensor core reads an f32 register in a TF32 product: its
    top 19 bits (sign, exponent, 10 mantissa bits), the low 13 cleared."""
    x = x.to(torch.float32).contiguous()
    return torch.where(torch.isnan(x), x, (x.view(torch.int32) & -0x2000).view(torch.float32))


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo in TF32 parts, as the CUDA kernel splits: hi = x's top 19
    bits and lo = x - hi (exact in f32), as the tensor core reads it (its
    top 19 bits), so hi + lo is x within 2^-20 of |x|."""
    hi = tf32_truncate(x)
    return hi, tf32_truncate(x.float() - hi)


def _split_product(eq: str, a: torch.Tensor, b: torch.Tensor, exact_b: bool = False) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` as the kernel's tensor cores take it: hi
    hi + (hi lo + lo hi) over the TF32 parts (``split_tf32``), each product
    in f32 (a product of two TF32 values is exact in f32).  ``exact_b``: b
    is exact in TF32 (widened bf16), so its lo is 0 and two products do."""
    ah, al = split_tf32(a)
    if exact_b:
        return torch.einsum(eq, ah, b) + torch.einsum(eq, al, b)
    bh, bl = split_tf32(b)
    return torch.einsum(eq, ah, bh) + (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh))


def _segment_state(k, v, log_w, exact_v: bool):
    """The state one segment (B, n, H, K) leaves from zero and its log2
    decay, as the kernel's states pass takes them: chunks from the last,
    E += (k . 2^{suf + tot_c - cum_c})^T v with suf the log2 decay of the
    chunks after chunk c (every exponent <= 0)."""
    B, S, H, K = k.shape
    pad = (-S) % CHUNK
    n = (S + pad) // CHUNK

    def prep(t):
        return F.pad(t.float(), (0, 0, 0, 0, 0, pad)).reshape(B, n, CHUNK, H, K)

    k_, v_ = prep(k), prep(v)
    cum = torch.cumsum(prep(log_w) * LOG2E, dim=2)
    e = _zero_state(k)
    suf = torch.zeros((B, H, K), dtype=torch.float32, device=k.device)
    for c in reversed(range(n)):
        tot = cum[:, c, -1]
        k_dec = k_[:, c] * torch.exp2(suf[:, None] + (tot[:, None] - cum[:, c]))
        e = e + _split_product("bjhk,bjhv->bhkv", k_dec, v_[:, c], exact_b=exact_v)
        suf = suf + tot
    return e, suf


def _chunk_steps(r, k, v, log_w, u, state, exact_v: bool):
    """The kernel's chunks over one stretch of tokens (B, n, H, K), from
    ``state``: y and the state it leaves, as wkv6_chunks computes them (see
    ``wkv6_chunked_split_plain``)."""
    B, S, H, K = r.shape
    L = CHUNK
    pad = (-S) % L
    n = (S + pad) // L

    def prep(t):
        return F.pad(t.float(), (0, 0, 0, 0, 0, pad)).reshape(B, n, L, H, K)

    r_, k_, v_ = prep(r), prep(k), prep(v)
    cum = torch.cumsum(prep(log_w) * LOG2E, dim=2)                   # log2 units, inclusive, <= 0
    cum_q = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], dim=2)
    total = cum[:, :, -1]
    idx = torch.arange(L, device=r.device)
    lower = (idx[None, :] < idx[:, None])[None, :, :, None, None]
    diag = (idx[None, :] == idx[:, None])[None, :, :, None]
    half = L // 2
    same_half = ((idx[:, None] // half) == (idx[None, :] // half))[None, :, :, None, None]
    u32 = u.float()
    ys = []
    for c in range(n):
        rc, kc, vc = r_[:, c], k_[:, c], v_[:, c]
        cumc, cumqc, totc = cum[:, c], cum_q[:, c], total[:, c]
        # A: the diagonal blocks directly, the block below them factored at m
        ld = cumqc[:, :, None] - cumc[:, None, :]
        D = torch.where(lower & same_half, torch.exp2(torch.where(lower, ld, 0.0)), 0.0)
        A = (rc[:, :, None] * kc[:, None] * D).sum(-1)               # (B, i, j, H)
        r_f = rc[:, half:] * torch.exp2(cumqc[:, half:] - cumc[:, half - 1:half])
        k_f = kc[:, :half] * torch.exp2(cumc[:, half - 1:half] - cumc[:, :half])
        A[:, half:, :half] = torch.einsum("bihk,bjhk->bijh", r_f, k_f)
        A = torch.where(diag, (rc * u32 * kc).sum(-1)[:, :, None], A)  # the bonus on the diagonal
        y = _split_product("bihk,bhkv->bihv", rc * torch.exp2(cumqc), state)
        ys.append(y + _split_product("bijh,bjhv->bihv", A, vc, exact_b=exact_v))
        E = _split_product("bjhk,bjhv->bhkv", kc * torch.exp2(totc[:, None] - cumc), vc, exact_b=exact_v)
        state = torch.exp2(totc)[..., None] * state + E
    return torch.stack(ys, dim=1).reshape(B, n * L, H, K)[:, :S], state


def wkv6_chunked_split_plain(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    S0: Optional[torch.Tensor] = None, seg_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's arithmetic on the CPU (csrc/wkv6.cu).  Per chunk of
    CHUNK tokens, in log2 units (cum the inclusive running sum of log_w *
    log2(e), cumq the exclusive one, tot the last; every exponent <= 0):
    A[i][j] = sum_k r_i k_j 2^{cumq_i - cum_j} (j < i) with the bonus
    sum_k r_i u k_i on its diagonal, taken directly within the two diagonal
    blocks of CHUNK / 2 tokens and, for the block below them, as R~ K~^T
    with R~_i = r_i . 2^{cumq_i - cum_m} and K~_j = k_j . 2^{cum_m - cum_j}
    (m = CHUNK / 2 - 1; both exponents <= 0); y = (r . 2^{cumq}) S + A v; S
    <- 2^{tot} . S + E with E = (k . 2^{tot - cum})^T v.  The three products
    go through the tensor cores' split TF32 (``_split_product``; v is exact
    when r, k and v are bf16), the decay of S on the CUDA cores.  With
    ``seg_len`` (a multiple of CHUNK), over segments as the kernel's
    sequence-parallel passes: each segment but the last from a zero state
    (its E, summed from its last chunk back, and its decay 2^{sum of its
    log2 decays}; ``_segment_state``), the carry, and each segment from its
    start.  Returns y (B, S, H, K) and the final state, both f32."""
    B, S, H, K = r.shape
    state = _zero_state(r) if S0 is None else S0.float()
    if S == 0:
        return torch.zeros((B, 0, H, K), dtype=torch.float32, device=r.device), state
    exact_v = r.dtype == torch.bfloat16
    seg_len = S if seg_len is None else seg_len
    bounds = [(a, min(S, a + seg_len)) for a in range(0, S, seg_len)]
    starts = [state]
    for a, b in bounds[:-1]:
        e, tot = _segment_state(k[:, a:b], v[:, a:b], log_w[:, a:b], exact_v)
        starts.append(torch.exp2(tot)[..., None] * starts[-1] + e)
    ys = []
    for (a, b), start in zip(bounds, starts):
        y, state = _chunk_steps(r[:, a:b], k[:, a:b], v[:, a:b], log_w[:, a:b], u, start, exact_v)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def _segment_grad_state(r, dy, log_w):
    """The gradient one segment (B, n, H, K) sends to the state before it
    from a zero gradient after it, G = sum_t (r_t . 2^{cumq_t})^T dy_t with
    cumq the exclusive running sum of the log2 decays over the segment, as
    the backward's states pass takes it: chunks from the first, r~ = r .
    2^{pre + cumq_c} with pre the log2 decay of the chunks before (every
    exponent <= 0)."""
    B, S, H, K = r.shape
    pad = (-S) % CHUNK
    n = (S + pad) // CHUNK

    def prep(t):
        return F.pad(t.float(), (0, 0, 0, 0, 0, pad)).reshape(B, n, CHUNK, H, K)

    r_, dy_ = prep(r), prep(dy)
    cum = torch.cumsum(prep(log_w) * LOG2E, dim=2)
    cum_q = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], dim=2)
    g = _zero_state(r)
    pre = torch.zeros((B, H, K), dtype=torch.float32, device=r.device)
    for c in range(n):
        g = g + _split_product("bjhk,bjhv->bhkv", r_[:, c] * torch.exp2(pre[:, None] + cum_q[:, c]), dy_[:, c])
        pre = pre + cum[:, c, -1]
    return g


def _exclusive_cumsum(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Over dim 1: the sum of the entries before each (after it when
    ``reverse``), each sum taken directly."""
    if reverse:
        return _exclusive_cumsum(x.flip(1)).flip(1)
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1].cumsum(1)], dim=1)


# _carry_back and _dlogw_terms are functions of their own only so that
# tests/test_torch_wkv6_grad.py can replace them: a twin that drops the
# carry or one of the four terms must fail BWD_TOL.
def _carry_back(dS: torch.Tensor, tot: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient carried to the state before a chunk: 2^{tot} . dS' + G."""
    return torch.exp2(tot)[..., None] * dS + g


def _dlogw_terms(a, b, c, d):
    """dlog_w of a chunk from its four direct terms (see
    ``wkv6_bwd_chunked_split_plain``), summed in the kernel's order."""
    return a + b + c + d


def _chunk_grads(r, k, v, log_w, u, dy, start, dS, exact_v: bool):
    """The backward's chunk pass over one segment (B, n, H, K): its chunks'
    states rebuilt forward from ``start``, then its chunks walked back from
    ``dS``, the gradient after the segment.  Returns dr, dk, dv, dlog_w (B,
    n, H, K), du's share (B, H, K) and the gradient before the segment."""
    B, S, H, K = r.shape
    L, half = CHUNK, CHUNK // 2
    pad = (-S) % L
    n = (S + pad) // L

    def prep(t):
        return F.pad(t.float(), (0, 0, 0, 0, 0, pad)).reshape(B, n, L, H, K)

    r_, k_, v_, dy_ = prep(r), prep(k), prep(v), prep(dy)
    cum = torch.cumsum(prep(log_w) * LOG2E, dim=2)
    cum_q = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], dim=2)
    total = cum[:, :, -1]
    idx = torch.arange(L, device=r.device)
    lower = (idx[None, :] < idx[:, None])[None, :, :, None, None]           # j < i
    on_or_below = (idx[None, :] <= idx[:, None])[None, :, :, None]
    diag = (idx[None, :] == idx[:, None])[None, :, :, None]
    same_half = ((idx[:, None] // half) == (idx[None, :] // half))[None, :, :, None, None]
    # straddle[t, i, j]: the pair (i, j), j < i, of one half straddles t
    straddle = ((idx[None, None, :] < idx[:, None, None]) & (idx[:, None, None] < idx[None, :, None])
                & ((idx[None, :, None] // half) == (idx[None, None, :] // half))).float()
    u32 = u.float()
    states = [start]
    for c in range(n - 1):
        kd = k_[:, c] * torch.exp2(total[:, c, None] - cum[:, c])
        E = _split_product("bjhk,bjhv->bhkv", kd, v_[:, c], exact_b=exact_v)
        states.append(torch.exp2(total[:, c])[..., None] * states[-1] + E)
    out = [torch.zeros((B, n, L, H, K), dtype=torch.float32, device=r.device) for _ in range(4)]
    du = torch.zeros((B, H, K), dtype=torch.float32, device=r.device)
    for c in reversed(range(n)):
        rc, kc, vc, gc, Sc = r_[:, c], k_[:, c], v_[:, c], dy_[:, c], states[c]
        cumc, cumqc, totc = cum[:, c], cum_q[:, c], total[:, c]
        r_t = rc * torch.exp2(cumqc)                                         # r~
        k_t = kc * torch.exp2(totc[:, None] - cumc)                          # k~
        # the weights within the chunk: the diagonal blocks directly, the
        # block below them factored at its corner m = half - 1
        ld = cumqc[:, :, None] - cumc[:, None, :]
        D = torch.where(lower & same_half, torch.exp2(torch.where(lower, ld, 0.0)), 0.0)  # (B, i, j, H, K)
        r_f = rc[:, half:] * torch.exp2(cumqc[:, half:] - cumc[:, half - 1:half])         # R~
        k_f = kc[:, :half] * torch.exp2(cumc[:, half - 1:half] - cumc[:, :half])          # K~
        A = (rc[:, :, None] * kc[:, None] * D).sum(-1)
        A[:, half:, :half] = torch.einsum("bihk,bjhk->bijh", r_f, k_f)
        A = torch.where(diag, (rc * u32 * kc).sum(-1)[:, :, None], A)
        dA = torch.where(on_or_below, torch.einsum("bihv,bjhv->bijh", gc, vc), 0.0)
        dAd = torch.diagonal(dA, dim1=1, dim2=2).permute(0, 2, 1)[..., None]  # (B, L, H, 1)
        # the five K x V products on the tensor cores
        dr_t = _split_product("bhkv,bihv->bihk", Sc, gc)
        dk_t = _split_product("bhkv,bjhv->bjhk", dS, vc, exact_b=exact_v)
        G = _split_product("bihk,bihv->bhkv", r_t, gc)
        dv = _split_product("bjhk,bhkv->bjhv", k_t, dS) + torch.einsum("bijh,bihv->bjhv", A, gc)
        # dr, dk: the state's share, the pairs of the diagonal blocks, the
        # block below them through its factors, the bonus
        P = dA[..., None] * D                                               # (B, i, j, H, K)
        dr = dr_t * torch.exp2(cumqc) + (P * kc[:, None]).sum(2) + dAd * u32 * kc
        dk = dk_t * torch.exp2(totc[:, None] - cumc) + (P * rc[:, :, None]).sum(1) + dAd * u32 * rc
        y_off = torch.einsum("bijh,bjhk->bihk", dA[:, half:, :half], k_f)  # (dA K~)_i, i >= half
        x_off = torch.einsum("bijh,bihk->bjhk", dA[:, half:, :half], r_f)  # (dA^T R~)_j, j < half
        dr[:, half:] += torch.exp2(cumqc[:, half:] - cumc[:, half - 1:half]) * y_off
        dk[:, :half] += torch.exp2(cumc[:, half - 1:half] - cumc[:, :half]) * x_off
        # dlog_w: (a) the state's decay, the same for every token; (b) r~'s
        # after t; (c) k~'s before t; (d) A's pairs that straddle t: those of
        # the diagonal blocks directly, those of the block below as prefix
        # sums of K~ (dA^T R~) over the first half and suffix sums of R~
        # (dA K~) over the second
        a = (torch.exp2(totc) * (Sc * dS).sum(-1))[:, None]
        b = _exclusive_cumsum(r_t * dr_t, reverse=True)
        c_ = _exclusive_cumsum(k_t * dk_t)
        pairs = P * rc[:, :, None] * kc[:, None]
        d = torch.einsum("tij,bijhk->bthk", straddle, pairs)
        d[:, :half] += _exclusive_cumsum(k_f * x_off)
        d[:, half:] += _exclusive_cumsum(r_f * y_off, reverse=True)
        dlw = _dlogw_terms(a, b, c_, d)
        du = du + (dAd * rc * kc).sum(1)
        for o, x in zip(out, (dr, dk, dv, dlw)):
            o[:, c] = x
        dS = _carry_back(dS, totc, G)
    return [o.reshape(B, n * L, H, K)[:, :S] for o in out] + [du, dS]


def wkv6_bwd_chunked_split_plain(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    S0: Optional[torch.Tensor], dy: torch.Tensor, dS_out: Optional[torch.Tensor] = None,
    seg_len: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's arithmetic on the CPU (csrc/wkv6_bwd.cu), the
    backward's twin of ``wkv6_chunked_split_plain``: (dr, dk, dv, dlog_w,
    du, dS0), all f32.  Per chunk of CHUNK tokens, in log2 units (cum,
    cumq, tot as there; r~ = r . 2^{cumq}, k~ = k . 2^{tot - cum}), with S
    the state before the chunk and dS' the gradient after it:
      dA[i][j] = dy_i . v_j (j <= i), A as the forward's;
      dv  = A^T dy + k~ dS';  dr~ = dy S^T;  dk~ = v dS'^T;
      dr_i = dr~_i . 2^{cumq_i} + sum_{j<i} dA[i][j] k_j 2^{cumq_i - cum_j} + dA[i][i] u k_i;
      dk_j = dk~_j . 2^{tot - cum_j} + sum_{i>j} dA[i][j] r_i 2^{cumq_i - cum_j} + dA[j][j] u r_j;
      du  += sum_i dA[i][i] r_i k_i;  the gradient before: 2^{tot} . dS' + r~^T dy;
      dlog_w_t = (a) 2^{tot} (S . dS' summed over the values) + (b) sum_{s>t} r~_s dr~_s
               + (c) sum_{s<t} k~_s dk~_s + (d) sum_{s<t<s'} dA[s'][s] r_s' k_s 2^{cumq_s' - cum_s},
    every exponent <= 0 (no reverse cumsum of a growing sum).  The pair
    sums take the diagonal blocks of CHUNK / 2 tokens directly and the
    block below them through the factors R~, K~ of the forward.  The five
    K x V products (the chunk's state product for the rebuild, dr~, dk~,
    r~^T dy and k~ dS') go through the tensor cores' split TF32
    (``_split_product``; v is exact when r, k and v are bf16); the carried
    state and gradient are decayed on the CUDA cores.  With ``seg_len`` (a
    multiple of CHUNK), over segments as the kernel's passes: each
    segment's state from zero and its decay (``_segment_state``) and its
    gradient from zero (``_segment_grad_state``), the carries forward from
    S0 and back from dS_out, then each segment rebuilt and walked back."""
    B, S, H, K = r.shape
    start = _zero_state(r) if S0 is None else S0.float()
    end = _zero_state(r) if dS_out is None else dS_out.float()
    if S == 0:
        z = torch.zeros((B, 0, H, K), dtype=torch.float32, device=r.device)
        return z, z.clone(), z.clone(), z.clone(), torch.zeros_like(u, dtype=torch.float32), end
    exact_v = r.dtype == torch.bfloat16
    seg_len = S if seg_len is None else seg_len
    bounds = [(a, min(S, a + seg_len)) for a in range(0, S, seg_len)]
    sl = [slice(a, b) for a, b in bounds]
    starts, decays = [start], []
    for s in sl:
        e, tot = _segment_state(k[:, s], v[:, s], log_w[:, s], exact_v)
        decays.append(torch.exp2(tot))
        starts.append(decays[-1][..., None] * starts[-1] + e)
    ends = [end]
    for i in reversed(range(1, len(sl))):
        g = _segment_grad_state(r[:, sl[i]], dy[:, sl[i]], log_w[:, sl[i]])
        ends.insert(0, decays[i][..., None] * ends[0] + g)
    outs, du = [], torch.zeros((B, H, K), dtype=torch.float32, device=r.device)
    for i in reversed(range(len(sl))):
        s = sl[i]
        *grads, du_s, dS = _chunk_grads(r[:, s], k[:, s], v[:, s], log_w[:, s], u, dy[:, s], starts[i], ends[i],
                                        exact_v)
        outs.insert(0, grads)
        du = du + du_s
    dr, dk, dv, dlw = (torch.cat(x, dim=1) for x in zip(*outs))
    return dr, dk, dv, dlw, du.sum(0), dS


def wkv6_segmented_plain(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    S0: Optional[torch.Tensor] = None, seg_len: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The three passes of the kernel's sequence-parallel form over segments
    of ``seg_len`` tokens (the last may be shorter): (1) the state each
    segment but the last leaves from zero, E = sum_j (k_j * e^{tot - cum_j})
    v_j^T, and its decay e^{tot} (cum the running sum of log_w within the
    segment, tot its last value: every exponent <= 0); (2) the carry,
    start[s + 1] = e^{tot_s} start[s] + E_s from start[0] = S0; (3) the
    exact scan of each segment from its start.  Returns y (B, S, H, K) and
    the final state, both f32."""
    B, S, H, K = r.shape
    state = _zero_state(r) if S0 is None else S0.float()
    bounds = [(a, min(S, a + seg_len)) for a in range(0, S, seg_len)]
    starts = [state]
    for a, b in bounds[:-1]:
        cum = torch.cumsum(log_w[:, a:b].float(), dim=1)               # (B, L, H, K)
        tot = cum[:, -1]                                                # (B, H, K)
        k_dec = k[:, a:b].float() * torch.exp(tot[:, None] - cum)
        e = torch.einsum("bjhk,bjhv->bhkv", k_dec, v[:, a:b].float())
        starts.append(torch.exp(tot)[..., None] * starts[-1] + e)
    ys = []
    for (a, b), start in zip(bounds, starts):
        y, state = wkv6_scan(r[:, a:b], k[:, a:b], v[:, a:b], log_w[:, a:b], u, start)
        ys.append(y)
    if not ys:
        return torch.zeros((B, 0, H, K), dtype=torch.float32, device=r.device), state
    return torch.cat(ys, dim=1), state


def wkv6_bwd_plain(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor,
    S0: Optional[torch.Tensor], dy: torch.Tensor, dS_out: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32, with_scales: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The gradient of the WKV6 recurrence (``wkv6_scan``) given dy (B, S,
    H, K), the gradient of y, and dS_out (B, H, K, K), that of the final
    state (zeros when None): (dr, dk, dv, dlog_w, du, dS0), all in
    ``dtype`` (f32, as the CUDA kernel computes, or f64, its yardstick).
    Per head, walking t from S - 1 down to 0 with dS = dL/dS_t (from
    dS_out) and w_t = e^{log_w_t}:
      dr_t[i]     = sum_j S_{t-1}[i,j] dy_t[j] + u_i k_t[i] (v_t . dy_t)
      du_i       += r_t[i] k_t[i] (v_t . dy_t)
      dk_t[i]     = sum_j dS[i,j] v_t[j] + r_t[i] u_i (v_t . dy_t)
      dv_t[j]     = sum_i dS[i,j] k_t[i] + (sum_i r_t[i] u_i k_t[i]) dy_t[j]
      dlog_w_t[i] = w_t[i] sum_j S_{t-1}[i,j] dS[i,j]
      dS         <- diag(w_t) dS + r_t dy_t^T        (dS0 is the last dS)
    S_{t-1} is never recovered by dividing out the decay (w underflows to
    0): the states at every STRETCH-th token are kept from a forward
    walk, and each stretch is walked forward again from its state before it
    is walked backward.  With ``with_scales``, returns (grads, scales):
    scales[n] is the sum of the magnitudes of the terms grads[n] sums (each
    product above taken in absolute values, dS0's through the recurrence),
    the scale of a float sum's rounding where its terms cancel
    (``bwd_agreement``)."""
    B, S, H, K = r.shape
    f = lambda t: t.to(dtype)  # noqa: E731
    r_, k_, v_, lw, dy_ = f(r), f(k), f(v), f(log_w), f(dy)
    u_ = f(u)
    w = torch.exp(lw)
    state = _zero_state(r, dtype) if S0 is None else f(S0)
    starts = []
    for t in range(S):
        if t % STRETCH == 0:
            starts.append(state)
        state = w[:, t, ..., None] * state + k_[:, t, ..., :, None] * v_[:, t, ..., None, :]
    dS = _zero_state(r, dtype) if dS_out is None else f(dS_out)
    dr, dk, dv, dlw = (torch.zeros((B, S, H, K), dtype=dtype, device=r.device) for _ in range(4))
    du = torch.zeros((B, H, K), dtype=dtype, device=r.device)
    if with_scales:
        sc = [torch.zeros_like(dr) for _ in range(4)]
        sc_du = torch.zeros_like(du)
        sc_dS = dS.abs()
    for c in reversed(range(len(starts))):
        a, b = c * STRETCH, min(S, (c + 1) * STRETCH)
        # the stretch's S_{t-1} and dS = dL/dS_t, token by token; the rest
        # at once over the stretch
        prev, after, state = [], [], starts[c]
        for t in range(a, b):
            prev.append(state)
            state = w[:, t, ..., None] * state + k_[:, t, ..., :, None] * v_[:, t, ..., None, :]
        for t in reversed(range(a, b)):
            after.append(dS)
            if with_scales:
                sc_dS = w[:, t, ..., None] * sc_dS + (r_[:, t, ..., :, None] * dy_[:, t, ..., None, :]).abs()
            dS = w[:, t, ..., None] * dS + r_[:, t, ..., :, None] * dy_[:, t, ..., None, :]
        sp, ds = torch.stack(prev, 1), torch.stack(after[::-1], 1)     # (B, L, H, K, K)
        rt, kt, vt, dyt, wt = (x[:, a:b] for x in (r_, k_, v_, dy_, w))
        vdy = (vt * dyt).sum(-1, keepdim=True)
        dr[:, a:b] = torch.einsum("blhij,blhj->blhi", sp, dyt) + u_ * kt * vdy
        du += (rt * kt * vdy).sum(1)
        dk[:, a:b] = torch.einsum("blhij,blhj->blhi", ds, vt) + rt * u_ * vdy
        dv[:, a:b] = torch.einsum("blhij,blhi->blhj", ds, kt) + (rt * u_ * kt).sum(-1, keepdim=True) * dyt
        dlw[:, a:b] = wt * (sp * ds).sum(-1)
        if with_scales:
            a_vdy = (vt * dyt).abs().sum(-1, keepdim=True)
            a_sp, a_ds = sp.abs(), ds.abs()
            sc[0][:, a:b] = torch.einsum("blhij,blhj->blhi", a_sp, dyt.abs()) + (u_ * kt).abs() * a_vdy
            sc[1][:, a:b] = torch.einsum("blhij,blhj->blhi", a_ds, vt.abs()) + (rt * u_).abs() * a_vdy
            sc[2][:, a:b] = (torch.einsum("blhij,blhi->blhj", a_ds, kt.abs())
                             + (rt * u_ * kt).abs().sum(-1, keepdim=True) * dyt.abs())
            sc[3][:, a:b] = wt * (a_sp * a_ds).sum(-1)
            sc_du += ((rt * kt).abs() * a_vdy).sum(1)
    grads = (dr, dk, dv, dlw, du.sum(0), dS)
    if with_scales:
        return grads, (sc[0], sc[1], sc[2], sc[3], sc_du.sum(0), sc_dS)
    return grads
