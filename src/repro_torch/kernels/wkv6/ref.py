# Plain PyTorch versions of the WKV6 recurrence (RWKV6 "Finch" time-mix).
#
# ``wkv6_scan`` is the exact per-token scan of the JAX package's
# ``kernels/wkv6/ref.py::wkv6_ref`` and ``models/rwkv6._wkv_scan``: the
# oracle, and the decode step.  ``wkv6_plain`` is the exact chunked form of
# ``models/rwkv6._wkv_chunked`` (the algebra ``wkv6_pallas`` computes), plus
# the carried state: the CUDA kernel's plain version, which the ``ops``
# wrapper takes for a tensor on the CPU.  ``wkv6_segmented_plain`` is the
# kernel's sequence-parallel algebra (segment states, carry, rescan) written
# plainly, so that the decomposition can be checked without a card.  ``agreement`` is the tolerance the
# kernel is held to against it.
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


def agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The kernel's ``got`` against the plain version's ``want`` under
    KERNEL_TOL (``kernels._agreement``)."""
    return _agreement(got, want, KERNEL_TOL)


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
    (B, S, H, K) and the final state (B, H, K, K), both f32."""
    B, S, H, K = r.shape
    state = _zero_state(r) if S0 is None else S0.float()
    if S == 0:
        return torch.zeros((B, 0, H, K), dtype=torch.float32, device=r.device), state
    L = min(chunk, S)
    pad = (-S) % L
    n = (S + pad) // L

    def prep(t):
        return F.pad(t.float(), (0, 0, 0, 0, 0, pad)).reshape(B, n, L, H, K)

    r_, k_, v_, lw = prep(r), prep(k), prep(v), prep(log_w)
    cum = torch.cumsum(lw, dim=2)                                    # inclusive, <= 0
    cum_q = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], dim=2)  # cum_{i-1}
    total = cum[:, :, -1]                                            # (B, n, H, K)
    u32 = u.float()
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
