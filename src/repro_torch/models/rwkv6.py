# RWKV6 "Finch" time-mix + channel-mix blocks (attention-free, data-
# dependent decay; arXiv:2404.05892), after the JAX package's
# models/rwkv6.py, with its names.
#
# Forms of the WKV6 recurrence:
#   * 'scan'       - exact per-token scan (kernels/wkv6/ref.wkv6_scan): the
#                    reference, and every decode step (S == 1);
#   * 'chunked'    - the default for S > 1: kernels.wkv6.ops.wkv6, the
#                    hand-written CUDA kernel on the card and its exact
#                    chunked plain version on the CPU;
#   * 'factorized' - the JAX package's clamped, approximate chunked form,
#                    plain torch; the serving path never takes it.
#
# Recurrence (per head; k, r in R^K, v in R^V, w_t in (0,1)^K, u in R^K):
#   y_t = (S_{t-1} + diag(u . k_t) v_t^T)^T r_t
#   S_t = diag(w_t) S_{t-1} + k_t v_t^T
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.kernels.wkv6.ref import wkv6_scan
from .common import ParamDef, sigmoid, silu

LOG_CLAMP = -30.0  # log-decay anchor for the factorized form

# Default WKV form for full-sequence passes: 'chunked' is exact and, on the
# card, the hand-written kernel.
DEFAULT_METHOD = "chunked"


def rwkv6_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    K = cfg.ssm.head_size
    H = d // K
    lora = 64
    return {
        # token-shift mixing coefficients (static mu for r/k/v/g, LoRA for w)
        "mu_r": ParamDef((d,), ("embed",), init="zeros"),
        "mu_k": ParamDef((d,), ("embed",), init="zeros"),
        "mu_v": ParamDef((d,), ("embed",), init="zeros"),
        "mu_g": ParamDef((d,), ("embed",), init="zeros"),
        "mu_w": ParamDef((d,), ("embed",), init="zeros"),
        "w_lora_a": ParamDef((d, lora), ("embed", None)),
        "w_lora_b": ParamDef((lora, d), (None, "embed"), init="zeros"),
        "w0": ParamDef((d,), ("embed",), init="zeros"),
        "u": ParamDef((H, K), ("heads", None), init="zeros"),
        "wr": ParamDef((d, d), ("embed", "q_proj")),
        "wk": ParamDef((d, d), ("embed", "q_proj")),
        "wv": ParamDef((d, d), ("embed", "q_proj")),
        "wg": ParamDef((d, d), ("embed", "q_proj")),
        "wo": ParamDef((d, d), ("q_proj", "embed")),
        "ln_x": ParamDef((d,), ("embed",), init="zeros"),  # per-head group norm scale
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The previous token's hidden (zeros, or the carried ``last``, at
    position 0)."""
    prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if last is not None:
        prev[:, 0] = last  # prev is a view of the fresh padded tensor
    return prev


def _mix(x: torch.Tensor, prev: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (prev - x) * mu


def rwkv6_time_mix(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, d)
    cfg: ArchConfig,
    state: Optional[Dict[str, torch.Tensor]] = None,  # decode carry
    method: str = "default",
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    B, S, d = x.shape
    K = cfg.ssm.head_size
    H = d // K
    last_x = state["shift_t"] if state is not None else None
    prev = _token_shift(x, last_x)

    xr = _mix(x, prev, p["mu_r"])
    xk = _mix(x, prev, p["mu_k"])
    xv = _mix(x, prev, p["mu_v"])
    xg = _mix(x, prev, p["mu_g"])
    xw = _mix(x, prev, p["mu_w"])

    r = (xr @ p["wr"]).reshape(B, S, H, K)
    k = (xk @ p["wk"]).reshape(B, S, H, K)
    v = (xv @ p["wv"]).reshape(B, S, H, K)
    xg = xg @ p["wg"]
    g = silu(xg)
    # data-dependent decay (the Finch contribution):
    #   w_t = exp(-exp(w0 + LoRA(x_w))) in (0,1), its log taken in f32
    w_log = p["w0"].float() + (torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]).float()
    log_w = -torch.exp(torch.clamp(w_log, -8.0, 4.0))  # log of decay, <= 0
    log_w = log_w.reshape(B, S, H, K)

    if state is not None:
        S0 = state["wkv"]
    else:
        S0 = torch.zeros((B, H, K, K), dtype=torch.float32, device=x.device)
    if method == "default":
        method = DEFAULT_METHOD
    if method == "scan" or S == 1:
        y, S_out = _wkv_scan(r, k, v, log_w, p["u"], S0)
    elif method == "factorized":
        y, S_out = _wkv_chunked_factorized(r, k, v, log_w, p["u"], S0)
    else:
        y, S_out = _wkv_chunked(r, k, v, log_w, p["u"], S0)

    # per-head group norm (the population variance, as jnp.var), then gate
    y32 = y.reshape(B, S, H, K).float()
    mean = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, correction=0)
    yn = (y32 - mean) * torch.rsqrt(var + 64e-5)
    yn = yn.reshape(B, S, d) * (1.0 + p["ln_x"].float())
    out = (yn.to(x.dtype) * g) @ p["wo"]

    new_state = None
    if state is not None:
        new_state = {"wkv": S_out, "shift_t": x[:, -1]}
    return out, new_state


def _wkv_scan(r, k, v, log_w, u, S0):
    """Exact recurrence, scanned over time.  r/k/v/log_w: (B, S, H, K)."""
    return wkv6_scan(r, k, v, log_w, u, S0)


def _wkv_chunked(r, k, v, log_w, u, S0):
    """The exact chunked recurrence through the wkv6 kernel's wrapper: the
    hand-written CUDA kernel for a CUDA tensor, the plain chunked form
    (chunk 16, as the JAX package's _wkv_chunked) for a CPU tensor."""
    return wkv6_ops.wkv6(r.contiguous(), k.contiguous(), v.contiguous(), log_w.contiguous(), u,
                         S0.contiguous())


def _wkv_chunked_factorized(r, k, v, log_w, u, S0, chunk: int = 16):
    """The JAX package's traffic-optimized chunked form: the intra-chunk
    pairwise decay factorized as (r_i e^{c_i}) . (k_j e^{-c_j}) with c =
    max(cum, LOG_CLAMP), exact only while |cum| stays below |LOG_CLAMP|
    within a chunk; cross-chunk carries stay exact.  Plain torch."""
    B, S, H, K = r.shape
    L = min(chunk, S)
    pad = (-S) % L
    Sp = S + pad
    n = Sp // L

    def prep(t):
        return F.pad(t.float(), (0, 0, 0, 0, 0, pad)).reshape(B, n, L, H, K)

    r_, k_, v_, lw = prep(r), prep(k), prep(v), prep(log_w)
    cum = torch.cumsum(lw, dim=2)
    cum_q = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], dim=2)
    total = cum[:, :, -1]
    u32 = u.float()
    idx = torch.arange(L, device=r.device)
    lower = (idx[None, :] < idx[:, None])[None, None]  # (1, 1, L, L)

    qs = r_ * torch.exp(torch.clamp(cum_q, min=LOG_CLAMP))
    ks = k_ * torch.exp(-torch.clamp(cum, min=LOG_CLAMP))
    A = torch.einsum("bnihk,bnjhk->bnhij", qs, ks)
    A = torch.where(lower, A, 0.0)
    y_intra = torch.einsum("bnhij,bnjhv->bnihv", A, v_)
    Au = torch.einsum("bnihk,bnihk->bnih", r_, u32[None, None, None] * k_)
    y_intra = y_intra + Au[..., None] * v_

    kv_seg = torch.einsum("bnjhk,bnjhv->bnhkv", k_ * torch.exp(total[:, :, None] - cum), v_)
    rq = r_ * torch.exp(cum_q)  # exact for the carry path (<= 1)
    state = S0.float()
    y_cross = []
    for c in range(n):
        y_cross.append(torch.einsum("bihk,bhkv->bihv", rq[:, c], state))
        state = torch.exp(total[:, c])[..., None] * state + kv_seg[:, c]
    y = (y_intra + torch.stack(y_cross, dim=1)).reshape(B, Sp, H, K)[:, :S]
    return y, state


# ---------------------------------------------------------------------------
# Channel mix (the RWKV FFN)
# ---------------------------------------------------------------------------


def rwkv6_channel_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamDef((d,), ("embed",), init="zeros"),
        "mu_r": ParamDef((d,), ("embed",), init="zeros"),
        "wk": ParamDef((d, f), ("embed", "mlp")),
        "wv": ParamDef((f, d), ("mlp", "embed")),
        "wr": ParamDef((d, d), ("embed", None)),
    }


def rwkv6_channel_mix(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ArchConfig,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    last_x = state["shift_c"] if state is not None else None
    prev = _token_shift(x, last_x)
    xk = _mix(x, prev, p["mu_k"])
    xr = _mix(x, prev, p["mu_r"])
    k = torch.square(F.relu(xk @ p["wk"]))
    out = sigmoid(xr @ p["wr"]) * (k @ p["wv"])
    new_state = {"shift_c": x[:, -1]} if state is not None else None
    return out, new_state
