# Mamba2 SSD block (zamba2-7b; arXiv:2405.21060 "Transformers are SSMs"),
# after the JAX package's models/mamba2.py, with its names.  The decay is
# one scalar a head and token, a_t = exp(A dt_t), so the chunked dual form
# is exact: within a chunk of L tokens the pairwise decay is an (L, L)
# matrix a head.
#
# Forms of the SSD recurrence  h_t = a_t h_{t-1} + B_t (dt x)_t,  y_t = C_t h_t:
#   * ``ssd_batched``  - the serving form: every chunk's intra-chunk terms in
#                        one batched pass, only the chunk states carried
#                        across chunks (``_pass_states``); nothing is read
#                        back to the host;
#   * ``_ssd_chunked`` - a straightforward transcription of the reference's
#                        scan, one step a chunk: the plain yardstick;
#   * the decode step (S == 1) in ``mamba2_block``: one recurrence step.
# Every product of the SSD is an f32 product.  On a card it runs under
# PyTorch's default, ``torch.backends.cuda.matmul.allow_tf32 = False``, so
# cuBLAS computes it in f32, not TF32, as the reference's f32 einsums do.
#
# Rounding follows the reference's compiled block (ROADMAP C40, C41): the
# depthwise conv rounds each product, each partial sum and the bias add to
# bf16, and silu rounds step by step (common.silu); the gated norm
# ``rms_norm(y * silu(z))`` takes the product unrounded in f32.
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from .common import ParamDef, rms_norm, silu

STATE_BLOCK = 16  # chunks whose states _pass_states relates by one product


def mamba2_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_in, heads, head dim P, state size N)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.headdim
    return d_in, H, s.headdim, s.d_state


def mamba2_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    s = cfg.ssm
    d_in, H, P, N = mamba2_dims(cfg)
    G = s.n_groups
    conv_dim = d_in + 2 * G * N
    return {
        # in_proj -> [z, x, B, C, dt]
        "w_in": ParamDef((d, 2 * d_in + 2 * G * N + H), ("embed", "ssm_in")),
        "conv_w": ParamDef((s.d_conv, conv_dim), (None, "ssm_in")),
        "conv_b": ParamDef((conv_dim,), ("ssm_in",), init="zeros"),
        "dt_bias": ParamDef((H,), ("heads",), init="zeros"),
        "a_log": ParamDef((H,), ("heads",), init="zeros"),
        "d_skip": ParamDef((H,), ("heads",), init="ones"),
        "norm": ParamDef((d_in,), ("ssm_in",), init="zeros"),
        "w_out": ParamDef((d_in, d), ("ssm_in", "embed")),
    }


@torch.no_grad()
def spread_zero_inits_(named_params, generator: torch.Generator) -> None:
    """Draw the tensors mamba2_defs initialises to constants from
    ``generator`` (on the parameters' device): Mamba2's published
    initialisation (arXiv:2405.21060; mamba_ssm's defaults) for the decay,
    a_log = log U[1, 16] and dt_bias the inverse softplus of a dt drawn
    log-uniform in [1e-3, 1e-1]; conv_b and norm 0.1 N(0, 1).  Leaves are
    matched by the last part of their name in ``named_params`` ((name,
    tensor) pairs, as Module.named_parameters gives) whose parent is a
    block's ``mamba`` node, or with no parent at all."""
    for name, p in named_params:
        parts = name.split(".")
        if (parts[-2] if len(parts) > 1 else "mamba") != "mamba":
            continue
        leaf = parts[-1]
        shape, dev = p.shape, p.device
        if leaf == "a_log":
            p.copy_(torch.log(1.0 + 15.0 * torch.rand(shape, generator=generator, device=dev)))
        elif leaf == "dt_bias":
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt = torch.exp(lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev))
            p.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif leaf in ("conv_b", "norm"):
            p.copy_(0.1 * torch.randn(shape, generator=generator, device=dev))


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv then silu; x (B, S, C), w (W, C), state (B,
    W-1, C) the carried inputs.  Each product, partial sum and the bias add
    rounds to x's type, as the reference's compiled conv does (C40).  The
    padded input is laid out time-major, (S + W - 1, B, C), so that each
    tap reads a contiguous slice; the output (B, S, C) and the new state
    (B, W-1, C, the last W-1 inputs) are views of time-major tensors."""
    W = w.shape[0]
    B, S, C = x.shape
    xp = x.new_empty((S + W - 1, B, C))
    if state is None:
        xp[: W - 1] = 0
    else:
        xp[: W - 1] = state.transpose(0, 1)
    xp[W - 1 :] = x.transpose(0, 1)
    out = xp[:S] * w[0]
    for i in range(1, W):
        out = out + xp[i : i + S] * w[i]
    new_state = None if state is None else xp[S:].transpose(0, 1)
    return silu(out + b).transpose(0, 1), new_state


def in_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w_in -> [z, x, B, C, dt] (a function of its own so a profile can
    name it)."""
    return x @ w


def out_proj(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return y @ w


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, logaddexp(x, 0)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def mamba2_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, d)
    cfg: ArchConfig,
    state: Optional[Dict[str, torch.Tensor]] = None,
    chunk: int = 64,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (out, new state); the new state ({'conv', 'ssm'}, fresh
    tensors) only when ``state`` is given.  S == 1 takes one recurrence
    step; longer inputs the chunked SSD from ``state`` (zeros without)."""
    B, S, d = x.shape
    s = cfg.ssm
    d_in, H, P, N = mamba2_dims(cfg)
    G = s.n_groups

    zxbcdt = in_proj(x, p["w_in"])
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in : d_in + d_in + 2 * G * N]
    dt = zxbcdt[..., -H:]

    conv_state = state.get("conv") if state is not None else None
    xbc, new_conv = _causal_conv1d(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs = xbc[..., :d_in].reshape(B, S, H, P)
    Bmat = xbc[..., d_in : d_in + G * N].reshape(B, S, G, N)
    Cmat = xbc[..., d_in + G * N :].reshape(B, S, G, N)

    dt = _softplus(dt.float() + p["dt_bias"].float())  # (B, S, H)
    a = -torch.exp(p["a_log"].float())  # (H,) negative
    log_decay = dt * a  # (B, S, H) <= 0
    xdt = xs.float() * dt[..., None]  # dt-weighted input

    if state is not None:
        ssm_state = state["ssm"]
    else:
        ssm_state = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    if S == 1:
        # decode: one recurrence step (groups broadcast over their heads)
        Bh = Bmat[:, 0, :, None].float().expand(B, G, H // G, N).reshape(B, H, N)
        Ch = Cmat[:, 0, :, None].float().expand(B, G, H // G, N).reshape(B, H, N)
        dec = torch.exp(log_decay[:, 0])  # (B, H)
        new_ssm = dec[..., None, None] * ssm_state + xdt[:, 0, :, :, None] * Bh[:, :, None, :]
        y = (new_ssm @ Ch[..., None])[..., 0][:, None]  # (B, 1, H, P)
    else:
        y, new_ssm = ssd_batched(xdt, log_decay, Bmat.float(), Cmat.float(), ssm_state, chunk)
    y = y + p["d_skip"].float()[None, None, :, None] * xs.float()

    y = y.reshape(B, S, d_in).to(x.dtype)
    # gated RMSNorm, norm(y * silu(z)), of the product unrounded (C41)
    y = rms_norm(y.float() * silu(z.contiguous()).float(), p["norm"], cfg.norm_eps).to(x.dtype)
    out = out_proj(y, p["w_out"])

    new_state = None
    if state is not None:
        new_state = {"conv": new_conv, "ssm": new_ssm}
    return out, new_state


def _chunks(t: torch.Tensor, L: int) -> torch.Tensor:
    """(B, S, ...) zero-padded along S to a multiple of L -> (B, n, L, ...)."""
    pad = (-t.shape[1]) % L
    if pad:
        t = torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))], dim=1)
    return t.reshape(t.shape[0], t.shape[1] // L, L, *t.shape[2:])


def _lower(L: int, device, strict: bool) -> torch.Tensor:
    """(L, L) mask of [i, j] with j <= i (j < i when ``strict``)."""
    idx = torch.arange(L, device=device)
    return idx[None, :] < idx[:, None] if strict else idx[None, :] <= idx[:, None]


def _decay_matrix(rows: torch.Tensor, cols: torch.Tensor, mask: torch.Tensor,
                  inplace: bool = True) -> torch.Tensor:
    """exp(rows_i - cols_j) where ``mask``, else 0: the masked differences
    (positive above the diagonal, where they could overflow) are set to
    -inf before the exp, as the reference's inner where keeps them from
    it; in place, one buffer, unless ``inplace`` is False (autograd keeps
    exp's output for its backward, so a caller that scales the matrix
    needs it out of place)."""
    diff = rows[..., :, None] - cols[..., None, :]
    if not inplace:
        return diff.masked_fill(~mask, float("-inf")).exp()
    return diff.masked_fill_(~mask, float("-inf")).exp_()


def ssd_batched(xdt: torch.Tensor, log_decay: torch.Tensor, Bg: torch.Tensor, Cg: torch.Tensor,
                S0: torch.Tensor, chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD with every chunk's terms in one batched pass.  xdt
    (B, S, H, P), log_decay (B, S, H), Bg/Cg (B, S, G, N) with G dividing H
    (the heads of a group share them; G = H takes the reference's repeated
    form), S0 (B, H, P, N).  Returns y (B, S, H, P) and the final state,
    f32.  A prompt that is not a multiple of the chunk pads its tail (zero
    input, no decay), and S < chunk takes one chunk of S."""
    B, S, H, P = xdt.shape
    G, N = Bg.shape[2], Bg.shape[3]
    rep = H // G
    L = min(chunk, S)
    # per (batch, chunk, group): heads of the group, then tokens
    x = _chunks(xdt, L).reshape(B, -1, L, G, rep, P).permute(0, 1, 3, 4, 2, 5)  # (B,n,G,rep,L,P)
    n = x.shape[1]
    b = _chunks(Bg, L).permute(0, 1, 3, 2, 4)  # (B,n,G,L,N)
    c = _chunks(Cg, L).permute(0, 1, 3, 2, 4)
    cum = torch.cumsum(_chunks(log_decay, L), dim=2)  # (B,n,L,H) inclusive
    cum = cum.reshape(B, n, L, G, rep).permute(0, 1, 3, 4, 2)  # (B,n,G,rep,L)
    total = cum[..., -1]  # (B,n,G,rep)

    # intra-chunk: y_i = sum_{j<=i} e^{cum_i - cum_j} (C_i . B_j) xdt_j; a
    # gradient needs D and its scaled form as tensors of their own (C45),
    # serving scales the one buffer in place
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (xdt, log_decay, Bg, Cg, S0))
    D = _decay_matrix(cum, cum, _lower(L, xdt.device, strict=False), inplace=not grad)  # (B,n,G,rep,L,L)
    cb = (c @ b.transpose(-1, -2))[:, :, :, None]  # (B,n,G,1,L,L)
    y = (D * cb if grad else D.mul_(cb)) @ x  # (B,n,G,rep,L,P)
    # each chunk's state from zero: sum_j e^{total - cum_j} xdt_j B_j^T
    xw = x * torch.exp(total[..., None] - cum)[..., None]
    kv = xw.transpose(-1, -2).reshape(B, n, G, rep * P, L) @ b  # (B,n,G,rep*P,N)
    kv = kv.reshape(B, n, G, rep, P, N).reshape(B, n, H, P, N)
    states, S_out = _pass_states(kv, total.reshape(B, n, H), S0.float())
    # the carried state: y_i += e^{cum_i} C_i . S_in
    sin = states.reshape(B, n, G, rep * P, N)
    carried = (c @ sin.transpose(-1, -2)).reshape(B, n, G, L, rep, P).permute(0, 1, 2, 4, 3, 5)
    y = y.addcmul_(carried, torch.exp(cum)[..., None])
    y = y.permute(0, 1, 4, 2, 3, 5).reshape(B, n * L, H, P)[:, :S]
    return y, S_out


def _pass_states(kv: torch.Tensor, log_a: torch.Tensor, S0: torch.Tensor,
                 block: int = STATE_BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The states entering each step of  S_{c+1} = e^{log_a_c} S_c + kv_c
    from S_0 = S0.  kv (B, n, H, P, N), log_a (B, n, H) <= 0, S0 (B, H, P,
    N).  Steps are taken ``block`` at a time: within a block one product
    by the (block, block) decay matrix relates each state to the block's
    entering one (the state-passing product of arXiv:2405.21060 §6), and
    only the blocks' states are carried, a short recurrence of n / block
    steps.  Returns (entering states (B, n, H, P, N), final state)."""
    B, n, H, P, N = kv.shape
    Q = min(block, n)
    kvb = _chunks(kv.reshape(B, n, H, P * N), Q).permute(0, 1, 3, 2, 4)  # (B,nb,H,Q,F)
    la = _chunks(log_a, Q).permute(0, 1, 3, 2)  # (B,nb,H,Q); padded steps pass the state on
    nb = kvb.shape[1]
    cum = torch.cumsum(la, dim=-1)
    excl = cum - la
    local_in = _decay_matrix(excl, cum, _lower(Q, kv.device, strict=True)) @ kvb  # from zero at the block's start
    last = cum[..., -1]  # (B,nb,H)
    local_out = (torch.exp(last[..., None] - cum)[..., None, :] @ kvb)[..., 0, :]  # (B,nb,H,F)
    state = S0.reshape(B, H, P * N)
    entering = []
    for k in range(nb):
        entering.append(state)
        state = torch.exp(last[:, k])[..., None] * state + local_out[:, k]
    ent = torch.stack(entering, dim=1)  # (B,nb,H,F)
    states = local_in + torch.exp(excl)[..., None] * ent[:, :, :, None, :]
    states = states.permute(0, 1, 3, 2, 4).reshape(B, nb * Q, H, P, N)[:, :n]
    return states, state.reshape(B, H, P, N)


def _ssd_chunked(xdt, log_decay, Bh, Ch, S0, chunk: int):
    """The reference's chunked SSD transcribed, one step a chunk (the plain
    yardstick of ``ssd_batched``).  xdt (B,S,H,P), log_decay (B,S,H),
    Bh/Ch (B,S,H,N), S0 (B,H,P,N)."""
    B, S, H, P = xdt.shape
    L = min(chunk, S)
    xdt, Bh, Ch = (_chunks(t, L) for t in (xdt, Bh, Ch))
    cum = torch.cumsum(_chunks(log_decay, L), dim=2)  # (B,n,L,H) inclusive
    total = cum[:, :, -1]  # (B,n,H)
    lower_eq = _lower(L, xdt.device, strict=False)[None, :, :, None]  # j <= i

    Sprev = S0
    ys = []
    for k in range(xdt.shape[1]):
        xc, bc, cc, cumc, totc = xdt[:, k], Bh[:, k], Ch[:, k], cum[:, k], total[:, k]
        ldm = cumc[:, :, None] - cumc[:, None, :]  # (B,L,L,H)
        D = torch.where(lower_eq, torch.exp(torch.where(lower_eq, ldm, 0.0)), 0.0)
        A = torch.einsum("bihn,bjhn,bijh->bhij", cc, bc, D)
        y = torch.einsum("bhij,bjhp->bihp", A, xc)
        y = y + torch.einsum("bihn,bhpn,bih->bihp", cc, Sprev, torch.exp(cumc))
        kv = torch.einsum("bjhp,bjhn->bhpn", xc * torch.exp(totc[:, None] - cumc)[..., None], bc)
        Sprev = torch.exp(totc)[..., None, None] * Sprev + kv
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, -1, H, P)[:, :S]
    return y, Sprev


def mamba2_init_state(cfg: ArchConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    d_in, H, P, N = mamba2_dims(cfg)
    conv_dim = d_in + 2 * s.n_groups * N
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=torch.bfloat16, device=device),
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
    }
