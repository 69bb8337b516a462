# Mixture-of-Experts blocks (dbrx: 16 experts, top-4; llama4-scout: 16
# experts, top-1, with a shared expert), after the JAX package's
# models/moe.py.
#
# Dispatch is sort-based: each token's K choices are sorted by expert id
# (stably), each expert's run of the sorted list fills its C capacity slots
# in order, and the choices past C are dropped.  The JAX package vmaps the
# routing over ``dispatch_shards`` token groups; here the groups are the
# leading axis of one batched sort, searchsorted and gather.
#
# Nothing here reads a value back to the host (no .item(), no boolean-mask
# indexing, no nonzero or unique), so a decode step through this block can
# be captured in a CUDA graph.  The combine sums each token's K
# contributions in ascending expert order, rounding in the experts' dtype
# after each add, as the reference's sequential scatter-add into bf16 does; it is a
# gather, not an atomic scatter, so it gives the same bits on every run.
# The dispatch's gradient sums each token's K rows by a gather too, in f32
# in a fixed order (``_TokenRows``): index_select's own backward adds them
# by atomics on the card, in an order that changes between runs.
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from . import shardctx
from .common import ParamDef, activation_fn


def moe_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    assert cfg.moe is not None
    d, m = cfg.d_model, cfg.moe
    out: Dict[str, ParamDef] = {
        "router": ParamDef((d, m.n_experts), ("embed", "experts"), dtype=torch.float32),
        "w_gate": ParamDef((m.n_experts, d, m.d_ff_expert), ("experts", "embed", "mlp")),
        "w_up": ParamDef((m.n_experts, d, m.d_ff_expert), ("experts", "embed", "mlp")),
        "w_down": ParamDef((m.n_experts, m.d_ff_expert, d), ("experts", "mlp", "embed")),
    }
    if m.shared_expert_d_ff:
        out["shared_gate"] = ParamDef((d, m.shared_expert_d_ff), ("embed", "mlp"))
        out["shared_up"] = ParamDef((d, m.shared_expert_d_ff), ("embed", "mlp"))
        out["shared_down"] = ParamDef((m.shared_expert_d_ff, d), ("mlp", "embed"))
    return out


def capacity(cfg: ArchConfig, T: int) -> Tuple[int, int]:
    """(token groups, slots per expert and group) for T tokens: the
    reference's ``C = max(8, min(Tl, int(capacity_factor * K * Tl / E)))``,
    with Python's truncation."""
    m = cfg.moe
    ns = m.dispatch_shards if T % m.dispatch_shards == 0 else 1
    Tl = T // ns
    return ns, max(8, min(Tl, int(m.capacity_factor * m.top_k * Tl / m.n_experts)))


class Routing(NamedTuple):
    """The dispatch of ``ns`` groups of Tl tokens, each (ns, ...)."""
    expert_ids: torch.Tensor  # (ns, Tl, K) int64, in top-k order
    stok: torch.Tensor        # (ns, Tl*K) the token of each sorted choice
    slot: torch.Tensor        # (ns, Tl*K) its slot e*C + pos (pos 0 where dropped)
    keep: torch.Tensor        # (ns, Tl*K) bool, pos < C
    weight: torch.Tensor      # (ns, Tl*K) its gate times keep, in x's dtype
    by_token: torch.Tensor    # (ns, Tl, K) each token's sorted positions, ascending
    lb: torch.Tensor          # (ns,) f32 load-balance loss of each group


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, equal values in ascending index
    order (as ``jax.lax.top_k`` breaks ties; ``torch.topk`` does not say)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def route(logits: torch.Tensor, *, E: int, K: int, C: int, dtype: torch.dtype) -> Routing:
    """Sort-based dispatch of ``logits`` (ns, Tl, E) f32: the reference's
    ``_route_group`` over each group at once, without the gather into the
    expert buffers (``dispatch``)."""
    ns, Tl, _ = logits.shape
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k(probs, K)
    if K > 1:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    flat_e = expert_ids.reshape(ns, Tl * K)
    flat_g = gate_vals.reshape(ns, Tl * K)
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    idx = torch.arange(Tl * K, device=dev)
    stok = order // K  # the flat choice t * K + k belongs to token t
    sg = flat_g.gather(1, order)
    ids = torch.arange(E, device=dev).expand(ns, E).contiguous()
    start_of_expert = torch.searchsorted(se, ids)
    pos = idx - start_of_expert.gather(1, se)
    keep = pos < C
    slot = se * C + torch.where(keep, pos, 0)
    # each token's choices, by their place in the sorted list: ascending
    # places are ascending expert ids
    place = torch.empty_like(order).scatter_(1, order, idx.expand(ns, -1))
    by_token = torch.sort(place.reshape(ns, Tl, K), dim=-1).values
    top1 = expert_ids[..., 0]
    density = (top1[..., None] == torch.arange(E, device=dev)).sum(dim=1, dtype=torch.float32) / Tl
    lb = E * torch.sum(density * probs.mean(dim=1), dim=-1)
    weight = (sg * keep).to(dtype)
    return Routing(expert_ids, stok, slot, keep, weight, by_token, lb)


class _TokenRows(torch.autograd.Function):
    """``x.index_select(0, rows)`` for rows that name each of x's rows K
    times, whose backward sums each row's K gradient rows in f32 in the
    order ``by_token`` lists them (ascending) and rounds the sum once, as
    the CPU's index_add_ does: a gather, so the same bits on every run."""

    @staticmethod
    def forward(ctx, x, rows, by_token):
        ctx.save_for_backward(by_token)
        return x.index_select(0, rows)

    @staticmethod
    def backward(ctx, grad):
        (by_token,) = ctx.saved_tensors  # (x rows, K) rows of grad
        parts = grad.index_select(0, by_token.reshape(-1)).reshape(*by_token.shape, grad.shape[-1])
        out = parts[:, 0].float()
        for k in range(1, by_token.shape[1]):
            out = out + parts[:, k].float()
        return out.to(grad.dtype), None, None


def dispatch(xt: torch.Tensor, r: Routing, E: int, C: int) -> torch.Tensor:
    """xt (ns, Tl, d) into the expert buffers (ns, E, C, d): each kept
    choice's token copied to its slot.  Slots are unique, so the reference's
    ``.at[slot].add(..., mode='drop')`` into zeros is a copy; dropped
    choices go to one extra row per group, which is cut off."""
    ns, Tl, d = xt.shape
    rows = E * C + 1
    base = torch.arange(ns, device=xt.device)[:, None]
    dest = torch.where(r.keep, r.slot, E * C) + base * rows
    K = r.by_token.shape[-1]
    src = _TokenRows.apply(xt.reshape(ns * Tl, d), (r.stok + base * Tl).reshape(-1),
                           (r.by_token + base[:, :, None] * (Tl * K)).reshape(ns * Tl, K))
    xin = xt.new_zeros((ns * rows, d))
    xin.index_copy_(0, dest.reshape(-1), src)
    return xin.reshape(ns, rows, d)[:, : E * C].reshape(ns, E, C, d)


def combine(y: torch.Tensor, r: Routing) -> torch.Tensor:
    """y (ns, E*C, d) back to the tokens (ns, Tl, d): each token's K
    contributions ``y[slot] * weight``, summed in ascending expert order
    in y's dtype (the reference's scatter-add applies them in that order)."""
    ns, EC, d = y.shape
    _, Tl, K = r.by_token.shape
    flat = r.by_token.reshape(ns, Tl * K)
    base = torch.arange(ns, device=y.device)[:, None]
    rows = (r.slot.gather(1, flat) + base * EC).reshape(-1)
    contrib = y.reshape(ns * EC, d).index_select(0, rows) * r.weight.gather(1, flat).reshape(-1, 1)
    contrib = contrib.reshape(ns, Tl, K, d)
    out = contrib[:, :, 0]
    for k in range(1, K):
        out = out + contrib[:, :, k]
    return out


def router_logits(xt: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """(T, d) -> (T, E) in f32.  On the card TF32 stays off for this
    product (torch.backends.cuda.matmul.allow_tf32 is False by default)."""
    return xt.float() @ router


def shared_expert(p: Dict[str, torch.Tensor], xt: torch.Tensor, act) -> torch.Tensor:
    return (act(xt @ p["shared_gate"]) * (xt @ p["shared_up"])) @ p["shared_down"]


def experts(p: Dict[str, torch.Tensor], xin: torch.Tensor, act) -> torch.Tensor:
    """The expert contractions on (ns, E, C, d) -> (ns, E*C, d): one batched
    product per weight over the experts, the groups' slots side by side."""
    ns, E, C, d = xin.shape
    xe = xin.transpose(0, 1).reshape(E, ns * C, d)
    h = act(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    # the pins see h and y as the JAX package's (ns, E, C, .) buffers
    h = shardctx.constrain(h.reshape(E, ns, C, -1).transpose(0, 1), "moe_h").transpose(0, 1).reshape(E, ns * C, -1)
    y = torch.bmm(h, p["w_down"])
    return shardctx.constrain(y.reshape(E, ns, C, d).transpose(0, 1), "moe_y").reshape(ns, E * C, d)


def moe_block(
    p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (out, aux) with the load-balance and router-z losses."""
    m = cfg.moe
    act = activation_fn(cfg.activation)
    B, S, d = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    xt = x.reshape(T, d)
    logits = router_logits(xt, p["router"])
    ns, C = capacity(cfg, T)
    Tl = T // ns
    r = route(logits.reshape(ns, Tl, E), E=E, K=K, C=C, dtype=xt.dtype)
    # the expert buffers' sharding is pinned by the launcher (xin here, h
    # and y in experts): EP puts the experts on 'model', TP the hidden dim
    xin = shardctx.constrain(dispatch(xt.reshape(ns, Tl, d), r, E, C), "moe_xin")
    y = experts(p, xin, act)
    out = combine(y, r).reshape(B, S, d).to(x.dtype)
    if m.shared_expert_d_ff:
        out = out + shared_expert(p, xt, act).reshape(B, S, d).to(x.dtype)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return out, {"lb_loss": r.lb.mean(), "router_z": z_loss}
