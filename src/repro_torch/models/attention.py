# Attention layers: GQA with RoPE/M-RoPE, full-causal, sliding-window,
# chunked (block-diagonal), bidirectional (encoder), and KV-cache decode.
# Every prefill attention runs in the flash kernel (kernels/flash: the
# hand-written CUDA kernel on a card, its plain PyTorch version on the CPU),
# with the window as the kernel's mask on local layers.  The banded and
# chunked plain versions stay here as the reference's own formulations, which
# the tests hold the kernel's plain version against; decode stays torch ops.
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash import ops as flash_ops
from .common import ParamDef, apply_rope, mrope_angles, rms_norm, rope_angles

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def attention_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    out: Dict[str, ParamDef] = {
        "wq": ParamDef((d, H * Dh), ("embed", "q_proj")),
        "wk": ParamDef((d, Hkv * Dh), ("embed", "kv_proj")),
        "wv": ParamDef((d, Hkv * Dh), ("embed", "kv_proj")),
        "wo": ParamDef((H * Dh, d), ("q_proj", "embed")),
    }
    if cfg.qk_norm:
        out["q_norm"] = ParamDef((Dh,), (None,), init="zeros")
        out["k_norm"] = ParamDef((Dh,), (None,), init="zeros")
    return out


# ---------------------------------------------------------------------------
# Plain attention formulations (scores in f32; p cast to q's type for p.v)
# ---------------------------------------------------------------------------


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 of (B, S, ...) at the end."""
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + tuple(x.shape[2:]))], dim=1)


def banded_window_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,
    *,
    window: int,
    scale: float,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Sliding-window causal attention computed on the diagonal band only
    (each query block of size W attends to its own and the previous block:
    2W keys).  `window` = number of attendable positions (inclusive of
    self)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    W = min(window, S)
    pad = (-S) % W
    Sp = S + pad
    nb = Sp // W
    dev = q.device
    qp = _pad_seq(q, pad).reshape(B, nb, W, Hkv, G, D)
    kp = _pad_seq(k, pad).reshape(B, nb, W, Hkv, D)
    vp = _pad_seq(v, pad).reshape(B, nb, W, Hkv, D)
    # previous block (zeros before block 0)
    k_prev = torch.cat([torch.zeros_like(kp[:, :1]), kp[:, :-1]], dim=1)
    v_prev = torch.cat([torch.zeros_like(vp[:, :1]), vp[:, :-1]], dim=1)
    k_cat = torch.cat([k_prev, kp], dim=2)  # (B, nb, 2W, Hkv, D)
    v_cat = torch.cat([v_prev, vp], dim=2)
    s = torch.einsum("bnqhgd,bnkhd->bnhgqk", qp.float(), k_cat.float()) * scale
    if logit_softcap > 0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    # indices: query r in [0,W), key c in [0,2W): global delta = (W + r) - c
    r = torch.arange(W, device=dev)[:, None]
    c = torch.arange(2 * W, device=dev)[None, :]
    delta = (W + r) - c
    band = (delta >= 0) & (delta < W)
    # block 0 has no previous block: mask keys c < W there
    blk = torch.arange(nb, device=dev)[:, None, None]
    valid_prev = (blk > 0) | (c[None] >= W)
    # padded tail keys: global key index = (n-1)*W + c must be < S
    key_global = blk * W + (c[None] - W)
    mask = band[None] & valid_prev & (key_global < S) & (key_global >= 0)
    s = torch.where(mask[:, None, None, :, :][None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnhgqk,bnkhd->bnqhgd", p.to(q.dtype), v_cat)
    return out.reshape(B, Sp, H, D)[:, :S]


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    chunk: int,
    scale: float,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Block-diagonal causal attention (llama4-style chunked attention):
    queries attend only within their own chunk.  Chunks larger than 2048
    fold into the batch and run through the flash kernel, as the reference
    routes them through its online-softmax path."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    C = min(chunk, S)
    pad = (-S) % C
    nb = (S + pad) // C
    if C > 2048:
        def fold(x):
            return _pad_seq(x, pad).reshape(B * nb, C, x.shape[2], D)

        out = flash_ops.flash_attention(fold(q), fold(k), fold(v), causal=True,
                                        scale=scale, logit_softcap=logit_softcap)
        return out.reshape(B, S + pad, H, D)[:, :S]
    dev = q.device
    qp = _pad_seq(q, pad).reshape(B, nb, C, Hkv, G, D)
    kp = _pad_seq(k, pad).reshape(B, nb, C, Hkv, D)
    vp = _pad_seq(v, pad).reshape(B, nb, C, Hkv, D)
    s = torch.einsum("bnqhgd,bnkhd->bnhgqk", qp.float(), kp.float()) * scale
    if logit_softcap > 0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    r = torch.arange(C, device=dev)[:, None]
    c = torch.arange(C, device=dev)[None, :]
    blk = torch.arange(nb, device=dev)[:, None, None]
    key_global = blk * C + c[None]
    mask = (c <= r)[None] & (key_global < S)
    s = torch.where(mask[:, None, None, :, :][None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnhgqk,bnkhd->bnqhgd", p.to(q.dtype), vp)
    return out.reshape(B, S + pad, H, D)[:, :S]


def decode_attention(
    q: torch.Tensor,        # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,
    valid_mask: torch.Tensor,  # (B, S) bool
    *,
    scale: float,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    B, _, H, D = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, 1, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_cache.float()) * scale
    if logit_softcap > 0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    s = torch.where(valid_mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(q.dtype), v_cache)
    return out.reshape(B, 1, H, D)


# ---------------------------------------------------------------------------
# The full attention block (projections + rope + variant dispatch + cache)
# ---------------------------------------------------------------------------


@dataclass
class AttnInputs:
    positions: torch.Tensor         # (B, S) int — or (3, B, S) for M-RoPE
    cache: Optional[Dict[str, torch.Tensor]] = None  # decode: {'k','v'} (B,Sc,Hkv,D), written in place
    cache_pos: Optional[torch.Tensor] = None  # decode: the write position, a 0-dim int64 device tensor
    collect_kv: bool = False         # prefill: return the built cache
    quantize_collected: bool = False  # prefill: emit the int8 cache layout


def _rope_for(cfg: ArchConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    Dh = cfg.resolved_head_dim
    if cfg.m_rope_sections:
        return mrope_angles(Dh, cfg.rope_theta, positions, cfg.m_rope_sections)
    return rope_angles(Dh, cfg.rope_theta, positions)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 values and f16 scales per (..., head) over the feature axis:
    scale = max|x| / 127 (1 where that is 0), values round half to even."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1, keepdim=True) / 127.0
    s = torch.where(s == 0, 1.0, s)
    return torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8), s.to(torch.float16)


def _valid(pos: torch.Tensor, Sc: int, rolling: bool, B: int, device) -> torch.Tensor:
    """The cache slots decode may read at position ``pos`` (a 0-dim device
    tensor, so no value reaches the host): a ring buffer holds the last Sc
    positions, the others every position up to ``pos``."""
    idx = torch.arange(Sc, device=device)
    if rolling:
        valid = (idx <= pos % Sc) | (pos >= Sc)
    else:
        valid = idx <= pos
    return valid[None].expand(B, Sc)


def attention_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                # (B, S, d_model)
    cfg: ArchConfig,
    kind: str,                      # 'global' | 'local' | 'chunked' | 'bidir'
    inputs: AttnInputs,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    B, S, d = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    scale = cfg.attn_scale if cfg.attn_scale is not None else Dh ** -0.5

    q = (x @ p["wq"]).reshape(B, S, H, Dh)
    k = (x @ p["wk"]).reshape(B, S, Hkv, Dh)
    v = (x @ p["wv"]).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if kind != "nope":
        cos, sin = _rope_for(cfg, inputs.positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    new_cache: Optional[Dict[str, torch.Tensor]] = None
    if inputs.cache is not None and "k_q" in inputs.cache:
        # int8 KV cache (serving): quantize the new token's k/v into the
        # cache in place, dequantize the cache for the read.  Scales are per
        # (pos, head).
        qc = inputs.cache
        Sc = qc["k_q"].shape[1]
        pos = inputs.cache_pos
        rolling = kind in ("local", "chunked")
        write = (pos % Sc if rolling else pos).reshape(1)
        for name, part in zip(("k_q", "k_s", "v_q", "v_s"), quantize_rows(k) + quantize_rows(v)):
            qc[name].index_copy_(1, write, part)
        new_cache = qc
        kc = (qc["k_q"].float() * qc["k_s"].float()).to(q.dtype)
        vc = (qc["v_q"].float() * qc["v_s"].float()).to(q.dtype)
        valid = _valid(pos, Sc, rolling, B, x.device)
        out = decode_attention(q, kc, vc, valid, scale=scale, logit_softcap=cfg.attn_softcap)
        y = out.reshape(B, S, H * Dh) @ p["wo"]
        return y, new_cache
    if inputs.collect_kv:
        # prefill: build the decode cache from the computed k/v.  Local and
        # chunked layers keep a ring buffer of the last W positions, aligned
        # so that the next decode write lands at pos % W.
        W = init_cache_shape(cfg, kind, B, S)[1]
        if W < S:
            kc = torch.roll(k[:, -W:], S % W, dims=1)
            vc = torch.roll(v[:, -W:], S % W, dims=1)
        else:
            kc, vc = k, v
        if inputs.quantize_collected:
            kq, ks = quantize_rows(kc)
            vq, vs = quantize_rows(vc)
            new_cache = {"k_q": kq, "k_s": ks, "v_q": vq, "v_s": vs}
        else:
            new_cache = {"k": kc.to(torch.bfloat16), "v": vc.to(torch.bfloat16)}
    if inputs.cache is not None:
        # decode: write k/v at cache_pos in place (rolling for local layers),
        # indexed on the device
        kc, vc = inputs.cache["k"], inputs.cache["v"]
        Sc = kc.shape[1]
        pos = inputs.cache_pos
        rolling = kind in ("local", "chunked")  # bounded cache, ring buffer
        write = (pos % Sc if rolling else pos).reshape(1)
        kc.index_copy_(1, write, k.to(kc.dtype))
        vc.index_copy_(1, write, v.to(vc.dtype))
        new_cache = inputs.cache
        valid = _valid(pos, Sc, rolling, B, x.device)
        out = decode_attention(
            q, kc.to(q.dtype), vc.to(q.dtype), valid, scale=scale, logit_softcap=cfg.attn_softcap
        )
    elif kind == "local":
        out = flash_ops.flash_attention(q, k, v, causal=True, window=cfg.window, scale=scale,
                                        logit_softcap=cfg.attn_softcap)
    elif kind == "chunked" and S > cfg.chunk_size:
        out = chunked_attention(q, k, v, chunk=cfg.chunk_size, scale=scale, logit_softcap=cfg.attn_softcap)
    else:
        out = flash_ops.flash_attention(q, k, v, causal=kind != "bidir", scale=scale,
                                        logit_softcap=cfg.attn_softcap)

    y = out.reshape(B, S, H * Dh) @ p["wo"]
    return y, new_cache


def init_cache_shape(cfg: ArchConfig, kind: str, batch: int, max_seq: int) -> Tuple[int, ...]:
    """Cache length: full context for global layers, window for local
    layers, chunk for chunked layers (sub-quadratic cache)."""
    if kind == "local":
        S = min(cfg.window, max_seq)
    elif kind == "chunked":
        S = min(cfg.chunk_size, max_seq)
    else:
        S = max_seq
    return (batch, S, cfg.n_kv_heads, cfg.resolved_head_dim)
