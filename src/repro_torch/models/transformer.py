# Model assembly: parameter-definition trees, the layer stacker (pattern
# periods with stacked parameters, plus a remainder), and the forward /
# prefill / decode entry points for the attention families (with a dense
# or a mixture-of-experts feed-forward), rwkv6, zamba2 (Mamba2 layers with
# shared attention blocks) and the audio encoder (hubert-xlarge: precomputed
# frame embeddings through one ``frontend`` projection, bidirectional
# layers, a ``head`` over its units, and a loss on ``labels`` under an
# optional ``label_mask``, as the JAX package's stub frontend has it).
#
# Heterogeneous layer patterns (gemma local:global alternation) stack one
# tensor per pattern position with a leading ``repeats`` axis, as the JAX
# package stacks them for lax.scan; here a Python loop over the repeats
# indexes ``[r]``.  Caches are stacked the same way; decode writes them in
# place (the attention block its k/v at the position, the rwkv and mamba2
# blocks their whole state).  zamba2 invokes one of its
# ``n_shared_blocks`` shared transformer blocks (stacked under ``shared``)
# after every ``shared_attn_period``-th layer, block ``inv %
# n_shared_blocks`` for the inv-th invocation; each invocation has its own
# k/v cache, stacked (repeats, invocations a repeat, ...) under ``shared``
# and listed under ``shared_rem`` for the remainder layers.
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from . import shardctx
from .attention import AttnInputs, attention_block, attention_defs, init_cache_shape
from .common import (
    ParamDef,
    draw_param_,
    param_count,
    rms_norm,
    softcap,
    tree_abstract,
    tree_leaves,
    tree_map,
    tree_stack_defs,
)
from .mamba2 import mamba2_block, mamba2_defs, mamba2_init_state
from .mlp import mlp_block, mlp_defs
from .moe import moe_block, moe_defs
from .rwkv6 import rwkv6_channel_defs, rwkv6_channel_mix, rwkv6_defs, rwkv6_time_mix

ATTN_KINDS = ("global", "local", "chunked", "bidir")
AUX_KEYS = ("lb_loss", "router_z")


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def block_defs(cfg: ArchConfig, kind: str) -> Dict[str, Any]:
    d = cfg.d_model

    def ln():
        return ParamDef((d,), ("embed",), init="zeros")

    if kind in ATTN_KINDS:
        out: Dict[str, Any] = {"ln1": ln(), "attn": attention_defs(cfg)}
        if cfg.post_block_norms:
            out["ln1_post"] = ln()
        out["ln2"] = ln()
        if cfg.moe is not None:
            out["moe"] = moe_defs(cfg)
        else:
            out["mlp"] = mlp_defs(cfg)
        if cfg.post_block_norms:
            out["ln2_post"] = ln()
        return out
    if kind == "rwkv":
        return {"ln1": ln(), "tmix": rwkv6_defs(cfg), "ln2": ln(), "cmix": rwkv6_channel_defs(cfg)}
    if kind == "mamba2":
        return {"ln1": ln(), "mamba": mamba2_defs(cfg)}
    raise ValueError(f"unknown layer kind {kind}")


def shared_block_defs(cfg: ArchConfig) -> Dict[str, Any]:
    """zamba2's shared transformer block (attention + MLP), invoked every
    ``shared_attn_period`` layers; its weights are shared across
    invocations (two alternating blocks), with a per-use input projection
    from [h, embed]."""
    d = cfg.d_model
    din = 2 * d if cfg.shared_concat_embed else d
    return {
        "in_proj": ParamDef((din, d), ("embed", "embed_out")),
        "ln1": ParamDef((din,), ("embed",), init="zeros"),
        "attn": attention_defs(cfg),
        "ln2": ParamDef((d,), ("embed",), init="zeros"),
        "mlp": mlp_defs(cfg),
    }


def model_defs(cfg: ArchConfig) -> Dict[str, Any]:
    d, V = cfg.d_model, cfg.vocab_size
    (pattern, repeats), remainder = cfg.scan_groups()
    defs: Dict[str, Any] = {
        "final_norm": ParamDef((d,), ("embed",), init="zeros"),
    }
    if cfg.family == "audio":
        # the modality frontend is a stub, as in the JAX package: frame
        # embeddings come precomputed and one projection adapts them
        defs["frontend"] = ParamDef((d, d), ("embed", "embed_out"))
        defs["head"] = ParamDef((d, V), ("embed", "vocab"))
    else:
        defs["embed"] = ParamDef((V, d), ("vocab", "embed"))
        if not cfg.tie_embeddings:
            defs["lm_head"] = ParamDef((d, V), ("embed", "vocab"))
    if repeats > 0:
        defs["groups"] = {
            f"pos{i}": tree_stack_defs(block_defs(cfg, kind), repeats)
            for i, kind in enumerate(pattern)
        }
    if remainder:
        defs["remainder"] = [block_defs(cfg, kind) for kind in remainder]
    if cfg.shared_attn_period:
        assert len(pattern) % cfg.shared_attn_period == 0, (
            "layer_pattern length must be a multiple of shared_attn_period")
        defs["shared"] = tree_stack_defs(shared_block_defs(cfg), cfg.n_shared_blocks)
    return defs


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def apply_block(
    p: Dict[str, Any],
    x: torch.Tensor,
    cfg: ArchConfig,
    kind: str,
    positions: torch.Tensor,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos: Optional[int] = None,
    prefill: bool = False,
    prefill_quant: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Returns (x_out, new_cache, aux); aux holds the MoE block's
    lb_loss and router_z (f32 scalars), and is empty for other blocks."""
    if kind == "rwkv":
        return _rwkv_block(p, x, cfg, cache, prefill)
    if kind == "mamba2":
        return _mamba2_block(p, x, cfg, cache, prefill)
    if kind not in ATTN_KINDS:
        raise ValueError(f"unknown layer kind {kind}")
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    attn_out, new_cache = attention_block(
        p["attn"], h, cfg, kind,
        AttnInputs(positions, cache, cache_pos, collect_kv=prefill, quantize_collected=prefill_quant),
    )
    if cfg.post_block_norms:
        attn_out = rms_norm(attn_out, p["ln1_post"], cfg.norm_eps)
        x = x + attn_out
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
    else:
        # the JAX package's compiled block norms the f32 sum, unrounded (XLA
        # keeps the add fused into the norm, as in the rwkv block); the
        # residual itself is rounded
        h = rms_norm(x.float() + attn_out.float(), p["ln2"], cfg.norm_eps).to(x.dtype)
        x = x + attn_out
    aux: Dict[str, torch.Tensor] = {}
    if cfg.moe is not None:
        ff, aux = moe_block(p["moe"], h, cfg)
    else:
        ff = mlp_block(p["mlp"], h, cfg)
    if cfg.post_block_norms:
        ff = rms_norm(ff, p["ln2_post"], cfg.norm_eps)
    x = x + ff
    return x, new_cache, aux


def _rwkv_block(
    p: Dict[str, Any],
    x: torch.Tensor,
    cfg: ArchConfig,
    cache: Optional[Dict[str, torch.Tensor]],
    prefill: bool,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Time mix then channel mix, each on its normed input.  Prefill without
    a cache starts from the zero state and returns the state it ends in;
    with a cache (decode), the new wkv, shift_t and shift_c are copied into
    the cache's tensors in place, since decode_step keeps the stacked cache
    it was given and drops what the block returns."""
    if prefill and cache is None:
        cache = _map_shapes(lambda sd: torch.zeros(sd[0], dtype=sd[1], device=x.device),
                            _block_cache_shapes(cfg, "rwkv", x.shape[0], 1))
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    t_out, tstate = rwkv6_time_mix(p["tmix"], h, cfg, state=cache)
    # the JAX package's compiled block norms the f32 sum, unrounded (XLA
    # keeps the add fused into the norm); the residual itself is rounded
    h = rms_norm(x.float() + t_out.float(), p["ln2"], cfg.norm_eps).to(x.dtype)
    x = x + t_out
    c_out, cstate = rwkv6_channel_mix(p["cmix"], h, cfg, state=cache)
    x = x + c_out
    if cache is not None:
        for name, value in {**tstate, **cstate}.items():
            cache[name].copy_(value)
    return x, cache, {}


def _mamba2_block(
    p: Dict[str, Any],
    x: torch.Tensor,
    cfg: ArchConfig,
    cache: Optional[Dict[str, torch.Tensor]],
    prefill: bool,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """The normed input through the Mamba2 block, added to the residual.
    ``x`` is the bf16 residual or, after another mamba2 layer or a shared
    block of the same repeat, its unrounded f32 sum, which ln1 norms as it
    is; the sum returned is unrounded too (C42).  Prefill without a cache
    starts from the zero state and returns the state it ends in; with a
    cache (decode) the new conv and ssm states are copied into the cache's
    tensors in place, as in the rwkv block."""
    if prefill and cache is None:
        cache = mamba2_init_state(cfg, x.shape[0], device=x.device)
    dt = p["ln1"].dtype  # the weights' type: bf16, or f32 for a model in f32
    h = rms_norm(x, p["ln1"], cfg.norm_eps).to(dt)
    m_out, new_state = mamba2_block(p["mamba"], h, cfg, state=cache)
    if cache is not None:
        for name, value in new_state.items():
            cache[name].copy_(value)
    return x.to(dt).float() + m_out.float(), cache, {}


def apply_shared_block(
    p: Dict[str, Any],
    x: torch.Tensor,
    embed0: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos: Optional[torch.Tensor] = None,
    prefill: bool = False,
    prefill_quant: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """zamba2's shared block on [x, embed0]: ln1 over both, the input
    projection back to d_model, global attention, then the MLP, each added
    to x.  ``x`` may be a mamba2 layer's unrounded sum: the block reads it
    rounded, and returns its own last sum unrounded for the next layer's
    norm (C42).  Returns (x, the attention's cache: built at prefill,
    written in place at decode)."""
    x = x.to(embed0.dtype)
    h = torch.cat([x, embed0], dim=-1) if cfg.shared_concat_embed else x
    h = rms_norm(h, p["ln1"], cfg.norm_eps)
    h = h @ p["in_proj"]
    attn_out, new_cache = attention_block(
        p["attn"], h, cfg, "global",
        AttnInputs(positions, cache, cache_pos, collect_kv=prefill, quantize_collected=prefill_quant),
    )
    # ln2 norms the f32 sum, unrounded, as in the attention block
    h2 = rms_norm(x.float() + attn_out.float(), p["ln2"], cfg.norm_eps).to(attn_out.dtype)
    x = x + attn_out
    return x.float() + mlp_block(p["mlp"], h2, cfg).float(), new_cache


def _layer(tree: Dict[str, Any], r: int) -> Dict[str, Any]:
    """Repeat ``r`` of a stacked tree (views, so writes reach the stack)."""
    return tree_map(lambda a: a[r], tree)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def _block_cache_shapes(cfg: ArchConfig, kind: str, batch: int, max_seq: int,
                        quantized: bool = False) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    if kind == "rwkv":
        # the recurrent state has no sequence axis: max_seq and quantized
        # do not apply
        K = cfg.ssm.head_size
        H = cfg.d_model // K
        return {
            "wkv": ((batch, H, K, K), torch.float32),
            "shift_t": ((batch, cfg.d_model), torch.bfloat16),
            "shift_c": ((batch, cfg.d_model), torch.bfloat16),
        }
    if kind == "mamba2":
        return {name: (tuple(t.shape), t.dtype) for name, t in mamba2_init_state(cfg, batch, device="meta").items()}
    shape = init_cache_shape(cfg, kind, batch, max_seq)
    if quantized:
        s_shape = shape[:-1] + (1,)
        return {
            "k_q": (shape, torch.int8),
            "k_s": (s_shape, torch.float16),
            "v_q": (shape, torch.int8),
            "v_s": (s_shape, torch.float16),
        }
    return {"k": (shape, torch.bfloat16), "v": (shape, torch.bfloat16)}


def cache_abstract(cfg: ArchConfig, batch: int, max_seq: int, quantized: bool = False) -> Dict[str, Any]:
    """The cache tree with (shape, dtype) leaves."""
    (pattern, repeats), remainder = cfg.scan_groups()
    out: Dict[str, Any] = {}
    if repeats > 0:
        out["groups"] = {
            f"pos{i}": {
                name: ((repeats,) + shape, dt)
                for name, (shape, dt) in _block_cache_shapes(cfg, kind, batch, max_seq, quantized).items()
            }
            for i, kind in enumerate(pattern)
        }
    if remainder:
        out["remainder"] = [_block_cache_shapes(cfg, kind, batch, max_seq, quantized) for kind in remainder]
    per_step, rem_inv = _shared_layout(cfg)
    if per_step:
        out["shared"] = {
            name: ((repeats, per_step) + shape, dt)
            for name, (shape, dt) in _block_cache_shapes(cfg, "global", batch, max_seq, quantized).items()
        }
    if rem_inv:
        out["shared_rem"] = [_block_cache_shapes(cfg, "global", batch, max_seq, quantized) for _ in range(rem_inv)]
    return out


def _block_cache_axes(cfg: ArchConfig, kind: str, quantized: bool = False) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical axis names for each cache leaf (mirrors _block_cache_shapes);
    read by the launcher's sharding rules."""
    if kind in ATTN_KINDS:
        ax = ("batch", "kv_seq", "kv_heads", "head_dim")
        if quantized:
            sax = ("batch", "kv_seq", "kv_heads", None)
            return {"k_q": ax, "k_s": sax, "v_q": ax, "v_s": sax}
        return {"k": ax, "v": ax}
    if kind == "rwkv":
        return {
            "wkv": ("batch", "heads", "key_dim", "value_dim"),
            "shift_t": ("batch", "act_embed"),
            "shift_c": ("batch", "act_embed"),
        }
    if kind == "mamba2":
        return {
            "conv": ("batch", None, "ssm_act"),
            "ssm": ("batch", "heads", "head_dim", "state"),
        }
    raise ValueError(kind)


def cache_axes(cfg: ArchConfig, quantized: bool = False) -> Dict[str, Any]:
    """Logical axes tree congruent with cache_abstract."""
    (pattern, repeats), remainder = cfg.scan_groups()

    def stack(tree, extra=("layers",)):
        return {name: tuple(extra) + ax for name, ax in tree.items()}

    out: Dict[str, Any] = {}
    if repeats > 0:
        out["groups"] = {
            f"pos{i}": stack(_block_cache_axes(cfg, kind, quantized))
            for i, kind in enumerate(pattern)
        }
    if remainder:
        out["remainder"] = [_block_cache_axes(cfg, kind, quantized) for kind in remainder]
    per_step, rem_inv = _shared_layout(cfg)
    if per_step:
        out["shared"] = stack(_block_cache_axes(cfg, "global", quantized), extra=("layers", None))
    if rem_inv:
        out["shared_rem"] = [_block_cache_axes(cfg, "global", quantized) for _ in range(rem_inv)]
    return out


def _shared_layout(cfg: ArchConfig) -> Tuple[int, int]:
    """(shared invocations a repeat of the pattern, invocations among the
    remainder layers)."""
    if not cfg.shared_attn_period:
        return 0, 0
    (pattern, repeats), remainder = cfg.scan_groups()
    base = repeats * len(pattern)
    rem = sum(1 for j in range(len(remainder)) if (base + j + 1) % cfg.shared_attn_period == 0)
    return len(pattern) // cfg.shared_attn_period, rem


def _is_shape_leaf(x: Any) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], torch.dtype)


def _map_shapes(fn, tree: Any) -> Any:
    if _is_shape_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_shapes(fn, v) for k, v in tree.items()}
    return [_map_shapes(fn, v) for v in tree]


def cache_init(cfg: ArchConfig, batch: int, max_seq: int, quantized: bool = False,
               device: Any = None) -> Dict[str, Any]:
    """A zero cache on ``device`` (the card unless the caller asks for the
    CPU; on ``"meta"`` the abstract cache: shapes and dtypes, nothing
    allocated)."""
    dev = resolve_device(device)
    return _map_shapes(lambda sd: torch.zeros(sd[0], dtype=sd[1], device=dev),
                       cache_abstract(cfg, batch, max_seq, quantized))


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def embed_tokens(params: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg: ArchConfig) -> torch.Tensor:
    if cfg.family == "audio":
        # frames rounded to bf16, then promoted to the weights' type as
        # jnp's matmul promotes them (f32 weights take bf16 frames in f32)
        frames, w = batch["frames"].to(torch.bfloat16), params["frontend"]
        return frames.to(torch.promote_types(frames.dtype, w.dtype)) @ w
    tok = batch["tokens"]
    x = params["embed"][tok.long()]
    if "patch_embeds" in batch:  # VLM stub frontend: positionwise merge
        x = torch.where(batch["patch_mask"][..., None], batch["patch_embeds"].to(x.dtype), x)
    if cfg.embed_scale:
        # the JAX package casts sqrt(d) to the embedding's type first
        # (sqrt(3584) = 59.87 becomes 59.75 in bf16), then multiplies; the
        # rounded factor is a host scalar, so a captured decode step copies
        # nothing from the host
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def _positions_of(batch: Dict[str, torch.Tensor], cfg: ArchConfig, B: int, S: int,
                  device: torch.device) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
    if cfg.m_rope_sections:
        return pos[None].expand(3, B, S)
    return pos


def _layers(cfg: ArchConfig):
    """(group key or None, repeat or remainder index, kind, shared) in
    layer order.  ``shared`` is the shared invocation that follows the
    layer, else None: (the block it uses, the index of its cache) with the
    index (r, j), the j-th invocation of repeat r in the ``shared`` stack,
    or (k,), the k-th of ``shared_rem``.  The inv-th invocation (counted
    across the repeats and the remainder) uses block inv % n_shared_blocks."""
    (pattern, repeats), remainder = cfg.scan_groups()
    period = cfg.shared_attn_period

    def invocation(layer: int) -> Optional[int]:
        if period and (layer + 1) % period == 0:
            return (layer + 1) // period - 1
        return None

    for r in range(repeats):
        for i, kind in enumerate(pattern):
            inv = invocation(r * len(pattern) + i)
            yield f"pos{i}", r, kind, None if inv is None else (inv % cfg.n_shared_blocks, (r, (i + 1) // period - 1))
    k = 0
    for j, kind in enumerate(remainder):
        inv = invocation(repeats * len(pattern) + j)
        yield None, j, kind, None if inv is None else (inv % cfg.n_shared_blocks, (k,))
        k += inv is not None


def _layer_params(params: Dict[str, Any], group: Optional[str], idx: int) -> Dict[str, Any]:
    if group is None:
        return params["remainder"][idx]
    return _layer(params["groups"][group], idx)


def forward(
    params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    remat: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward (train / prefill).  Returns (logits, aux),
    aux the MoE losses summed over the layers (zeros without experts), as
    the JAX package sums them over its scan and the remainder.  ``remat``
    recomputes each repeat of the layer pattern in the backward
    (torch.utils.checkpoint), as the JAX package checkpoints each step of
    its scan; the remainder layers are not recomputed, as there.  The
    residual stream is pinned to the installed layout (shardctx) after the
    embedding and after each layer of a repeat, where the JAX package pins
    it."""
    x = shardctx.constrain_hidden(embed_tokens(params, batch, cfg))
    embed0 = x
    B, S, _ = x.shape
    positions = _positions_of(batch, cfg, B, S, x.device)
    (pattern, repeats), remainder = cfg.scan_groups()
    zero = torch.zeros(len(AUX_KEYS), dtype=torch.float32, device=x.device)
    by_repeat: Dict[Optional[int], List[tuple]] = {}
    for layer in _layers(cfg):
        by_repeat.setdefault(None if layer[0] is None else layer[1], []).append(layer)

    def run(x: torch.Tensor, r: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The layers of repeat ``r`` (None: the remainder), each followed
        by its shared invocation, if any."""
        acc = zero
        for group, idx, kind, shared in by_repeat[r]:
            x, _, aux = apply_block(_layer_params(params, group, idx), x, cfg, kind, positions)
            if aux:
                acc = acc + torch.stack([aux[k] for k in AUX_KEYS])
            if shared is not None:
                x, _ = apply_shared_block(_layer(params["shared"], shared[0]), x, embed0, cfg, positions)
            if r is not None:
                x = shardctx.constrain_hidden(x)
        # a repeat ends rounded (the reference's scan carries bf16); the
        # remainder's last sum reaches the final norm unrounded (C42)
        return (x if r is None else x.to(embed0.dtype)), acc

    aux_acc = zero
    for r in range(repeats):
        x, aux_r = checkpoint(run, x, r, use_reentrant=False) if remat else run(x, r)
        aux_acc = aux_acc + aux_r
    if remainder:
        x, aux_r = run(x, None)
        aux_acc = aux_acc + aux_r
    x = rms_norm(x, params["final_norm"], cfg.norm_eps).to(embed0.dtype)
    logits = _project_logits(params, x, cfg)
    return logits, dict(zip(AUX_KEYS, aux_acc.unbind()))


def _project_logits(params: Dict[str, Any], x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.family == "audio":
        logits = x @ params["head"]
    elif cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    if cfg.final_softcap > 0:
        logits = softcap(logits, cfg.final_softcap)
    return logits


def _stack_caches(caches: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {name: torch.stack([c[name] for c in caches]) for name in caches[0]}


def prefill_forward(
    params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    cfg: ArchConfig,
    quantize_cache: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Forward pass that also materializes decode caches (serving prefill).
    Returns (last-position logits (B, 1, V), cache): full (B, S, V) logits
    at 32k x 256k vocab would be hundreds of GB."""
    x = shardctx.constrain_hidden(embed_tokens(params, batch, cfg))
    embed0 = x
    B, S, _ = x.shape
    positions = _positions_of(batch, cfg, B, S, x.device)
    (pattern, repeats), remainder = cfg.scan_groups()
    per_group: Dict[str, List[Dict[str, torch.Tensor]]] = {f"pos{i}": [] for i in range(len(pattern))}
    rem_caches: List[Dict[str, torch.Tensor]] = []
    per_repeat: List[List[Dict[str, torch.Tensor]]] = [[] for _ in range(repeats)]
    shared_rem: List[Dict[str, torch.Tensor]] = []
    for group, idx, kind, shared in _layers(cfg):
        x, c_new, _ = apply_block(_layer_params(params, group, idx), x, cfg, kind, positions,
                                  prefill=True, prefill_quant=quantize_cache)
        (rem_caches if group is None else per_group[group]).append(c_new)
        if shared is not None:
            x, sc_new = apply_shared_block(_layer(params["shared"], shared[0]), x, embed0, cfg, positions,
                                           prefill=True, prefill_quant=quantize_cache)
            (shared_rem if group is None else per_repeat[idx]).append(sc_new)
        if group == f"pos{len(pattern) - 1}":
            x = x.to(embed0.dtype)  # a repeat ends rounded (C42)
    cache: Dict[str, Any] = {}
    if repeats > 0:
        cache["groups"] = {g: _stack_caches(cs) for g, cs in per_group.items()}
    if remainder:
        cache["remainder"] = rem_caches
    if repeats > 0 and per_repeat[0]:
        cache["shared"] = _stack_caches([_stack_caches(cs) for cs in per_repeat])
    if shared_rem:
        cache["shared_rem"] = shared_rem
    # the last position's slice is taken of the rounded residual (C42)
    x = rms_norm(x[:, -1:].to(embed0.dtype), params["final_norm"], cfg.norm_eps)
    logits = _project_logits(params, x, cfg)
    return logits, cache


# ---------------------------------------------------------------------------
# Decode step (one token, cache-carrying)
# ---------------------------------------------------------------------------


def decode_step(
    params: Dict[str, Any],
    cache: Dict[str, Any],
    batch: Dict[str, Any],
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """batch: {'tokens': (B,1), 'pos': 0-dim int device tensor (an int is
    taken too)} -> (logits (B,1,V), cache).  The cache is written in place
    and returned.  Nothing here reads a value back to the host, so the step
    can be captured in a CUDA graph (serve/step.py)."""
    x = embed_tokens(params, batch, cfg)
    B = x.shape[0]
    pos = torch.as_tensor(batch["pos"], device=x.device).to(torch.int64)
    positions = pos.to(torch.int32).reshape(1, 1).expand(B, 1)
    if cfg.m_rope_sections:
        positions = positions[None].expand(3, B, 1)
    embed0 = x
    for group, idx, kind, shared in _layers(cfg):
        lc = cache["remainder"][idx] if group is None else _layer(cache["groups"][group], idx)
        x, _, _ = apply_block(_layer_params(params, group, idx), x, cfg, kind, positions, lc, pos)
        if shared is not None:
            block, at = shared
            sc = cache["shared_rem"][at[0]] if group is None else _layer(_layer(cache["shared"], at[0]), at[1])
            x, _ = apply_shared_block(_layer(params["shared"], block), x, embed0, cfg, positions, sc, pos)
        if group == f"pos{len(cfg.layer_pattern) - 1}":
            x = x.to(embed0.dtype)  # a repeat ends rounded (C42)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps).to(embed0.dtype)
    logits = _project_logits(params, x, cfg)
    return logits, cache


# ---------------------------------------------------------------------------
# Loss (differentiable: the flash kernel carries its gradient)
# ---------------------------------------------------------------------------


def lm_loss(
    params: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg: ArchConfig, *, remat: bool = False
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean next-token nll under ``loss_mask`` (text), or the audio
    encoder's nll of ``labels`` at each frame under ``label_mask``, unshifted;
    MoE models add their aux term."""
    logits, aux = forward(params, batch, cfg, remat=remat)
    if cfg.family == "audio":
        labels = batch["labels"].long()
        mask = batch.get("label_mask")
        mask = torch.ones(labels.shape, device=logits.device) if mask is None else mask.float()
    else:
        labels = batch["tokens"][:, 1:].long()
        logits = logits[:, :-1]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(batch["tokens"].shape, device=logits.device)
        mask = mask[:, 1:].float()
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    ll = torch.gather(logits32, -1, labels[..., None])[..., 0]
    nll = (lse - ll) * mask
    loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
    metrics = {"loss": loss, **aux}
    if cfg.moe is not None:
        loss = loss + 0.01 * aux["lb_loss"] + cfg.moe.router_z_loss * aux["router_z"]
    return loss, metrics


# ---------------------------------------------------------------------------
# Public model facade
# ---------------------------------------------------------------------------


def resolve_device(device: Any = None) -> torch.device:
    """The card unless the caller asks for the CPU; never a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's LM stack runs on the card; pass device='cpu' to run on the CPU"
        )
    return dev


class _Node(nn.Module):
    """A dict level of the parameter tree."""


def _populate(node: nn.Module, defs: Dict[str, Any], device: torch.device) -> nn.Module:
    """Register ``defs`` on ``node``: a ParamDef as a parameter (ones where
    declared, zeros otherwise), a dict as a child node, a list as a
    ModuleList of nodes."""
    for name, d in defs.items():
        if isinstance(d, ParamDef):
            fill = torch.ones if d.init == "ones" else torch.zeros
            node.register_parameter(name, nn.Parameter(fill(d.shape, dtype=d.dtype, device=device),
                                                       requires_grad=False))
        elif isinstance(d, list):
            node.add_module(name, nn.ModuleList([_populate(_Node(), x, device) for x in d]))
        else:
            node.add_module(name, _populate(_Node(), d, device))
    return node


def _tree_of(module: nn.Module) -> Any:
    if isinstance(module, nn.ModuleList):
        return [_tree_of(m) for m in module]
    out: Dict[str, Any] = dict(module.named_parameters(recurse=False))
    for name, child in module.named_children():
        out[name] = _tree_of(child)
    return out


class Model(nn.Module):
    """The LM as a module: its parameters live under the JAX tree's own names
    with dots for nesting (``groups.pos0.attn.wq``, ``remainder.0.mlp.w_up``),
    stacked as the JAX package stacks them, so weights carry across name for
    name.  Parameters are allocated as declared (zeros, ones; the normal
    ones as zeros) until ``init_params`` draws them or ``load_state_dict``
    copies them in.  The card is the default device."""

    def __init__(self, cfg: ArchConfig, *, device: Any = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self._defs = model_defs(cfg)
        _populate(self, self._defs, self.device)

    def defs(self) -> Dict[str, Any]:
        return self._defs

    def abstract_params(self) -> Dict[str, Any]:
        """The parameter tree as tensors on the meta device (build the model
        on ``device="meta"`` to allocate nothing at all)."""
        return tree_abstract(self._defs)

    def n_params(self) -> int:
        return param_count(self._defs)

    @property
    def params(self) -> Dict[str, Any]:
        """The parameters as the JAX package's nested tree of tensors."""
        return _tree_of(self)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from ``generator`` (a generator on the
        model's device), leaf by leaf, after the JAX package's scheme."""
        for path, d in tree_leaves(self._defs):
            draw_param_(self.get_parameter(path), d, generator)
        return self

    def forward(self, batch: Dict[str, torch.Tensor],
                remat: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return forward(self.params, batch, self.cfg, remat=remat)

    def loss(self, batch: Dict[str, torch.Tensor], remat: bool = False):
        return lm_loss(self.params, batch, self.cfg, remat=remat)

    def prefill(self, batch: Dict[str, torch.Tensor], quantize_cache: bool = False):
        return prefill_forward(self.params, batch, self.cfg, quantize_cache)

    def decode_step(self, cache: Dict[str, Any], batch: Dict[str, Any]):
        return decode_step(self.params, cache, batch, self.cfg)

    def cache_abstract(self, batch: int, max_seq: int, quantized: bool = False):
        return cache_abstract(self.cfg, batch, max_seq, quantized)

    def cache_init(self, batch: int, max_seq: int, quantized: bool = False):
        return cache_init(self.cfg, batch, max_seq, quantized, device=self.device)
