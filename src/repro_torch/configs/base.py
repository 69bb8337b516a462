# Architecture configuration system.  One ArchConfig fully describes a model
# family member; the ten assigned architectures live in sibling modules and
# register themselves here (``get_config(arch_id)``).
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Layer kinds (the heterogeneous-pattern vocabulary)
# ---------------------------------------------------------------------------
# 'global'  — full causal self-attention
# 'local'   — sliding-window causal attention (window = cfg.window)
# 'chunked' — chunked attention (llama4-style: attend within fixed chunks)
# 'bidir'   — full bidirectional attention (encoder-only)
# 'rwkv'    — RWKV6 time-mix block (attention-free)
# 'mamba2'  — Mamba2 SSD block
# 'shared_attn' — invocation of the *shared* transformer block (zamba2)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert_d_ff: int = 0          # llama4 shared expert
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    # Routing is dispatched independently within each of `dispatch_shards`
    # token groups (the launcher sets this to the data-parallel degree) so
    # the sort-based dispatch never sorts across data shards — the paper's
    # indirect partitioning applied *within* each direct partition.
    dispatch_shards: int = 1


@dataclass(frozen=True)
class SSMConfig:
    # RWKV6
    head_size: int = 64
    # Mamba2
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    n_groups: int = 1


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # layer pattern: cycle of layer kinds; tiled/truncated to n_layers
    layer_pattern: Tuple[str, ...] = ("global",)
    window: int = 4096               # sliding-window size for 'local'
    chunk_size: int = 8192           # chunk size for 'chunked'
    # attention details
    rope_theta: float = 10000.0
    m_rope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (per half-dim)
    attn_softcap: float = 0.0        # gemma2 logit soft-capping (50.0)
    final_softcap: float = 0.0       # gemma2 final-logit softcap (30.0)
    qk_norm: bool = False            # gemma3 QK-norm
    attn_scale: Optional[float] = None  # override 1/sqrt(head_dim)
    causal: bool = True              # False for encoder-only
    # MLP
    activation: str = "silu"         # silu | gelu | gelu_tanh
    gated_mlp: bool = True
    # embeddings
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma multiplies embeddings by sqrt(d)
    # norms
    norm_eps: float = 1e-6
    post_block_norms: bool = False   # gemma2/3 sandwich norms
    # extensions
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_period: int = 0      # zamba2: shared block every k layers
    n_shared_blocks: int = 2         # zamba2: alternating shared blocks
    shared_concat_embed: bool = True # zamba2: shared block sees [h, embed]
    # serving
    max_seq_len: int = 32768
    # notes for DESIGN.md / dry-run skip logic
    supports_decode: bool = True
    subquadratic: bool = False       # eligible for long_500k
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expand the pattern cycle to n_layers entries, then interleave
        shared-attention invocations (zamba2) if configured."""
        kinds = tuple(
            self.layer_pattern[i % len(self.layer_pattern)] for i in range(self.n_layers)
        )
        return kinds

    def scan_groups(self) -> Tuple[Tuple[Tuple[str, ...], int], Tuple[str, ...]]:
        """Split the layer-kind sequence into (pattern, repeats) + remainder
        for lax.scan stacking: the sequence is  pattern × repeats ⧺ remainder."""
        kinds = self.layer_kinds()
        p = len(self.layer_pattern)
        # normalize pattern so a full cycle is the scan body
        repeats = len(kinds) // p
        remainder = kinds[repeats * p :]
        return (tuple(self.layer_pattern), repeats), remainder


# ---------------------------------------------------------------------------
# Shape cells (assigned input shapes; identical across the LM family)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_config(arch_id: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if arch_id not in _REGISTRY:
        _load_all()
    return _REGISTRY[arch_id]


def list_archs() -> List[str]:
    _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    # import side effect registers each config
    from . import (  # noqa: F401
        gemma2_9b,
        gemma3_4b,
        starcoder2_3b,
        starcoder2_15b,
        hubert_xlarge,
        dbrx_132b,
        llama4_scout,
        qwen2_vl_72b,
        rwkv6_3b,
        zamba2_7b,
    )


def valid_cells(cfg: ArchConfig) -> List[str]:
    """The dry-run cells this architecture runs (assignment skip rules)."""
    cells = ["train_4k", "prefill_32k"]
    if cfg.supports_decode:
        cells.append("decode_32k")
        if cfg.subquadratic:
            cells.append("long_500k")
    return cells


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests (per assignment:
    'small layers/width, few experts, tiny embedding tables')."""
    p = len(cfg.layer_pattern)
    n_layers = max(p + 1, 3) if cfg.shared_attn_period == 0 else max(cfg.shared_attn_period + 1, 3)
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=64,
                                  shared_expert_d_ff=32 if cfg.moe.shared_expert_d_ff else 0)
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, head_size=16, d_state=16, headdim=16)
    m_rope = cfg.m_rope_sections
    if m_rope:
        m_rope = (2, 3, 3)  # sums to reduced head_dim // 2
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        window=16,
        chunk_size=32,
        max_seq_len=128,
        m_rope_sections=m_rope,
        attn_scale=16 ** -0.5 if cfg.attn_scale is not None else None,
        moe=moe,
        ssm=ssm,
        shared_attn_period=min(cfg.shared_attn_period, 2) if cfg.shared_attn_period else 0,
    )
