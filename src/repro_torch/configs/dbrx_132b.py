# dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8, head_dim=128)
# d_ff=10752/expert vocab=100352, MoE 16 experts top-4 (fine-grained).
# [hf:databricks/dbrx-base; unverified]
from .base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    arch_id="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    layer_pattern=("global",),
    rope_theta=500000.0,
    activation="silu",
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
    max_seq_len=32768,
    subquadratic=False,
    source="hf:databricks/dbrx-base",
))
