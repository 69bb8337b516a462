# llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8, head_dim=128)
# d_ff=8192/expert vocab=202048, MoE 16e top-1 + shared expert; chunked
# attention (8192) with every 4th layer global (iRoPE approximated with
# RoPE everywhere — DESIGN.md §9). [hf:meta-llama/Llama-4-Scout-17B-16E]
from .base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    arch_id="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    layer_pattern=("chunked", "chunked", "chunked", "global"),
    chunk_size=8192,
    rope_theta=500000.0,
    activation="silu",
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, shared_expert_d_ff=8192),
    max_seq_len=524288,
    subquadratic=True,  # chunked layers bound attention span
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
