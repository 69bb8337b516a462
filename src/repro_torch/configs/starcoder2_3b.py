# starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2, head_dim=128)
# d_ff=12288 vocab=49152 — full attention, RoPE. [arXiv:2402.19173; hf]
# Deviation: HF uses LayerNorm + non-gated MLP; we keep the repo-wide RMSNorm
# and use a plain (non-gated) MLP to match d_ff FLOPs (DESIGN.md §9).
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    layer_pattern=("global",),
    rope_theta=999999.0,
    activation="gelu_tanh",
    gated_mlp=False,
    tie_embeddings=True,
    max_seq_len=32768,
    subquadratic=False,  # pure full attention -> long_500k skipped
    source="arXiv:2402.19173",
))
