# gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4, head_dim=256)
# d_ff=10240 vocab=262144 — 5:1 local:global (window 1024), QK-norm, 128k ctx.
# [hf:google/gemma-3-4b-pt; unverified]
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    rope_theta=1_000_000.0,  # global layers; local layers use 10k in HF —
                             # single theta here, noted in DESIGN.md
    qk_norm=True,
    attn_scale=256 ** -0.5,
    activation="gelu_tanh",
    tie_embeddings=True,
    embed_scale=True,
    post_block_norms=True,
    max_seq_len=524288,
    subquadratic=True,
    source="hf:google/gemma-3-4b-pt",
))
