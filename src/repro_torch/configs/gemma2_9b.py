# gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8, head_dim=256)
# d_ff=14336 vocab=256000 — local+global alternating attention (window 4096),
# attention+final logit softcapping, sandwich norms, tied embeddings.
# [arXiv:2408.00118; hf]
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    layer_pattern=("local", "global"),
    window=4096,
    rope_theta=10000.0,
    attn_softcap=50.0,
    final_softcap=30.0,
    attn_scale=256 ** -0.5,
    activation="gelu_tanh",
    tie_embeddings=True,
    embed_scale=True,
    post_block_norms=True,
    max_seq_len=524288,
    subquadratic=True,   # local layers bound KV to the window; global layers
                         # use a length-sharded cache (DESIGN.md §6)
    source="arXiv:2408.00118",
))
