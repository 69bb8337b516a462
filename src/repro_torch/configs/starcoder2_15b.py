# starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4, head_dim=128)
# d_ff=24576 vocab=49152 — full attention, RoPE. [arXiv:2402.19173; hf]
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    layer_pattern=("global",),
    rope_theta=999999.0,
    activation="gelu_tanh",
    gated_mlp=False,
    tie_embeddings=False,
    max_seq_len=32768,
    subquadratic=False,
    source="arXiv:2402.19173",
))
