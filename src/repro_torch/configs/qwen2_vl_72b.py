# qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8, head_dim=128)
# d_ff=29568 vocab=152064 — M-RoPE (sections 16/24/24), dynamic resolution;
# vision frontend is a STUB (input_specs provides patch embeddings).
# [arXiv:2409.12191; hf]
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    layer_pattern=("global",),
    rope_theta=1_000_000.0,
    m_rope_sections=(16, 24, 24),
    activation="silu",
    max_seq_len=32768,
    subquadratic=False,
    source="arXiv:2409.12191",
))
