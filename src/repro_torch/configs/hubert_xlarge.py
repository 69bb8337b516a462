# hubert-xlarge [audio]: 48L d_model=1280 16H (MHA kv=16, head_dim=80)
# d_ff=5120 vocab=504 — encoder-only; the conv waveform frontend is a STUB
# per assignment (input_specs() provides precomputed frame embeddings).
# [arXiv:2106.07447; unverified]
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    layer_pattern=("bidir",),
    causal=False,
    activation="gelu",
    gated_mlp=False,
    max_seq_len=32768,
    supports_decode=False,  # encoder-only: no decode shapes
    subquadratic=False,
    source="arXiv:2106.07447",
))
