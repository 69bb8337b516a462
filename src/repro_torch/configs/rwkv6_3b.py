# rwkv6-3b "Finch" [ssm]: 32L d_model=2560 (attention-free, 40 wkv heads of
# size 64) d_ff=8960 vocab=65536 — data-dependent decay. [arXiv:2404.05892]
from .base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    arch_id="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # d_model / head_size
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    layer_pattern=("rwkv",),
    ssm=SSMConfig(head_size=64),
    activation="relu2",
    max_seq_len=524288,
    subquadratic=True,     # O(1) state per token
    source="arXiv:2404.05892",
))
