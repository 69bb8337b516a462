# zamba2-7b [hybrid]: 81 Mamba2 layers d_model=3584 + shared attention
# blocks (32H MHA, kv=32) invoked every 6th layer (two alternating shared
# blocks, input = [h, embed] -> proj), d_ff=14336, vocab=32000, ssm_state=64.
# [arXiv:2411.15242; unverified]  Simplifications noted in DESIGN.md §9.
from .base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    layer_pattern=("mamba2",) * 6,   # one scan step = 6 mamba + 1 shared call
    shared_attn_period=6,
    n_shared_blocks=2,
    shared_concat_embed=True,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, headdim=64, n_groups=1),
    activation="gelu_tanh",
    max_seq_len=524288,
    subquadratic=True,
    source="arXiv:2411.15242",
))
