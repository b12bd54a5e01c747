"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block.

81L d_model=3584 32H kv=32 d_ff=14336 vocab=32000 ssm_state=64.
[arXiv:2411.15242]

81 Mamba2 (SSD) blocks; one *shared* full-attention block (one parameter
set) is applied after every ``attn_period`` ssm layers: 13 applications and
a remainder group of 3 ssm layers.
"""
from repro_torch.configs.base import DSSoftmaxConfig, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    attn_period=6,
    head="ds",
    ds=DSSoftmaxConfig(num_experts=8),
)

SUB_QUADRATIC = True  # attention in O(1) blocks of the depth: long_500k runs
