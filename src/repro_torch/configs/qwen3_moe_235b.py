"""qwen3-moe-235b-a22b [moe]: 128 experts, top-8, deep (94L), large vocab.

94L d_model=4096 64H kv=4 d_ff(expert)=1536 vocab=151936.
[hf:Qwen/Qwen3-235B-A22B]
"""
from repro_torch.configs.base import DSSoftmaxConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,  # qwen3 sets head_dim 128 explicitly (64H * 128 != d_model)
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
    head="ds",
    ds=DSSoftmaxConfig(num_experts=16),
)
