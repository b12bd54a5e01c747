"""qwen2-1.5b [dense]: GQA kv=2, QKV bias, very large vocab.

28L d_model=1536 12H kv=2 d_ff=8960 vocab=151936.  [arXiv:2407.10671]
"""
from repro_torch.configs.base import DSSoftmaxConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    head="ds",
    ds=DSSoftmaxConfig(num_experts=16),
)
