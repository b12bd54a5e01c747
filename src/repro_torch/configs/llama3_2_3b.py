"""llama3.2-3b [dense]: small llama3, GQA kv=8.

28L d_model=3072 24H kv=8 d_ff=8192 vocab=128256.  [hf:meta-llama/Llama-3.2-3B]
"""
from repro_torch.configs.base import DSSoftmaxConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    tie_embeddings=True,
    head="ds",
    ds=DSSoftmaxConfig(num_experts=16),
)
