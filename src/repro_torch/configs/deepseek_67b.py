"""deepseek-67b [dense]: llama-arch, deep (95L), GQA kv=8.

95L d_model=8192 64H kv=8 d_ff=22016 vocab=102400.  [arXiv:2401.02954]
"""
from repro_torch.configs.base import DSSoftmaxConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10000.0,
    head="ds",
    ds=DSSoftmaxConfig(num_experts=8),
)
