"""granite-20b [dense]: llama-arch code model, extreme GQA (MQA, kv=1).

52L d_model=6144 48H kv=1 d_ff=24576 vocab=49152.  [arXiv:2405.04324]
"""
from repro_torch.configs.base import DSSoftmaxConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    act="gelu",  # granite-20b-code uses a gpt-bigcode style MLP
    head="ds",
    ds=DSSoftmaxConfig(num_experts=8),
)
