"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

24L d_model=768 d_ff=0 vocab=50280 ssm_state=128.  [arXiv:2405.21060]
"""
from repro_torch.configs.base import DSSoftmaxConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
    head="ds",
    ds=DSSoftmaxConfig(num_experts=8),
)

SUB_QUADRATIC = True  # pure SSM: long_500k runs
