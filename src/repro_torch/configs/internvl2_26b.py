"""internvl2-26b [vlm]: InternViT frontend (a stub) + InternLM2-20B backbone.

48L d_model=6144 48H kv=8 d_ff=16384 vocab=92553.  [arXiv:2404.16821]

The InternViT-6B vision tower is a stub: the caller provides precomputed
patch embeddings (batch, n_patches, d_model), which are prepended to the
token embeddings.
"""
from repro_torch.configs.base import DSSoftmaxConfig, ModelConfig, VisionStubConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1000000.0,
    vision=VisionStubConfig(num_patches=256),
    head="ds",
    ds=DSSoftmaxConfig(num_experts=8),
)
