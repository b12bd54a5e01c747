"""olmoe-1b-7b [moe]: 64 experts, top-8, fine-grained FFN experts.

16L d_model=2048 16H kv=16 d_ff(expert)=1024 vocab=50304.  [arXiv:2409.02060]

Two sparse-expert systems coexist here: the MoE FFN backbone and the
DS-Softmax head; the head reuses the MoE's sort-based dispatch.
"""
from repro_torch.configs.base import DSSoftmaxConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
    head="ds",
    ds=DSSoftmaxConfig(num_experts=8),
)
