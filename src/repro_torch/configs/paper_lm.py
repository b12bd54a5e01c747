"""Paper-scale configs: PTB and WikiText-2 vocab scale (dense LMs), IWSLT
En-Vi scale (an encoder-decoder) and CASIA scale (dense).
"""
from repro_torch.configs.base import DSSoftmaxConfig, ModelConfig

# PTB-scale: |V|=10,000, small backbone (paper: LSTM-200).
PTB = ModelConfig(
    name="paper-ptb",
    family="dense",
    n_layers=2,
    d_model=200,
    n_heads=4,
    n_kv_heads=4,
    d_ff=800,
    vocab_size=10000,
    pad_vocab_to=1,
    head="ds",
    ds=DSSoftmaxConfig(num_experts=8, lambda_lasso=1.0, lambda_expert=1.0),
    remat="none",
)

# WikiText-2-scale: |V|=33,278.
WIKI2 = PTB.replace(name="paper-wiki2", vocab_size=33278)

# IWSLT En-Vi scale: |V|=7,709 (seq2seq in the paper; the encdec family).
ENVI = ModelConfig(
    name="paper-envi",
    family="encdec",
    n_layers=2,
    n_encoder_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=1024,
    vocab_size=7709,
    pad_vocab_to=1,
    head="ds",
    ds=DSSoftmaxConfig(num_experts=8),
    remat="none",
)

# CASIA scale: 3,740 classes.
CASIA = ModelConfig(
    name="paper-casia",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=1024,
    vocab_size=3740,
    pad_vocab_to=1,
    head="ds",
    ds=DSSoftmaxConfig(num_experts=8),
    remat="none",
)

CONFIG = PTB
