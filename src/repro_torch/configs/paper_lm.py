"""Paper-scale LM configs (dense family): PTB and WikiText-2 vocab scale.

The encoder-decoder (IWSLT En-Vi) config waits for the encdec family.
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
    ds=DSSoftmaxConfig(num_experts=8),
)

# WikiText-2-scale: |V|=33,278.
WIKI2 = PTB.replace(name="paper-wiki2", vocab_size=33278)

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
)

CONFIG = PTB
