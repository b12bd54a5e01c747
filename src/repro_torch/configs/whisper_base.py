"""whisper-base [audio]: an encoder-decoder transformer backbone.

6L(enc)+6L(dec) d_model=512 8H kv=8 d_ff=2048 vocab=51865.  [arXiv:2212.04356]

The conv/mel frontend is a stub: the caller provides precomputed frame
embeddings (batch, n_frames, d_model) for the encoder.
"""
from repro_torch.configs.base import DSSoftmaxConfig, ModelConfig, VisionStubConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,            # decoder layers
    n_encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    act="gelu",
    rope_theta=0.0,        # learned (decoder) and sinusoidal (encoder) positions, no rope
    vision=VisionStubConfig(num_patches=1500),  # 30 s of audio -> 1500 frames
    head="ds",
    ds=DSSoftmaxConfig(num_experts=8),
)
