"""Architecture registry: ``get_config(arch)`` and ``reduce_config``.

Every dense, moe, vlm, ssm and hybrid architecture of ``repro``'s registry
is listed; the encdec ones raise ``KeyError`` naming the work that adds
their family.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (deepseek_67b, granite_20b, internvl2_26b, llama3_2_3b,
                                 mamba2_130m, olmoe_1b_7b, paper_lm, qwen2_1_5b,
                                 qwen3_moe_235b, zamba2_7b)
from repro_torch.configs.base import (DSSoftmaxConfig, ModelConfig, MoEConfig, ShapeConfig,
                                      TrainConfig, VisionStubConfig)

_CONFIGS: Dict[str, ModelConfig] = {
    "qwen2-1.5b": qwen2_1_5b.CONFIG,
    "llama3.2-3b": llama3_2_3b.CONFIG,
    "granite-20b": granite_20b.CONFIG,
    "deepseek-67b": deepseek_67b.CONFIG,
    "olmoe-1b-7b": olmoe_1b_7b.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b.CONFIG,
    "internvl2-26b": internvl2_26b.CONFIG,
    "mamba2-130m": mamba2_130m.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
    "paper-ptb": paper_lm.PTB,
    "paper-wiki2": paper_lm.WIKI2,
    "paper-casia": paper_lm.CASIA,
}

# Archs of repro's registry whose family is not ported yet (ROADMAP.md,
# Queue 1 item 6).
_LATER = {
    "whisper-base": "the encdec family (Queue 1 item 6)",
    "paper-envi": "the encdec family (Queue 1 item 6)",
}


def get_config(arch: str) -> ModelConfig:
    if arch in _CONFIGS:
        return _CONFIGS[arch]
    if arch in _LATER:
        raise KeyError(f"arch {arch!r} is not ported yet: it comes with "
                       f"{_LATER[arch]}; available: {sorted(_CONFIGS)}")
    raise KeyError(f"unknown arch {arch!r}; available: {sorted(_CONFIGS)}")


def reduce_config(cfg: ModelConfig, vocab: int = 512) -> ModelConfig:
    """A tiny config of the same family for CPU tests (as in ``repro``)."""
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid"):
        raise KeyError(f"family {cfg.family!r} is not ported yet (Queue 1 item 6)")
    kw = dict(
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=vocab,
        remat="none",
        attn_q_chunk=64,
        attn_kv_chunk=64,
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), head_dim=16)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32)
    if cfg.family == "hybrid":
        kw.update(attn_period=1, n_layers=3)
    if cfg.moe is not None:
        kw.update(moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64))
    if cfg.vision is not None:
        kw.update(vision=VisionStubConfig(num_patches=8))
    kw.update(ds=cfg.ds.replace(num_experts=4))
    return cfg.replace(**kw)


__all__ = [
    "DSSoftmaxConfig",
    "ModelConfig",
    "MoEConfig",
    "ShapeConfig",
    "TrainConfig",
    "VisionStubConfig",
    "get_config",
    "reduce_config",
]
