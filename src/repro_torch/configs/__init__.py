"""Architecture registry: ``get_config(arch)``, the shape suite and
``reduce_config``, as ``repro.configs`` has them: every architecture of
``repro``'s registry, in its order.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs import (deepseek_67b, granite_20b, internvl2_26b, llama3_2_3b,
                                 mamba2_130m, olmoe_1b_7b, paper_lm, qwen2_1_5b,
                                 qwen3_moe_235b, whisper_base, zamba2_7b)
from repro_torch.configs.base import (DSSoftmaxConfig, ModelConfig, MoEConfig, ShapeConfig,
                                      TrainConfig, VisionStubConfig)
from repro_torch.configs.shapes import SHAPES, shapes_for

_MODULES = {
    "mamba2-130m": mamba2_130m,
    "granite-20b": granite_20b,
    "qwen2-1.5b": qwen2_1_5b,
    "llama3.2-3b": llama3_2_3b,
    "deepseek-67b": deepseek_67b,
    "whisper-base": whisper_base,
    "zamba2-7b": zamba2_7b,
    "internvl2-26b": internvl2_26b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b,
    "paper-ptb": paper_lm,
}

# the paper-scale configs besides paper-ptb (``paper_lm.CONFIG``)
_PAPER = {"paper-wiki2": paper_lm.WIKI2, "paper-envi": paper_lm.ENVI,
          "paper-casia": paper_lm.CASIA}

ARCHS: Tuple[str, ...] = tuple(k for k in _MODULES if k != "paper-ptb")


def get_config(arch: str) -> ModelConfig:
    if arch in _PAPER:
        return _PAPER[arch]
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_MODULES)}")
    return _MODULES[arch].CONFIG


def is_sub_quadratic(arch: str) -> bool:
    return bool(getattr(_MODULES[arch], "SUB_QUADRATIC", False))


def arch_shapes(arch: str):
    """The runnable shape cells of ``arch``."""
    return shapes_for(get_config(arch).family, is_sub_quadratic(arch))


def dryrun_cells() -> list[tuple[str, ShapeConfig]]:
    """Every (arch, shape) cell."""
    return [(a, s) for a in ARCHS for s in arch_shapes(a)]


def reduce_config(cfg: ModelConfig, vocab: int = 512) -> ModelConfig:
    """A tiny config of the same family for CPU tests (as in ``repro``)."""
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
    if cfg.n_encoder_layers:
        kw.update(n_encoder_layers=2)
    if cfg.moe is not None:
        kw.update(moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64))
    if cfg.vision is not None:
        kw.update(vision=VisionStubConfig(num_patches=8))
    kw.update(ds=cfg.ds.replace(num_experts=4))
    return cfg.replace(**kw)


__all__ = [
    "ARCHS",
    "SHAPES",
    "DSSoftmaxConfig",
    "ModelConfig",
    "MoEConfig",
    "ShapeConfig",
    "TrainConfig",
    "VisionStubConfig",
    "arch_shapes",
    "dryrun_cells",
    "get_config",
    "is_sub_quadratic",
    "reduce_config",
]
