"""Architecture registry: ``get_config(arch)`` and ``reduce_config``.

Only the dense architectures this slice of the port can build are listed;
the others raise ``KeyError`` naming the slice that adds their family.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import paper_lm, qwen2_1_5b
from repro_torch.configs.base import DSSoftmaxConfig, ModelConfig, ShapeConfig

_CONFIGS: Dict[str, ModelConfig] = {
    "qwen2-1.5b": qwen2_1_5b.CONFIG,
    "paper-ptb": paper_lm.PTB,
    "paper-wiki2": paper_lm.WIKI2,
    "paper-casia": paper_lm.CASIA,
}

# Archs of repro's registry whose family is not ported yet (ROADMAP.md,
# Queue 1 item 7) — dense ones among them need nothing beyond a config.
_LATER = {
    "mamba2-130m": "the ssm family (Queue 1 item 7)",
    "zamba2-7b": "the hybrid family (Queue 1 item 7)",
    "olmoe-1b-7b": "the moe family (Queue 1 item 7)",
    "qwen3-moe-235b-a22b": "the moe family (Queue 1 item 7)",
    "whisper-base": "the encdec family (Queue 1 item 7)",
    "paper-envi": "the encdec family (Queue 1 item 7)",
    "internvl2-26b": "the vlm family (Queue 1 item 7)",
    "granite-20b": "a later slice that ports its config file",
    "llama3.2-3b": "a later slice that ports its config file",
    "deepseek-67b": "a later slice that ports its config file",
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
    if cfg.family != "dense":
        raise KeyError(f"family {cfg.family!r} is not ported yet")
    kw = dict(
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=vocab,
        attn_q_chunk=64,
        attn_kv_chunk=64,
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), head_dim=16)
    kw.update(ds=cfg.ds.replace(num_experts=4))
    return cfg.replace(**kw)


__all__ = [
    "DSSoftmaxConfig",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "reduce_config",
]
