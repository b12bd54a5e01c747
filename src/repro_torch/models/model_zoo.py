"""Uniform model API: ``build(cfg)`` returns a :class:`ModelBundle`.

Only the dense family is ported in this slice; other families raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer


@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]


def build(cfg: ModelConfig, device="cuda") -> ModelBundle:
    """The model's functions, with ``init`` placing params on ``device``."""
    dev = resolve_device(device)
    if cfg.family != "dense":
        raise ValueError(f"family {cfg.family!r} is not ported yet (dense only)")
    return ModelBundle(
        cfg=cfg,
        device=dev,
        init=lambda gen: transformer.init_params(gen, cfg, device=dev),
        prefill=lambda p, t, batch, k=8, kernel=None: transformer.prefill(
            p, t, cfg, batch, k=k, kernel=kernel),
        decode_step=lambda p, t, cache, tok, pos, k=8, kernel=None,
        capacity_factor=None, with_stats=False: transformer.decode_step(
            p, t, cfg, cache, tok, pos, k=k, kernel=kernel,
            capacity_factor=capacity_factor, with_stats=with_stats),
    )


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Decode-cache specs sized to the cell's seq_len and batch."""
    if cfg.family != "dense":
        raise ValueError(f"family {cfg.family!r} is not ported yet (dense only)")
    kv = TensorSpec((cfg.n_layers, shape.global_batch, shape.seq_len,
                     cfg.n_kv_heads, cfg.hd), cfg.jdtype)
    return transformer.DecodeCache(k=kv, v=kv)
