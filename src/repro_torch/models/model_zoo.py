"""Uniform model API: ``build(cfg)`` returns a :class:`ModelBundle`: the
model's init, train loss and serving functions over one config.

The dense, moe and vlm families are ported (all three run through
``transformer``); the others raise, naming ROADMAP.md Queue 1 item 6.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer


def _check_family(cfg: ModelConfig, what: str = "family") -> None:
    if cfg.family not in transformer.FAMILIES:
        raise ValueError(f"{what} {cfg.family!r} is not ported yet (ROADMAP.md, Queue 1 item 6; "
                         f"ported: {', '.join(transformer.FAMILIES)})")


@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Any]
    # (params, ds_state, batch) → (total loss, metrics)
    train_loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    # the decode step's backbone, up to the hidden state the head reads
    # (``transformer.decode_hidden``); ``ServeSession`` captures it as a
    # CUDA graph
    decode_hidden: Callable[..., Any]
    # chunked prefill into an existing cache (``transformer.prefill_chunk``)
    prefill_chunk: Optional[Callable[..., Any]] = None
    # speculative draft–verify: a (B, W) candidate block at per-slot (B,)
    # positions scored in one chunk-shaped call, the head over all B·W rows
    # → (vals, ids) (B, W, k) (``transformer.verify_step``); K/V committed
    # in place, masking makes rollback free
    verify_step: Optional[Callable[..., Any]] = None
    # its backbone, up to the (B, W, d) hidden states the head reads
    # (``transformer.verify_hidden``); ``ServeSession`` captures it as a
    # CUDA graph
    verify_hidden: Optional[Callable[..., Any]] = None
    # True for families whose verify step leaves recurrent state alone and
    # needs a commit pass after acceptance (the ssm/hybrid families of
    # ``repro``); never for the dense family
    verify_needs_state_commit: bool = False


def build(cfg: ModelConfig, device="cuda") -> ModelBundle:
    """The model's functions, with ``init`` placing params on ``device``."""
    dev = resolve_device(device)
    _check_family(cfg)
    return ModelBundle(
        cfg=cfg,
        device=dev,
        init=lambda gen: transformer.init_params(gen, cfg, device=dev),
        train_loss=lambda p, s, batch: transformer.train_loss(p, s, cfg, batch),
        prefill=lambda p, t, batch, k=8, kernel=None: transformer.prefill(
            p, t, cfg, batch, k=k, kernel=kernel),
        decode_step=lambda p, t, cache, tok, pos, k=8, kernel=None,
        capacity_factor=None, with_stats=False, pages=None: transformer.decode_step(
            p, t, cfg, cache, tok, pos, k=k, kernel=kernel,
            capacity_factor=capacity_factor, with_stats=with_stats, pages=pages),
        decode_hidden=lambda p, cache, tok, pos, pages=None: transformer.decode_hidden(
            p, cfg, cache, tok, pos, pages=pages),
        prefill_chunk=lambda p, t, cache, tokens, pos0, n_valid, k=8, kernel=None,
        pages=None: transformer.prefill_chunk(p, t, cfg, cache, tokens, pos0, n_valid,
                                              k=k, kernel=kernel, pages=pages),
        verify_step=lambda p, t, cache, tokens, pos0, k=8, kernel=None, capacity_factor=None,
        with_stats=False, pages=None: transformer.verify_step(
            p, t, cfg, cache, tokens, pos0, k=k, kernel=kernel,
            capacity_factor=capacity_factor, with_stats=with_stats, pages=pages),
        verify_hidden=lambda p, cache, tokens, pos0, pages=None: transformer.verify_hidden(
            p, cfg, cache, tokens, pos0, pages=pages),
    )


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Decode-cache specs sized to the cell's seq_len and batch."""
    _check_family(cfg)
    kv = TensorSpec((cfg.n_layers, shape.global_batch, shape.seq_len,
                     cfg.n_kv_heads, cfg.hd), cfg.jdtype)
    return transformer.DecodeCache(k=kv, v=kv)


def paged_cache_specs(cfg: ModelConfig, n_pages: int, page_size: int):
    """Paged-arena specs: the slot axis of :func:`cache_specs` becomes a
    page axis shared by every slot, ``(L, n_pages, page_size, KV, dh)``,
    addressed through a host-side ``(n_slots, n_pg)`` page table
    (``repro_torch.serve.paged_cache.PagedCacheManager``). At the default
    arena size the bytes equal the contiguous cache's: paging buys
    sharing and cheap preemption, not smaller buffers."""
    _check_family(cfg, "paged cache for family")
    kv = TensorSpec((cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.hd), cfg.jdtype)
    return transformer.DecodeCache(k=kv, v=kv)


def cache_kv_leaves(cfg: ModelConfig):
    """Per-leaf bool: True for position-indexed attention K/V leaves (paged
    over KV pages). The transformer families have no state leaves."""
    _check_family(cfg, "paged cache for family")
    return transformer.DecodeCache(k=True, v=True)
