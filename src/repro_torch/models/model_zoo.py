"""Uniform model API: ``build(cfg)`` returns a :class:`ModelBundle`: the
model's init, train loss and serving functions over one config.

The dense, moe and vlm families run through ``transformer``, the ssm and
hybrid families through ``hybrid``; encdec raises, naming ROADMAP.md
Queue 1 item 6.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import hybrid, transformer

FAMILIES = transformer.FAMILIES + hybrid.FAMILIES


def _check_family(cfg: ModelConfig, what: str = "family") -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{what} {cfg.family!r} is not ported yet (ROADMAP.md, Queue 1 item 6; "
                         f"ported: {', '.join(FAMILIES)})")


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
    # (``transformer.decode_hidden``, ``hybrid.decode_hidden``);
    # ``ServeSession`` captures it as a CUDA graph
    decode_hidden: Callable[..., Any]
    # chunked prefill into an existing cache (K/V written in place; the
    # state families thread each layer's conv/ssm through the cache row)
    prefill_chunk: Optional[Callable[..., Any]] = None
    # speculative draft–verify: a (B, W) candidate block at per-slot (B,)
    # positions scored in one chunk-shaped call, the head over all B·W rows
    # → (vals, ids) (B, W, k); K/V committed in place, masking makes
    # rollback free; the state families leave conv/ssm untouched
    verify_step: Optional[Callable[..., Any]] = None
    # its backbone, up to the (B, W, d) hidden states the head reads;
    # ``ServeSession`` captures it as a CUDA graph
    verify_hidden: Optional[Callable[..., Any]] = None
    # True for families whose verify step leaves recurrent state alone and
    # needs a commit pass after acceptance (ssm, hybrid)
    verify_needs_state_commit: bool = False
    # the commit pass of those families: (params, cache, tokens, pos0,
    # n_valid, pages=, state_pages=) → cache, each row's conv/ssm advanced
    # in place by its ``n_valid`` tokens through the one-token recurrence;
    # None where ``verify_needs_state_commit`` is False
    commit_block: Optional[Callable[..., Any]] = None


def build(cfg: ModelConfig, device="cuda") -> ModelBundle:
    """The model's functions, with ``init`` placing params on ``device``.
    ``pages`` ((B, n_pg) page table) and ``state_pages`` ((B,) state-page
    ids) switch the serving functions to the paged arena; a family without
    the corresponding leaf kind ignores the extra argument."""
    dev = resolve_device(device)
    _check_family(cfg)
    if cfg.family in hybrid.FAMILIES:
        mod = hybrid
        st = lambda sp: dict(state_pages=sp)
    else:
        mod = transformer
        st = lambda sp: {}
    return ModelBundle(
        cfg=cfg,
        device=dev,
        init=lambda gen: mod.init_params(gen, cfg, device=dev),
        train_loss=lambda p, s, batch: mod.train_loss(p, s, cfg, batch),
        prefill=lambda p, t, batch, k=8, kernel=None: mod.prefill(
            p, t, cfg, batch, k=k, kernel=kernel),
        decode_step=lambda p, t, cache, tok, pos, k=8, kernel=None, capacity_factor=None,
        with_stats=False, pages=None, state_pages=None: mod.decode_step(
            p, t, cfg, cache, tok, pos, k=k, kernel=kernel, capacity_factor=capacity_factor,
            with_stats=with_stats, pages=pages, **st(state_pages)),
        decode_hidden=lambda p, cache, tok, pos, pages=None, state_pages=None: mod.decode_hidden(
            p, cfg, cache, tok, pos, pages=pages, **st(state_pages)),
        prefill_chunk=lambda p, t, cache, tokens, pos0, n_valid, k=8, kernel=None, pages=None,
        state_pages=None: mod.prefill_chunk(p, t, cfg, cache, tokens, pos0, n_valid, k=k,
                                            kernel=kernel, pages=pages, **st(state_pages)),
        verify_step=lambda p, t, cache, tokens, pos0, k=8, kernel=None, capacity_factor=None,
        with_stats=False, pages=None, state_pages=None: mod.verify_step(
            p, t, cfg, cache, tokens, pos0, k=k, kernel=kernel, capacity_factor=capacity_factor,
            with_stats=with_stats, pages=pages, **st(state_pages)),
        verify_hidden=lambda p, cache, tokens, pos0, pages=None, state_pages=None:
            mod.verify_hidden(p, cfg, cache, tokens, pos0, pages=pages, **st(state_pages)),
        verify_needs_state_commit=mod is hybrid,
        commit_block=None if mod is not hybrid else (
            lambda p, cache, tokens, pos0, n_valid, pages=None, state_pages=None:
            hybrid.commit_block(p, cfg, cache, tokens, pos0, n_valid, pages=pages,
                                state_pages=state_pages)),
    )


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def _state_specs(cfg: ModelConfig, rows: int, attn_rows: tuple):
    """A :class:`~repro_torch.models.hybrid.HybridCache` of specs: conv/ssm
    with ``rows`` on axis 1, the shared block's K/V with ``attn_rows``
    (slots and positions, or pages and page positions)."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    attn = TensorSpec((hybrid.n_attn_apps(cfg),) + attn_rows
                      + (max(cfg.n_kv_heads, 1), max(cfg.hd, 1)), cfg.jdtype)
    return hybrid.HybridCache(
        conv=TensorSpec((cfg.n_layers, rows, cfg.ssm_conv_width - 1, conv_dim), cfg.jdtype),
        ssm=TensorSpec((cfg.n_layers, rows, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state),
                       torch.float32),
        attn_k=attn, attn_v=attn)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Decode-cache specs sized to the cell's seq_len and batch."""
    _check_family(cfg)
    B, S = shape.global_batch, shape.seq_len
    if cfg.family in hybrid.FAMILIES:
        return _state_specs(cfg, B, (B, S))
    kv = TensorSpec((cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd), cfg.jdtype)
    return transformer.DecodeCache(k=kv, v=kv)


def paged_cache_specs(cfg: ModelConfig, n_pages: int, page_size: int, n_state_pages: int = 0):
    """Paged-arena specs: the slot axis of :func:`cache_specs` becomes a
    page axis shared by every slot: K/V leaves ``(·, n_pages, page_size, KV,
    dh)`` addressed through a host-side ``(n_slots, n_pg)`` page table
    (``repro_torch.serve.paged_cache.PagedCacheManager``), position-free
    conv/ssm leaves ``(L, n_state_pages, …)`` addressed by a ``(n_slots,)``
    state-page id vector. At the default arena size the K/V bytes equal the
    contiguous cache's: paging buys sharing and cheap preemption, not
    smaller buffers."""
    _check_family(cfg, "paged cache for family")
    if cfg.family in hybrid.FAMILIES:
        return _state_specs(cfg, n_state_pages, (n_pages, page_size))
    kv = TensorSpec((cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.hd), cfg.jdtype)
    return transformer.DecodeCache(k=kv, v=kv)


def cache_kv_leaves(cfg: ModelConfig):
    """Per-leaf bool: True for position-indexed attention K/V leaves (paged
    over KV pages), False for position-free conv/ssm state leaves (paged
    over state pages)."""
    _check_family(cfg, "paged cache for family")
    if cfg.family in hybrid.FAMILIES:
        return hybrid.HybridCache(conv=False, ssm=False, attn_k=True, attn_v=True)
    return transformer.DecodeCache(k=True, v=True)
