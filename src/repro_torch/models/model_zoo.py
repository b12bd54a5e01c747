"""Uniform model API: ``build(cfg)`` returns a :class:`ModelBundle`: the
model's init, train loss and serving functions over one config; and the
input, cache and serve-table specs and the analytic parameter and FLOP
counts of a config.

The dense, moe and vlm families run through ``transformer``, the ssm and
hybrid families through ``hybrid``, the encdec family through ``encdec``
(whole-prompt prefill and decode only: no chunked prefill, no verify step,
no paged cache, as in ``repro``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import dssoftmax as ds
from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, transformer

FAMILIES = transformer.FAMILIES + hybrid.FAMILIES + encdec.FAMILIES
MAX_TARGET_LEN = 32768  # the encdec learned-position table's rows (decode_32k)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def _check_paged(cfg: ModelConfig) -> None:
    _check_family(cfg)
    if cfg.family in encdec.FAMILIES:
        raise ValueError(f"no paged cache for family {cfg.family!r}")


@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Any]
    # (params, ds_state, batch, mesh=None) → (total loss, metrics); ``mesh``:
    # the batch is this rank's share of the mesh train step's
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

    def abstract_params(self):
        """(params, ds_state) as meta tensors: ``init``'s shapes and dtypes,
        no memory (the dry-run's counterpart of ``jax.eval_shape``)."""
        return build(self.cfg, device="meta").init(torch.Generator())


def build(cfg: ModelConfig, device="cuda") -> ModelBundle:
    """The model's functions, with ``init`` placing params on ``device``.
    ``pages`` ((B, n_pg) page table) and ``state_pages`` ((B,) state-page
    ids) switch the serving functions to the paged arena; a family without
    the corresponding leaf kind ignores the extra argument. ``mesh`` serves
    the DS head expert-parallel and ``gather`` from FSDP-stored weights
    (``distributed.sharding``). ``device='meta'`` builds on shapes alone:
    the dry-run traces such a bundle's step (``launch.dryrun``)."""
    dev = resolve_device(device, meta=True)
    _check_family(cfg)
    if cfg.family in encdec.FAMILIES:
        return _build_encdec(cfg, dev)
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
        train_loss=lambda p, s, batch, mesh=None, gather=None: mod.train_loss(
            p, s, cfg, batch, mesh=mesh, gather=gather),
        prefill=lambda p, t, batch, k=8, kernel=None, mesh=None, gather=None: mod.prefill(
            p, t, cfg, batch, k=k, kernel=kernel, mesh=mesh, gather=gather),
        decode_step=lambda p, t, cache, tok, pos, k=8, kernel=None, capacity_factor=None,
        with_stats=False, pages=None, state_pages=None, mesh=None, gather=None: mod.decode_step(
            p, t, cfg, cache, tok, pos, k=k, kernel=kernel, capacity_factor=capacity_factor,
            with_stats=with_stats, pages=pages, mesh=mesh, gather=gather, **st(state_pages)),
        decode_hidden=lambda p, cache, tok, pos, pages=None, state_pages=None, gather=None:
            mod.decode_hidden(p, cfg, cache, tok, pos, pages=pages, gather=gather,
                              **st(state_pages)),
        prefill_chunk=lambda p, t, cache, tokens, pos0, n_valid, k=8, kernel=None, pages=None,
        state_pages=None, mesh=None, gather=None: mod.prefill_chunk(
            p, t, cfg, cache, tokens, pos0, n_valid, k=k, kernel=kernel, pages=pages, mesh=mesh,
            gather=gather, **st(state_pages)),
        verify_step=lambda p, t, cache, tokens, pos0, k=8, kernel=None, capacity_factor=None,
        with_stats=False, pages=None, state_pages=None, mesh=None, gather=None: mod.verify_step(
            p, t, cfg, cache, tokens, pos0, k=k, kernel=kernel, capacity_factor=capacity_factor,
            with_stats=with_stats, pages=pages, mesh=mesh, gather=gather, **st(state_pages)),
        verify_hidden=lambda p, cache, tokens, pos0, pages=None, state_pages=None, gather=None:
            mod.verify_hidden(p, cfg, cache, tokens, pos0, pages=pages, gather=gather,
                              **st(state_pages)),
        verify_needs_state_commit=mod is hybrid,
        commit_block=None if mod is not hybrid else (
            lambda p, cache, tokens, pos0, n_valid, pages=None, state_pages=None, gather=None:
            hybrid.commit_block(p, cfg, cache, tokens, pos0, n_valid, pages=pages,
                                state_pages=state_pages, gather=gather)),
    )


def _build_encdec(cfg: ModelConfig, dev: torch.device) -> ModelBundle:
    """Whole-prompt prefill (``batch``: frames and tokens) and decode at a
    scalar or (B,) ``pos``; no chunked prefill, verify step or pages."""
    return ModelBundle(
        cfg=cfg,
        device=dev,
        init=lambda gen: encdec.init_params(gen, cfg, device=dev, max_target_len=MAX_TARGET_LEN),
        train_loss=lambda p, s, batch, mesh=None, gather=None: encdec.train_loss(
            p, s, cfg, batch, mesh=mesh, gather=gather),
        prefill=lambda p, t, batch, k=8, kernel=None, mesh=None, gather=None: encdec.prefill(
            p, t, cfg, batch, k=k, kernel=kernel, mesh=mesh, gather=gather),
        decode_step=lambda p, t, cache, tok, pos, k=8, kernel=None, capacity_factor=None,
        with_stats=False, mesh=None, gather=None: encdec.decode_step(
            p, t, cfg, cache, tok, pos, k=k, kernel=kernel, capacity_factor=capacity_factor,
            with_stats=with_stats, mesh=mesh, gather=gather),
        decode_hidden=lambda p, cache, tok, pos, gather=None: encdec.decode_hidden(
            p, cfg, cache, tok, pos, gather=gather),
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
    if cfg.family in encdec.FAMILIES:
        ckv = TensorSpec((cfg.n_layers, B, encoder_frames(cfg), cfg.n_kv_heads, cfg.hd),
                         cfg.jdtype)
        return encdec.EncDecCache(self_k=kv, self_v=kv, cross_k=ckv, cross_v=ckv)
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
    _check_paged(cfg)
    if cfg.family in hybrid.FAMILIES:
        return _state_specs(cfg, n_state_pages, (n_pages, page_size))
    kv = TensorSpec((cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.hd), cfg.jdtype)
    return transformer.DecodeCache(k=kv, v=kv)


def cache_kv_leaves(cfg: ModelConfig):
    """Per-leaf bool: True for position-indexed attention K/V leaves (paged
    over KV pages), False for position-free conv/ssm state leaves (paged
    over state pages)."""
    _check_paged(cfg)
    if cfg.family in hybrid.FAMILIES:
        return hybrid.HybridCache(conv=False, ssm=False, attn_k=True, attn_v=True)
    return transformer.DecodeCache(k=True, v=True)


def cache_seq_axes(cfg: ModelConfig):
    """Per-leaf sequence axis of a decode cache (-1: position-free state,
    replaced whole when a slot is admitted). The batch axis is 1 for every
    family's leaves."""
    _check_family(cfg)
    if cfg.family in hybrid.FAMILIES:
        return hybrid.HybridCache(conv=-1, ssm=-1, attn_k=2, attn_v=2)
    if cfg.family in encdec.FAMILIES:
        return encdec.EncDecCache(self_k=2, self_v=2, cross_k=-1, cross_v=-1)
    return transformer.DecodeCache(k=2, v=2)


def encoder_frames(cfg: ModelConfig) -> int:
    """The encoder's frames per example: the vision stub's, else 1500 (30 s
    of audio)."""
    return cfg.vision.num_patches if cfg.vision else 1500


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The batch of ``train_loss`` (kind 'train'), ``prefill`` or a decode
    step (kind 'decode'), as tensors on the meta device: shapes and dtypes,
    no memory."""
    B, S = shape.global_batch, shape.seq_len
    meta = lambda *sh, dtype=torch.int32: torch.empty(sh, dtype=dtype, device="meta")
    extra = 1 if shape.kind == "train" else 0
    if shape.kind == "decode":
        return {"token": meta(B)}
    if cfg.family in encdec.FAMILIES:
        return {"frames": meta(B, encoder_frames(cfg), cfg.d_model, dtype=cfg.jdtype),
                "tokens": meta(B, S + extra)}
    if cfg.family == "vlm":
        P = cfg.vision.num_patches
        return {"patches": meta(B, P, cfg.d_model, dtype=cfg.jdtype),
                "tokens": meta(B, S - P + extra)}
    return {"tokens": meta(B, S + extra)}


def _serve_pad(cfg: ModelConfig, vocab: int) -> int:
    return cfg.ds.serve_pad or max(128, 2 * vocab // cfg.ds.num_experts)


def serve_table_spec(cfg: ModelConfig):
    """The specs of a DS head's packed fp serve table before any mask is
    trained (V_pad 2·N/K rounded up to 128: the paper's ~2x mean
    redundancy over K experts); None for a full-softmax head."""
    if cfg.head != "ds":
        return None
    K = cfg.ds.num_experts
    v_pad = cfg.ds.serve_pad or ds._round_up(max(128, 2 * cfg.padded_vocab // K))
    return ds.ServeTable(ids=TensorSpec((K, v_pad), torch.int32),
                         weights=TensorSpec((K, v_pad, cfg.d_model), cfg.jdtype))


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Matmul parameters a token touches (the embedding lookup left out,
    the head counted); ``active_only`` counts a moe layer's top-k experts
    and the served head's V_pad rows."""
    d, ff = cfg.d_model, cfg.d_ff
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = d * H * dh + 2 * d * KV * dh + H * dh * d
    ffn = (3 if cfg.act == "swiglu" else 2) * d * ff
    di, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    mamba = d * (2 * di + 2 * gn + cfg.ssm_nheads) + di * d  # in and out projections
    total = 0
    if cfg.family in ("dense", "vlm"):
        total = cfg.n_layers * (attn + ffn)
    elif cfg.family == "moe":
        mc = cfg.moe
        e = mc.top_k if active_only else mc.num_experts
        total = cfg.n_layers * (attn + e * 3 * d * mc.d_ff_expert + d * mc.num_experts)
    elif cfg.family == "ssm":
        total = cfg.n_layers * mamba
    elif cfg.family == "hybrid":
        # the shared block's params exist once, but each application
        # touches them again
        apps = hybrid.n_attn_apps(cfg)
        total = cfg.n_layers * mamba + (apps if active_only else 1) * (attn + ffn)
    elif cfg.family == "encdec":
        total = cfg.n_encoder_layers * (attn + ffn) + cfg.n_layers * (2 * attn + ffn)
    if cfg.head == "ds":
        rows = _serve_pad(cfg, cfg.vocab_size) if active_only else cfg.vocab_size
        head = cfg.ds.num_experts * d + rows * d
    else:
        head = cfg.vocab_size * d
    return int(total + head)


def head_flops_per_token(cfg: ModelConfig, serve: bool) -> int:
    """Forward FLOPs of the head per token (the paper's measure: 2·rows·d):
    the gate and V_pad rows when serving a DS head, the gate and every
    class in training, every class for the full softmax."""
    d = cfg.d_model
    if cfg.head != "ds":
        return 2 * cfg.vocab_size * d
    rows = _serve_pad(cfg, cfg.vocab_size) if serve else cfg.vocab_size
    return 2 * (cfg.ds.num_experts * d + rows * d)
