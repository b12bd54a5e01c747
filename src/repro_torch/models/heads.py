"""Output heads: DS-Softmax (the paper) and the full softmax (baseline).

A head is a dict of tensors under ``params['head']`` plus, for DS, a
``DSState`` mask packed into a :class:`~repro_torch.core.dssoftmax.ServeTable`
(or its int8 :class:`~repro_torch.core.dssoftmax.QuantizedServeTable`) for
serving. Only serving (``head_topk``) is ported so far.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dssoftmax as ds
from repro_torch.kernels.ref import topk_stable


def init_head(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    if cfg.head == "ds":
        return ds.init(generator, cfg.d_model, cfg.padded_vocab, cfg.ds,
                       dtype=cfg.jdtype, n_valid=cfg.vocab_size, device=device)
    if cfg.tie_embeddings:
        return {}, None
    w = torch.empty((cfg.padded_vocab, cfg.d_model), dtype=cfg.jdtype, device=device)
    return {"unembed": ds.normal_(w, generator, 1.0 / math.sqrt(cfg.padded_vocab))}, None


def head_topk(head_params, serve_table, cfg: ModelConfig, h: torch.Tensor, k: int,
              embed_table: Optional[torch.Tensor] = None, kernel=None,
              capacity_factor: Optional[float] = None, with_stats: bool = False):
    """Top-k classes from hidden states h (B, d) → (values, ids) (B, k).
    For a DS head ``serve_table`` is either table kind.

    ``kernel`` overrides ``cfg.ds.serve_kernel`` (a registered name, policy
    name, or KernelPolicy); ``capacity_factor`` overrides
    ``cfg.ds.capacity_factor``; ``with_stats=True`` appends the per-expert
    ``{'dispatched', 'overflow'}`` telemetry (zeros of shape (1,) for the
    full-softmax head). Runs on the device of ``h``."""
    if cfg.head == "ds":
        kern = kernel if kernel is not None else cfg.ds.serve_kernel
        cf = capacity_factor if capacity_factor is not None else cfg.ds.capacity_factor
        return ds.serve_topk(head_params["gate"], serve_table, h, k, kernel=kern,
                             capacity_factor=cf, with_stats=with_stats, device=h.device)
    w = embed_table if cfg.tie_embeddings else head_params["unembed"]
    z = h.float() @ w.float().T
    if w.shape[0] > cfg.vocab_size:  # mask vocab-padding classes
        z = torch.where(torch.arange(w.shape[0], device=h.device)[None, :] < cfg.vocab_size,
                        z, -1e9)
    vals, ids = topk_stable(z, k)
    ids = ids.to(torch.int32)
    if not with_stats:
        return vals, ids
    zero = torch.zeros((1,), dtype=torch.int32, device=h.device)
    return vals, ids, {"dispatched": zero, "overflow": zero}
