"""Output heads: DS-Softmax (the paper) and the full softmax (baseline).

A head is a dict of tensors under ``params['head']`` plus, for DS, a
``DSState`` mask packed into a :class:`~repro_torch.core.dssoftmax.ServeTable`
(or its int8 :class:`~repro_torch.core.dssoftmax.QuantizedServeTable`) for
serving. Both heads expose ``head_loss`` (mean CE over (B, S) positions +
an aux-loss dict) and ``head_topk`` (top-k classes from final hidden
states).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dssoftmax as ds
from repro_torch.distributed.sharding import batch_group, batch_ranks, batch_sum, collective
from repro_torch.kernels.ref import topk_stable


def init_head(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    if cfg.head == "ds":
        return ds.init(generator, cfg.d_model, cfg.padded_vocab, cfg.ds,
                       dtype=cfg.jdtype, n_valid=cfg.vocab_size, device=device)
    if cfg.tie_embeddings:
        return {}, None
    w = torch.empty((cfg.padded_vocab, cfg.d_model), dtype=cfg.jdtype, device=device)
    return {"unembed": ds.normal_(w, generator, 1.0 / math.sqrt(cfg.padded_vocab))}, None


def _full_ce_chunk(h_i, lab_i, w):
    z = h_i.float() @ w.float().T                                  # (B, cc, N)
    lse = torch.logsumexp(z, dim=-1)
    gold = torch.sum(h_i.float() * w[lab_i.long()].float(), dim=-1)
    return lse - gold


def _full_ce(w, h, labels, label_mask, mesh=None):
    """Full-softmax CE. w: (N, d); h: (B, S, d); labels: (B, S). The gold
    logit is h·w[label]. The sequence runs in up to 8 chunks under
    ``torch.utils.checkpoint``, so one chunk's (B, cc, N) fp32 logits are
    live at a time and the backward recomputes them. ``mesh``: the mean
    is over every batch rank's positions (``sharding.batch_sum``)."""
    B, S, _ = h.shape
    n_chunks = 1
    for cand in (8, 4, 2):
        if S % cand == 0 and S // cand >= 8:
            n_chunks = cand
            break
    if n_chunks > 1:
        from torch.utils.checkpoint import checkpoint

        cc = S // n_chunks
        ce = torch.cat([checkpoint(_full_ce_chunk, h[:, i * cc:(i + 1) * cc],
                                   labels[:, i * cc:(i + 1) * cc], w, use_reentrant=False)
                        for i in range(n_chunks)], dim=1)
    else:
        ce = _full_ce_chunk(h, labels, w)
    if batch_ranks(mesh) > 1:
        m = torch.ones_like(ce) if label_mask is None else label_mask.float()
        return batch_sum(torch.sum(ce * m), mesh) / torch.clamp(
            batch_sum(torch.sum(m), mesh), min=1.0)
    if label_mask is not None:
        m = label_mask.float()
        return torch.sum(ce * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(ce)


def head_loss(head_params, ds_state, cfg: ModelConfig, h: torch.Tensor, labels: torch.Tensor,
              embed_table: Optional[torch.Tensor] = None,
              label_mask: Optional[torch.Tensor] = None, mesh=None, gather=None):
    """→ (task_ce, aux_losses_dict). h: (B, S, d). ``mesh``: h is this
    rank's batch share, and the CE and aux losses are the whole batch's.
    ``gather`` (the mesh train step's ``TrainParamGather``): the head's
    leaves are this rank's blocks; a DS head gathers its gate whole and
    its experts one at a time inside the CE (``ds.loss_rows``), a full
    softmax its ``(V, d)`` operand whole."""
    if cfg.head == "ds":
        if gather is not None:
            head_params = dict(head_params, gate=gather.full("head/gate", head_params["gate"]))
        ce, aux = ds.loss_rows(head_params, ds_state, h, labels, cfg.ds,
                               label_mask=label_mask, mesh=mesh, gather=gather)
        dcfg = cfg.ds
        aux_total = (dcfg.lambda_lasso * aux.lasso + dcfg.lambda_expert * aux.expert_lasso
                     + dcfg.lambda_load * aux.load)
        return ce, {
            "ds_lasso": aux.lasso,
            "ds_expert_lasso": aux.expert_lasso,
            "ds_load": aux.load,
            "ds_drop_frac": aux.drop_frac,
            "head_aux_total": aux_total,
        }
    if cfg.tie_embeddings:
        w = embed_table if gather is None else gather.full("embed/table", embed_table)
    else:
        w = head_params["unembed"] if gather is None else gather.full(
            "head/unembed", head_params["unembed"])
    ce = _full_ce(w, h, labels, label_mask, mesh=mesh)
    return ce, {"head_aux_total": torch.zeros((), dtype=torch.float32, device=h.device)}


def head_topk(head_params, serve_table, cfg: ModelConfig, h: torch.Tensor, k: int,
              embed_table: Optional[torch.Tensor] = None, kernel=None, mesh=None, gather=None,
              capacity_factor: Optional[float] = None, with_stats: bool = False,
              local_rows: bool = False):
    """Top-k classes from hidden states h (B, d) → (values, ids) (B, k).
    For a DS head ``serve_table`` is either table kind.

    ``kernel`` overrides ``cfg.ds.serve_kernel`` (a registered name, policy
    name, or KernelPolicy); ``capacity_factor`` overrides
    ``cfg.ds.capacity_factor``; ``with_stats=True`` appends the per-expert
    ``{'dispatched', 'overflow'}`` telemetry (zeros of shape (1,) for the
    full-softmax head). Runs on the device of ``h``.

    ``mesh`` routes a DS head through the expert-parallel
    ``ds.serve_topk_sharded`` (``serve_table`` is then this rank's
    ``TableShard``). ``gather`` (a
    :class:`~repro_torch.distributed.sharding.ServeParamGather`) marks the
    head's weights as FSDP-stored: a DS head gathers only its (K, d) gate
    here (the expert rows live in the serve table), a full softmax its
    whole (V, d) operand. ``local_rows=True`` (with ``mesh``): ``h`` holds
    only this batch rank's block of the rows (a slot-split session's step);
    the result is every rank's rows merged, (B, k) in global row order on
    every rank."""
    if gather is not None:
        if cfg.head == "ds":
            head_params = dict(head_params, gate=gather.full("head/gate", head_params["gate"]))
        else:
            head_params = gather.full("head", head_params)
            if cfg.tie_embeddings and embed_table is not None:
                embed_table = gather.full("embed/table", embed_table)
    if cfg.head == "ds":
        kern = kernel if kernel is not None else cfg.ds.serve_kernel
        cf = capacity_factor if capacity_factor is not None else cfg.ds.capacity_factor
        if mesh is not None:
            return ds.serve_topk_sharded(head_params["gate"], serve_table, h, k, mesh=mesh,
                                         kernel=kern, capacity_factor=cf, with_stats=with_stats,
                                         h_local=local_rows)
        return ds.serve_topk(head_params["gate"], serve_table, h, k, kernel=kern,
                             capacity_factor=cf, with_stats=with_stats, device=h.device)
    w = embed_table if cfg.tie_embeddings else head_params["unembed"]
    z = h.float() @ w.float().T
    if w.shape[0] > cfg.vocab_size:  # mask vocab-padding classes
        z = torch.where(torch.arange(w.shape[0], device=h.device)[None, :] < cfg.vocab_size,
                        z, -1e9)
    vals, ids = topk_stable(z, k)
    ids = ids.to(torch.int32)
    if local_rows and batch_ranks(mesh) > 1:
        # the batch ranks' blocks, concatenated in rank order
        group = batch_group(mesh)
        vals = collective(vals, group).reshape(-1, k)
        ids = collective(ids, group).reshape(-1, k)
    if not with_stats:
        return vals, ids
    zero = torch.zeros((1,), dtype=torch.int32, device=h.device)
    return vals, ids, {"dispatched": zero, "overflow": zero}
