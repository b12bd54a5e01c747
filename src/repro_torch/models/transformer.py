"""Decoder-only transformer LM (dense / moe / vlm families).

Per-layer parameters are stacked on axis 0 (``(L, …)``, as in
``repro.models.transformer``) and consumed by a Python loop over layers.
``cfg.remat`` sets what the train forward keeps for the backward: 'layer'
checkpoints each layer (``torch.utils.checkpoint``), 'dots' each layer
but saving its weight matmuls' outputs, 'none' everything. A moe config
runs ``moe.moe_block`` where a dense one runs its MLP; a vlm config
prepends ``batch["patches"]`` (precomputed patch embeddings, a stub of the
vision tower) to the token embeddings in training and whole-prompt
prefill.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import heads, moe
from repro_torch.models.layers import (
    attention_block,
    attention_decode,
    attention_prefill_chunk,
    embed,
    init_attention,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    mlp,
    rmsnorm,
    stacked_layer,
    whole,
)


# the families this module builds (``repro`` builds them through its
# ``transformer`` too; ssm and hybrid: ``models.hybrid``)
FAMILIES = ("dense", "moe", "vlm")


class DecodeCache(NamedTuple):
    k: torch.Tensor  # (L, B, S_max, KV, dh)
    v: torch.Tensor


def init_layer(generator: torch.Generator, cfg: ModelConfig, n_layers: int, device="cuda"):
    """``n_layers`` layers' params stacked on a leading ``(L, …)`` axis (what
    ``repro``'s ``vmap`` of its one-layer ``init_layer`` stacks): the
    attention, then the MoE block or the MLP; the norms start at one."""
    lead = (n_layers,)
    p = {"ln1": init_rmsnorm(cfg.d_model, lead, device),
         "attn": init_attention(generator, cfg, lead, device),
         "ln2": init_rmsnorm(cfg.d_model, lead, device)}
    if cfg.moe is not None:
        p["moe"] = moe.init_moe(generator, cfg, n_layers, device=device)
    else:
        p["mlp"] = init_mlp(generator, cfg, lead=lead, device=device)
    return p


def init_params(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    """Seeded params on ``device`` → (params, ds_state)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not built by models.transformer")
    layers_p = init_layer(generator, cfg, cfg.n_layers, device)
    params = {
        "embed": init_embedding(generator, cfg.padded_vocab, cfg.d_model, cfg.jdtype, device),
        "layers": layers_p,
        "final_norm": init_rmsnorm(cfg.d_model, device=device),
    }
    params["head"], ds_state = heads.init_head(generator, cfg, device=device)
    return params, ds_state


def _ffn_residual(lp, cfg: ModelConfig, x, mesh=None):
    """x + the layer's FFN (the MoE block or the MLP) of norm(x) → (new x,
    the MoE's aux load loss; None for an MLP). ``mesh``: the mesh train
    step's (``moe.moe_block``)."""
    xn = rmsnorm(lp["ln2"], x)
    if cfg.moe is not None:
        y, aux = moe.moe_block(lp["moe"], cfg, xn, mesh=mesh)
        return x + y, aux.load_loss
    return x + mlp(lp["mlp"], cfg, xn), None


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def _layer_body(cfg: ModelConfig, x, layer_params, positions, mesh=None, gather=None):
    """One train layer: the differentiable attention, then the FFN. →
    (new x, the layer's MoE aux load loss, 0-d; zero for an MLP).
    ``gather``: ``layer_params`` is this rank's block of the layer, gathered
    here, inside the layer's ``remat`` region."""
    if gather is not None:
        layer_params = gather.layer("layers", layer_params)
    h, _ = attention_block(layer_params["attn"], cfg, rmsnorm(layer_params["ln1"], x),
                           positions, train=True)
    x, aux = _ffn_residual(layer_params, cfg, x + h, mesh=mesh)
    return x, (torch.zeros((), dtype=torch.float32, device=x.device) if aux is None else aux)


# The weight matmuls (``x @ W``, with or without a bias) reach aten as mm /
# addmm; attention's products carry a batch axis and reach it as bmm.
_WEIGHT_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_matmuls(ctx, op, *args, **kwargs):
    """'dots' policy: keep the weight matmuls' outputs, recompute the rest
    (``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _WEIGHT_MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(cfg: ModelConfig, body, *args):
    """``body(*args)`` in a train forward, kept for the backward as
    ``cfg.remat`` says: 'layer' recomputes the whole body, 'dots' keeps its
    weight matmuls' outputs, 'none' keeps everything."""
    if cfg.remat == "layer":
        return checkpoint(body, *args, use_reentrant=False)
    if cfg.remat == "dots":
        return checkpoint(body, *args, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       _save_weight_matmuls))
    if cfg.remat == "none":
        return body(*args)
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


def forward_hidden(params, cfg: ModelConfig, x: torch.Tensor, positions, mesh=None,
                   gather=None):
    """x: (B, S, d) embeddings → (final normed hidden (B, S, d), the sum of
    the layers' MoE aux load losses: a 0-d zero without MoE). ``mesh``: the
    mesh train step's (x is this rank's batch share); ``gather``: its
    ``TrainParamGather`` (``params`` are this rank's blocks), each layer
    gathered inside its ``remat`` region, so nothing gathered is saved."""
    body = functools.partial(_layer_body, cfg, mesh=mesh, gather=gather)
    auxs = []
    for i in range(cfg.n_layers):
        x, aux = remat(cfg, body, x, stacked_layer(params["layers"], i), positions)
        auxs.append(aux)
    return (rmsnorm(whole(params["final_norm"], gather, "final_norm"), x),
            torch.sum(torch.stack(auxs)))


def embed_inputs(params, cfg: ModelConfig, batch, gather=None):
    """Token (+ vision-prefix) embedding → (x (B, S, d), positions (B, S),
    label_mask). With a vlm config and ``batch["patches"]`` ((B, P, d)
    stub patch embeddings, cast to the embedding dtype) the patches come
    first and ``label_mask`` (B, P + S_text) marks the text positions;
    else ``label_mask`` is None. ``gather`` serves from FSDP-stored
    weights (the rows are gathered, never the table)."""
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, gather)
    label_mask = None
    if cfg.vision is not None and "patches" in batch:
        patches = batch["patches"].to(x.dtype)
        x = torch.cat([patches, x], dim=1)
        label_mask = torch.cat([torch.zeros(patches.shape[:2], dtype=torch.bool,
                                            device=x.device),
                                torch.ones(tokens.shape, dtype=torch.bool, device=x.device)],
                               dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    return x, positions, label_mask


def train_loss(params, ds_state, cfg: ModelConfig, batch, mesh=None, gather=None):
    """batch: tokens (B, S+1) [+ patches (B, P, d)]. → (total_loss, metrics
    dict of 0-d tensors). The CE covers the text positions only; a moe
    config adds ``router_aux_weight`` × the layers' aux load losses.
    ``mesh``: the batch is this rank's share of the mesh train step's, and
    the loss and metrics are the whole batch's (``distributed.sharding``'s
    loss convention); ``gather``: ``params`` are this rank's blocks, read
    through the step's ``TrainParamGather``."""
    tokens = batch["tokens"]
    x, positions, label_mask = embed_inputs(params, cfg, {**batch, "tokens": tokens[:, :-1]},
                                            gather)
    labels = tokens[:, 1:]
    h, moe_aux = forward_hidden(params, cfg, x, positions, mesh=mesh, gather=gather)
    if label_mask is not None:  # labels align with the text suffix
        h = h[:, x.shape[1] - labels.shape[1]:]
    ce, aux = heads.head_loss(params["head"], ds_state, cfg, h, labels,
                              embed_table=params["embed"]["table"], label_mask=None, mesh=mesh,
                              gather=gather)
    moe_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
    total = ce + aux["head_aux_total"] + moe_w * moe_aux
    return total, {"ce": ce, "moe_aux": moe_aux, **aux}


def prefill(params, table, cfg: ModelConfig, batch, k: int = 8, kernel=None, mesh=None,
            gather=None):
    """Run the whole prompt (``batch["tokens"]``, after ``batch["patches"]``
    for a vlm config); returns (topk_vals, topk_ids, DecodeCache) with the
    cache sized to the prompt length (patches included) and the head
    applied to the last position. ``mesh`` serves the DS head expert-
    parallel (``table``: this rank's ``TableShard``); ``gather`` serves
    from FSDP-stored weights, each layer gathered where it runs."""
    x, positions, _ = embed_inputs(params, cfg, batch, gather)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = stacked_layer(params["layers"], i, gather)
        h, (kk, vv) = attention_block(lp["attn"], cfg, rmsnorm(lp["ln1"], x), positions)
        x, _ = _ffn_residual(lp, cfg, x + h)
        ks.append(kk)
        vs.append(vv)
    h = rmsnorm(params["final_norm"], x)[:, -1]
    vals, ids = heads.head_topk(params["head"], table, cfg, h, k,
                                embed_table=params["embed"]["table"], kernel=kernel, mesh=mesh,
                                gather=gather)
    return vals, ids, DecodeCache(k=torch.stack(ks), v=torch.stack(vs))


def prefill_chunk(params, table, cfg: ModelConfig, cache: DecodeCache, tokens, pos0,
                  n_valid, k: int = 8, kernel=None, pages=None, mesh=None, gather=None):
    """Prefill one chunk of a prompt into an existing decode cache, in place.

    tokens: (B, C) int at positions ``pos0 .. pos0+C-1`` (an int, or a
    (B,) tensor of per-row starts); rows at or past ``n_valid`` (an int or
    a (B,) tensor) are right-padding whose K/V writes stay masked until
    real tokens overwrite them. Returns (vals, ids, cache) with the head
    applied to the hidden state of token ``n_valid - 1``; only a prompt's
    last chunk gives a meaningful top-k. ``pages`` ((B, n_pg) page table)
    switches the cache to the paged arena (``cache.k``/``cache.v``:
    (L, n_pages, page_size, KV, dh)); ``mesh`` and ``gather`` as in
    :func:`prefill`."""
    h = _chunk_hidden(params, cfg, cache, tokens, pos0, pages=pages, gather=gather)
    if torch.is_tensor(n_valid):
        h_last = h[torch.arange(h.shape[0], device=h.device), n_valid.long() - 1]
    else:
        h_last = h[:, n_valid - 1]
    vals, ids = heads.head_topk(params["head"], table, cfg, h_last, k,
                                embed_table=params["embed"]["table"], kernel=kernel, mesh=mesh,
                                gather=gather)
    return vals, ids, cache


def _chunk_hidden(params, cfg: ModelConfig, cache: DecodeCache, tokens, pos0, pages=None,
                  gather=None):
    """The chunk backbone: run a (B, C) token block at positions ``pos0 ..
    pos0+C-1`` against the cache (written in place). Returns the final
    normed hidden states (B, C, d)."""
    x = embed(params["embed"], tokens, gather)
    for i in range(cfg.n_layers):
        lp = stacked_layer(params["layers"], i, gather)
        h, _, _ = attention_prefill_chunk(lp["attn"], cfg, rmsnorm(lp["ln1"], x),
                                          cache.k[i], cache.v[i], pos0, pages=pages)
        x, _ = _ffn_residual(lp, cfg, x + h)
    return rmsnorm(params["final_norm"], x)


def verify_hidden(params, cfg: ModelConfig, cache: DecodeCache, tokens, pos0, pages=None,
                  gather=None):
    """The verify backbone: :func:`_chunk_hidden` over a (B, W) block at
    per-row starts ``pos0`` ((B,) int tensor), the cache written in place.
    Returns the hidden states (B, W, d). With a tensor ``pos0`` it makes no
    host sync and has no data-dependent shape: a CUDA graph can capture
    it."""
    return _chunk_hidden(params, cfg, cache, tokens, pos0, pages=pages, gather=gather)


def verify_step(params, table, cfg: ModelConfig, cache: DecodeCache, tokens, pos0,
                k: int = 8, kernel=None, capacity_factor=None, with_stats=False, pages=None,
                mesh=None, gather=None):
    """Speculative draft–verify: score a (B, W) block of candidate tokens.

    tokens: (B, W) int; row b holds ``[t_b, d_1 .. d_{W-1}]`` (the slot's
    last committed token, then the draft's proposals) at positions
    ``pos0[b] .. pos0[b]+W-1``, ``pos0`` a (B,) int tensor. The chunk
    backbone (:func:`verify_hidden`), then the head once over all B·W rows
    (the grouped regime of the head at serving batch sizes). Returns (vals,
    ids) of shape (B, W, k) and the cache: position w scores the target's
    candidates for the token after the w-th input; plus the head's
    per-expert telemetry when ``with_stats=True``.

    K/V of all W positions are committed as written. Positions past a
    slot's accepted prefix need no rollback: they stay masked, and the
    next real token at each of them overwrites it."""
    h = verify_hidden(params, cfg, cache, tokens, pos0, pages=pages, gather=gather)
    B, W, d = h.shape
    out = heads.head_topk(params["head"], table, cfg, h.reshape(B * W, d), k,
                          embed_table=params["embed"]["table"], kernel=kernel, mesh=mesh,
                          gather=gather, capacity_factor=capacity_factor,
                          with_stats=with_stats)
    return (out[0].reshape(B, W, k), out[1].reshape(B, W, k), cache, *out[2:])


def decode_hidden(params, cfg: ModelConfig, cache: DecodeCache, token, pos, pages=None,
                  gather=None):
    """The decode backbone: embed one token per row, run the L layers
    against the cache (written in place at ``pos``) and the final norm.
    token: (B,) int; pos: (B,) int per-slot positions; ``pages`` ((B, n_pg)
    page table) selects the paged arena. Returns the hidden state (B, d)
    the head reads. Device ops only, no host sync and no data-dependent
    shape: a CUDA graph can capture it. ``gather`` serves from FSDP-stored
    weights (each layer gathered where it runs)."""
    x = embed(params["embed"], token, gather)[:, None, :]
    for i in range(cfg.n_layers):
        lp = stacked_layer(params["layers"], i, gather)
        h, _, _ = attention_decode(lp["attn"], cfg, rmsnorm(lp["ln1"], x),
                                   cache.k[i], cache.v[i], pos, pages=pages)
        x, _ = _ffn_residual(lp, cfg, x + h)
    return rmsnorm(params["final_norm"], x)[:, 0]


def decode_step(params, table, cfg: ModelConfig, cache: DecodeCache, token, pos,
                k: int = 8, kernel=None, capacity_factor=None, with_stats=False,
                pages=None, mesh=None, gather=None):
    """One-token decode: :func:`decode_hidden`, then the head. The cache is
    updated in place. Returns (vals, ids, cache) — plus the head's
    per-expert telemetry when ``with_stats=True``. ``mesh`` and ``gather``
    as in :func:`prefill`."""
    h = decode_hidden(params, cfg, cache, token, pos, pages=pages, gather=gather)
    out = heads.head_topk(params["head"], table, cfg, h, k,
                          embed_table=params["embed"]["table"], kernel=kernel, mesh=mesh,
                          gather=gather, capacity_factor=capacity_factor,
                          with_stats=with_stats)
    return (*out[:2], cache, *out[2:])
