"""SSM and hybrid LMs: mamba2-130m (a pure SSD stack) and zamba2-7b (a
Mamba2 backbone with one *shared* attention block applied every
``attn_period`` layers, zamba-style), as ``repro.models.hybrid`` builds
them.

Layer layout for hybrid (L mamba layers, period p):
    [m m m m m m A] x n_groups  [m] x remainder
where every ``A`` is the SAME parameter set (the shared block). Per-layer
mamba params are stacked on axis 0 (``(L, …)``) and consumed by a Python
loop over layers.

Serving writes the :class:`HybridCache` in place (``repro`` returns new
arrays): each layer's new conv/ssm state is copied into its leaf, so a
CUDA graph that captured a step replays it against the same tensors. With
``state_pages`` ((B,) int state-page ids) the conv/ssm leaves are arenas
``(L, n_state_pages, …)``: each row's state lives in the page it owns,
gathered before and scattered after each layer's update. ``pages`` ((B,
n_pg) page table) pages the shared block's K/V as ``layers`` pages the
transformer's.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from repro_torch.configs.base import ModelConfig
from repro_torch.models import heads
from repro_torch.models.layers import (
    attention_block,
    attention_decode,
    attention_prefill_chunk,
    dense_init,
    embed,
    init_attention,
    init_embedding,
    init_rmsnorm,
    mlp,
    rmsnorm,
    stacked_layer,
    whole,
)
from repro_torch.models.mamba2 import (
    init_mamba2,
    mamba2_block,
    mamba2_decode,
    mamba2_prefill_chunk,
    mamba2_verify_scan,
)
from repro_torch.models.transformer import remat

FAMILIES = ("ssm", "hybrid")


class HybridCache(NamedTuple):
    conv: torch.Tensor    # (L, B, W-1, conv_dim)
    ssm: torch.Tensor     # (L, B, H, P, N) fp32
    attn_k: torch.Tensor  # (n_apps, B, S_max, KV, dh); zero-sized (0 apps) for pure ssm
    attn_v: torch.Tensor


def _layout(cfg: ModelConfig) -> tuple:
    """(n_groups, remainder) of the mamba stack around the shared-attention
    points."""
    if cfg.family != "hybrid":
        return 0, cfg.n_layers
    return cfg.n_layers // cfg.attn_period, cfg.n_layers % cfg.attn_period


def n_attn_apps(cfg: ModelConfig) -> int:
    return _layout(cfg)[0]


def init_params(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    """Seeded params on ``device`` → (params, ds_state)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not built by models.hybrid")
    d, dt, gen = cfg.d_model, cfg.jdtype, generator
    params = {
        "embed": init_embedding(gen, cfg.padded_vocab, d, dt, device),
        "layers": {"ln": init_rmsnorm(d, (cfg.n_layers,), device),
                   "mamba": init_mamba2(gen, cfg, cfg.n_layers, device=device)},
        "final_norm": init_rmsnorm(d, device=device),
    }
    if cfg.family == "hybrid":
        ff = cfg.d_ff
        dense = lambda d_in, d_out: dense_init(gen, (d_in, d_out), dt, device=device)
        attn = init_attention(gen, cfg, device=device)
        # drawn up, down, gate (``layers.init_mlp`` draws the gate first)
        mlp_p = {"w_up": dense(d, ff), "w_down": dense(ff, d)}
        if cfg.act == "swiglu":
            mlp_p["w_gate"] = dense(d, ff)
        params["shared_attn"] = {"ln1": init_rmsnorm(d, device=device), "attn": attn,
                                 "ln2": init_rmsnorm(d, device=device), "mlp": mlp_p}
    params["head"], ds_state = heads.init_head(gen, cfg, device=device)
    return params, ds_state


def _groups(cfg: ModelConfig) -> list:
    """Group lengths of the mamba stack; the shared block follows each of
    the first ``n_attn_apps`` groups."""
    n_groups, rem = _layout(cfg)
    if cfg.family != "hybrid":
        return [cfg.n_layers]
    return [cfg.attn_period] * n_groups + ([rem] if rem else [])


def _shared_block(sa, cfg: ModelConfig, x, attn):
    """x + attention(norm(x)), then + MLP(norm(x)); ``attn(xn) -> h``."""
    x = x + attn(rmsnorm(sa["ln1"], x))
    return x + mlp(sa["mlp"], cfg, rmsnorm(sa["ln2"], x))


def _walk(params, cfg: ModelConfig, x, mamba_op, attn_op, gather=None):
    """The serving scaffold: ``mamba_op(layer_params, i, x) -> x`` over the
    stack (each layer gathered where it runs when ``gather`` is given),
    ``attn_op(x, app_index) -> x`` after each full group."""
    n_apps = n_attn_apps(cfg)
    i = 0
    for gi, glen in enumerate(_groups(cfg)):
        for _ in range(glen):
            x = mamba_op(stacked_layer(params["layers"], i, gather), i, x)
            i += 1
        if gi < n_apps:
            x = attn_op(x, gi)
    return x


def _gather_shared(params, gather):
    """``params`` with the shared attention block gathered whole, once per
    call (it runs after every group), when weights are FSDP-stored."""
    if gather is None or "shared_attn" not in params:
        return params
    return dict(params, shared_attn=gather.full("shared_attn", params["shared_attn"]))


def _mamba_residual(cfg: ModelConfig, x, lp, gather=None):
    """x + the mamba layer of norm(x); ``gather``: ``lp`` is this rank's
    block of the layer, gathered here (inside its ``remat`` region)."""
    if gather is not None:
        lp = gather.layer("layers", lp)
    return x + mamba2_block(lp["mamba"], cfg, rmsnorm(lp["ln"], x))


def forward_hidden(params, cfg: ModelConfig, x, positions, *, collect_state=False, train=False,
                   gather=None):
    """x: (B, S, d) embeddings → (final normed hidden, aux 0, and with
    ``collect_state`` the :class:`HybridCache` sized to S). In training
    (``train=True``) ``cfg.remat`` checkpoints each mamba layer as
    ``transformer.forward_hidden`` checkpoints each layer, and each
    application of the shared block likewise. ``gather`` serves from
    FSDP-stored weights; in training it is the mesh train step's
    ``TrainParamGather``. In both, each mamba layer is gathered where it
    runs (in training inside its ``remat`` region) and the shared block
    whole once."""
    params = _gather_shared(params, gather)
    conv, ssm, ks, vs = [], [], [], []
    body = functools.partial(_mamba_residual, cfg, gather=gather)

    def mamba_op(lp, i, x):
        if collect_state:
            if gather is not None:
                lp = gather.layer("layers", lp)
            out, (c, s) = mamba2_block(lp["mamba"], cfg, rmsnorm(lp["ln"], x),
                                       return_state=True)
            conv.append(c)
            ssm.append(s)
            return x + out
        return remat(cfg, body, x, lp) if train else body(x, lp)

    def shared(x, sa):
        return _shared_block(sa, cfg, x, lambda xn: attention_block(
            sa["attn"], cfg, xn, positions, train=True)[0])

    def attn_op(x, gi):
        if train:  # the K/V appends serve only collect_state
            return remat(cfg, shared, x, params["shared_attn"])

        def attn(xn):
            h, (k, v) = attention_block(params["shared_attn"]["attn"], cfg, xn, positions)
            ks.append(k)
            vs.append(v)
            return h
        return _shared_block(params["shared_attn"], cfg, x, attn)

    x = _walk(params, cfg, x, mamba_op, attn_op)
    h = rmsnorm(whole(params["final_norm"], gather, "final_norm"), x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not collect_state:
        return h, aux
    if ks:
        ak, av = torch.stack(ks), torch.stack(vs)
    else:
        B, S = x.shape[:2]
        ak = av = torch.zeros((0, B, S, max(cfg.n_kv_heads, 1), max(cfg.hd, 1)),
                              dtype=cfg.jdtype, device=x.device)
    return h, HybridCache(conv=torch.stack(conv), ssm=torch.stack(ssm), attn_k=ak, attn_v=av)


def train_loss(params, ds_state, cfg: ModelConfig, batch, mesh=None, gather=None):
    """batch: tokens (B, S+1). → (total loss, metrics dict of 0-d tensors).
    ``mesh`` and ``gather``: as in ``transformer.train_loss``."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    x = embed(params["embed"], inputs, gather)
    B, S = inputs.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    h, _ = forward_hidden(params, cfg, x, positions, train=True, gather=gather)
    ce, aux = heads.head_loss(params["head"], ds_state, cfg, h, labels,
                              embed_table=params["embed"]["table"], label_mask=None, mesh=mesh,
                              gather=gather)
    return ce + aux["head_aux_total"], {"ce": ce, **aux}


def prefill(params, table, cfg: ModelConfig, batch, k: int = 8, kernel=None, mesh=None,
            gather=None):
    """The whole prompt (``batch["tokens"]``) → (vals, ids, HybridCache sized
    to the prompt), the head on the last position. On CUDA tensors the
    shared block's attention runs the ``flash_attention`` kernel. ``mesh``
    serves the DS head expert-parallel, ``gather`` from FSDP-stored
    weights (as in ``transformer.prefill``)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"], tokens, gather)
    positions = torch.arange(S, device=x.device).expand(B, S)
    h, cache = forward_hidden(params, cfg, x, positions, collect_state=True, gather=gather)
    vals, ids = heads.head_topk(params["head"], table, cfg, h[:, -1], k,
                                embed_table=params["embed"]["table"], kernel=kernel, mesh=mesh,
                                gather=gather)
    return vals, ids, cache


def _state_io(cache: HybridCache, i: int, state_pages):
    """Layer ``i``'s (conv, ssm) rows for this batch and a function that
    writes the new ones back in place."""
    conv, ssm = cache.conv[i], cache.ssm[i]
    if state_pages is None:
        def put(nc, ns):
            conv.copy_(nc)
            ssm.copy_(ns)
        return conv, ssm, put
    idx = state_pages.long()

    def put(nc, ns):
        conv.index_copy_(0, idx, nc.to(conv.dtype))
        ssm.index_copy_(0, idx, ns)
    return conv[idx], ssm[idx], put


def _chunk_attn(params, cfg, cache, pos0, pages):
    def attn_op(x, gi):
        def attn(xn):
            h, _, _ = attention_prefill_chunk(params["shared_attn"]["attn"], cfg, xn,
                                              cache.attn_k[gi], cache.attn_v[gi], pos0,
                                              pages=pages)
            return h
        return _shared_block(params["shared_attn"], cfg, x, attn)
    return attn_op


def _chunk_hidden(params, cfg: ModelConfig, cache: HybridCache, tokens, pos0, n_valid,
                  pages=None, state_pages=None, gather=None):
    """The chunk backbone: per-layer conv/ssm threaded through the cache
    (seeded from it, written back after the last valid row), the shared
    block through ``attention_prefill_chunk``. Returns (B, C, d) hidden."""
    x = embed(params["embed"], tokens, gather)
    params = _gather_shared(params, gather)

    def mamba_op(lp, i, x):
        conv, ssm, put = _state_io(cache, i, state_pages)
        out, nconv, nssm = mamba2_prefill_chunk(lp["mamba"], cfg, rmsnorm(lp["ln"], x),
                                                conv, ssm, n_valid)
        put(nconv, nssm)
        return x + out

    x = _walk(params, cfg, x, mamba_op, _chunk_attn(params, cfg, cache, pos0, pages), gather)
    return rmsnorm(params["final_norm"], x)


def prefill_chunk(params, table, cfg: ModelConfig, cache: HybridCache, tokens, pos0,
                  n_valid, k: int = 8, kernel=None, pages=None, state_pages=None, mesh=None,
                  gather=None):
    """State-passing chunked prefill: one (B, C) prompt chunk at positions
    ``pos0 .. pos0+C-1`` against the cache, written in place. Rows at or
    past ``n_valid`` are right-padding. Returns (vals, ids, cache) with the
    head on the hidden state of token ``n_valid - 1``; only a prompt's last
    chunk gives a meaningful top-k."""
    h = _chunk_hidden(params, cfg, cache, tokens, pos0, n_valid, pages, state_pages, gather)
    if torch.is_tensor(n_valid):
        h_last = h[torch.arange(h.shape[0], device=h.device), n_valid.long() - 1]
    else:
        h_last = h[:, n_valid - 1]
    vals, ids = heads.head_topk(params["head"], table, cfg, h_last, k,
                                embed_table=params["embed"]["table"], kernel=kernel, mesh=mesh,
                                gather=gather)
    return vals, ids, cache


def _scan_hidden(params, cfg: ModelConfig, cache: HybridCache, tokens, pos0, n_valid,
                 commit: bool, pages=None, state_pages=None, gather=None):
    """A (B, W) block through :func:`mamba2_verify_scan` (the one-token
    recurrence unrolled) and the shared block at per-row starts ``pos0``.
    With ``commit`` each row's conv/ssm advance by its ``n_valid`` tokens,
    in place; without, they are left as they were."""
    x = embed(params["embed"], tokens, gather)
    params = _gather_shared(params, gather)
    W = tokens.shape[1]

    def mamba_op(lp, i, x):
        conv, ssm, put = _state_io(cache, i, state_pages)
        out, nconv, nssm = mamba2_verify_scan(lp["mamba"], cfg, rmsnorm(lp["ln"], x),
                                              conv, ssm, n_valid if commit else W)
        if commit:
            put(nconv, nssm)
        return x + out

    x = _walk(params, cfg, x, mamba_op, _chunk_attn(params, cfg, cache, pos0, pages), gather)
    return rmsnorm(params["final_norm"], x)


def verify_hidden(params, cfg: ModelConfig, cache: HybridCache, tokens, pos0, pages=None,
                  state_pages=None, gather=None):
    """The verify backbone: a (B, W) block at per-row starts ``pos0`` ((B,)
    int tensor) → hidden (B, W, d). The conv/ssm leaves are left untouched
    (a rejected token's update cannot be rolled back; :func:`commit_block`
    advances each row by its accepted prefix afterwards); the shared block's
    K/V are written in place, as masking makes their rollback free. No host
    sync, no data-dependent shape: a CUDA graph can capture it."""
    return _scan_hidden(params, cfg, cache, tokens, pos0, None, False, pages, state_pages,
                        gather)


def verify_step(params, table, cfg: ModelConfig, cache: HybridCache, tokens, pos0,
                k: int = 8, kernel=None, capacity_factor=None, with_stats=False, pages=None,
                state_pages=None, mesh=None, gather=None):
    """Speculative draft–verify for the state families: :func:`verify_hidden`,
    then the head once over all B·W rows. Returns (vals, ids) of shape (B,
    W, k), the cache, and the head's telemetry with ``with_stats``."""
    h = verify_hidden(params, cfg, cache, tokens, pos0, pages, state_pages, gather)
    B, W, d = h.shape
    out = heads.head_topk(params["head"], table, cfg, h.reshape(B * W, d), k,
                          embed_table=params["embed"]["table"], kernel=kernel, mesh=mesh,
                          gather=gather, capacity_factor=capacity_factor,
                          with_stats=with_stats)
    return (out[0].reshape(B, W, k), out[1].reshape(B, W, k), cache, *out[2:])


def commit_block(params, cfg: ModelConfig, cache: HybridCache, tokens, pos0, n_valid,
                 pages=None, state_pages=None, gather=None):
    """The commit pass after a verify: advance each row's conv/ssm by its
    accepted prefix only (``n_valid`` (B,) = accepted + 1), in place, through
    the one-token recurrence, so the committed state equals decoding the
    accepted tokens one at a time. The shared blocks run (their outputs feed
    later layers) and write the K/V verify wrote. No head. Returns the
    cache."""
    _scan_hidden(params, cfg, cache, tokens, pos0, n_valid, True, pages, state_pages, gather)
    return cache


def decode_hidden(params, cfg: ModelConfig, cache: HybridCache, token, pos, pages=None,
                  state_pages=None, gather=None):
    """The decode backbone: embed one token per row, run the stack against
    the cache (conv/ssm copied in place, the shared block's K/V written at
    ``pos``) and the final norm. token: (B,) int; pos: (B,) int. Returns
    the (B, d) hidden state. Device ops only, no host sync: a CUDA graph
    can capture it."""
    x = embed(params["embed"], token, gather)[:, None, :]
    params = _gather_shared(params, gather)

    def mamba_op(lp, i, x):
        conv, ssm, put = _state_io(cache, i, state_pages)
        out, nconv, nssm = mamba2_decode(lp["mamba"], cfg, rmsnorm(lp["ln"], x), conv, ssm)
        put(nconv, nssm)
        return x + out

    def attn_op(x, gi):
        def attn(xn):
            h, _, _ = attention_decode(params["shared_attn"]["attn"], cfg, xn,
                                       cache.attn_k[gi], cache.attn_v[gi], pos, pages=pages)
            return h
        return _shared_block(params["shared_attn"], cfg, x, attn)

    x = _walk(params, cfg, x, mamba_op, attn_op, gather)
    return rmsnorm(params["final_norm"], x)[:, 0]


def decode_step(params, table, cfg: ModelConfig, cache: HybridCache, token, pos, k: int = 8,
                kernel=None, capacity_factor=None, with_stats=False, pages=None,
                state_pages=None, mesh=None, gather=None):
    """One-token decode: :func:`decode_hidden`, then the head. The state
    recurrence never reads the table, so a hot-swap keeps resident state.
    Returns (vals, ids, cache) and the head's telemetry with
    ``with_stats``."""
    h = decode_hidden(params, cfg, cache, token, pos, pages, state_pages, gather)
    out = heads.head_topk(params["head"], table, cfg, h, k,
                          embed_table=params["embed"]["table"], kernel=kernel, mesh=mesh,
                          gather=gather, capacity_factor=capacity_factor,
                          with_stats=with_stats)
    return (*out[:2], cache, *out[2:])
