"""Encoder-decoder transformer (the whisper-base backbone), as
``repro.models.encdec`` builds it.

The conv/mel audio frontend is a stub: the model takes precomputed frame
embeddings (B, F, d). Sinusoidal positions on the encoder, learned positions
on the decoder (whisper-style; no rope). Per-layer params are stacked on
axis 0 (``(L, …)``) and consumed by a Python loop over layers.

The encoder's self-attention and both cross-attentions are plain PyTorch
on either device (``repro``'s are plain ``jnp``); the decoder's causal
self-attention runs the ``flash_attention`` kernel at prefill on CUDA
tensors, through ``layers.attention_block``. The decode step writes the
self K/V cache in place at ``pos``, so the cache must have room for it:
:func:`pad_self_cache` grows the prompt-sized cache that :func:`prefill`
returns to a ``max_seq_len``.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dssoftmax import normal_
from repro_torch.models import heads
from repro_torch.models.layers import (
    attention_block,
    attention_decode,
    cross_attention_block,
    dense_init,
    embed,
    init_attention,
    init_embedding,
    init_layernorm,
    layernorm,
    mlp,
    stacked_layer,
    whole,
)
from repro_torch.models.transformer import remat

FAMILIES = ("encdec",)


class EncDecCache(NamedTuple):
    self_k: torch.Tensor   # (L, B, S_max, KV, dh)
    self_v: torch.Tensor
    cross_k: torch.Tensor  # (L, B, F, KV, dh), computed once from the encoder memory
    cross_v: torch.Tensor


def sinusoidal(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) fp32 positions: sin of ``pos / 10000^(2i/d)`` then cos."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_params(generator: torch.Generator, cfg: ModelConfig, device="cuda",
                max_target_len: int = 4096):
    """Seeded params on ``device`` → (params, ds_state)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not built by models.encdec")
    d, ff, dt, gen = cfg.d_model, cfg.d_ff, cfg.jdtype, generator
    attention = lambda L: init_attention(gen, cfg, (L,), device)
    dense = lambda L, d_in, d_out: dense_init(gen, (L, d_in, d_out), dt, fan_in=d_in,
                                              device=device)

    def ffn(L):  # drawn up, down, gate (``layers.init_mlp`` draws the gate first)
        p = {"w_up": dense(L, d, ff), "w_down": dense(L, ff, d)}
        if cfg.act == "swiglu":
            p["w_gate"] = dense(L, d, ff)
        return p

    norm = lambda *lead: init_layernorm(d, lead, device)

    Le, Ld = cfg.n_encoder_layers, cfg.n_layers
    pos_embed = torch.empty((max_target_len, d), dtype=dt, device=device)
    params = {
        "embed": init_embedding(gen, cfg.padded_vocab, d, dt, device),
        "pos_embed": normal_(pos_embed, gen, 0.01),
        "enc_layers": {"ln1": norm(Le), "attn": attention(Le), "ln2": norm(Le),
                       "mlp": ffn(Le)},
        "enc_norm": norm(),
        "dec_layers": {"ln1": norm(Ld), "self_attn": attention(Ld), "ln_x": norm(Ld),
                       "cross_attn": attention(Ld), "ln2": norm(Ld), "mlp": ffn(Ld)},
        "dec_norm": norm(),
    }
    params["head"], ds_state = heads.init_head(gen, cfg, device=device)
    return params, ds_state


def _run(cfg: ModelConfig, body, train: bool, *args):
    """``body(*args)``; in training checkpointed as ``cfg.remat`` says."""
    return remat(cfg, body, *args) if train else body(*args)


def _enc_layer(cfg: ModelConfig, train: bool, x, lp, positions, gather=None):
    if gather is not None:  # inside the layer's remat region in training
        lp = gather.layer("enc_layers", lp)
    h, _ = attention_block(lp["attn"], cfg, layernorm(lp["ln1"], x), positions, causal=False,
                           train=train)
    x = x + h
    return x + mlp(lp["mlp"], cfg, layernorm(lp["ln2"], x))


def encode(params, cfg: ModelConfig, frames: torch.Tensor, train: bool = False,
           gather=None) -> torch.Tensor:
    """frames: (B, F, d) stub embeddings → the encoder memory (B, F, d).
    ``gather`` serves from FSDP-stored weights, or trains from the mesh
    train step's blocks: each layer gathered where it runs (in training
    inside its ``remat`` region)."""
    B, F, _ = frames.shape
    x = frames + sinusoidal(F, cfg.d_model, device=frames.device).to(frames.dtype)[None]
    positions = torch.arange(F, device=x.device).expand(B, F)
    body = functools.partial(_enc_layer, cfg, train, gather=gather)
    for i in range(cfg.n_encoder_layers):
        x = _run(cfg, body, train, x, stacked_layer(params["enc_layers"], i), positions)
    return layernorm(whole(params["enc_norm"], gather, "enc_norm"), x)


def _dec_layer(cfg: ModelConfig, train: bool, x, lp, positions, memory, gather=None):
    if gather is not None:  # inside the layer's remat region in training
        lp = gather.layer("dec_layers", lp)
    h, (k, v) = attention_block(lp["self_attn"], cfg, layernorm(lp["ln1"], x), positions,
                                train=train)
    x = x + h
    x = x + cross_attention_block(lp["cross_attn"], cfg, layernorm(lp["ln_x"], x), memory)
    return x + mlp(lp["mlp"], cfg, layernorm(lp["ln2"], x)), k, v


def _decoder_hidden(params, cfg: ModelConfig, tokens, memory, train: bool = False,
                    gather=None):
    """tokens (B, S) at positions 0..S-1 against ``memory`` → (final normed
    hidden (B, S, d), the self K and V of every layer, (L, B, S, KV, dh)
    each). ``gather`` as in :func:`encode`."""
    B, S = tokens.shape
    x = embed(params["embed"], tokens, gather) + _pos_rows(params, torch.arange(
        S, device=tokens.device), gather)[None]
    positions = torch.arange(S, device=x.device).expand(B, S)
    body = functools.partial(_dec_layer, cfg, train, gather=gather)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, k, v = _run(cfg, body, train, x, stacked_layer(params["dec_layers"], i), positions,
                       memory)
        ks.append(k)
        vs.append(v)
    return layernorm(whole(params["dec_norm"], gather, "dec_norm"), x), torch.stack(ks), \
        torch.stack(vs)


def train_loss(params, ds_state, cfg: ModelConfig, batch, mesh=None, gather=None):
    """batch: frames (B, F, d), tokens (B, S+1). → (total loss, metrics
    dict of 0-d tensors). ``mesh`` and ``gather``: as in
    ``transformer.train_loss``."""
    memory = encode(params, cfg, batch["frames"].to(cfg.jdtype), train=True, gather=gather)
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    h, _, _ = _decoder_hidden(params, cfg, inputs, memory, train=True, gather=gather)
    ce, aux = heads.head_loss(params["head"], ds_state, cfg, h, labels,
                              embed_table=params["embed"]["table"], mesh=mesh, gather=gather)
    return ce + aux["head_aux_total"], {"ce": ce, **aux}


def _pos_rows(params, pos, gather):
    """The learned position embeddings at ``pos`` (rows gathered when
    FSDP-stored)."""
    if gather is not None:
        return gather.rows("pos_embed", params["pos_embed"], pos)
    return params["pos_embed"][pos]


def prefill(params, table, cfg: ModelConfig, batch, k: int = 8, kernel=None, mesh=None,
            gather=None):
    """batch: frames (B, F, d), tokens (B, S) (the target prefix). The
    encoder, the decoder over the prefix, each decoder layer's cross K/V
    from the memory (decode never reads the memory again), and the head on
    the last position → (vals, ids, EncDecCache) with the self K/V sized
    to S. ``mesh`` serves the DS head expert-parallel, ``gather`` from
    FSDP-stored weights (as in ``transformer.prefill``)."""
    memory = encode(params, cfg, batch["frames"].to(cfg.jdtype), gather=gather)
    h, sk, sv = _decoder_hidden(params, cfg, batch["tokens"], memory, gather=gather)
    B, F, _ = memory.shape
    KV, dh = cfg.n_kv_heads, cfg.hd
    ca = params["dec_layers"]["cross_attn"]
    cks, cvs = [], []
    for i in range(cfg.n_layers):
        kv = {"wk": ca["wk"][i], "wv": ca["wv"][i]}
        if gather is not None:
            kv = gather.layer("dec_layers/cross_attn", kv)
        cks.append((memory @ kv["wk"]).reshape(B, F, KV, dh))
        cvs.append((memory @ kv["wv"]).reshape(B, F, KV, dh))
    vals, ids = heads.head_topk(params["head"], table, cfg, h[:, -1], k,
                                embed_table=params["embed"]["table"], kernel=kernel, mesh=mesh,
                                gather=gather)
    return vals, ids, EncDecCache(self_k=sk, self_v=sv, cross_k=torch.stack(cks),
                                  cross_v=torch.stack(cvs))


def pad_self_cache(cache: EncDecCache, max_seq_len: int) -> EncDecCache:
    """The cache with its self K/V zero-padded on the sequence axis to
    ``max_seq_len`` positions: room for the decode steps, which write at
    ``pos`` in place. (``repro``'s decode step at a position past the cache
    drops the write (vector ``pos``) or clamps it (scalar ``pos``).)"""
    S = cache.self_k.shape[2]
    if max_seq_len < S:
        raise ValueError(f"max_seq_len {max_seq_len} is below the cache's {S} positions")

    def grow(t):
        out = t.new_zeros(t.shape[:2] + (max_seq_len,) + t.shape[3:])
        out[:, :, :S] = t
        return out
    return cache._replace(self_k=grow(cache.self_k), self_v=grow(cache.self_v))


def _cross_decode(ca, cfg: ModelConfig, x, ck, cv):
    """One token's cross-attention against the cached (B, F, KV, dh) K/V:
    fp32 scores and an unmasked softmax. x: (B, 1, d) normed → (B, 1, d)."""
    B = x.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x[:, 0] @ ca["wq"]).reshape(B, KV, H // KV, dh)
    s = torch.einsum("bkgd,bfkd->bkgf", q.float(), ck.float()) / math.sqrt(dh)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgf,bfkd->bkgd", p, cv.float()).reshape(B, H * dh)
    return (o.to(x.dtype) @ ca["wo"])[:, None]


def decode_hidden(params, cfg: ModelConfig, cache: EncDecCache, token, pos, gather=None):
    """The decode backbone: embed one token per row at its learned position,
    run the decoder layers (self-attention against the cache, written in
    place at ``pos``; cross-attention against the cached K/V) and the final
    norm. token: (B,) int; pos: a 0-d int (every row at one position) or
    (B,) per-row positions. Returns the hidden state (B, d) the head
    reads."""
    B = token.shape[0]
    pos = torch.as_tensor(pos, device=token.device)
    pos_b = (pos.expand(B) if pos.dim() == 0 else pos).long()
    x = embed(params["embed"], token, gather)[:, None, :] + _pos_rows(params, pos_b,
                                                                      gather)[:, None]
    for i in range(cfg.n_layers):
        lp = stacked_layer(params["dec_layers"], i, gather, "dec_layers")
        h, _, _ = attention_decode(lp["self_attn"], cfg, layernorm(lp["ln1"], x),
                                   cache.self_k[i], cache.self_v[i], pos_b)
        x = x + h
        x = x + _cross_decode(lp["cross_attn"], cfg, layernorm(lp["ln_x"], x), cache.cross_k[i],
                              cache.cross_v[i])
        x = x + mlp(lp["mlp"], cfg, layernorm(lp["ln2"], x))
    return layernorm(params["dec_norm"], x)[:, 0]


def decode_step(params, table, cfg: ModelConfig, cache: EncDecCache, token, pos, k: int = 8,
                kernel=None, capacity_factor=None, with_stats=False, mesh=None, gather=None):
    """One-token decode: :func:`decode_hidden`, then the head. The self
    cache is updated in place. Returns (vals, ids, cache), plus the head's
    per-expert telemetry when ``with_stats=True``. ``mesh`` and ``gather``
    as in :func:`prefill`."""
    h = decode_hidden(params, cfg, cache, token, pos, gather)
    out = heads.head_topk(params["head"], table, cfg, h, k,
                          embed_table=params["embed"]["table"], kernel=kernel, mesh=mesh,
                          gather=gather, capacity_factor=capacity_factor,
                          with_stats=with_stats)
    return (*out[:2], cache, *out[2:])
