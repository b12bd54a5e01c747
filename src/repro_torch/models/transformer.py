"""Decoder-only transformer LM, dense family.

Per-layer parameters are stacked on axis 0 (``(L, …)``, as in
``repro.models.transformer``) and consumed by a Python loop over layers.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dssoftmax import normal_
from repro_torch.models import heads
from repro_torch.models.layers import (
    attention_block,
    attention_decode,
    embed,
    mlp,
    rmsnorm,
)


class DecodeCache(NamedTuple):
    k: torch.Tensor  # (L, B, S_max, KV, dh)
    v: torch.Tensor


def _dense(gen, L, shape, dtype, device, fan_in=None):
    w = torch.empty((L,) + shape, dtype=dtype, device=device)
    return normal_(w, gen, 1.0 / math.sqrt(fan_in or shape[0]))


def init_params(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    """Seeded params on ``device`` → (params, ds_state)."""
    if cfg.family != "dense":
        raise ValueError(f"family {cfg.family!r} is not ported yet")
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt, gen = cfg.jdtype, generator
    attn = {
        "wq": _dense(gen, L, (d, H * dh), dt, device),
        "wk": _dense(gen, L, (d, KV * dh), dt, device),
        "wv": _dense(gen, L, (d, KV * dh), dt, device),
        "wo": _dense(gen, L, (H * dh, d), dt, device),
    }
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros((L, H * dh), dtype=dt, device=device)
        attn["bk"] = torch.zeros((L, KV * dh), dtype=dt, device=device)
        attn["bv"] = torch.zeros((L, KV * dh), dtype=dt, device=device)
    if cfg.act == "swiglu":
        mlp_p = {"w_gate": _dense(gen, L, (d, ff), dt, device),
                 "w_up": _dense(gen, L, (d, ff), dt, device),
                 "w_down": _dense(gen, L, (ff, d), dt, device)}
    else:
        mlp_p = {"w_up": _dense(gen, L, (d, ff), dt, device),
                 "w_down": _dense(gen, L, (ff, d), dt, device)}
    ones = lambda: {"scale": torch.ones((L, d), dtype=torch.float32, device=device)}
    table = torch.empty((cfg.padded_vocab, d), dtype=dt, device=device)
    params = {
        "embed": {"table": normal_(table, gen, 1.0 / math.sqrt(d))},
        "layers": {"ln1": ones(), "attn": attn, "ln2": ones(), "mlp": mlp_p},
        "final_norm": {"scale": torch.ones((d,), dtype=torch.float32, device=device)},
    }
    params["head"], ds_state = heads.init_head(gen, cfg, device=device)
    return params, ds_state


def _layer_params(stacked, i: int):
    """Layer ``i``'s slice of the stacked ``(L, …)`` layer params."""
    if isinstance(stacked, dict):
        return {key: _layer_params(v, i) for key, v in stacked.items()}
    return stacked[i]


def _mlp_residual(lp, cfg: ModelConfig, x):
    return x + mlp(lp["mlp"], cfg, rmsnorm(lp["ln2"], x))


def prefill(params, table, cfg: ModelConfig, batch, k: int = 8, kernel=None):
    """Run the whole prompt; returns (topk_vals, topk_ids, DecodeCache) with
    the cache sized to the prompt length and the head applied to the last
    position."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer_params(params["layers"], i)
        h, (kk, vv) = attention_block(lp["attn"], cfg, rmsnorm(lp["ln1"], x), positions)
        x = _mlp_residual(lp, cfg, x + h)
        ks.append(kk)
        vs.append(vv)
    h = rmsnorm(params["final_norm"], x)[:, -1]
    vals, ids = heads.head_topk(params["head"], table, cfg, h, k,
                                embed_table=params["embed"]["table"], kernel=kernel)
    return vals, ids, DecodeCache(k=torch.stack(ks), v=torch.stack(vs))


def decode_step(params, table, cfg: ModelConfig, cache: DecodeCache, token, pos,
                k: int = 8, kernel=None, capacity_factor=None, with_stats=False):
    """One-token decode. token: (B,) int; pos: (B,) int per-slot positions.
    The cache is updated in place. Returns (vals, ids, cache) — plus the
    head's per-expert telemetry when ``with_stats=True``."""
    x = embed(params["embed"], token)[:, None, :]
    for i in range(cfg.n_layers):
        lp = _layer_params(params["layers"], i)
        h, _, _ = attention_decode(lp["attn"], cfg, rmsnorm(lp["ln1"], x),
                                   cache.k[i], cache.v[i], pos)
        x = _mlp_residual(lp, cfg, x + h)
    h = rmsnorm(params["final_norm"], x)[:, 0]
    out = heads.head_topk(params["head"], table, cfg, h, k,
                          embed_table=params["embed"]["table"], kernel=kernel,
                          capacity_factor=capacity_factor, with_stats=with_stats)
    return (*out[:2], cache, *out[2:])
