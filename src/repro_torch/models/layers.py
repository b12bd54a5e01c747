"""Shared neural-net layers: plain functions on dicts of tensors.

Conventions (those of ``repro.models.layers``, so weights carry across by
a copy):
* weights are ``(d_in, d_out)`` and applied as ``x @ W``; params are in
  the config dtype except norm scales (fp32);
* softmax and norm statistics are fp32; a product whose JAX version asks
  for fp32 accumulation (``preferred_element_type``) widens both operands
  to fp32 first — a bf16 × bf16 product is exact in fp32, while a bf16
  ``matmul`` in torch would return bf16;
* attention is plain tensor code mirroring the JAX einsums: masks at
  -1e9, fp32 softmax. A hand-written flash-attention kernel is a later
  slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # theta ** t with a Python-float base computes in fp32 on the device
    # (a tensor made from theta would cost a host-to-device copy per call)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S). Split
    halves, computed in fp32."""
    if theta <= 0.0:
        return x
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)
    angles = positions[..., None].float() * freqs           # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def _project_qkv(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, KV, dh)
    v = v.reshape(B, S, KV, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k: torch.Tensor, G: int) -> torch.Tensor:
    """(B, S, KV, dh) → (B, S, KV·G, dh), each KV head repeated G times."""
    return k.repeat_interleave(G, dim=2) if G > 1 else k


def _attn_chunk(q, k, v, scale: float, mask: Optional[torch.Tensor]):
    """One (q-chunk, kv-chunk) block. q: (B,Cq,H,dh) k/v: (B,Ck,KV,dh).
    Returns unnormalized online-softmax statistics (acc, m, l), fp32."""
    G = q.shape[2] // k.shape[2]
    k, v = _expand_kv(k, G), _expand_kv(v, G)
    s = torch.einsum("bqhd,bchd->bqhc", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask[:, :, None, :], s, -1e9)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bqhc,bchd->bqhd", p.to(v.dtype).float(), v.float())
    return acc, m, l


def _merge_online(stats_a, stats_b):
    acc_a, m_a, l_a = stats_a
    acc_b, m_b, l_b = stats_b
    m = torch.maximum(m_a, m_b)
    ca = torch.exp(m_a - m)
    cb = torch.exp(m_b - m)
    return acc_a * ca[..., None] + acc_b * cb[..., None], m, l_a * ca + l_b * cb


def chunked_causal_attention(cfg: ModelConfig, q, k, v) -> torch.Tensor:
    """Flash-style causal attention over query chunks; q-chunk i visits kv
    chunks 0..i only. q,k,v: (B,S,H|KV,dh) → (B,S,H,dh)."""
    B, S, H, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    Cq = min(cfg.attn_q_chunk, S)
    Ck = min(cfg.attn_kv_chunk, S)
    if S % Cq or S % Ck:  # small/odd sizes: single full block
        Cq = Ck = S
    nq = S // Cq
    outs = []
    for i in range(nq):
        qi = q[:, i * Cq: (i + 1) * Cq]
        q_pos = i * Cq + torch.arange(Cq, device=q.device)
        j_diag = (i * Cq) // Ck
        kd = k[:, j_diag * Ck: (j_diag + 1) * Ck]
        vd = v[:, j_diag * Ck: (j_diag + 1) * Ck]
        kv_pos = j_diag * Ck + torch.arange(Ck, device=q.device)
        mask = q_pos[None, :, None] >= kv_pos[None, None, :]
        stats = _attn_chunk(qi, kd, vd, scale, mask)
        for j in range(j_diag):  # strictly-below-diagonal kv chunks: no mask
            blk = _attn_chunk(qi, k[:, j * Ck: (j + 1) * Ck], v[:, j * Ck: (j + 1) * Ck],
                              scale, None)
            stats = _merge_online(stats, blk)
        acc, m, l = stats
        outs.append((acc / l[..., None]).reshape(B, Cq, H, dh))
    return torch.cat(outs, dim=1).to(q.dtype)


def full_attention(q, k, v, causal: bool) -> torch.Tensor:
    """Plain attention for short sequences. Shapes as above."""
    S, dh = q.shape[1], q.shape[3]
    G = q.shape[2] // k.shape[2]
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    k, v = _expand_kv(k, G), _expand_kv(v, G)
    s = torch.einsum("bqhd,bchd->bqhc", q.float(), k.float()) * scale
    if causal:
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        s = torch.where(mask[None, :, None, :], s, -1e9)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhc,bchd->bqhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def attention_block(params, cfg: ModelConfig, x: torch.Tensor, positions, *, causal=True):
    """Self-attention over whole sequences (prefill). Returns the output
    projection and the (k, v) tensors for the cache."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    B, S = x.shape[:2]
    if causal and S > cfg.attn_q_chunk:
        o = chunked_causal_attention(cfg, q, k, v)
    else:
        o = full_attention(q, k, v, causal=causal)
    return o.reshape(B, S, -1) @ params["wo"], (k, v)


def attention_decode(params, cfg: ModelConfig, x, cache_k, cache_v, pos):
    """One-token decode against a contiguous (B, S_cache, KV, dh) cache.

    x: (B, 1, d); pos: (B,) int per-row positions (every slot decodes at
    its own length). Row b's new K/V is written IN PLACE into the caches
    at ``pos[b]``; cache rows > pos[b] are masked. Returns (out (B,1,d),
    cache_k, cache_v)."""
    B = x.shape[0]
    pos_b = pos.long()
    q, k_new, v_new = _project_qkv(params, cfg, x, pos_b[:, None])
    rows = torch.arange(B, device=x.device)
    cache_k[rows, pos_b] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, pos_b] = v_new[:, 0].to(cache_v.dtype)
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    S = cache_k.shape[1]
    qg = q.reshape(B, KV, G, dh)
    s = torch.einsum("bkgd,bckd->bkgc", qg.float(), cache_k.float()) / math.sqrt(dh)
    valid = torch.arange(S, device=x.device)[None, None, None, :] <= pos_b[:, None, None, None]
    s = torch.where(valid, s, -1e9)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckd->bkgd", p.to(cache_v.dtype).float(), cache_v.float())
    out = o.reshape(B, H * dh).to(x.dtype) @ params["wo"]
    return out[:, None, :], cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP and embedding
# ---------------------------------------------------------------------------


def mlp(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in params:
        g = F.silu((x @ params["w_gate"]).float())
        u = (x @ params["w_up"]).float()
        return (g * u).to(x.dtype) @ params["w_down"]
    u = F.gelu((x @ params["w_up"]).float(), approximate="tanh")  # jax.nn.gelu default
    return u.to(x.dtype) @ params["w_down"]


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]
