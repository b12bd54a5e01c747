"""Shared neural-net layers: plain functions on dicts of tensors.

Conventions (those of ``repro.models.layers``, so weights carry across by
a copy):
* weights are ``(d_in, d_out)`` and applied as ``x @ W``; params are in
  the config dtype except norm scales (fp32);
* softmax and norm statistics are fp32; a product whose JAX version asks
  for fp32 accumulation (``preferred_element_type``) widens both operands
  to fp32 first — a bf16 × bf16 product is exact in fp32, while a bf16
  ``matmul`` in torch would return bf16;
* causal self-attention over whole sequences (prefill) runs the
  hand-written ``flash_attention`` kernel on CUDA tensors (and the
  dry-run's meta tensors take that path), for every sequence length; on
  CPU tensors it stays the plain tensor code mirroring the JAX einsums
  (``chunked_causal_attention`` above ``attn_q_chunk``, else
  ``full_attention``), as do decode and chunked prefill on either
  device: masks at -1e9, fp32 softmax; non-causal attention (the
  encoder's, cross-attention) is that plain code on either device too;
* training (``attention_block(..., train=True)``) always takes that plain,
  differentiable code, as ``repro`` trains: the kernel is forward-only,
  and its wrapper raises when autograd would need a gradient through it;
* the caches are written in place (``repro`` returns updated arrays):
  contiguous ``(B, S_max, KV, dh)`` rows, or, with ``pages=``, an arena of
  ``(n_pages, page_size, KV, dh)`` pages addressed through a per-row page
  table.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import on_card
from repro_torch.core.dssoftmax import normal_
from repro_torch.kernels.flash_attention import flash_attention

# ---------------------------------------------------------------------------
# Initializers. ``repro``'s take a key and give one layer; these take the
# torch generator the params are drawn from and ``lead``, the leading axes
# (a stack's ``(L,)``) every leaf gets, so a stack of L layers is drawn leaf
# by leaf, each leaf for all L layers at once: the order the port's
# ``init_params`` have always drawn in.
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, dtype, fan_in: Optional[int] = None,
               device="cuda") -> torch.Tensor:
    """N(0, 1/fan_in) weights of ``shape`` (fan_in: ``shape[0]`` unless
    given), drawn in fp32 by ``core.dssoftmax.normal_`` and cast."""
    w = torch.empty(tuple(shape), dtype=dtype, device=device)
    return normal_(w, generator, 1.0 / math.sqrt(fan_in or shape[0]))


def init_rmsnorm(d: int, lead: tuple = (), device="cuda"):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=torch.float32, device=device)}


def init_layernorm(d: int, lead: tuple = (), device="cuda"):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=torch.float32, device=device),
            "bias": torch.zeros(tuple(lead) + (d,), dtype=torch.float32, device=device)}


def init_attention(generator: torch.Generator, cfg: ModelConfig, lead: tuple = (),
                   device="cuda"):
    """wq, wk, wv, wo (drawn in that order) and, with ``cfg.qkv_bias``,
    zero q/k/v biases."""
    d, H, KV, dh, dt = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.jdtype
    lead = tuple(lead)
    dense = lambda d_in, d_out: dense_init(generator, lead + (d_in, d_out), dt, fan_in=d_in,
                                           device=device)
    p = {"wq": dense(d, H * dh), "wk": dense(d, KV * dh), "wv": dense(d, KV * dh),
         "wo": dense(H * dh, d)}
    if cfg.qkv_bias:
        p.update({n: torch.zeros(lead + (w,), dtype=dt, device=device)
                  for n, w in (("bq", H * dh), ("bk", KV * dh), ("bv", KV * dh))})
    return p


def init_mlp(generator: torch.Generator, cfg: ModelConfig, d_ff: Optional[int] = None,
             lead: tuple = (), device="cuda"):
    """swiglu: w_gate, w_up, w_down (drawn in that order); else w_up, w_down."""
    d, ff, dt, lead = cfg.d_model, d_ff or cfg.d_ff, cfg.jdtype, tuple(lead)
    dense = lambda d_in, d_out: dense_init(generator, lead + (d_in, d_out), dt, fan_in=d_in,
                                           device=device)
    if cfg.act == "swiglu":
        return {"w_gate": dense(d, ff), "w_up": dense(d, ff), "w_down": dense(ff, d)}
    return {"w_up": dense(d, ff), "w_down": dense(ff, d)}


def init_embedding(generator: torch.Generator, vocab: int, d: int, dtype, device="cuda"):
    return {"table": dense_init(generator, (vocab, d), dtype, fan_in=d, device=device)}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"]
    return y.to(x.dtype)


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
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


def attention_block(params, cfg: ModelConfig, x: torch.Tensor, positions, *, causal=True,
                    train=False):
    """Self-attention over whole sequences (prefill, training). Returns the
    output projection and the (k, v) tensors for the cache.

    Causal attention on CUDA tensors runs the ``flash_attention`` kernel,
    whatever S: the (B, S, H, dh) tensors pass as (B, H, S, dh) views and
    the output comes back in the (B, S, H, dh) layout ``wo`` reads. CPU
    tensors, and every call with ``train=True``, take the plain
    differentiable code, as ``repro`` does."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    B, S = x.shape[:2]
    if causal and on_card(q) and not train:
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            device=q.device).transpose(1, 2)
    elif causal and S > cfg.attn_q_chunk:
        o = chunked_causal_attention(cfg, q, k, v)
    else:
        o = full_attention(q, k, v, causal=causal)
    return o.reshape(B, S, -1) @ params["wo"], (k, v)


def _paged_view(cache, pages: torch.Tensor) -> torch.Tensor:
    """The logical (B, n_pg·page_size, KV, dh) view of an (n_pages,
    page_size, KV, dh) arena through a (B, n_pg) page table (a gather)."""
    B, n_pg = pages.shape
    return cache[pages.long()].reshape(B, n_pg * cache.shape[1], *cache.shape[2:])


def attention_decode(params, cfg: ModelConfig, x, cache_k, cache_v, pos, pages=None):
    """One-token decode against a contiguous (B, S_cache, KV, dh) cache.

    x: (B, 1, d); pos: (B,) int per-row positions (every slot decodes at
    its own length). Row b's new K/V is written IN PLACE into the caches
    at ``pos[b]``; cache rows > pos[b] are masked. Returns (out (B,1,d),
    cache_k, cache_v).

    ``pages`` ((B, n_pg) int page table) switches to the paged layout:
    the caches are (n_pages, page_size, KV, dh) arenas, row b's K/V goes
    to page ``pages[b, pos // page_size]`` at ``pos % page_size``, and the
    unchanged math runs on the gathered (B, n_pg·page_size, KV, dh) view.
    Unmapped entries point at the all-zero page, so their V rows add
    exact zeros, never NaN."""
    B = x.shape[0]
    pos_b = pos.long()
    q, k_new, v_new = _project_qkv(params, cfg, x, pos_b[:, None])
    rows = torch.arange(B, device=x.device)
    if pages is not None:
        ps = cache_k.shape[1]
        pid = pages.long()[rows, pos_b // ps]
        cache_k[pid, pos_b % ps] = k_new[:, 0].to(cache_k.dtype)
        cache_v[pid, pos_b % ps] = v_new[:, 0].to(cache_v.dtype)
        view_k, view_v = _paged_view(cache_k, pages), _paged_view(cache_v, pages)
    else:
        cache_k[rows, pos_b] = k_new[:, 0].to(cache_k.dtype)
        cache_v[rows, pos_b] = v_new[:, 0].to(cache_v.dtype)
        view_k, view_v = cache_k, cache_v
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    S = view_k.shape[1]
    qg = q.reshape(B, KV, G, dh)
    s = torch.einsum("bkgd,bckd->bkgc", qg.float(), view_k.float()) / math.sqrt(dh)
    valid = torch.arange(S, device=x.device)[None, None, None, :] <= pos_b[:, None, None, None]
    s = torch.where(valid, s, -1e9)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckd->bkgd", p.to(view_v.dtype).float(), view_v.float())
    out = o.reshape(B, H * dh).to(x.dtype) @ params["wo"]
    return out[:, None, :], cache_k, cache_v


def attention_prefill_chunk(params, cfg: ModelConfig, x, cache_k, cache_v, pos0, pages=None):
    """Chunked prefill: C new tokens against a partly filled (B, S_max, KV,
    dh) cache.

    x: (B, C, d) at positions ``pos0 .. pos0+C-1``; ``pos0`` is an int
    shared by every row, or a (B,) int tensor of per-row starts. The
    chunk's K/V are written IN PLACE into the caches; each query attends
    to every cache position up to its own, so consecutive chunks compute
    what one whole-prompt prefill computes (masked positions add exact
    zeros to the softmax). Padding rows at a chunk's tail write K/V at
    positions that stay masked until a later real token overwrites them.
    ``pages`` switches to the paged layout (see :func:`attention_decode`):
    the chunk's rows go to ``pages[b, position // page_size]`` and the
    same masked attention runs on the gathered view, which is how a tail
    chunk attends to pages another request prefilled. Returns (out (B, C,
    d), cache_k, cache_v)."""
    B, C, _ = x.shape
    steps = torch.arange(C, device=x.device)
    if torch.is_tensor(pos0) and pos0.dim() == 1:
        positions = pos0.long()[:, None] + steps[None, :]
    else:
        positions = (int(pos0) + steps).expand(B, C)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)
    if pages is not None:
        ps = cache_k.shape[1]
        pid = torch.gather(pages.long(), 1, positions // ps)   # (B, C)
        cache_k[pid, positions % ps] = k_new.to(cache_k.dtype)
        cache_v[pid, positions % ps] = v_new.to(cache_v.dtype)
        view_k, view_v = _paged_view(cache_k, pages), _paged_view(cache_v, pages)
    else:
        rows = torch.arange(B, device=x.device)[:, None]
        cache_k[rows, positions] = k_new.to(cache_k.dtype)
        cache_v[rows, positions] = v_new.to(cache_v.dtype)
        view_k, view_v = cache_k, cache_v
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    S = view_k.shape[1]
    k, v = _expand_kv(view_k, G), _expand_kv(view_v, G)
    # the einsum and dtype conventions of full_attention, so chunked
    # prefill matches the whole-prompt path row for row
    s = torch.einsum("bqhd,bchd->bqhc", q.float(), k.float()) * (1.0 / math.sqrt(dh))
    valid = positions[:, :, None] >= torch.arange(S, device=x.device)[None, None, :]
    s = torch.where(valid[:, :, None, :], s, -1e9)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhc,bchd->bqhd", p.to(v.dtype).float(), v.float()).to(q.dtype)
    return o.reshape(B, C, -1) @ params["wo"], cache_k, cache_v


def cross_attention_block(params, cfg: ModelConfig, x, memory):
    """Decoder cross-attention to the encoder's output (whisper): x (B, S,
    d) attends to every row of ``memory`` (B, F, d); K/V come from memory,
    without rope. Plain, non-causal attention on either device, as in
    ``repro``."""
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    n_mem = memory.shape[1]
    q = (x @ params["wq"]).reshape(B, S, H, dh)
    k = (memory @ params["wk"]).reshape(B, n_mem, KV, dh)
    v = (memory @ params["wv"]).reshape(B, n_mem, KV, dh)
    o = full_attention(q, k, v, causal=False)
    return o.reshape(B, S, -1) @ params["wo"]


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


def embed(params, tokens: torch.Tensor, gather=None) -> torch.Tensor:
    """Token embedding ``params["table"][tokens]``; with ``gather`` (FSDP-stored
    serving weights, ``distributed.sharding.ServeParamGather``) each rank
    takes its d-slice of the rows and only the rows cross ranks."""
    if gather is not None:
        return gather.rows("embed/table", params["table"], tokens)
    return params["table"][tokens]


def whole(sub, gather=None, key: str = ""):
    """``sub`` (``params[key]``, a non-stacked subtree or leaf); with
    ``gather`` gathered whole where it is used."""
    return sub if gather is None else gather.full(key, sub)


def stacked_layer(stacked, i: int, gather=None, key: str = "layers"):
    """Layer ``i``'s slice of the stacked ``(L, …)`` params ``stacked``
    (``params[key]``); with ``gather`` gathered whole, so the full layer
    exists only while it runs."""
    lp = ({name: stacked_layer(v, i) for name, v in stacked.items()}
          if isinstance(stacked, dict) else stacked[i])
    return lp if gather is None else gather.layer(key, lp)
