"""Plain PyTorch versions of every kernel of the port.

Each function computes what its CUDA kernel computes, in the same order
of operations: fp32 logits from fp32 operands (bf16 × bf16 products are
exact in fp32), for int8 rows the per-row scale applied to the fp32
logits, then the gate value, padding rows (id -1) at ``NEG_INF``. int8
rows are cast to the token dtype first, which is exact (|q| ≤ 127);
``q · scale`` is never premultiplied. The kernel wrappers call
these (through :func:`plain`) only for tensors off the card: on the CPU,
and on the meta tensors of the dry-run's trace; tests and
``chip_smoke.py`` hold the kernels against them.

Top-k is a stable descending sort, so ties go to the lowest packed
position, as ``jax.lax.top_k`` does (``torch.topk`` promises no order
among ties).

``flash_attention_ref`` is the reference's oracle: unlike the kernel (and
the Pallas kernel) it does not round p to bf16 before p·v, so on bf16
inputs the two differ by one bf16 rounding of each p.
"""
from __future__ import annotations

import torch

NEG_INF = -1e9

# Set by ``distributed.hlo_analysis.CostCounter`` while it counts a traced
# step: a kernel's plain version then counts as the kernel itself.
_COUNTER = None


def plain(name: str, fn, *args, flops=None, **kw):
    """``fn(*args, **kw)``, kernel ``name``'s plain version, which its
    wrapper runs on tensors off the card. Under a cost counter the call
    counts as the kernel does on the card: one op that reads its operands
    and writes its results once, its temporaries never resident, its
    flops the plain version's products or ``flops`` where the body does
    less work."""
    if _COUNTER is None:
        return fn(*args, **kw)
    return _COUNTER.kernel_call(name, fn, args, kw, flops)


def topk_stable(z: torch.Tensor, k: int):
    """(values, positions) of the k largest along the last axis; ties to
    the lowest position."""
    vals, pos = torch.sort(z, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def gate_top1_ref(gate_w: torch.Tensor, h: torch.Tensor):
    """Fused top-1 gate: fp32 logits, softmax, first argmax of p, g = max p.
    → (idx (B,) int32, g (B,) fp32)."""
    p = torch.softmax(h.float() @ gate_w.float().T, dim=-1)
    return torch.argmax(p, dim=-1).to(torch.int32), torch.amax(p, dim=-1)


def check_scales(weights, scales) -> None:
    """int8 rows come with their per-row scales, and only they do."""
    if (weights.dtype == torch.int8) != (scales is not None):
        raise ValueError("int8 weights need their per-row scales, and only they take scales")


def _rows(weights, scales, x_dtype):
    """The rows as the product reads them: int8 rows cast to the token
    dtype, then widened to fp32."""
    return (weights.to(x_dtype) if scales is not None else weights).float()


def dss_topk_grouped_ref(weights, ids, buf, g_buf, k: int, scales=None):
    """Expert-grouped retrieval. weights (K, V_pad, d) (int8 with
    ``scales`` (K, V_pad) fp32), ids (K, V_pad), buf (K, C, d), g_buf
    (K, C) fp32 → (vals (K, C, k) fp32, ids (K, C, k) int32)."""
    check_scales(weights, scales)
    w = _rows(weights, scales, buf.dtype)
    z = torch.bmm(buf.float(), w.transpose(1, 2))  # (K, C, V_pad)
    if scales is not None:
        z = z * scales[:, None, :]
    z = z * g_buf[..., None]
    z = torch.where(ids[:, None, :] >= 0, z, NEG_INF)
    vals, pos = topk_stable(z, k)
    return vals, torch.gather(ids[:, None, :].expand(z.shape), 2, pos)


def dss_topk_fused_ref(gate_w, weights, ids, h, k: int, e_base: int = 0, scales=None):
    """Single-launch decode retrieval: gating on the first argmax of the
    fp32 logits with ``g = 1/Σexp(l - max)``, then retrieval over the
    selected expert's rows only (int8 rows with ``scales``). Tokens whose
    expert lies outside ``[e_base, e_base + K)`` emit ``(-inf, -1)``.
    → (vals (B, k) fp32, ids (B, k) int32, expert (B,) int32 global)."""
    check_scales(weights, scales)
    K = weights.shape[0]
    glog = h.float() @ gate_w.float().T                      # (B, K_real)
    sel = torch.argmax(glog, dim=-1)                         # first maximum
    g = 1.0 / torch.sum(torch.exp(glog - torch.amax(glog, -1, keepdim=True)), -1)
    local = sel - e_base
    mine = (local >= 0) & (local < K)
    lc = local.clamp(0, K - 1)
    ids_sel = ids[lc]                                        # (B, V_pad)
    z = torch.einsum("bvd,bd->bv", _rows(weights[lc], scales, h.dtype), h.float())
    if scales is not None:
        z = z * scales[lc]
    z = z * g[:, None]
    z = torch.where(ids_sel >= 0, z, NEG_INF)
    vals, pos = topk_stable(z, k)
    out_ids = torch.gather(ids_sel, 1, pos)
    vals = torch.where(mine[:, None], vals, float("-inf"))
    out_ids = torch.where(mine[:, None], out_ids, -1)
    return vals, out_ids, sel.to(torch.int32)


def dss_topk_ref(weights, ids, h_scaled, expert_idx, k: int):
    """Per-token retrieval from each token's own expert, fp tables only.
    weights (K, V_pad, d), ids (K, V_pad), h_scaled (B, d) already
    multiplied by the gate value, expert_idx (B,) → (vals (B, k) fp32,
    ids (B, k) int32). Tail slots of an expert with fewer than k real
    rows are its padding rows, ``(NEG_INF, -1)``."""
    e = expert_idx.long()
    ids_sel = ids[e]
    z = torch.einsum("bvd,bd->bv", weights[e].float(), h_scaled.float())
    z = torch.where(ids_sel >= 0, z, NEG_INF)
    vals, pos = topk_stable(z, k)
    return vals, torch.gather(ids_sel, 1, pos)


def lasso_prune_ref(weights, mask, gamma: float):
    """Group-lasso row step. weights (K, N, d) f32/bf16, mask (K, N) bool →
    (norms (K, N) fp32, new_mask (K, N) bool): the fp32 l2 norm of every
    row, exactly 0 for a masked row (its fp32 copy is zeroed first, as
    ``repro.kernels.ref.lasso_prune_ref`` does), and
    ``new_mask = mask ∧ norm > gamma`` with gamma compared in fp32. One
    expert at a time, so no fp32 copy of the whole (K, N, d) tensor exists."""
    norms = torch.empty(mask.shape, dtype=torch.float32, device=weights.device)
    for e in range(weights.shape[0]):
        w = weights[e].float() * mask[e, :, None]
        norms[e] = torch.sqrt(torch.sum(w * w, dim=-1))
    return norms, mask & (norms > gamma)


def flash_attention_ref(q, k, v, causal: bool = True):
    """Oracle attention, as ``repro.kernels.ref.flash_attention_ref``
    computes it. q (B, H, S, dh), k/v (B, H_kv, S, dh) with H % H_kv == 0
    (query head h reads kv head h // (H / H_kv), the order of
    ``jnp.repeat(k, H // H_kv, axis=1)``) → (B, H, S, dh) in q's dtype:
    fp32 scores times 1/√dh (an fp32 division), -1e9 causal mask, fp32
    softmax, p·v with v widened to fp32 and p not rounded."""
    G = q.shape[1] // k.shape[1]
    if G > 1:
        k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    S = q.shape[2]
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=torch.float32))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale.to(q.device)
    if causal:
        pos = torch.arange(S, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
