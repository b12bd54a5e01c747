"""DS-Softmax serving: the paper's doubly-sparse softmax head at inference.

Parameters (a plain dict of tensors):
    gate:    U (K, d)      — sparse-mixture gating network
    experts: W (K, N, d)   — per-expert class embeddings
Non-trainable state:
    mask:    (K, N) bool   — surviving classes per expert

``serve_topk`` gathers the chosen expert's packed active rows (a
:class:`ServeTable`) and returns the top-k classes. Every path follows
one order of operations: fp32 logits from fp32 operands, the
un-renormalized top-1 gate value ``g`` applied to the fp32 logits after
the product, padding rows at ``NEG_INF``, ties to the lowest packed
position. The training half of ``repro.core.dssoftmax`` is a later slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import DSSoftmaxConfig
from repro_torch.core.dispatch import dispatch_indices, dispatch_load
from repro_torch.core.gating import top1_gate
from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.kernels.registry import KernelContext, get_spec, resolve_kernel

NEG_INF = ref.NEG_INF


class DSState(NamedTuple):
    mask: torch.Tensor  # (K, N) bool


class ServeTable(NamedTuple):
    """Static-shape packed experts.

    ids:     (K, V_pad) int32 — class id per packed row; -1 for padding.
    weights: (K, V_pad, d)    — gathered active rows (zeros for padding).
    """

    ids: torch.Tensor
    weights: torch.Tensor

    @property
    def v_pad(self) -> int:
        return self.ids.shape[1]


def normal_(out: torch.Tensor, generator: torch.Generator, scale: float) -> torch.Tensor:
    """Fill ``out`` with ``N(0, 1) * scale`` drawn in fp32 then cast, one
    leading-axis slice at a time so large tensors need no fp32 copy."""
    rows = out.unsqueeze(0) if out.dim() < 3 else out
    for r in rows:
        r.copy_(torch.randn(r.shape, generator=generator, device=out.device) * scale)
    return out


def init(generator: torch.Generator, d: int, n_classes: int, cfg: DSSoftmaxConfig,
         dtype=torch.float32, n_valid: Optional[int] = None, device="cuda"):
    """Initialize params + state on ``device``. Experts start as full
    softmaxes (paper); columns ≥ ``n_valid`` start (and stay) masked."""
    dev = resolve_device(device)
    K = cfg.num_experts
    scale = 1.0 / math.sqrt(d)
    params = {
        "gate": normal_(torch.empty((K, d), dtype=dtype, device=dev), generator, scale),
        "experts": normal_(torch.empty((K, n_classes, d), dtype=dtype, device=dev),
                           generator, scale),
    }
    mask = torch.ones((K, n_classes), dtype=torch.bool, device=dev)
    if n_valid is not None and n_valid < n_classes:
        mask[:, n_valid:] = False
    return params, DSState(mask=mask)


def _round_up(x: int, m: int = 128) -> int:
    return ((x + m - 1) // m) * m


def pack_experts(params, state: DSState, pad: Optional[int] = None) -> ServeTable:
    """Compact each expert's surviving rows into a padded static table, on
    the tensors' own device. ``pad`` must cover the largest expert — a
    smaller pad would drop surviving classes, so it raises instead."""
    mask, w = state.mask, params["experts"]
    K, N, d = w.shape
    sizes = mask.sum(dim=1).cpu()
    max_size = int(sizes.max())
    if pad is not None and int(pad) < max_size:
        over = torch.nonzero(sizes > int(pad))[:, 0].tolist()
        listing = ", ".join(f"expert {e}: {int(sizes[e])} rows" for e in over[:8])
        raise ValueError(
            f"pack_experts pad={int(pad)} is smaller than the surviving-class "
            f"count of {len(over)}/{K} experts ({listing}); packing would "
            "silently truncate surviving rows"
        )
    v_pad = int(pad) if pad else _round_up(max(1, max_size))
    ids = torch.full((K, v_pad), -1, dtype=torch.int32, device=w.device)
    weights = torch.zeros((K, v_pad, d), dtype=w.dtype, device=w.device)
    for e in range(K):
        idx = torch.nonzero(mask[e])[:, 0]
        ids[e, : idx.numel()] = idx.to(torch.int32)
        weights[e, : idx.numel()] = w[e, idx]
    return ServeTable(ids=ids, weights=weights)


def serve_kernel_context(table: ServeTable, h: torch.Tensor, k: int,
                         capacity_factor: float = 2.0) -> KernelContext:
    """The :class:`KernelContext` of one ``serve_topk`` call; the backend
    is the device type of ``h``."""
    return KernelContext(
        B=h.shape[0],
        d=h.shape[1],
        K=table.ids.shape[0],
        v_pad=table.ids.shape[1],
        k=k,
        backend=h.device.type,
        capacity_factor=capacity_factor,
        wbytes=table.weights.element_size(),
        hbytes=h.element_size(),
    )


def serve_topk(gate_w: torch.Tensor, table: ServeTable, h: torch.Tensor, k: int, *,
               kernel="jnp", capacity_factor: float = 2.0, with_stats: bool = False,
               device="cuda"):
    """Top-k class retrieval (paper inference). h: (B, d) → values/ids (B, k).

    ``kernel`` is a registered name, a policy name, or a KernelPolicy:

    'jnp'          — per-token gather + product in plain PyTorch (oracle).
    'grouped'      — tokens grouped by top-1 expert, one (C, d)×(d, V_pad)
                     product per expert in plain PyTorch, exact overflow
                     fallback.
    'cuda_grouped' — the same dispatch feeding the ``gate_top1`` and
                     ``dss_topk_grouped`` kernels.
    'cuda_fused'   — gate, dispatch and retrieval in one ``dss_topk_fused``
                     launch.
    'auto'         — cheapest feasible path by the registry's bytes model.

    On CPU tensors the kernel paths run their wrappers' plain versions.
    ``with_stats=True`` also returns ``{'dispatched': (K,), 'overflow':
    (K,)}`` int32 per-expert load telemetry.
    """
    dev = resolve_device(device)
    check_on(dev, gate_w=gate_w, h=h, table_ids=table.ids, table_weights=table.weights)
    kernel = resolve_kernel(kernel, serve_kernel_context(table, h, k, capacity_factor))
    if get_spec(kernel).fused:
        return _serve_topk_fused(gate_w, table, h, k, with_stats=with_stats)
    if kernel == "cuda_grouped":
        expert_idx, g = kops.gate_top1(gate_w, h, device=h.device)
    else:
        expert_idx, g, _ = top1_gate(gate_w, h)
    return _serve_topk_local(table, h, expert_idx, g, k, kernel,
                             capacity_factor=capacity_factor, with_stats=with_stats)


def _serve_topk_local(table: ServeTable, h, expert_idx, g, k: int, kernel: str, *,
                      capacity_factor: float = 2.0, with_stats: bool = False):
    """Retrieval after gating, for the non-fused paths."""
    overflow = None
    if kernel in ("grouped", "cuda_grouped"):
        vals, ids, overflow = _serve_topk_grouped(
            table, h, expert_idx, g, k, capacity_factor=capacity_factor,
            use_kernel=kernel == "cuda_grouped")
    elif kernel != "jnp":
        raise NotImplementedError(f"registered serve kernel {kernel!r} has no dispatch branch")
    else:
        vals, ids = _exact_rows_topk(table, h, expert_idx, g, k)
    if not with_stats:
        return vals, ids
    K = table.ids.shape[0]
    dispatched, zero = dispatch_load(expert_idx, K)
    return vals, ids, {"dispatched": dispatched,
                       "overflow": zero if overflow is None else overflow}


def _exact_rows_logits(table: ServeTable, expert_idx, h):
    """Per-token gather-path logits: (B, V_pad) fp32 UN-gated ``z`` plus the
    gathered (B, V_pad) row ids."""
    e = expert_idx.long()
    z = torch.bmm(table.weights[e].float(), h.float()[:, :, None])[:, :, 0]
    return z, table.ids[e]


def _exact_rows_topk(table: ServeTable, h, expert_idx, g, k: int):
    z, ids_sel = _exact_rows_logits(table, expert_idx, h)
    z = z * g[:, None]
    z = torch.where(ids_sel >= 0, z, NEG_INF)
    vals, pos = ref.topk_stable(z, k)
    return vals, torch.gather(ids_sel, 1, pos)


def _group_tokens(h, g, expert_idx, K: int, capacity: int):
    """Grouped-dispatch pre-pass: scatter tokens (UNscaled) and their fp32
    gate values into per-expert capacity buffers; overflowed tokens are
    left out. Returns (buf (K, C, d), g_buf (K, C), slot, valid)."""
    slot, valid = dispatch_indices(expert_idx, K, capacity)
    e, s = expert_idx[valid].long(), slot[valid].long()
    buf = torch.zeros((K, capacity, h.shape[-1]), dtype=h.dtype, device=h.device)
    buf[e, s] = h[valid]
    g_buf = torch.zeros((K, capacity), dtype=torch.float32, device=h.device)
    g_buf[e, s] = g[valid].float()
    return buf, g_buf, slot, valid


def _overflow_fixup(table: ServeTable, h, g, expert_idx, valid, vals, ids, k: int,
                    capacity: int):
    """Exact fallback for every ~valid token through the gather path, in
    chunks of O = min(B, max(capacity, K)) tokens so the gathered rows stay
    bounded: cost proportional to the actual overflow."""
    over = torch.nonzero(~valid)[:, 0]
    if over.numel() == 0:
        return vals, ids
    B, K = h.shape[0], table.ids.shape[0]
    O = min(B, max(capacity, K))
    for lo in range(0, over.numel(), O):
        idx = over[lo: lo + O]
        v_o, i_o = _exact_rows_topk(table, h[idx], expert_idx[idx], g[idx], k)
        vals[idx] = v_o
        ids[idx] = i_o
    return vals, ids


def _serve_topk_grouped(table: ServeTable, h, expert_idx, g, k: int,
                        capacity_factor: float = 2.0, use_kernel: bool = False):
    """Expert-batched serving: one weight-stationary (C, d)×(d, V_pad)
    contraction per expert. ``use_kernel`` runs it through the
    ``dss_topk_grouped`` kernel, else through its plain version. Tokens
    overflowing an expert's capacity fall back to the gather path.
    Returns (vals, ids, overflow (K,) int32)."""
    B = h.shape[0]
    K = table.ids.shape[0]
    capacity = int(max(1, round(B / K * capacity_factor)))
    buf, g_buf, slot, valid = _group_tokens(h, g, expert_idx, K, capacity)
    _, overflow = dispatch_load(expert_idx, K, valid)
    if use_kernel:
        vals_b, ids_b = kops.dss_topk_grouped(table.weights, table.ids, buf, g_buf, k,
                                              device=h.device)
    else:
        vals_b, ids_b = ref.dss_topk_grouped_ref(table.weights, table.ids, buf, g_buf, k)
    e, s = expert_idx.long(), slot.clamp(max=capacity - 1).long()
    vals, ids = vals_b[e, s], ids_b[e, s]
    vals, ids = _overflow_fixup(table, h, g, expert_idx, valid, vals, ids, k, capacity)
    return vals, ids, overflow


def _serve_topk_fused(gate_w, table: ServeTable, h, k: int, *, with_stats: bool = False):
    """Single-launch decode: gating, top-1 dispatch and retrieval all in
    the ``dss_topk_fused`` kernel."""
    vals, ids, eidx = kops.dss_topk_fused(gate_w, table.weights, table.ids, h, k,
                                          device=h.device)
    if not with_stats:
        return vals, ids
    dispatched, zero = dispatch_load(eidx, table.ids.shape[0])
    return vals, ids, {"dispatched": dispatched, "overflow": zero}
