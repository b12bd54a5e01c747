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
position. A :class:`QuantizedServeTable` holds int8 rows with per-row fp32
scales; every path casts the rows to the token dtype, forms the fp32
product, and multiplies the accumulator by the row scale and then by
``g``. The training half of ``repro.core.dssoftmax`` is a later slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import numpy as np
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


class QuantizedServeTable(NamedTuple):
    """Int8 serve table with per-row fp32 scales.

    Accepted wherever serving takes a :class:`ServeTable`. Rows are stored
    symmetric-quantized, ``w[e, v] ≈ qweights[e, v] * scales[e, v]`` with
    ``scales[e, v] = max|w[e, v, :]| / 127``, and dequantized in the
    product: every path casts the int8 rows to the token dtype,
    accumulates in fp32 and multiplies the accumulator by the row scale,
    so the (K, V_pad, d) table is read at 1 byte per element.

    Experts whose top-k ids flip against the fp oracle on calibration
    traffic (:func:`calibrate_quantized_table`) keep their exact rows in
    ``fb_weights`` and are served through the gather path.

    ids:        (K, V_pad) int32 — class id per packed row; -1 padding.
    qweights:   (K, V_pad, d) int8 — symmetric-quantized rows.
    scales:     (K, V_pad) float32 — per-row scale (1.0 on all-zero rows).
    fb_index:   (K,) int32 — row of expert e in ``fb_weights``; -1 means
                served from int8 rows.
    fb_weights: (n_fb, V_pad, d) source dtype — exact rows of the
                fallback experts (empty when none fell back).
    """

    ids: torch.Tensor
    qweights: torch.Tensor
    scales: torch.Tensor
    fb_index: torch.Tensor
    fb_weights: torch.Tensor

    @property
    def v_pad(self) -> int:
        return self.ids.shape[1]

    @property
    def n_fallback(self) -> int:
        return self.fb_weights.shape[0]


AnyServeTable = Union[ServeTable, QuantizedServeTable]


def table_rows(table: AnyServeTable) -> torch.Tensor:
    """The (K, V_pad, d) rows the kernels stream: int8 for a quantized
    table, else the fp rows."""
    return table.qweights if isinstance(table, QuantizedServeTable) else table.weights


def quantize_table(table: ServeTable, fb_mask=None) -> QuantizedServeTable:
    """Symmetric int8 row quantization of a packed :class:`ServeTable`, on
    the table's own device, in fp32 from the source rows.

    ``fb_mask`` (K,) bool marks experts kept at full precision (their
    exact rows move to ``fb_weights``; their ``qweights`` stay populated
    but are never read). ``torch.round`` rounds half to even as
    ``np.rint`` does, so ``qweights`` and ``scales`` equal repro's bit for
    bit. One expert at a time, so no fp32 copy of the whole table exists.
    """
    w = table.weights
    K = w.shape[0]
    scales = torch.empty(w.shape[:2], dtype=torch.float32, device=w.device)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    for e in range(K):
        w32 = w[e].float()
        amax = w32.abs().amax(dim=1)
        scales[e] = torch.where(amax > 0, amax / 127.0, 1.0)
        q[e] = torch.round(w32 / scales[e][:, None]).clamp_(-127, 127).to(torch.int8)
    fb = (torch.zeros(K, dtype=torch.bool) if fb_mask is None
          else torch.as_tensor(fb_mask, dtype=torch.bool).cpu())
    fb_rows = torch.nonzero(fb)[:, 0]
    fb_index = torch.full((K,), -1, dtype=torch.int32)
    fb_index[fb_rows] = torch.arange(fb_rows.numel(), dtype=torch.int32)
    return QuantizedServeTable(
        ids=table.ids, qweights=q, scales=scales,
        fb_index=fb_index.to(w.device), fb_weights=w[fb_rows.to(w.device)])


def dequantize_table(table: QuantizedServeTable) -> ServeTable:
    """The fp32 table a :class:`QuantizedServeTable` serves: ``q * s`` rows,
    fallback experts' exact rows substituted. A test and debugging helper;
    the serve paths never build it."""
    w = table.qweights.float() * table.scales[..., None]
    for e in torch.nonzero(table.fb_index >= 0)[:, 0].tolist():
        w[e] = table.fb_weights[int(table.fb_index[e])].float()
    return ServeTable(ids=table.ids, weights=w)


class ExactnessReport(NamedTuple):
    """The quantized-serving exactness gate's result
    (:func:`calibrate_quantized_table`): top-k ids of the all-int8 table
    against the fp oracle on calibration traffic; experts whose flip rate
    exceeds ``flip_threshold`` fall back to full-precision rows. The gate
    passes iff no flip remains on an int8-served expert."""

    n_tokens: int
    n_flips_raw: int           # all-int8 table vs the fp oracle
    n_unguarded_flips: int     # flips left after the per-expert fallback
    flip_threshold: float
    per_expert_flip_rate: tuple  # (K,) floats, calibration-token weighted
    fallback_experts: tuple      # experts served from full-precision rows

    @property
    def passed(self) -> bool:
        return self.n_unguarded_flips == 0

    def as_dict(self) -> dict:
        return {
            "n_tokens": int(self.n_tokens),
            "n_flips_raw": int(self.n_flips_raw),
            "n_unguarded_flips": int(self.n_unguarded_flips),
            "flip_rate_raw": (float(self.n_flips_raw) / self.n_tokens
                              if self.n_tokens else 0.0),
            "flip_threshold": float(self.flip_threshold),
            "per_expert_flip_rate": [float(r) for r in self.per_expert_flip_rate],
            "fallback_experts": [int(e) for e in self.fallback_experts],
            "n_fallback": len(self.fallback_experts),
            "passed": bool(self.passed),
        }


def calibrate_quantized_table(gate_w: torch.Tensor, table: ServeTable,
                              calib_h: torch.Tensor, k: int = 8,
                              flip_threshold: float = 0.0):
    """Quantize ``table`` to int8 under the exactness gate.

    Runs the ``jnp`` oracle on the fp table and on the all-int8 table over
    the (n, d) calibration activations ``calib_h``, compares top-``k`` ids
    position by position, and re-quantizes with full-precision fallback
    for every expert whose flip rate (over the tokens its top-1 gate
    took) exceeds ``flip_threshold``. → (table, :class:`ExactnessReport`).
    """
    if not isinstance(table, ServeTable):
        raise TypeError(
            "calibrate_quantized_table expects a full-precision ServeTable, "
            f"got {type(table).__name__}")
    dev = calib_h.device
    qt_all = quantize_table(table)
    _, ids_ref = serve_topk(gate_w, table, calib_h, k, kernel="jnp", device=dev)
    _, ids_q = serve_topk(gate_w, qt_all, calib_h, k, kernel="jnp", device=dev)
    eidx = top1_gate(gate_w, calib_h)[0].cpu().numpy()
    flips = (ids_ref != ids_q).any(dim=1).cpu().numpy()
    K = table.ids.shape[0]
    tok_e = np.bincount(eidx, minlength=K).astype(np.int64)
    flip_e = np.bincount(eidx, weights=flips.astype(np.float64), minlength=K)
    rate = flip_e / np.maximum(tok_e, 1)
    fb = rate > flip_threshold
    qtable = quantize_table(table, fb_mask=fb) if fb.any() else qt_all
    report = ExactnessReport(
        n_tokens=int(calib_h.shape[0]),
        n_flips_raw=int(flips.sum()),
        n_unguarded_flips=int(flips[~fb[eidx]].sum()),
        flip_threshold=float(flip_threshold),
        per_expert_flip_rate=tuple(float(r) for r in rate),
        fallback_experts=tuple(int(e) for e in np.nonzero(fb)[0]),
    )
    return qtable, report


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


def pack_experts(params, state: DSState, pad: Optional[int] = None,
                 quantize: Optional[str] = None) -> AnyServeTable:
    """Compact each expert's surviving rows into a padded static table, on
    the tensors' own device. ``pad`` must cover the largest expert — a
    smaller pad would drop surviving classes, so it raises instead.
    ``quantize='int8'`` returns a :class:`QuantizedServeTable` with no
    fallback experts (:func:`calibrate_quantized_table` gates one)."""
    if quantize not in (None, "int8"):
        raise ValueError(f"pack_experts quantize={quantize!r}: only 'int8' is supported")
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
    table = ServeTable(ids=ids, weights=weights)
    return quantize_table(table) if quantize == "int8" else table


def serve_kernel_context(table: AnyServeTable, h: torch.Tensor, k: int,
                         capacity_factor: float = 2.0) -> KernelContext:
    """The :class:`KernelContext` of one ``serve_topk`` call; the backend
    is the device type of ``h``, ``wbytes`` the element size of the rows
    the kernels stream (1 for an int8 table, which also prices its
    scales)."""
    return KernelContext(
        B=h.shape[0],
        d=h.shape[1],
        K=table.ids.shape[0],
        v_pad=table.ids.shape[1],
        k=k,
        backend=h.device.type,
        capacity_factor=capacity_factor,
        wbytes=table_rows(table).element_size(),
        hbytes=h.element_size(),
        quantized=isinstance(table, QuantizedServeTable),
    )


def serve_topk(gate_w: torch.Tensor, table: AnyServeTable, h: torch.Tensor, k: int, *,
               kernel="jnp", capacity_factor: float = 2.0, with_stats: bool = False,
               device="cuda"):
    """Top-k class retrieval (paper inference). h: (B, d) → values/ids (B, k).

    ``table`` is a :class:`ServeTable` or a :class:`QuantizedServeTable`.
    ``kernel`` is a registered name, a policy name, or a KernelPolicy:

    'jnp'           — per-token gather + product in plain PyTorch (oracle).
    'grouped'       — tokens grouped by top-1 expert, one (C, d)×(d, V_pad)
                      product per expert in plain PyTorch, exact overflow
                      fallback.
    'cuda_grouped'  — the same dispatch feeding the ``gate_top1`` and
                      ``dss_topk_grouped`` kernels.
    'cuda_fused'    — gate, dispatch and retrieval in one ``dss_topk_fused``
                      launch.
    'cuda_pertoken' — ``gate_top1``, then the per-token ``dss_topk`` kernel
                      with ``g`` folded into ``h``; fp tables only.
    'auto'          — cheapest feasible path by the registry's bytes model.

    On CPU tensors the kernel paths run their wrappers' plain versions.
    ``with_stats=True`` also returns ``{'dispatched': (K,), 'overflow':
    (K,)}`` int32 per-expert load telemetry.
    """
    dev = resolve_device(device)
    check_on(dev, gate_w=gate_w, h=h, table_ids=table.ids, table_rows=table_rows(table))
    kernel = resolve_kernel(kernel, serve_kernel_context(table, h, k, capacity_factor))
    if get_spec(kernel).fused:
        return _serve_topk_fused(gate_w, table, h, k, with_stats=with_stats)
    if kernel in ("cuda_grouped", "cuda_pertoken"):
        expert_idx, g = kops.gate_top1(gate_w, h, device=h.device)
    else:
        expert_idx, g, _ = top1_gate(gate_w, h)
    return _serve_topk_local(table, h, expert_idx, g, k, kernel,
                             capacity_factor=capacity_factor, with_stats=with_stats)


def _serve_topk_local(table: AnyServeTable, h, expert_idx, g, k: int, kernel: str, *,
                      capacity_factor: float = 2.0, with_stats: bool = False):
    """Retrieval after gating, for the non-fused paths."""
    overflow = None
    if kernel in ("grouped", "cuda_grouped"):
        vals, ids, overflow = _serve_topk_grouped(
            table, h, expert_idx, g, k, capacity_factor=capacity_factor,
            use_kernel=kernel == "cuda_grouped")
    elif kernel == "cuda_pertoken":
        vals, ids = kops.dss_topk(table.weights, table.ids, h, expert_idx, g, k,
                                  device=h.device)
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


# Bytes of gathered rows (with their fp32 copies) the gather path holds at
# once: it runs over the tokens in chunks of this size, so a calibration
# batch of hundreds of tokens at full width needs ~1 GiB, not ~18 GiB.
_GATHER_BUDGET = 1 << 30


def _exact_rows_logits(table: AnyServeTable, expert_idx, h):
    """Per-token gather-path logits: (B, V_pad) fp32 UN-gated ``z`` plus the
    gathered (B, V_pad) row ids, for both table kinds.

    Quantized rule (every path follows it, so all emit the same ids): the
    int8 rows cast to the token dtype, the fp32 product, THEN the per-row
    scale on the accumulator — never ``q·s`` premultiplied. (int8 → fp32
    is exact and equals the cast through the token dtype, |q| ≤ 127.)
    Tokens of fallback experts get their exact full-precision rows."""
    e = expert_idx.long()
    rows = table_rows(table)
    quantized = isinstance(table, QuantizedServeTable)
    fb = quantized and table.n_fallback > 0
    row_elems = table.v_pad * rows.shape[2]
    per_tok = row_elems * (rows.element_size() + 4)
    if fb:
        per_tok += row_elems * (table.fb_weights.element_size() + 4)
    step = max(1, _GATHER_BUDGET // per_tok)
    z = torch.empty((e.numel(), table.v_pad), dtype=torch.float32, device=h.device)
    for lo in range(0, e.numel(), step):
        ec, hc = e[lo: lo + step], h[lo: lo + step].float()[:, :, None]
        zc = torch.bmm(rows[ec].float(), hc)[:, :, 0]
        if quantized:
            zc = zc * table.scales[ec]
        if fb:
            row = table.fb_index[ec].long()
            z_fb = torch.bmm(table.fb_weights[row.clamp(min=0)].float(), hc)[:, :, 0]
            zc = torch.where((row >= 0)[:, None], z_fb, zc)
        z[lo: lo + step] = zc
    return z, table.ids[e]


def _exact_rows_topk(table: AnyServeTable, h, expert_idx, g, k: int):
    z, ids_sel = _exact_rows_logits(table, expert_idx, h)
    z = z * g[:, None]
    z = torch.where(ids_sel >= 0, z, NEG_INF)
    vals, pos = ref.topk_stable(z, k)
    return vals, torch.gather(ids_sel, 1, pos)


def _group_tokens(h, g, expert_idx, K: int, capacity: int):
    """Grouped-dispatch pre-pass: scatter tokens (UNscaled) and their fp32
    gate values into per-expert capacity buffers. Overflowed tokens and
    expert ids outside [0, K) (the sentinel K) are left out, as JAX's
    ``mode="drop"`` leaves them: they land in one trash row past the end,
    a mask instead of boolean indexing so nothing waits for the device.
    Returns (buf (K, C, d), g_buf (K, C), slot, valid)."""
    slot, valid = dispatch_indices(expert_idx, K, capacity)
    e = expert_idx.long()
    keep = valid & (e >= 0) & (e < K)
    row = torch.where(keep, e * capacity + slot.long(), K * capacity)
    buf = torch.zeros((K * capacity + 1, h.shape[-1]), dtype=h.dtype, device=h.device)
    buf[row] = h
    g_buf = torch.zeros((K * capacity + 1,), dtype=torch.float32, device=h.device)
    g_buf[row] = g.float()
    return (buf[:-1].view(K, capacity, -1), g_buf[:-1].view(K, capacity),
            slot, valid)


def _overflow_fixup(table: AnyServeTable, h, g, expert_idx, valid, vals, ids, k: int):
    """Exact fallback for every ~valid token through the gather path
    (capacity overflow, and on quantized tables the tokens of
    full-precision fallback experts): cost proportional to the actual
    overflow, the gathered rows bounded by ``_GATHER_BUDGET``."""
    over = torch.nonzero(~valid)[:, 0]
    if over.numel() == 0:
        return vals, ids
    vals[over], ids[over] = _exact_rows_topk(table, h[over], expert_idx[over], g[over], k)
    return vals, ids


def _serve_topk_grouped(table: AnyServeTable, h, expert_idx, g, k: int,
                        capacity_factor: float = 2.0, use_kernel: bool = False):
    """Expert-batched serving: one weight-stationary (C, d)×(d, V_pad)
    contraction per expert. ``use_kernel`` runs it through the
    ``dss_topk_grouped`` kernel, else through its plain version. Tokens
    overflowing an expert's capacity fall back to the gather path; on a
    quantized table so do the tokens of fallback experts, routed to the
    sentinel K before dispatch so they stay out of the int8 buffers and
    the overflow telemetry. Returns (vals, ids, overflow (K,) int32)."""
    B = h.shape[0]
    K = table.ids.shape[0]
    capacity = int(max(1, round(B / K * capacity_factor)))
    quantized = isinstance(table, QuantizedServeTable)
    scales = table.scales if quantized else None
    e_disp, fb_tok = expert_idx, None
    if quantized and table.n_fallback:
        fb_tok = table.fb_index[expert_idx.long()] >= 0
        e_disp = torch.where(fb_tok, K, expert_idx)
    buf, g_buf, slot, valid = _group_tokens(h, g, e_disp, K, capacity)
    _, overflow = dispatch_load(e_disp, K, valid)
    if fb_tok is not None:
        valid = valid & ~fb_tok
    rows = table_rows(table)
    if use_kernel:
        vals_b, ids_b = kops.dss_topk_grouped(rows, table.ids, buf, g_buf, k,
                                              scales=scales, device=h.device)
    else:
        vals_b, ids_b = ref.dss_topk_grouped_ref(rows, table.ids, buf, g_buf, k,
                                                 scales=scales)
    e, s = expert_idx.long(), slot.clamp(max=capacity - 1).long()
    vals, ids = vals_b[e, s], ids_b[e, s]
    vals, ids = _overflow_fixup(table, h, g, expert_idx, valid, vals, ids, k)
    return vals, ids, overflow


def _serve_topk_fused(gate_w, table: AnyServeTable, h, k: int, *, with_stats: bool = False):
    """Single-launch decode: gating, top-1 dispatch and retrieval all in
    the ``dss_topk_fused`` kernel. On a quantized table with fallback
    experts, their tokens are fixed up exactly outside the kernel through
    the gather path, with ``top1_gate``'s ``g``."""
    quantized = isinstance(table, QuantizedServeTable)
    vals, ids, eidx = kops.dss_topk_fused(
        gate_w, table_rows(table), table.ids, h, k,
        scales=table.scales if quantized else None, device=h.device)
    if quantized and table.n_fallback:
        fb_tok = table.fb_index[eidx.long()] >= 0
        _, g, _ = top1_gate(gate_w, h)
        vals, ids = _overflow_fixup(table, h, g, eidx, ~fb_tok, vals, ids, k)
    if not with_stats:
        return vals, ids
    dispatched, zero = dispatch_load(eidx, table.ids.shape[0])
    return vals, ids, {"dispatched": dispatched, "overflow": zero}
