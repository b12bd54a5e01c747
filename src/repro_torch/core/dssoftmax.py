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
``g``.

Training (``loss``, ``loss_rows``, ``update_mask``) follows the paper:
logits are scaled by the *un-renormalized* top-1 gate value (Eq. 2), and
pruned classes contribute ``exp(0)`` to the train normalizer in
``mask_mode='zero'`` or are excluded via ``NEG_INF`` in ``'neg_inf'``.
Gradients come from ``torch.autograd``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import DSSoftmaxConfig
from repro_torch.core import losses as L
from repro_torch.core import pruning
from repro_torch.core.dispatch import dispatch_indices, dispatch_load
from repro_torch.core.gating import sparse_gate_matrix, top1_gate
from repro_torch.device import check_on, on_card, resolve_device
from repro_torch.distributed import sharding
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.kernels.registry import KernelContext, get_spec, resolve_kernel

NEG_INF = ref.NEG_INF


class DSState(NamedTuple):
    mask: torch.Tensor  # (K, N) bool


class DSAux(NamedTuple):
    """Auxiliary losses + diagnostics returned by :func:`loss`."""

    lasso: torch.Tensor
    expert_lasso: torch.Tensor
    load: torch.Tensor
    drop_frac: torch.Tensor  # sorted dispatch only; 0.0 for dense
    gate_entropy: torch.Tensor


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

    def shard(self, mesh) -> "TableShard":
        """This rank's expert-parallel slice over ``mesh`` (:func:`shard_table`)."""
        return shard_table(self, mesh)


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

    def shard(self, mesh) -> "TableShard":
        """This rank's expert-parallel slice over ``mesh`` (:func:`shard_table`)."""
        return shard_table(self, mesh)


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
    leading-axis slice at a time so large tensors need no fp32 copy. A meta
    tensor has no values to fill (the dry-run's abstract build)."""
    if out.is_meta:
        return out
    rows = out.unsqueeze(0) if out.dim() < 3 else out
    for r in rows:
        r.copy_(torch.randn(r.shape, generator=generator, device=out.device) * scale)
    return out


def init(generator: torch.Generator, d: int, n_classes: int, cfg: DSSoftmaxConfig,
         dtype=torch.float32, n_valid: Optional[int] = None, device="cuda"):
    """Initialize params + state on ``device`` (``'meta'``: shapes only,
    for the dry-run). Experts start as full softmaxes (paper); columns ≥
    ``n_valid`` start (and stay) masked."""
    dev = resolve_device(device, meta=True)
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


def abstract_params(d: int, n_classes: int, cfg: DSSoftmaxConfig, dtype=torch.bfloat16):
    """Meta-tensor stand-ins of :func:`init`'s params and state (for the
    dry-run: no allocation)."""
    K = cfg.num_experts
    meta = lambda *shape, dtype=dtype: torch.empty(shape, dtype=dtype, device="meta")
    return ({"gate": meta(K, d), "experts": meta(K, n_classes, d)},
            DSState(mask=meta(K, n_classes, dtype=torch.bool)))


# ---------------------------------------------------------------------------
# Training forward / loss
# ---------------------------------------------------------------------------


def _masked_logits(z: torch.Tensor, mask: torch.Tensor, mode: str) -> torch.Tensor:
    """Apply the class mask to raw logits z (…, N) with mask (…, N)."""
    if mode == "zero":
        # Faithful: pruned rows are zero weights => logit exactly 0.
        return z * mask.to(z.dtype)
    return torch.where(mask, z, NEG_INF)


def logits_dense(params, state: DSState, h: torch.Tensor, cfg: DSSoftmaxConfig):
    """Reference path: full (T, N) mixture logits via the sparse gate.

    h: (T, d) → logits (T, N) float32, plus (expert_idx, g, G). Every
    expert's logits for every token (O(K·T·N·d)), then the one-hot select."""
    expert_idx, g, G = top1_gate(params["gate"], h)
    w = pruning.apply_mask(params["experts"], state.mask)  # (K, N, d)
    z_all = torch.einsum("td,knd->tkn", h.float(), w.float())
    Gs = sparse_gate_matrix(G)  # (T, K) — only top-1 nonzero, grads flow
    z = torch.einsum("tkn,tk->tn", z_all, Gs)
    sel_mask = state.mask[expert_idx.long()]  # (T, N)
    return _masked_logits(z, sel_mask, cfg.mask_mode), (expert_idx, g, G)


def _scatter_rows(values: torch.Tensor, row: torch.Tensor, n_rows: int) -> torch.Tensor:
    """A (n_rows, …) buffer of zeros with ``values[i]`` written at row
    ``row[i]``. ``row == n_rows`` is a trash row, cut off before return:
    the writes JAX's ``mode="drop"`` would drop land there. The gradient
    reaches every value written to a kept row and is zero for the others."""
    buf = torch.zeros((n_rows + 1,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    return buf.index_put((row,), values)[:n_rows]


def _aux(sq, cfg: DSSoftmaxConfig, G, Gs, drop, mesh=None) -> DSAux:
    """The aux losses from ``sq``: the masked rows' sums of squares (K, N)
    and the experts' (K,); with ``mesh`` (the mesh train step's) the gate's
    per-expert sums and its entropy are over every batch rank's tokens."""
    ent = torch.sum(G * torch.log(G + 1e-10), dim=-1)
    return DSAux(
        lasso=L.group_lasso_of(sq[0], cfg.gamma),
        expert_lasso=L.expert_lasso_of(sq[1]),
        load=L.load_balance(sharding.batch_sum(torch.sum(Gs.reshape(-1, Gs.shape[-1]), dim=0),
                                               mesh)),
        drop_frac=drop,
        gate_entropy=-sharding.batch_mean(ent.reshape(-1), mesh),
    )


def loss(params, state: DSState, h: torch.Tensor, labels: torch.Tensor,
         cfg: DSSoftmaxConfig, *, dispatch: str = "dense", capacity_factor: float = 2.0):
    """Mean cross-entropy + the paper's aux losses.

    h: (T, d), labels: (T,) int. Returns (task_ce, DSAux). Total train
    objective = task_ce + λ_lasso·lasso + λ_expert·expert + λ_load·load
    (assembled by the caller, :func:`total_loss`).

    ``dispatch='dense'`` is the exact reference (every expert's logits);
    ``'sorted'`` groups tokens by top-1 expert into (K, C, d) buffers, C =
    round(T/K·capacity_factor), one product per expert; tokens past an
    expert's capacity are dropped from the mean (``drop_frac``)."""
    T, d = h.shape
    K, N, _ = params["experts"].shape
    if dispatch == "dense":
        z, (expert_idx, g, G) = logits_dense(params, state, h, cfg)
        ce = _ce_from_logits(z, labels)
        drop = torch.zeros((), dtype=torch.float32, device=h.device)
    elif dispatch == "sorted":
        expert_idx, g, G = top1_gate(params["gate"], h)
        capacity = int(max(1, round(T / K * capacity_factor)))
        slot, valid = dispatch_indices(expert_idx, K, capacity)
        e = expert_idx.long()
        w = pruning.apply_mask(params["experts"], state.mask)
        g_kept = torch.sum(sparse_gate_matrix(G), dim=-1)  # == g, with Eq-1 gradients
        row = torch.where(valid, e * capacity + slot.long(), K * capacity)
        buf = _scatter_rows(h, row, K * capacity).view(K, capacity, d)
        lab_buf = _scatter_rows(labels.long(), row, K * capacity).view(K, capacity)
        g_buf = _scatter_rows(g_kept, row, K * capacity).view(K, capacity)
        z = torch.einsum("kcd,knd->kcn", buf.float(), w.float()) * g_buf[..., None]
        z = _masked_logits(z, state.mask[:, None, :], cfg.mask_mode)
        ce_buf = _ce_from_logits(z.reshape(K * capacity, N), lab_buf.reshape(-1),
                                 mean=False).reshape(K, capacity)
        tok_ce = torch.where(valid, ce_buf[e, slot.long().clamp(max=capacity - 1)], 0.0)
        n_valid = torch.clamp(torch.sum(valid.float()), min=1.0)
        ce = torch.sum(tok_ce) / n_valid
        drop = 1.0 - n_valid / T
    else:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    sq = (L.per_expert(L.row_sq, params["experts"], state.mask),
          L.per_expert(L.frobenius_sq, params["experts"], state.mask))
    return ce, _aux(sq, cfg, G, sparse_gate_matrix(G), drop)


def _ce_chunk(buf_i, lab_i, g_i, w32, mask, mode: str):
    """CE of one capacity chunk of one expert: buf_i (B, cc, d), lab_i/g_i
    (B, cc), the expert's masked rows w32 (N, d) fp32 and mask (N,) → (B,
    cc)."""
    z = torch.einsum("bcd,nd->bcn", buf_i.float(), w32) * g_i[..., None]
    z = _masked_logits(z, mask, mode)
    return _ce_from_logits(z, lab_i, mean=False)


def _expert_ce(w, mask, buf, lab, g, n_chunks: int, mode: str, gather):
    """One expert's part of :func:`loss_rows`: its rows ``w`` (N, d) (with
    ``gather``, this rank's block of them, gathered whole here), masked and
    widened to fp32 once, the CE of its capacity slots buf (B, C, d), lab
    and g (B, C) in ``n_chunks`` chunks under ``checkpoint``, and the masked
    rows' sums of squares → (CE (B, C), (row sums (N,), their total))."""
    if gather is not None:
        w = gather.expert("head/experts", w)
    # each read of the rows widens them on its own, as ``repro``'s CE and
    # lassos do, so their gradients meet at the rows in the rows' dtype:
    # the Frobenius sum taken as the row sums' total (one widening for both
    # lassos) parts the bf16 mesh step's grad norm from the single-device
    # step's by more than 1e-3 at 2x1 and 2x2
    w32 = pruning.apply_mask(w, mask).float()
    sq = (L.row_sq(w, mask), L.frobenius_sq(w, mask))
    if n_chunks == 1:
        return _ce_chunk(buf, lab, g, w32, mask, mode), sq
    cc = buf.shape[1] // n_chunks
    return torch.cat([
        checkpoint(_ce_chunk, *(t[:, i * cc:(i + 1) * cc] for t in (buf, lab, g)), w32, mask,
                   mode, use_reentrant=False)
        for i in range(n_chunks)], dim=1), sq


def loss_rows(params, state: DSState, h: torch.Tensor, labels: torch.Tensor,
              cfg: DSSoftmaxConfig, *, capacity_factor: float = 1.25,
              label_mask: Optional[torch.Tensor] = None, mesh=None, gather=None):
    """Sorted-dispatch CE over batched rows. h: (B, S, d), labels: (B, S).

    Tokens are grouped by expert *within each row*: the B rows dispatch at
    once over B·K row-offset expert ids (a stable sort groups by row, then
    by expert, keeping each row's token order), into (B, K, C, d) buffers
    with C = round(S/K·capacity_factor). Then one expert at a time
    (:func:`_expert_ce`, under ``torch.utils.checkpoint``): its rows masked
    and widened to fp32, its capacity in chunks under a checkpoint of their
    own (n // K chunks, where n ≤ 8 chunks of at least 8 slots would split
    the K experts' capacity together), so one chunk's (B, cc, N) fp32
    logits and one expert's (N, d) fp32 rows are live at a time and the
    backward recomputes them;
    the lassos read the (K, N) sums of squares it keeps. No fp32 or masked
    copy of the whole (K, N, d) experts exists. ``label_mask`` (B, S)
    excludes positions from the CE. ``mesh`` (the mesh train step's: the
    rows are this rank's batch share) makes the CE, its token counts and
    the gate statistics the whole batch's (``sharding.batch_sum``);
    ``gather`` (its ``TrainParamGather``): ``params["experts"]`` is this
    rank's block, each expert's rows gathered inside its region. Returns
    (task_ce, DSAux)."""
    B, S, d = h.shape
    K = state.mask.shape[0]
    expert_idx, g, G = top1_gate(params["gate"], h)          # (B,S), (B,S), (B,S,K)
    Gs = sparse_gate_matrix(G)
    g_kept = torch.sum(Gs, dim=-1)                           # (B,S) — g with Eq-1 grads
    capacity = int(max(1, round(S / K * capacity_factor)))

    rows = torch.arange(B, device=h.device)[:, None]
    e_flat = (rows * K + expert_idx.long()).reshape(-1)      # row-offset expert ids
    slot, valid = dispatch_indices(e_flat, B * K, capacity)
    n_slots = B * K * capacity
    row = torch.where(valid, e_flat * capacity + slot.long(), n_slots)
    buf = _scatter_rows(h.reshape(B * S, d), row, n_slots).view(B, K, capacity, d)
    lab_buf = _scatter_rows(labels.reshape(-1).long(), row, n_slots).view(B, K, capacity)
    g_buf = _scatter_rows(g_kept.reshape(-1), row, n_slots).view(B, K, capacity)

    n_chunks = 1  # the K experts' capacity together: up to 8 chunks of 8 slots or more
    for cand in (8, 4, 2):
        if capacity % cand == 0 and capacity // cand >= 8:
            n_chunks = cand
            break
    # one expert's capacity in n_chunks // K of them: a chunk's (B, cc, N)
    # fp32 logits are at most an n_chunks-th of the K experts' (B, K, C, N)
    n_chunks = max(1, n_chunks // K)
    # the experts' gradient is one stack of the K experts' (unbind's
    # backward), not K zero tensors of the whole head added up
    per = [checkpoint(_expert_ce, w, state.mask[e], buf[:, e], lab_buf[:, e], g_buf[:, e],
                      n_chunks, cfg.mask_mode, gather, use_reentrant=False)
           for e, w in enumerate(params["experts"].unbind(0))]
    ce_buf = torch.stack([c for c, _ in per], dim=1)        # (B, K, C)
    sq = (torch.stack([q for _, (q, _) in per]),            # (K, N)
          torch.stack([f for _, (_, f) in per]))            # (K,)

    tok_ce = ce_buf.reshape(-1)[torch.where(valid, row, 0)]
    tok_ce = torch.where(valid, tok_ce, 0.0).view(B, S)
    valid = valid.view(B, S)
    if label_mask is not None:
        valid = valid & label_mask.bool()
    nb = sharding.batch_ranks(mesh)
    n_valid = torch.clamp(sharding.batch_sum(torch.sum(valid.float()), mesh), min=1.0)
    ce = sharding.batch_sum(torch.sum(torch.where(valid, tok_ce, 0.0)), mesh) / n_valid
    if label_mask is None:  # a Python count: no host-to-device copy
        drop = 1.0 - n_valid / (B * S * nb)
    else:
        drop = 1.0 - n_valid / torch.clamp(
            sharding.batch_sum(torch.sum(label_mask.float()), mesh), min=1.0)
    return ce, _aux(sq, cfg, G, Gs, drop, mesh)


def total_loss(params, state, h, labels, cfg: DSSoftmaxConfig, **kw):
    """task CE + λ-weighted aux losses (paper Algorithm 1's L_all)."""
    ce, aux = loss(params, state, h, labels, cfg, **kw)
    full = (ce + cfg.lambda_lasso * aux.lasso + cfg.lambda_expert * aux.expert_lasso
            + cfg.lambda_load * aux.load)
    return full, (ce, aux)


def _ce_from_logits(z: torch.Tensor, labels: torch.Tensor, mean: bool = True) -> torch.Tensor:
    """CE from fp32 logits: logsumexp minus the gold logit."""
    lse = torch.logsumexp(z, dim=-1)
    gold = torch.gather(z, -1, labels.long()[..., None])[..., 0]
    ce = lse - gold
    return torch.mean(ce) if mean else ce


# ---------------------------------------------------------------------------
# Pruning step (between optimizer steps)
# ---------------------------------------------------------------------------


def update_mask(params, state: DSState, task_loss, cfg: DSSoftmaxConfig,
                norm_group=None) -> DSState:
    """Algorithm 1's prune: the new mask, gated on ``task_loss`` (a 0-d
    tensor or a float) below ``cfg.prune_task_loss_threshold``.
    ``norm_group``: the experts' ``d`` is split over it (the mesh train
    step's blocks; ``pruning.prune_step``)."""
    return DSState(mask=pruning.prune_step(
        params["experts"], state.mask, task_loss, gamma=cfg.gamma,
        threshold=cfg.prune_task_loss_threshold, norm_group=norm_group))


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
                         capacity_factor: float = 2.0, ep: int = 1,
                         ndata: int = 1) -> KernelContext:
    """The :class:`KernelContext` of one ``serve_topk`` call; the backend
    is the device type of ``h``, ``wbytes`` the element size of the rows
    the kernels stream (1 for an int8 table, which also prices its
    scales). ``ep``/``ndata``: the degrees of a ``serve_topk_sharded``
    call."""
    return KernelContext(
        B=h.shape[0],
        d=h.shape[1],
        K=table.ids.shape[0],
        v_pad=table.ids.shape[1],
        k=k,
        # a meta trace (the dry-run) prices the paths as the card runs them
        backend="cuda" if on_card(h) else h.device.type,
        capacity_factor=capacity_factor,
        wbytes=table_rows(table).element_size(),
        hbytes=h.element_size(),
        quantized=isinstance(table, QuantizedServeTable),
        ep=ep,
        ndata=ndata,
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
    dev = resolve_device(device, meta=True)
    check_on(dev, gate_w=gate_w, h=h, table_ids=table.ids, table_rows=table_rows(table))
    kernel = resolve_kernel(kernel, serve_kernel_context(table, h, k, capacity_factor))
    if get_spec(kernel).sharded:
        raise ValueError(f"serve kernel {kernel!r} is an expert-parallel path; call "
                         "serve_topk_sharded(..., mesh=...) (or pass a mesh through "
                         "ServeSession)")
    vals, ids, _, stats = serve_topk_local_half(
        gate_w, TableShard(table, table.ids.shape[0], 0), h, k, kernel,
        capacity_factor=capacity_factor, with_stats=with_stats)
    return (vals, ids, stats) if with_stats else (vals, ids)


def _serve_topk_local(table: AnyServeTable, h, expert_idx, g, k: int, kernel: str, *,
                      capacity_factor: float = 2.0, owned=None,
                      n_experts_global: Optional[int] = None, with_stats: bool = False):
    """Retrieval after gating, for the non-fused paths; shared by
    ``serve_topk`` and each rank of ``serve_topk_sharded``.

    ``expert_idx`` is LOCAL to ``table`` (clipped into range by the sharded
    caller). ``owned`` (B,) bool marks the tokens this rank answers for:
    the others stay out of the grouped dispatch and the overflow fixup,
    and their rows come out ``(NEG_INF, -1)``. ``n_experts_global`` sizes
    the grouped capacity by the global expert count (a rank sees the same
    tokens per expert as the whole run)."""
    overflow = None
    if kernel in ("grouped", "cuda_grouped"):
        vals, ids, overflow = _serve_topk_grouped(
            table, h, expert_idx, g, k, capacity_factor=capacity_factor,
            use_kernel=kernel == "cuda_grouped", owned=owned,
            n_experts_global=n_experts_global)
    elif kernel == "cuda_pertoken":
        vals, ids = kops.dss_topk(table.weights, table.ids, h, expert_idx, g, k,
                                  device=h.device)
    elif kernel != "jnp":
        raise NotImplementedError(f"registered serve kernel {kernel!r} has no dispatch branch")
    else:
        vals, ids = _exact_rows_topk(table, h, expert_idx, g, k)
    if owned is not None:
        vals = torch.where(owned[:, None], vals, NEG_INF)
        ids = torch.where(owned[:, None], ids, -1)
    if not with_stats:
        return vals, ids
    K = table.ids.shape[0]
    # tokens of other ranks count at the sentinel K, which is dropped
    dispatched, zero = dispatch_load(
        expert_idx if owned is None else torch.where(owned, expert_idx, K), K)
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
    overflow, the gathered rows bounded by ``_GATHER_BUDGET``. A meta
    trace (the dry-run) has no data to find the overflow from and counts
    it as none."""
    if h.is_meta:
        return vals, ids
    over = torch.nonzero(~valid)[:, 0]
    if over.numel() == 0:
        return vals, ids
    vals[over], ids[over] = _exact_rows_topk(table, h[over], expert_idx[over], g[over], k)
    return vals, ids


def _serve_topk_grouped(table: AnyServeTable, h, expert_idx, g, k: int,
                        capacity_factor: float = 2.0, use_kernel: bool = False,
                        owned=None, n_experts_global: Optional[int] = None):
    """Expert-batched serving: one weight-stationary (C, d)×(d, V_pad)
    contraction per expert. ``use_kernel`` runs it through the
    ``dss_topk_grouped`` kernel, else through its plain version. Tokens
    overflowing an expert's capacity fall back to the gather path; on a
    quantized table so do the tokens of fallback experts, routed to the
    sentinel K before dispatch so they stay out of the int8 buffers and
    the overflow telemetry. Tokens another rank owns (``owned`` False) go
    to the sentinel too and count as valid, so they never reach the fixup;
    ``n_experts_global`` sizes the capacity by the global expert count.
    Returns (vals, ids, overflow (K,) int32): the owned tokens that paid
    the fixup, per expert."""
    B = h.shape[0]
    K = table.ids.shape[0]
    capacity = int(max(1, round(B / (n_experts_global or K) * capacity_factor)))
    quantized = isinstance(table, QuantizedServeTable)
    scales = table.scales if quantized else None
    e_disp = expert_idx if owned is None else torch.where(owned, expert_idx, K)
    fb_tok = None
    if quantized and table.n_fallback:
        fb_tok = table.fb_index[expert_idx.long()] >= 0
        if owned is not None:
            fb_tok = fb_tok & owned
        e_disp = torch.where(fb_tok, K, e_disp)
    buf, g_buf, slot, valid = _group_tokens(h, g, e_disp, K, capacity)
    # counted before other ranks' tokens are marked valid: the owned tokens
    # that pay the fixup here
    _, overflow = dispatch_load(e_disp, K, valid)
    if fb_tok is not None:
        valid = valid & ~fb_tok
    if owned is not None:
        valid = valid | ~owned
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


def _serve_topk_fused(gate_w, shard: "TableShard", h, k: int, *, with_stats: bool = False):
    """Single-launch decode: gating over every expert, top-1 dispatch and
    retrieval over the shard's rows all in the ``dss_topk_fused`` kernel
    (``e_base`` = the shard's first expert). On a quantized table with
    fallback experts, their tokens are fixed up exactly outside the kernel
    through the gather path, with ``top1_gate``'s ``g``. → as
    :func:`serve_topk_local_half`."""
    tbl = shard.local
    quantized = isinstance(tbl, QuantizedServeTable)
    vals, ids, eidx = kops.dss_topk_fused(
        gate_w, table_rows(tbl), tbl.ids, h, k,
        scales=tbl.scales if quantized else None, e_base=shard.lo, device=h.device)
    owned, e_loc = _owned(shard, eidx)
    if owned is not None:
        # the kernel's -inf rows of other ranks' tokens become the finite padding
        vals = torch.where(owned[:, None], vals, NEG_INF)
        ids = torch.where(owned[:, None], ids, -1)
    if quantized and tbl.n_fallback:
        fb_tok = tbl.fb_index[e_loc.long()] >= 0
        if owned is not None:
            fb_tok = fb_tok & owned
        _, g, _ = top1_gate(gate_w, h)
        vals, ids = _overflow_fixup(tbl, h, g, e_loc, ~fb_tok, vals, ids, k)
    if not with_stats:
        return vals, ids, eidx, None
    K_loc = tbl.ids.shape[0]
    # tokens of other ranks count at the sentinel K_loc, which is dropped
    dispatched, zero = dispatch_load(e_loc if owned is None else torch.where(owned, e_loc, K_loc),
                                     K_loc)
    return vals, ids, eidx, {"dispatched": dispatched, "overflow": zero}


# ---------------------------------------------------------------------------
# Expert-parallel sharded serving
# ---------------------------------------------------------------------------


class TableShard(NamedTuple):
    """One rank's expert-parallel slice of a serve table (:func:`shard_table`).

    local:     the rows of experts ``[lo, lo + K_loc)`` of the padded table,
               a :class:`ServeTable` or a :class:`QuantizedServeTable`
               (whose ``fb_weights`` stay whole: ``fb_index`` holds global
               rows into them).
    n_experts: K_pad, the padded global expert count (a multiple of ep).
    lo:        the global id of ``local``'s first expert."""

    local: AnyServeTable
    n_experts: int
    lo: int

    @property
    def v_pad(self) -> int:
        return self.local.ids.shape[1]


def _pad_table_experts(table: AnyServeTable, ep: int) -> AnyServeTable:
    """Append all-padding dummy experts so that ``ep`` divides K (gating
    never routes to them: the gate keeps the real K rows)."""
    K = table.ids.shape[0]
    K_pad = -(-K // ep) * ep
    if K_pad == K:
        return table
    n = K_pad - K
    ids = torch.cat([table.ids, torch.full((n, table.v_pad), -1, dtype=table.ids.dtype,
                                           device=table.ids.device)])
    rows = table_rows(table)
    zeros = torch.zeros((n,) + tuple(rows.shape[1:]), dtype=rows.dtype, device=rows.device)
    if isinstance(table, QuantizedServeTable):
        return QuantizedServeTable(
            ids=ids,
            qweights=torch.cat([table.qweights, zeros]),
            # scale 1.0 on dummy rows keeps the dequantization defined
            scales=torch.cat([table.scales, torch.ones((n, table.v_pad), dtype=table.scales.dtype,
                                                       device=table.scales.device)]),
            fb_index=torch.cat([table.fb_index, torch.full((n,), -1, dtype=table.fb_index.dtype,
                                                           device=table.fb_index.device)]),
            fb_weights=table.fb_weights)
    return ServeTable(ids=ids, weights=torch.cat([table.weights, zeros]))


def _mesh_degrees(mesh) -> tuple:
    """(ep, ndata): the ``model`` axis' size and the product of the
    ``pod``/``data`` axes' sizes."""
    from repro_torch.distributed.sharding import batch_size_on, mesh_sizes

    return int(mesh_sizes(mesh).get("model", 1)), batch_size_on(mesh)


def table_shard(table: AnyServeTable, ep: int, rank: int) -> TableShard:
    """The slice of ``table`` that model rank ``rank`` of ``ep`` holds under
    ``serve_table_ep_shardings``: K padded to a multiple of ep, experts
    ``[rank·K_loc, (rank+1)·K_loc)`` kept (copies, so the whole table can
    be freed; at ep 1 the table's own tensors)."""
    from repro_torch.distributed.sharding import serve_table_ep_shardings, slice_leaf

    table = _pad_table_experts(table, ep)
    specs = serve_table_ep_shardings(None, table)
    local = type(table)(*(slice_leaf(x, spec, {"model": ep}, {"model": rank})
                          for x, spec in zip(table, specs)))
    K_pad = table.ids.shape[0]
    return TableShard(local=local, n_experts=K_pad, lo=rank * (K_pad // ep))


def shard_table(table, mesh) -> TableShard:
    """Expert-parallel placement of a packed serve table (either kind) on
    this rank: :func:`table_shard` at this rank's ``model`` coordinate.
    Replicated over the batch axes, which split tokens at call time. A
    :class:`TableShard` passes through."""
    from repro_torch.distributed.sharding import axis_index

    if isinstance(table, TableShard):
        return table
    ep, _ = _mesh_degrees(mesh)
    return table_shard(table, ep, axis_index(mesh, "model"))


def _owned(shard: TableShard, expert_idx):
    """(owned (B,) bool, local expert ids) of the tokens whose GLOBAL
    expert lies in the shard's ``[lo, lo + K_loc)``; ``owned`` is None when
    the shard holds every expert (a single-device call), which then pays
    no mask."""
    K_loc = shard.local.ids.shape[0]
    if K_loc == shard.n_experts:
        return None, expert_idx
    owned = (expert_idx >= shard.lo) & (expert_idx < shard.lo + K_loc)
    return owned, (expert_idx - shard.lo).clamp(0, K_loc - 1)


def serve_topk_local_half(gate_w, shard: TableShard, h, k: int, kernel: str, *,
                          capacity_factor: float = 2.0, with_stats: bool = False):
    """One rank's half of :func:`serve_topk_sharded`, with no collective,
    and the whole of :func:`serve_topk` (on a shard of every expert): the
    gate over every expert, the tokens this rank owns (those whose expert
    lies in ``[lo, lo + K_loc)``) and their retrieval over the local rows
    through the per-rank path ``kernel`` (a base name). → (vals, ids,
    expert_idx (B,) GLOBAL, stats or None): rows of other ranks' tokens are
    ``(NEG_INF, -1)``; ``stats`` is the (K_loc,) ``{'dispatched',
    'overflow'}`` of the owned tokens."""
    if get_spec(kernel).fused:
        return _serve_topk_fused(gate_w, shard, h, k, with_stats=with_stats)
    if kernel in ("cuda_grouped", "cuda_pertoken"):
        eidx, g = kops.gate_top1(gate_w, h, device=h.device)
    else:
        eidx, g, _ = top1_gate(gate_w, h)
    owned, e_loc = _owned(shard, eidx)
    out = _serve_topk_local(shard.local, h, e_loc, g, k, kernel,
                            capacity_factor=capacity_factor, owned=owned,
                            n_experts_global=shard.n_experts, with_stats=with_stats)
    return out[0], out[1], eidx, (out[2] if with_stats else None)


def merge_carries(vals_all, ids_all, expert_idx, k_loc: int):
    """The merge of :func:`serve_topk_sharded`: from the ranks' stacked
    (ep, B, k) carries, each token's row from the rank that owns its
    expert (``expert_idx // k_loc``)."""
    owner = expert_idx.long() // k_loc
    rows = torch.arange(expert_idx.shape[0], device=expert_idx.device)
    return vals_all[owner, rows], ids_all[owner, rows]


def serve_topk_sharded(gate_w, table, h, k: int, *, mesh, kernel="auto",
                       capacity_factor: float = 2.0, with_stats: bool = False,
                       h_local: bool = False):
    """Mesh-sharded top-k retrieval, run by every rank of ``mesh`` on the
    same (B, d) ``h``: experts over ``model``, tokens over ``pod``/``data``
    (when they divide B), one O(B·k) all-gather merge. → (B, k) values
    and ids on every rank. ``h_local=True``: ``h`` is already this rank's
    block of the B rows (batch rank r of n_b holds rows ``[r·B/n_b,
    (r+1)·B/n_b)``, what ``batch_pspec`` places; a slot-split session's
    step), so the rank takes no slice of it; the result is the same
    merged (B, k) in global row order.

    Ids equal the single-device :func:`serve_topk`'s bit for bit: the gate
    is computed on every rank, exactly one rank owns each token's expert,
    and that rank runs the same per-rank path over the same rows.
    ``table``: a :class:`TableShard` of this rank, or a whole table (placed
    here by :func:`shard_table`). ``kernel`` resolves with the call's
    (ep, ndata): ``'auto'`` picks among the ``*_ep`` specs at ep > 1, a
    base name forces that per-rank path.

    The only collectives: the (B_loc, k) fp32 value and int32 id carries
    over ``model``, the merged rows over the batch axes when tokens were
    split, and with ``with_stats=True`` the (K_loc,) counts (summed over
    the batch axes, then gathered over ``model``): ``{'dispatched',
    'overflow'}`` of length K_pad, global, on every rank."""
    from repro_torch.distributed.sharding import (axis_group, batch_axes, batch_pspec,
                                                  collective, mesh_coords, mesh_sizes,
                                                  slice_leaf)

    if h.device.type != mesh.device_type and not h.is_meta:  # meta: the dry-run's trace
        raise ValueError(f"h lies on {h.device}, the mesh on {mesh.device_type}")
    shard = shard_table(table, mesh)
    ep, ndata = _mesh_degrees(mesh)
    sizes = mesh_sizes(mesh)
    B = h.shape[0] * (ndata if h_local else 1)
    K_loc = shard.local.ids.shape[0]
    # tokens split over the batch axes where batch_pspec places them
    h_spec = batch_pspec(mesh, B)
    b_split = ndata if ndata > 1 and h_spec[0] is not None else 1
    if h_local and b_split == 1 and ndata > 1:
        raise ValueError(f"h_local: {B} rows do not split over {ndata} batch ranks")
    ctx = dataclasses.replace(serve_kernel_context(shard.local, h, k, capacity_factor,
                                                   ep=ep, ndata=b_split), K=shard.n_experts, B=B)
    spec = get_spec(resolve_kernel(kernel, ctx))
    local_name = spec.local_name or spec.name
    bax = tuple(a for a in batch_axes(mesh) if sizes[a] > 1)
    if b_split > 1 and not h_local:
        h = slice_leaf(h, h_spec, sizes, mesh_coords(mesh))
    vals, ids, eidx, stats = serve_topk_local_half(
        gate_w, shard, h, k, local_name, capacity_factor=capacity_factor,
        with_stats=with_stats)
    model = axis_group(mesh, "model")
    vals, ids = merge_carries(collective(vals, model), collective(ids, model), eidx, K_loc)
    if b_split > 1:
        data = axis_group(mesh, bax)
        vals = collective(vals, data).reshape(B, k)
        ids = collective(ids, data).reshape(B, k)
    if not with_stats:
        return vals, ids
    out = {}
    for key, count in stats.items():
        if b_split > 1:
            count = collective(count, axis_group(mesh, bax), "all_reduce")
        out[key] = collective(count, model).reshape(-1)
    return vals, ids, out


def as_serve_table(table):
    """Unwrap a versioned table resource to its current table: anything
    exposing a ``.table`` that is a :class:`ServeTable` or
    :class:`QuantizedServeTable` (``serve.table_manager.TableResource``)
    unwraps to it; a raw table passes through unchanged."""
    inner = getattr(table, "table", None)
    return inner if isinstance(inner, (ServeTable, QuantizedServeTable)) else table


def serve_full_probs(gate_w: torch.Tensor, table, h: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    """Full sparse categorical distribution (probability mass only on the
    chosen expert's surviving classes). For evaluation/debug. (B, N)."""
    table = as_serve_table(table)
    expert_idx, g, _ = top1_gate(gate_w, h)
    z, ids_sel = _exact_rows_logits(table, expert_idx, h.float())
    z = torch.where(ids_sel >= 0, z * g[:, None], NEG_INF)
    p = torch.softmax(z, dim=-1)
    out = torch.zeros((h.shape[0], n_classes), dtype=torch.float32, device=h.device)
    return out.scatter_add_(1, ids_sel.long().clamp(min=0), torch.where(ids_sel >= 0, p, 0.0))
