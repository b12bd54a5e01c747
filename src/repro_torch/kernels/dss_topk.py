"""Per-token DS-Softmax retrieval (the legacy serve path, fp tables only).

Wrapper over ``csrc/dss_topk.cu`` (replaces the Pallas kernel
``repro/kernels/dss_topk.py::dss_topk``). Each token streams only its own
expert's packed rows against ``h_scaled``, the token already multiplied
by its gate value (``ops.dss_topk`` does the fold), and the ``(B, k)``
result comes out directly: no per-block candidate spill and second top-k
as on the TPU. An expert with fewer than k real rows fills the tail with
its padding rows, ``(-1e9, -1)``. For CPU tensors it runs the plain
version, ``ref.dss_topk_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import _build, ref


def dss_topk(weights, ids, h_scaled, expert_idx, k: int = 8, *, device="cuda"):
    """weights (K, V_pad, d) and h_scaled (B, d) of one dtype (float32 or
    bfloat16), ids (K, V_pad) int32 with -1 as padding, expert_idx (B,)
    int32 in [0, K) → (vals (B, k) fp32, ids (B, k) int32)."""
    dev = resolve_device(device)
    check_on(dev, weights=weights, ids=ids, h_scaled=h_scaled, expert_idx=expert_idx)
    if weights.dtype == torch.int8:
        raise TypeError("dss_topk serves fp tables only; int8 rows take "
                        "dss_topk_grouped or dss_topk_fused")
    if dev.type == "cpu":
        return ref.dss_topk_ref(weights, ids, h_scaled, expert_idx, k)
    K, v_pad, d = weights.shape
    B = h_scaled.shape[0]
    if h_scaled.shape != (B, d) or ids.shape != (K, v_pad) or expert_idx.shape != (B,):
        raise ValueError(
            f"shapes disagree: weights {tuple(weights.shape)}, ids {tuple(ids.shape)}, "
            f"h_scaled {tuple(h_scaled.shape)}, expert_idx {tuple(expert_idx.shape)}")
    if weights.dtype != h_scaled.dtype or ids.dtype != torch.int32 \
            or expert_idx.dtype != torch.int32:
        raise TypeError("weights and h_scaled must share a dtype; ids and expert_idx int32")
    if not 1 <= k <= min(_build.MAX_K, v_pad):
        raise ValueError(f"k={k} must be in [1, min(64, v_pad={v_pad})]")
    weights, ids, h_scaled, expert_idx = (
        t.contiguous() for t in (weights, ids, h_scaled, expert_idx))
    nsplit, tps = _build.vocab_split(v_pad, max(B, 1))
    out_v = torch.empty((B, k), dtype=torch.float32, device=h_scaled.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=h_scaled.device)
    part_v = part_i = None
    if nsplit > 1:
        part_v = torch.empty((nsplit, B, k), dtype=torch.float32, device=h_scaled.device)
        part_i = torch.empty((nsplit, B, k), dtype=torch.int32, device=h_scaled.device)
    lib = _build.load("dss_topk")
    err = lib.dss_topk(
        weights.data_ptr(), ids.data_ptr(), h_scaled.data_ptr(), expert_idx.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(), _build.ptr(part_v), _build.ptr(part_i),
        K, B, v_pad, d, k, nsplit, tps, _build.dtype_code(h_scaled),
        torch.cuda.current_stream(h_scaled.device).cuda_stream)
    _build.check(lib, err, "dss_topk")
    dss_topk.launches += 1
    return out_v, out_i


dss_topk.launches = 0
