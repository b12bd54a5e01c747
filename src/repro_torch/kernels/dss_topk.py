"""Per-token DS-Softmax retrieval (the legacy serve path, fp tables only).

Wrapper over ``csrc/dss_topk.cu`` (replaces the Pallas kernel
``repro/kernels/dss_topk.py::dss_topk``). Each token is scored against
only its own expert's packed rows, ``h_scaled`` being the token already
multiplied by its gate value (``ops.dss_topk`` does the fold). The kernel
is the streaming retrieval of the decode kernels
(``csrc/retrieve_stream.cuh``) over the tokens grouped by expert: each
expert that holds a token is read once per group of up to
``retrieve_stream.token_group(d)`` of its tokens, in row chunks that a
fixed grid (:func:`launch_plan`) shares out on the device, and a merge
writes the ``(B, k)`` result directly. An expert with fewer than k real
rows fills the tail with its padding rows, ``(-1e9, -1)``; an expert id
outside ``[0, K)`` gives ``(-inf, -1)``. For CPU tensors it runs the plain
version, ``ref.dss_topk_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.device import check_forward_only, check_on, resolve_device
from repro_torch.kernels import _build, ref
from repro_torch.kernels.retrieve_stream import StreamPlan, row_vec_bytes, stream_plan


def launch_plan(B: int, K: int, v_pad: int, d: int, wdtype: torch.dtype) -> StreamPlan:
    """The retrieval's launch from the shapes alone: ``min(B, K)`` experts
    can hold a token (``retrieve_stream.stream_plan``)."""
    return stream_plan(min(B, K), v_pad, d, wdtype)


def dss_topk(weights, ids, h_scaled, expert_idx, k: int = 8, *, device="cuda"):
    """weights (K, V_pad, d) and h_scaled (B, d) of one dtype (float32 or
    bfloat16), ids (K, V_pad) int32 with -1 as padding, expert_idx (B,)
    int32 in [0, K) → (vals (B, k) fp32, ids (B, k) int32)."""
    dev = resolve_device(device, meta=True)
    check_forward_only("dss_topk", weights=weights, h_scaled=h_scaled)
    check_on(dev, weights=weights, ids=ids, h_scaled=h_scaled, expert_idx=expert_idx)
    if weights.dtype == torch.int8:
        raise TypeError("dss_topk serves fp tables only; int8 rows take "
                        "dss_topk_grouped or dss_topk_fused")
    if dev.type != "cuda":
        return ref.plain("dss_topk", ref.dss_topk_ref, weights, ids, h_scaled, expert_idx, k)
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
    plan = launch_plan(B, K, v_pad, d, weights.dtype)
    vb = row_vec_bytes(d, weights.element_size(), weights.data_ptr())
    cuda_dev = h_scaled.device
    out_v = torch.empty((B, k), dtype=torch.float32, device=cuda_dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=cuda_dev)
    part_v = torch.empty((plan.max_chunks, B, k), dtype=torch.float32, device=cuda_dev)
    part_p = torch.empty((plan.max_chunks, B, k), dtype=torch.int32, device=cuda_dev)
    n_sel = torch.empty((1,), dtype=torch.int32, device=cuda_dev)
    lib = _build.load("dss_topk")
    err = lib.dss_topk(
        weights.data_ptr(), ids.data_ptr(), h_scaled.data_ptr(), expert_idx.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(), part_v.data_ptr(), part_p.data_ptr(),
        n_sel.data_ptr(), K, B, v_pad, d, k, plan.grid, vb, _build.dtype_code(h_scaled),
        torch.cuda.current_stream(cuda_dev).cuda_stream)
    _build.check(lib, err, "dss_topk")
    dss_topk.launches += 1
    return out_v, out_i


dss_topk.launches = 0
