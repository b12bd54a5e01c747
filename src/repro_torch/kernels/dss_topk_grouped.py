"""Expert-grouped DS-Softmax retrieval (weight-stationary).

Wrapper over ``csrc/dss_topk_grouped.cu`` (replaces both bodies of the
Pallas kernel ``repro/kernels/dss_topk_grouped.py``: ``_kernel`` for
f32/bf16 rows and ``_kernel_q`` for int8 rows with per-row scales).
Tokens arrive already grouped by their top-1 expert into ``(K, C, d)``
capacity buffers; each expert's packed rows are streamed once per token
tile and only the ``(K, C, k)`` values/ids are written. For CPU tensors
it runs the plain version, ``ref.dss_topk_grouped_ref``. ``launches``
counts the f32/bf16 body, ``launches_q`` the int8 body.
"""
from __future__ import annotations

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import _build, ref


def _token_tile(capacity: int) -> int:
    """Tokens per block: 16 at decode capacities, 64 above."""
    return 16 if capacity <= 16 else 64


def dss_topk_grouped(weights, ids, buf, g_buf, k: int = 8, *, scales=None, device="cuda"):
    """weights (K, V_pad, d) of buf's dtype (float32 or bfloat16), or int8
    with ``scales`` (K, V_pad) fp32; buf (K, C, d); ids (K, V_pad) int32
    with -1 as padding; g_buf (K, C) fp32 → (vals (K, C, k) fp32,
    ids (K, C, k) int32)."""
    dev = resolve_device(device)
    check_on(dev, weights=weights, ids=ids, buf=buf, g_buf=g_buf)
    ref.check_scales(weights, scales)
    quantized = scales is not None
    if quantized:
        check_on(dev, scales=scales)
    if dev.type == "cpu":
        return ref.dss_topk_grouped_ref(weights, ids, buf, g_buf, k, scales=scales)
    K, v_pad, d = weights.shape
    C = buf.shape[1]
    if buf.shape != (K, C, d) or ids.shape != (K, v_pad) or g_buf.shape != (K, C) \
            or (quantized and scales.shape != (K, v_pad)):
        raise ValueError(
            f"shapes disagree: weights {tuple(weights.shape)}, ids "
            f"{tuple(ids.shape)}, buf {tuple(buf.shape)}, g_buf {tuple(g_buf.shape)}"
            + (f", scales {tuple(scales.shape)}" if quantized else ""))
    if (not quantized and buf.dtype != weights.dtype) or ids.dtype != torch.int32 \
            or g_buf.dtype != torch.float32 or (quantized and scales.dtype != torch.float32):
        raise TypeError("buf must share weights' dtype (or weights be int8 with "
                        "float32 scales), ids must be int32 and g_buf float32")
    if not 1 <= k <= min(_build.MAX_K, v_pad):
        raise ValueError(f"k={k} must be in [1, min(64, v_pad={v_pad})]")
    weights, ids, buf, g_buf = (t.contiguous() for t in (weights, ids, buf, g_buf))
    if quantized:
        scales = scales.contiguous()
    tb = _token_tile(C)
    nsplit, tps = _build.vocab_split(v_pad, K * -(-C // tb))
    out_v = torch.empty((K, C, k), dtype=torch.float32, device=buf.device)
    out_i = torch.empty((K, C, k), dtype=torch.int32, device=buf.device)
    part_v = part_i = None
    if nsplit > 1:
        part_v = torch.empty((nsplit, K, C, k), dtype=torch.float32, device=buf.device)
        part_i = torch.empty((nsplit, K, C, k), dtype=torch.int32, device=buf.device)
    lib = _build.load("dss_topk_grouped")
    err = lib.dss_topk_grouped(
        buf.data_ptr(), g_buf.data_ptr(), weights.data_ptr(), ids.data_ptr(),
        _build.ptr(scales), out_v.data_ptr(), out_i.data_ptr(),
        _build.ptr(part_v), _build.ptr(part_i),
        K, C, v_pad, d, k, tb, nsplit, tps, _build.dtype_code(buf),
        _build.weight_code(weights), torch.cuda.current_stream(buf.device).cuda_stream)
    _build.check(lib, err, "dss_topk_grouped")
    if quantized:
        dss_topk_grouped.launches_q += 1
    else:
        dss_topk_grouped.launches += 1
    return out_v, out_i


dss_topk_grouped.launches = 0
dss_topk_grouped.launches_q = 0
