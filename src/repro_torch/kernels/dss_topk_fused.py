"""Fused gate → dispatch → retrieve DS-Softmax decode kernel.

Wrapper over ``csrc/dss_topk_fused.cu`` (replaces both bodies of the
Pallas kernel ``repro/kernels/dss_topk_fused.py``: ``_kernel`` for
f32/bf16 rows and ``_kernel_q`` for int8 rows with per-row scales):
gating runs in the kernel, and each token reads only its selected
expert's rows. For CPU tensors it runs the plain version,
``ref.dss_topk_fused_ref``. ``launches`` counts the f32/bf16 body,
``launches_q`` the int8 body.
"""
from __future__ import annotations

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import _build, ref

TOKEN_TILE = 16  # tokens per gating pass (kTB in csrc/dss_topk_fused.cu)


def dss_topk_fused(gate_w, weights, ids, h, k: int = 8, *, scales=None, e_base: int = 0,
                   device="cuda"):
    """gate_w (K_real ≤ 64, d) and h (B, d) of one dtype (float32 or
    bfloat16); weights (K, V_pad, d) of that dtype, or int8 with
    ``scales`` (K, V_pad) fp32; ids (K, V_pad) int32 → (vals (B, k) fp32,
    ids (B, k) int32, expert (B,) int32 GLOBAL top-1 expert). ``e_base``
    is the global id of ``weights[0]``; tokens whose expert lies outside
    ``[e_base, e_base + K)`` emit ``(-inf, -1)`` rows."""
    dev = resolve_device(device)
    check_on(dev, gate_w=gate_w, weights=weights, ids=ids, h=h)
    ref.check_scales(weights, scales)
    quantized = scales is not None
    if quantized:
        check_on(dev, scales=scales)
    if dev.type == "cpu":
        return ref.dss_topk_fused_ref(gate_w, weights, ids, h, k, e_base, scales=scales)
    K, v_pad, d = weights.shape
    B = h.shape[0]
    K_real = gate_w.shape[0]
    if h.shape != (B, d) or gate_w.shape != (K_real, d) or ids.shape != (K, v_pad) \
            or (quantized and scales.shape != (K, v_pad)):
        raise ValueError(
            f"shapes disagree: gate_w {tuple(gate_w.shape)}, weights "
            f"{tuple(weights.shape)}, ids {tuple(ids.shape)}, h {tuple(h.shape)}"
            + (f", scales {tuple(scales.shape)}" if quantized else ""))
    if not 1 <= K_real <= _build.MAX_K:
        raise ValueError(f"K_real={K_real} must be in [1, 64]")
    if gate_w.dtype != h.dtype or (not quantized and weights.dtype != h.dtype) \
            or ids.dtype != torch.int32 or (quantized and scales.dtype != torch.float32):
        raise TypeError("gate_w and h must share a dtype, and weights too unless they "
                        "are int8 with float32 scales; ids int32")
    if not 1 <= k <= min(_build.MAX_K, v_pad):
        raise ValueError(f"k={k} must be in [1, min(64, v_pad={v_pad})]")
    gate_w, weights, ids, h = (t.contiguous() for t in (gate_w, weights, ids, h))
    if quantized:
        scales = scales.contiguous()
    n_tiles = -(-B // TOKEN_TILE)
    nsplit, tps = _build.vocab_split(v_pad, n_tiles * min(K, max(B, 1)))
    out_v = torch.empty((B, k), dtype=torch.float32, device=h.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=h.device)
    out_e = torch.empty((B,), dtype=torch.int32, device=h.device)
    part_v = part_i = None
    if nsplit > 1:
        part_v = torch.empty((nsplit, B, k), dtype=torch.float32, device=h.device)
        part_i = torch.empty((nsplit, B, k), dtype=torch.int32, device=h.device)
    lib = _build.load("dss_topk_fused")
    err = lib.dss_topk_fused(
        gate_w.data_ptr(), weights.data_ptr(), ids.data_ptr(), _build.ptr(scales),
        h.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), out_e.data_ptr(),
        _build.ptr(part_v), _build.ptr(part_i),
        K_real, K, B, v_pad, d, k, int(e_base), nsplit, tps,
        _build.dtype_code(h), _build.weight_code(weights),
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(lib, err, "dss_topk_fused")
    if quantized:
        dss_topk_fused.launches_q += 1
    else:
        dss_topk_fused.launches += 1
    return out_v, out_i, out_e


dss_topk_fused.launches = 0
dss_topk_fused.launches_q = 0
