"""Fused top-1 gate: logits + softmax + top-1 in one launch.

Wrapper over ``csrc/gate_top1.cu`` (replaces the Pallas kernel
``repro/kernels/gate_top1.py``). For CPU tensors it runs the plain
version, ``ref.gate_top1_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import _build, ref


def gate_top1(gate_w: torch.Tensor, h: torch.Tensor, *, device="cuda"):
    """gate_w (K, d) with K ≤ 64, h (B, d), same dtype (float32 or
    bfloat16) → (idx (B,) int32 = first argmax of softmax, g (B,) fp32 =
    its probability)."""
    dev = resolve_device(device)
    check_on(dev, gate_w=gate_w, h=h)
    if dev.type == "cpu":
        return ref.gate_top1_ref(gate_w, h)
    B, d = h.shape
    K = gate_w.shape[0]
    if gate_w.shape != (K, d) or not 1 <= K <= _build.MAX_K:
        raise ValueError(f"gate_w {tuple(gate_w.shape)} must be (K ≤ 64, {d})")
    if gate_w.dtype != h.dtype:
        raise TypeError(f"gate_w {gate_w.dtype} and h {h.dtype} must share a dtype")
    gate_w, h = gate_w.contiguous(), h.contiguous()
    idx = torch.empty(B, dtype=torch.int32, device=h.device)
    g = torch.empty(B, dtype=torch.float32, device=h.device)
    lib = _build.load("gate_top1")
    err = lib.gate_top1(gate_w.data_ptr(), h.data_ptr(), idx.data_ptr(),
                        g.data_ptr(), B, K, d, _build.dtype_code(h),
                        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(lib, err, "gate_top1")
    gate_top1.launches += 1
    return idx, g


gate_top1.launches = 0
