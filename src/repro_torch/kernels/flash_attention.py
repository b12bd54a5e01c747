"""Causal flash attention (online softmax over kv tiles).

Wrapper over ``csrc/flash_attention.cu`` (replaces the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``), with the JAX
signature and layout: q (B, H, S, dh), k/v (B, H_kv, S, dh). ``H_kv < H``
is grouped-query attention: query head h reads kv head h // (H / H_kv),
which is the Pallas kernel applied to ``jnp.repeat(k, H // H_kv, axis=1)``,
without the copy. Any element strides are taken as long as the dh axis is
contiguous, so a (B, S, H, dh) tensor passes as its ``transpose(1, 2)``
view; the output is dense with q's axis order, so a (B, S, H, dh) tensor
gets its output back in that layout. For CPU tensors it
runs the plain version, ``ref.flash_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import _build, ref

MAX_DH = 256


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, device="cuda"):
    """q (B, H, S, dh), k and v (B, H_kv, S, dh) with H % H_kv == 0, all
    float32 or all bfloat16 → o (B, H, S, dh) in q's dtype: causal
    attention with fp32 scores times 1/√dh, -1e9 masking and an fp32
    online softmax whose p is rounded to v's dtype before p·v."""
    dev = resolve_device(device)
    check_on(dev, q=q, k=k, v=v)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be (B, H, S, dh) and k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} (B, H_kv, S, dh)")
    B, H, S, dh = q.shape
    H_kv = k.shape[1]
    if k.shape != (B, H_kv, S, dh) or H % H_kv:
        raise ValueError(f"k/v {tuple(k.shape)} must be (B={B}, H_kv, S={S}, dh={dh}) "
                         f"with H={H} a multiple of H_kv")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v)
    code = _build.dtype_code(q)
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"head dim {dh} outside [1, {MAX_DH}]")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the head-dim axis of q, k and v must be contiguous (stride 1)")
    o = torch.empty_like(q)  # dense, with q's axis order (q's layout when q is dense)
    lib = _build.load("flash_attention")
    err = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                              *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                              *o.stride()[:3], B, H, H_kv, S, dh, code,
                              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
