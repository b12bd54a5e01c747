"""Group-lasso row norms and the survival mask (paper Eq. 3/4).

Wrapper over ``csrc/lasso_prune.cu`` (replaces the Pallas kernel
``repro/kernels/lasso_prune.py::lasso_prune``). One pass over the expert
tables gives every row's fp32 l2 norm (0 for a masked row, whose elements
the kernel never reads) and ``mask ∧ norm > gamma``, with no fp32 copy of
the (K, N, d) tables. For CPU tensors it runs the plain version,
``ref.lasso_prune_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.device import check_forward_only, check_on, resolve_device
from repro_torch.kernels import _build, ref

# Blocks per SM: 8 blocks of 8 warps fill an SM's 64 warp slots.
_BLOCKS_PER_SM = 8


def lasso_prune(weights: torch.Tensor, mask: torch.Tensor, gamma: float = 0.01, *,
                device="cuda"):
    """weights (K, N, d) float32 or bfloat16, mask (K, N) bool → (norms
    (K, N) fp32, new_mask (K, N) bool)."""
    dev = resolve_device(device, meta=True)
    check_forward_only("lasso_prune", weights=weights)
    check_on(dev, weights=weights, mask=mask)
    if weights.dim() != 3 or mask.shape != weights.shape[:2]:
        raise ValueError(f"weights {tuple(weights.shape)} must be (K, N, d) and mask "
                         f"{tuple(mask.shape)} (K, N)")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if dev.type != "cuda":
        return ref.plain("lasso_prune", ref.lasso_prune_ref, weights, mask, gamma)
    K, N, d = weights.shape
    weights, mask = weights.contiguous(), mask.contiguous()
    norms = torch.empty((K, N), dtype=torch.float32, device=weights.device)
    new_mask = torch.empty((K, N), dtype=torch.bool, device=weights.device)
    rows = K * N
    blocks = max(1, min(-(-rows // 8), _build.SMS * _BLOCKS_PER_SM))
    lib = _build.load("lasso_prune")
    # bool tensors hold one byte per entry, 0 or 1: the kernel's uint8
    err = lib.lasso_prune(weights.data_ptr(), mask.data_ptr(), norms.data_ptr(),
                          new_mask.data_ptr(), rows, d, float(gamma),
                          _build.dtype_code(weights), blocks,
                          torch.cuda.current_stream(weights.device).cuda_stream)
    _build.check(lib, err, "lasso_prune")
    lasso_prune.launches += 1
    return norms, new_mask


lasso_prune.launches = 0
