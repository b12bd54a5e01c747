"""Gradient compression for a cross-rank all-reduce (``repro.optim.
compression``).

* int8 quantization with a per-tensor scale and error feedback (the
  residual is carried between steps, so the compression error does not
  bias the descent direction);
* top-k magnitude sparsification with error feedback.

:func:`compressed_allreduce_int8` is the explicit compressed sum over a
process group: the int8 values summed as int32 (no overflow for up to 2^23
ranks), times the largest scale of the group. Every collective goes through
``distributed.sharding.collective``. No train step calls these yet:
``repro``'s ``TrainConfig.grad_compression`` names a scheme its step never
reads, and the port has no such option until a step reads it.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.distributed.sharding import collective
from repro_torch.kernels.ref import topk_stable
from repro_torch.utils.tree import tree_map


class CompressionState(NamedTuple):
    residual: Any  # error-feedback tree, fp32


def init_compression(params: Any) -> CompressionState:
    """Zero residuals, fp32, one for every leaf of ``params``."""
    return CompressionState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def compress_int8(x: torch.Tensor) -> tuple:
    """fp → (int8 values, fp32 0-d scale): symmetric per-tensor
    quantization, ``round(x / scale)`` (half to even) clipped to ±127."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(g: torch.Tensor, residual: torch.Tensor) -> tuple:
    """→ (int8 q, scale, new residual): g + residual quantized, the error
    kept."""
    target = g.float() + residual
    q, scale = compress_int8(target)
    return q, scale, target - decompress_int8(q, scale)


def topk_sparsify(g: torch.Tensor, residual: torch.Tensor, frac: float) -> tuple:
    """Keep the ``max(1, int(frac · size))`` largest magnitudes of g +
    residual (ties to the lower flat index, as ``jax.lax.top_k`` breaks
    them); the rest go into the residual. → (kept, new residual), g's
    shape, fp32."""
    target = (g.float() + residual).reshape(-1)
    k = max(1, int(frac * target.numel()))
    _, idx = topk_stable(torch.abs(target), k)
    mask = torch.zeros_like(target).index_fill_(0, idx, 1.0)
    kept = target * mask
    return kept.reshape(g.shape), (target - kept).reshape(g.shape)


def compressed_allreduce_int8(g: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``g`` over ``group`` with int8 values on every rank: each
    rank quantizes its own g, the values are summed as int32 and scaled by
    the group's largest scale. The same fp32 tensor on every rank."""
    q, scale = compress_int8(g)
    q_sum = collective(q.to(torch.int32), group, "all_reduce")
    scale_max = collective(scale, group, "all_reduce_max")
    return q_sum.float() * scale_max
