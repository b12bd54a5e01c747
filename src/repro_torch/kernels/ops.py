"""Public wrappers over the hand-written kernels (the API models call).

``core.dssoftmax.serve_topk`` resolves a kernel name through
``kernels.registry`` and only then dispatches into these wrappers.
``BODIES`` names every kernel body with the wrapper attribute that counts
its launches: a plain integer that rises by one per launch of that body
(never for the plain version that runs on CPU tensors). The fused wrapper
has two bodies, for f32/bf16 rows and for int8 rows; the grouped wrapper
six, a decode, a tensor-core (``wgmma``) and a CUDA-core tiled body for
each row kind, chosen by capacity and token dtype
(``kernels.dss_topk_grouped.select_body``); ``flash_attention`` has a
CUDA-core body and a tensor-core (``wgmma``) body, chosen by
``kernels.flash_attention.select_body``.
"""
from __future__ import annotations

from repro_torch.kernels.dss_topk import dss_topk as dss_topk_kernel
from repro_torch.kernels.dss_topk_fused import dss_topk_fused
from repro_torch.kernels.dss_topk_grouped import dss_topk_grouped
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gate_top1 import gate_top1
from repro_torch.kernels.lasso_prune import lasso_prune

# (body name, wrapper, counter attribute)
BODIES = (
    ("gate_top1", gate_top1, "launches"),
    ("dss_topk_grouped", dss_topk_grouped, "launches"),
    ("dss_topk_grouped_q", dss_topk_grouped, "launches_q"),
    ("dss_topk_grouped_wgmma", dss_topk_grouped, "launches_wgmma"),
    ("dss_topk_grouped_wgmma_q", dss_topk_grouped, "launches_wgmma_q"),
    ("dss_topk_grouped_tiled", dss_topk_grouped, "launches_tiled"),
    ("dss_topk_grouped_tiled_q", dss_topk_grouped, "launches_tiled_q"),
    ("dss_topk_fused", dss_topk_fused, "launches"),
    ("dss_topk_fused_q", dss_topk_fused, "launches_q"),
    ("dss_topk", dss_topk_kernel, "launches"),
    ("lasso_prune", lasso_prune, "launches"),
    ("flash_attention", flash_attention, "launches"),
    ("flash_attention_wgmma", flash_attention, "launches_wgmma"),
)


def dss_topk(weights, ids, h, expert_idx, g, k: int = 8, *, device="cuda"):
    """Per-token serve top-k (``dss_topk_kernel``) with the gate value
    folded into the token as ``repro.kernels.ops.dss_topk`` folds it: in
    fp32, rounded back to h's dtype before the product."""
    h_scaled = (h.float() * g[:, None]).to(h.dtype)
    return dss_topk_kernel(weights, ids, h_scaled, expert_idx, k, device=device)


def launch_counts() -> dict:
    return {name: getattr(fn, attr) for name, fn, attr in BODIES}


def reset_launch_counts() -> None:
    for _, fn, attr in BODIES:
        setattr(fn, attr, 0)


__all__ = ["BODIES", "dss_topk", "dss_topk_fused", "dss_topk_grouped", "dss_topk_kernel",
           "flash_attention", "gate_top1", "lasso_prune", "launch_counts", "reset_launch_counts"]
