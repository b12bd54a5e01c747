"""Public wrappers over the hand-written kernels (the API models call).

``core.dssoftmax.serve_topk`` resolves a kernel name through
``kernels.registry`` and only then dispatches into these wrappers.
``BODIES`` names every kernel body with the wrapper attribute that counts
its launches: a plain integer that rises by one per launch of that body
(never for the plain version that runs on CPU tensors). The grouped and
fused wrappers have two bodies each, for f32/bf16 rows and for int8 rows.
"""
from __future__ import annotations

from repro_torch.kernels.dss_topk import dss_topk as dss_topk_kernel
from repro_torch.kernels.dss_topk_fused import dss_topk_fused
from repro_torch.kernels.dss_topk_grouped import dss_topk_grouped
from repro_torch.kernels.gate_top1 import gate_top1
from repro_torch.kernels.lasso_prune import lasso_prune

# (body name, wrapper, counter attribute)
BODIES = (
    ("gate_top1", gate_top1, "launches"),
    ("dss_topk_grouped", dss_topk_grouped, "launches"),
    ("dss_topk_grouped_q", dss_topk_grouped, "launches_q"),
    ("dss_topk_fused", dss_topk_fused, "launches"),
    ("dss_topk_fused_q", dss_topk_fused, "launches_q"),
    ("dss_topk", dss_topk_kernel, "launches"),
    ("lasso_prune", lasso_prune, "launches"),
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
           "gate_top1", "lasso_prune", "launch_counts", "reset_launch_counts"]
