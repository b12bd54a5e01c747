"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch
versions (``ref.py``) and the serve-path registry (``registry.py``)."""
from repro_torch.kernels import ops, ref, registry
from repro_torch.kernels.dss_topk import dss_topk
from repro_torch.kernels.dss_topk_fused import dss_topk_fused
from repro_torch.kernels.dss_topk_grouped import dss_topk_grouped
from repro_torch.kernels.gate_top1 import gate_top1
from repro_torch.kernels.lasso_prune import lasso_prune
from repro_torch.kernels.registry import (
    AutoPolicy,
    FixedPolicy,
    KernelContext,
    KernelPolicy,
    KernelSpec,
    kernel_names,
)

__all__ = [
    "ops",
    "ref",
    "registry",
    "dss_topk",
    "dss_topk_fused",
    "dss_topk_grouped",
    "gate_top1",
    "lasso_prune",
    "AutoPolicy",
    "FixedPolicy",
    "KernelContext",
    "KernelPolicy",
    "KernelSpec",
    "kernel_names",
]
