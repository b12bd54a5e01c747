"""Public wrappers over the hand-written kernels (the API models call).

``core.dssoftmax.serve_topk`` resolves a kernel name through
``kernels.registry`` and only then dispatches into these wrappers.
``KERNELS`` lists every wrapper; each keeps a plain integer ``launches``
count that rises by one per kernel launch (never for the plain version
that runs on CPU tensors).
"""
from __future__ import annotations

from repro_torch.kernels.dss_topk_fused import dss_topk_fused
from repro_torch.kernels.dss_topk_grouped import dss_topk_grouped
from repro_torch.kernels.gate_top1 import gate_top1

KERNELS = (gate_top1, dss_topk_grouped, dss_topk_fused)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


__all__ = ["KERNELS", "dss_topk_fused", "dss_topk_grouped", "gate_top1",
           "launch_counts", "reset_launch_counts"]
