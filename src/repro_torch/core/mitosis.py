"""Mitosis training (paper §2.3, Fig. 2): progressive expert cloning.

Train with few experts; when converged, split every expert into two
near-identical offspring (sparsity masks inherited) and keep training. The
train-time memory stays bounded by the *pruned* expert sizes rather than K
full softmaxes.
"""
from __future__ import annotations

import torch

from repro_torch.core.dssoftmax import DSState


def clone_experts(generator: torch.Generator, params: dict, state: DSState,
                  noise: float = 1e-2):
    """K experts → 2K. Gate rows get ± noise (N(0, 1) · noise · std(gate),
    drawn from ``generator`` on the gate's device) so the offspring
    diverge; expert rows and masks are copied. At ``noise=0`` the result
    is bit-equal to ``repro``'s."""
    gate = params["gate"]   # (K, d)
    w = params["experts"]   # (K, N, d)
    std = torch.std(gate.float(), correction=0).to(gate.dtype)
    eps = (torch.randn(gate.shape, generator=generator, device=gate.device).to(gate.dtype)
           * noise * std)
    new_gate = torch.cat([gate + eps, gate - eps], dim=0)
    new_w = torch.cat([w, w], dim=0)
    new_mask = torch.cat([state.mask, state.mask], dim=0)
    return {"gate": new_gate, "experts": new_w}, DSState(mask=new_mask)


def memory_ratio(state: DSState) -> float:
    """Training memory in units of ONE full softmax (paper Fig. 5a): total
    surviving rows across experts / N."""
    mask = state.mask
    return float(mask.sum().item() / mask.shape[1])


def mitosis_schedule(start: int, target: int) -> list[int]:
    """Expert counts visited: e.g. 2 → [2, 4, 8, ..., target]."""
    ks = [start]
    while ks[-1] < target:
        ks.append(min(ks[-1] * 2, target))
    if ks[-1] != target:
        ks.append(target)
    return ks
