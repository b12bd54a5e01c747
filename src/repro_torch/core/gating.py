"""Sparse mixture gating (paper Eq. 1).

``G_k(h) = softmax(U h)_k``; only the top-1 expert's gate value is kept,
*after* normalization, so ``g`` is the max softmax probability and is not
renormalized. Logits are fp32 whatever the dtype of ``h`` and ``U``.
"""
from __future__ import annotations

import torch


def gate_values(gate_w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Normalized gate values G (…, K).  gate_w: (K, d), h: (…, d)."""
    logits = h.float() @ gate_w.float().T
    return torch.softmax(logits, dim=-1)


def top1_gate(gate_w: torch.Tensor, h: torch.Tensor):
    """Top-1 sparse gate → ``(expert_idx (…,) int32, g (…,) fp32, G (…, K))``.

    ``expert_idx`` is the first argmax of the softmax (not of the logits)."""
    G = gate_values(gate_w, h)
    expert_idx = torch.argmax(G, dim=-1).to(torch.int32)  # first maximum
    g = torch.amax(G, dim=-1)
    return expert_idx, g, G
