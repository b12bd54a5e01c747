"""Sort-based expert dispatch indices (index arithmetic on int vectors)."""
from __future__ import annotations

from typing import Optional

import torch


def dispatch_indices(e_flat: torch.Tensor, num_experts: int, capacity: int):
    """Assignment slots for a flat expert-id vector.

    e_flat: (A,) int — expert chosen per assignment, in [0, num_experts],
    where ``num_experts`` is the sentinel callers route dropped
    assignments to.
    Returns (slot (A,) int32, valid (A,) bool): ``slot`` is the rank of the
    assignment inside its expert (stable order), ``valid`` is False where
    the expert overflowed ``capacity``. The ``first`` gather is clamped as
    JAX clamps it, so sentinel ids get JAX's slots bit for bit.
    """
    A = e_flat.shape[0]
    e = e_flat.long()
    order = torch.argsort(e, stable=True)
    sorted_e = e[order]
    first = torch.searchsorted(
        sorted_e, torch.arange(num_experts, device=e.device), side="left")
    rank = torch.arange(A, device=e.device) - first[sorted_e.clamp(0, num_experts - 1)]
    slot = torch.empty(A, dtype=torch.int32, device=e.device)
    slot[order] = rank.to(torch.int32)
    valid = slot < capacity
    return slot, valid


def dispatch_load(e_flat: torch.Tensor, num_experts: int,
                  valid: Optional[torch.Tensor] = None):
    """Per-expert load telemetry → (dispatched (K,), overflow (K,)) int32.

    Ids >= K (e.g. the sentinel ``K``) are dropped from both counts, as
    JAX's ``mode="drop"`` scatter drops them."""
    e = e_flat.long()
    keep = ((e >= 0) & (e < num_experts)).to(torch.int32)
    e = e.clamp(0, num_experts - 1)  # dropped ids add 0 (no host sync)
    dispatched = torch.zeros(num_experts, dtype=torch.int32, device=e.device)
    dispatched.scatter_add_(0, e, keep)
    overflow = torch.zeros(num_experts, dtype=torch.int32, device=e.device)
    if valid is not None:
        overflow.scatter_add_(0, e, keep * (~valid).to(torch.int32))
    return dispatched, overflow
