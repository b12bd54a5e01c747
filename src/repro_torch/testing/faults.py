"""Deterministic fault injection for ``ServeSession`` tests (the part of
``repro.testing.faults`` ported so far)."""
from __future__ import annotations

import torch


def skew_gate(params):
    """Zero the DS head's gate matrix: all gate logits tie, the first
    argmax routes EVERY token to expert 0, and a capacity-bounded serve
    path overflows on ~(B - capacity)/B of the batch each step —
    deterministic sustained overflow for the breaker and the adaptation
    loop. Retrieval stays exact (the grouped paths' overflow fixup re-runs
    the dropped tokens), confined to expert 0's rows."""
    head = dict(params["head"])
    head["gate"] = torch.zeros_like(head["gate"])
    return dict(params, head=head)
