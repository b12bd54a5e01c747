"""DS-Softmax auxiliary losses (paper Eqs. 3–6).

* ``group_lasso``  (Eq. 3/4): sum of row l2 norms over rows still above the
  pruning threshold γ — rows already below γ are excluded.
* ``load_balance`` (Eq. 5): squared coefficient of variation of the summed
  sparse gate values per expert.
* ``expert_lasso`` (Eq. 6): expert-level group lasso Σ_k ||W^(k)||_F.

Every loss is fp32 whatever the dtype of the expert tables, as in
``repro.core.losses``.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import collective


def row_norms(experts_w: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    """l2 norm of each class row. experts_w: (K, N, d), mask: (K, N) → (K, N).
    The ``+1e-12`` inside the root keeps the gradient finite at a zero
    row. ``group``: the rows' ``d`` is split over this process group, so
    the squares are summed over it (an all-reduce, no gradient) before the
    ``+1e-12``."""
    w = experts_w.float() * mask[..., None].float()
    sq = torch.sum(torch.square(w), dim=-1)
    if group is not None:
        sq = collective(sq, group, "all_reduce")
    return torch.sqrt(sq + 1e-12)


def group_lasso(experts_w: torch.Tensor, mask: torch.Tensor, gamma: float) -> torch.Tensor:
    """Eq. 3 with Eq. 4's thresholding: only rows with ||W_c|| > γ
    contribute; the threshold test gets no gradient."""
    norms = row_norms(experts_w, mask)
    keep = (norms > gamma).to(norms.dtype).detach()
    return torch.sum(norms * keep)


def expert_lasso(experts_w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Eq. 6: Σ_k Frobenius norm of each (masked) expert."""
    w = experts_w.float() * mask[..., None].float()
    return torch.sum(torch.sqrt(torch.sum(torch.square(w), dim=(1, 2)) + 1e-12))


def cv_squared(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Squared coefficient of variation along the last axis (population
    variance, as ``jnp.var``)."""
    x = x.float()
    mean = torch.mean(x, dim=-1)
    var = torch.var(x, dim=-1, correction=0)
    return var / (torch.square(mean) + eps)


def load_balance(G_sparse_sum: torch.Tensor) -> torch.Tensor:
    """Eq. 5: CV(Σ_h G'_k(h))² over experts. ``G_sparse_sum``: (K,)."""
    return cv_squared(G_sparse_sum)
