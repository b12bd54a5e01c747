"""DS-Softmax auxiliary losses (paper Eqs. 3–6).

* ``group_lasso``  (Eq. 3/4): sum of row l2 norms over rows still above the
  pruning threshold γ — rows already below γ are excluded.
* ``load_balance`` (Eq. 5): squared coefficient of variation of the summed
  sparse gate values per expert.
* ``expert_lasso`` (Eq. 6): expert-level group lasso Σ_k ||W^(k)||_F.

Every loss is fp32 whatever the dtype of the expert tables, as in
``repro.core.losses``. The two lassos read the rows through their sums of
squares, (K, N) rows and (K,) experts, which the DS head's train loss
keeps an expert at a time (``core.dssoftmax.loss_rows``); ``*_of`` take
those sums.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import collective


def row_sq(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of squares of each masked class row: w (…, N, d), mask
    (…, N) → (…, N)."""
    return torch.sum(torch.square(w.float() * mask[..., None].float()), dim=-1)


def frobenius_sq(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of squares of one expert's masked rows w (N, d), mask
    (N,) → 0-d."""
    return torch.sum(torch.square(w.float() * mask[..., None].float()))


def per_expert(fn, experts_w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``fn(w, m)`` of each expert, stacked: one expert widened to fp32 at a
    time, so no fp32 copy of the whole experts exists (autograd keeps each
    expert's when a gradient is asked for)."""
    return torch.stack([fn(w, m) for w, m in zip(experts_w.unbind(0), mask.unbind(0))])


def norms_of(sq: torch.Tensor) -> torch.Tensor:
    """Row l2 norms from :func:`row_sq`'s sums; the ``+1e-12`` inside the
    root keeps the gradient finite at a zero row."""
    return torch.sqrt(sq + 1e-12)


def row_norms(experts_w: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    """l2 norm of each class row. experts_w: (K, N, d), mask: (K, N) → (K, N).
    ``group``: the rows' ``d`` is split over this process group, so the
    squares are summed over it (an all-reduce, no gradient) before the
    ``+1e-12``."""
    sq = per_expert(row_sq, experts_w, mask)
    if group is not None:
        sq = collective(sq, group, "all_reduce")
    return norms_of(sq)


def group_lasso_of(sq: torch.Tensor, gamma: float) -> torch.Tensor:
    """:func:`group_lasso` from the rows' sums of squares (K, N)."""
    norms = norms_of(sq)
    keep = (norms > gamma).to(norms.dtype).detach()
    return torch.sum(norms * keep)


def expert_lasso_of(fro: torch.Tensor) -> torch.Tensor:
    """:func:`expert_lasso` from the experts' sums of squares (K,)."""
    return torch.sum(torch.sqrt(fro + 1e-12))


def group_lasso(experts_w: torch.Tensor, mask: torch.Tensor, gamma: float) -> torch.Tensor:
    """Eq. 3 with Eq. 4's thresholding: only rows with ||W_c|| > γ
    contribute; the threshold test gets no gradient."""
    return group_lasso_of(per_expert(row_sq, experts_w, mask), gamma)


def expert_lasso(experts_w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Eq. 6: Σ_k Frobenius norm of each (masked) expert."""
    return expert_lasso_of(per_expert(frobenius_sq, experts_w, mask))


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
