"""Group-lasso pruning of expert class rows (paper Algorithm 1), the parts
serving needs.

A boolean ``mask`` (K, N) tracks the surviving classes of each expert. The
paper's footnote 4 keeps at least one copy of every class across all
experts; :func:`keep_one_copy` enforces it. ``prune_step`` comes with the
training slice: it reads ``losses.row_norms``, whose ``+1e-12`` inside the
square root ``kernels.lasso_prune`` does not have.
"""
from __future__ import annotations

import torch


def keep_one_copy(candidate_mask: torch.Tensor, norms: torch.Tensor,
                  prev_mask: torch.Tensor) -> torch.Tensor:
    """Every previously alive class column keeps at least one expert: the
    first of the largest norm (``torch.argmax`` returns the first maximum,
    as ``jnp.argmax`` does). Columns never alive stay dead."""
    col_alive = torch.any(candidate_mask, dim=0)                    # (N,)
    col_ever = torch.any(prev_mask, dim=0)                          # (N,)
    best_k = torch.argmax(norms, dim=0)                             # (N,)
    experts = torch.arange(norms.shape[0], device=norms.device)
    resurrection = (experts[:, None] == best_k[None, :]) & col_ever[None, :]
    return torch.where(col_alive[None, :], candidate_mask, resurrection)


def apply_mask(experts_w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Hard-zero pruned rows (keeps dtype)."""
    return experts_w * mask[..., None].to(experts_w.dtype)


def expert_sizes(mask: torch.Tensor) -> torch.Tensor:
    """|v_k| per expert. mask (K, N) → (K,) int32."""
    return torch.sum(mask, dim=-1, dtype=torch.int32)


def redundancy(mask: torch.Tensor) -> torch.Tensor:
    """Number of experts holding each class (paper Fig. 5b). → (N,) int32."""
    return torch.sum(mask, dim=0, dtype=torch.int32)
