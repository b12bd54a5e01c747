"""Group-lasso pruning of expert class rows (paper Algorithm 1).

A boolean ``mask`` (K, N) tracks the surviving classes of each expert.
Pruning runs between optimizer steps, gated on the task loss being below
a threshold ``t``; once pruned, a row stays pruned. The paper's footnote 4
keeps at least one copy of every class across all experts;
:func:`keep_one_copy` enforces it. ``prune_step`` reads
``losses.row_norms``, whose ``+1e-12`` inside the square root the
``lasso_prune`` kernel does not have, so the train step never calls the
kernel: the two differ on rows whose norm is near zero.
"""
from __future__ import annotations

import torch

from repro_torch.core.losses import row_norms


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


def prune_step(experts_w: torch.Tensor, mask: torch.Tensor, task_loss: torch.Tensor, *,
               gamma: float, threshold: float, norm_group=None) -> torch.Tensor:
    """One pruning update → the new mask. Branch-free: the gate on the
    task loss is a ``torch.where`` on the 0-d tensor, so nothing waits for
    the device. Computes no gradient.

    On a mesh ``experts_w`` and ``mask`` are this rank's blocks (the
    experts placed ``(None, model, data)``, the mask ``(None, model)``):
    ``norm_group``, the group the ``d`` axis splits over, completes each
    row's sum of squares; :func:`keep_one_copy` stays local, as every rank
    holds all K experts of its classes."""
    with torch.no_grad():
        norms = row_norms(experts_w, mask, norm_group)
        candidate = keep_one_copy(mask & (norms > gamma), norms, mask)
        do_prune = torch.as_tensor(task_loss, dtype=torch.float32,
                                   device=mask.device) < threshold
        return torch.where(do_prune, candidate, mask)


def apply_mask(experts_w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Hard-zero pruned rows (keeps dtype)."""
    return experts_w * mask[..., None].to(experts_w.dtype)


def expert_sizes(mask: torch.Tensor) -> torch.Tensor:
    """|v_k| per expert. mask (K, N) → (K,) int32."""
    return torch.sum(mask, dim=-1, dtype=torch.int32)


def redundancy(mask: torch.Tensor) -> torch.Tensor:
    """Number of experts holding each class (paper Fig. 5b). → (N,) int32."""
    return torch.sum(mask, dim=0, dtype=torch.int32)
