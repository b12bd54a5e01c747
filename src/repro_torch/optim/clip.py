"""Global-norm gradient clipping."""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import global_norm
from repro_torch.utils.tree import tree_global_norm, tree_map


def clip_by_global_norm(grads, max_norm: float, mesh=None, specs=None):
    """→ (grads scaled by min(1, max_norm / (norm + 1e-9)) in fp32 and cast
    back to each grad's dtype, the fp32 global norm as a 0-d tensor).

    With ``mesh`` the grads are this rank's blocks under the placement
    ``specs``, and the norm is the whole tree's
    (``distributed.sharding.global_norm``: each leaf's squares added over
    the axes it is split on, and only those)."""
    if mesh is None:
        norm = tree_global_norm(grads)
    else:
        norm = global_norm(grads, mesh, specs)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm
