"""Adam / AdamW as ``repro.optim.adam`` writes it (not ``torch.optim.Adam``).

The bias correction is folded into the step size, ``lr_t = lr·√bc2/bc1``,
and ε is added to ``√v``, not to ``√v̂`` (ε is then effectively ε·√bc2).
Moments are fp32 whatever the param dtype; each update runs in fp32 and
is cast back to the param's dtype.

The update is functional: it returns new tensors and leaves ``params``
and ``state`` as they were, so a step that fails partway leaves the state
it started from intact (the Trainer retries from it). The step count is
a 0-d int32 tensor on the params' device and the step size is computed
there in fp32, so an update waits for nothing on the host.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any              # fp32 tree
    v: Any              # fp32 tree


def adam_init(params: Any) -> OptState:
    """Zero moments for every leaf of ``params``, step 0."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def adam_update(params: Any, grads: Any, state: OptState, lr, *, b1: float = 0.9,
                b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.0):
    """One Adam step → (new params, new OptState). ``lr`` is a float or a
    0-d tensor (a schedule's value at ``state.step``)."""
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    lr_t = lr * torch.sqrt(bc2) / bc1

    def upd(p, g, m, v):
        gf = g.float()
        m2 = b1 * m + (1.0 - b1) * gf
        v2 = b2 * v + (1.0 - b2) * torch.square(gf)
        delta = m2 / (torch.sqrt(v2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        return (p.float() - lr_t * delta).to(p.dtype), m2, v2

    out = tree_map(upd, params, grads, state.m, state.v)
    return _pick(out, 0), OptState(step=step, m=_pick(out, 1), v=_pick(out, 2))


def _pick(tree, i: int):
    """Field ``i`` of every (p, m, v) tuple at the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
