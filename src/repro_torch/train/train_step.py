"""The canonical train step: loss → grads → clip → Adam → mask pruning.

One function for every architecture (the ModelBundle supplies the loss).
Supports microbatched gradient accumulation in fp32 and the DS-Softmax
mask update (paper Algorithm 1's "if L_task < t: prune").

The step is functional: the params and moments of the state it is given
are never written, so the Trainer can retry a failed step from it.
Gradients come from ``torch.autograd.grad`` on detached copies of the
params that require grad; the params kept in a :class:`TrainState` never
require grad, so serving them runs the kernels.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import dssoftmax as ds
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.optim import OptState, adam_update, clip_by_global_norm
from repro_torch.utils.tree import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    ds_state: Optional[ds.DSState]


def value_and_grad(bundle: ModelBundle, params, ds_state, batch):
    """→ ((total loss, metrics), grads): grads a tree like ``params``, each
    leaf in its param's dtype (zeros for a param the loss does not read);
    the loss and metrics detached."""
    leaves = tree_leaves(params)
    req = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(req)
    live = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        total, metrics = bundle.train_loss(live, ds_state, batch)
        grads = torch.autograd.grad(total, req, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p) for g, p in zip(grads, leaves))
    return ((total.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(lambda _: next(it), params))


def make_train_step(bundle: ModelBundle, tcfg: TrainConfig, lr_schedule=None):
    cfg = bundle.cfg

    def train_step(state: TrainState, batch):
        if tcfg.microbatches > 1:
            n = tcfg.microbatches
            grads, loss, metrics = None, 0.0, None
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                (l, metrics), g = value_and_grad(bundle, state.params, state.ds_state, mb)
                grads = (tree_map(lambda a: a.float(), g) if grads is None
                         else tree_map(lambda a, b: a + b.float(), grads, g))
                loss = loss + l
            grads = tree_map(lambda g: g / n, grads)
            loss = loss / n
        else:
            (loss, metrics), grads = value_and_grad(bundle, state.params, state.ds_state, batch)

        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        lr = lr_schedule(state.opt.step) if lr_schedule else tcfg.lr
        new_params, new_opt = adam_update(
            state.params, grads, state.opt, lr,
            b1=tcfg.beta1, b2=tcfg.beta2, eps=tcfg.eps, weight_decay=tcfg.weight_decay)

        new_ds = state.ds_state
        if cfg.head == "ds" and state.ds_state is not None:
            task_loss = metrics.get("ce", loss)
            new_ds = ds.update_mask(new_params["head"], state.ds_state, task_loss, cfg.ds)

        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return TrainState(params=new_params, opt=new_opt, ds_state=new_ds), metrics

    return train_step
