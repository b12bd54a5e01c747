"""The canonical train step: loss → grads → clip → Adam → mask pruning.

One function for every architecture (the ModelBundle supplies the loss).
Supports microbatched gradient accumulation in fp32 and the DS-Softmax
mask update (paper Algorithm 1's "if L_task < t: prune").

The step is functional: the params and moments of the state it is given
are never written, so the Trainer can retry a failed step from it.
Gradients come from ``torch.autograd.grad`` on detached copies of the
params that require grad; the params kept in a :class:`TrainState` never
require grad, so serving them runs the kernels.

``make_train_step(..., mesh=)`` steps a sharded state over a
``torch.distributed`` mesh, one process per rank: data parallel compute
over a train state each rank holds a block of (``repro`` writes the same
step once and GSPMD places it; here the collectives are explicit and live
in ``distributed.sharding``, each the identity without a mesh).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import dssoftmax as ds
from repro_torch.distributed import sharding
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.optim import OptState, adam_update, clip_by_global_norm
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    ds_state: Optional[ds.DSState]


def value_and_grad(bundle: ModelBundle, params, ds_state, batch, mesh=None, gather=None):
    """→ ((total loss, metrics), grads): grads a tree like ``params``, each
    leaf in its param's dtype (zeros for a param the loss does not read);
    the loss and metrics detached. ``mesh``: ``batch`` is this rank's share
    of the mesh step's, the loss the whole batch's, and the grads this
    rank's (``distributed.sharding``'s loss convention). ``gather`` (a
    ``sharding.TrainParamGather``): ``params`` are this rank's blocks, the
    loss reads every leaf through it, and the grads are the blocks' of the
    batch group's mean (each gather's backward reduces into its block), in
    fp32 where the batch ranks sum."""
    leaves = tree_leaves(params)
    req = (gather.grad_leaves(params) if gather is not None
           else [p.detach().requires_grad_(True) for p in leaves])
    it = iter(req)
    live = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        total, metrics = bundle.train_loss(live, ds_state, batch, mesh=mesh, gather=gather)
        grads = torch.autograd.grad(total, req, allow_unused=True)
    if gather is not None:
        missed = [p for p, g in zip(tree_paths(params), grads)
                  if g is not None and p not in gather.gathered]
        if missed:
            raise RuntimeError(f"the loss read {missed} without the step's gather: their "
                               "gradients would not be reduced over the batch ranks")
    it = iter(g if g is not None else torch.zeros_like(p) for g, p in zip(grads, req))
    return ((total.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(lambda _: next(it), params))


def rank_rows(x: torch.Tensor, mesh, micro: int, n_micro: int) -> torch.Tensor:
    """This rank's rows of microbatch ``micro`` of ``n_micro`` of a global
    batch leaf x (B, …): microbatch i is rows [i·B/n, (i+1)·B/n), and on a
    mesh this rank takes its batch block of it (row-major over (pod,
    data)). So every microbatch holds the rows it holds on one device, and
    its batch statistics are the same."""
    nb = sharding.batch_ranks(mesh)
    B = x.shape[0]
    if B % (n_micro * nb):
        raise ValueError(f"a batch of {B} rows does not split into {n_micro} microbatches "
                         f"over {nb} batch ranks")
    w = B // (n_micro * nb)
    return x.narrow(0, (micro * nb + sharding.batch_index(mesh)) * w, w)


def make_train_step(bundle: ModelBundle, tcfg: TrainConfig, lr_schedule=None, mesh=None,
                    shardings=None):
    """The train step ``(state, batch) → (new state, metrics)``:

    1. with ``mesh`` (a ``launch.mesh`` DeviceMesh over the running world;
       the step runs on every rank with the same global ``batch`` and steps
       this rank's block of a sharded ``TrainState``, placed by
       ``shardings``: ``sharding.train_state_shardings`` of the whole
       state, which ``sharding.shard_train_state`` makes beside the blocks)
       the params stay this rank's blocks through the step: the loss reads
       them through a ``sharding.TrainParamGather``, which gathers one
       layer (inside its ``remat`` region), one DS expert's rows or one
       small leaf where it runs, and whose backward reduces each gathered
       leaf's gradient into this rank's block of the batch group's mean
       (fp32 where ranks sum); the DS mask is gathered whole;
    2. per microbatch (:func:`rank_rows`: on a mesh this rank's rows of
       it), the loss of the whole microbatch and the gradients with respect
       to the blocks, summed in fp32 over microbatches, or in the params'
       dtype where there is one;
    3. the global-norm clip (on a mesh over the blocks), Adam, and the DS
       mask update (paper Algorithm 1; the row norms summed over ``data``
       where the experts' ``d`` is split).

    Loss and metrics are the whole batch's, equal on every rank. Without a
    mesh every collective is the identity. ``train_step.gather`` is the
    step's ``TrainParamGather`` (None without a mesh)."""
    cfg = bundle.cfg
    p_specs = mask_spec = norm_group = gather = None
    if mesh is not None:
        if shardings is None:
            raise ValueError("a mesh step needs the state's placement: shardings="
                             "sharding.train_state_shardings(mesh, whole_state)")
        p_specs = shardings.params
        gather = sharding.TrainParamGather(mesh, p_specs)
        mask_spec = shardings.ds_state.mask if shardings.ds_state is not None else None
        if cfg.head == "ds" and mask_spec is not None:
            d_axes = [a for a in sharding._spec_axes(p_specs["head"]["experts"][-1])
                      if sharding.mesh_sizes(mesh)[a] > 1]
            norm_group = sharding.axis_group(mesh, tuple(d_axes)) if d_axes else None

    def train_step(state: TrainState, batch):
        ds_state = state.ds_state
        whole_ds = None if ds_state is None else ds.DSState(
            mask=sharding.gather_leaf(ds_state.mask, mask_spec, mesh))
        n = tcfg.microbatches
        grads, loss, metrics = None, 0.0, None
        for i in range(n):
            mb = {k: rank_rows(v, mesh, i, n) for k, v in batch.items()}
            (l, metrics), g = value_and_grad(bundle, state.params, whole_ds, mb, mesh=mesh,
                                             gather=gather)
            if n == 1:  # the params' dtype
                grads = tree_map(lambda a, p: a.to(p.dtype), g, state.params)
            elif grads is None:
                grads = tree_map(lambda a: a.float(), g)
            else:
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
            loss = loss + l
        del g
        if n > 1:
            grads = tree_map(lambda g: g / n, grads)
            loss = loss / n
        else:
            loss = l

        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip, mesh=mesh, specs=p_specs)
        lr = lr_schedule(state.opt.step) if lr_schedule else tcfg.lr
        new_params, new_opt = adam_update(
            state.params, grads, state.opt, lr,
            b1=tcfg.beta1, b2=tcfg.beta2, eps=tcfg.eps, weight_decay=tcfg.weight_decay)

        new_ds = ds_state
        if cfg.head == "ds" and ds_state is not None:
            task_loss = metrics.get("ce", loss)
            new_ds = ds.update_mask(new_params["head"], ds_state, task_loss, cfg.ds,
                                    norm_group=norm_group)

        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return TrainState(params=new_params, opt=new_opt, ds_state=new_ds), metrics

    train_step.gather = gather
    return train_step
