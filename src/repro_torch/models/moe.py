"""Token-choice top-k MoE FFN (olmoe / qwen3-moe backbones).

Sort-based dispatch per batch row (as ``repro.models.moe``): a row's
tokens are grouped by expert within that row only, so one row's tokens
never change another row's drops, and greedy streams stay the same across
batching. Per-row capacity is ``C = max(1, round(S·top_k/E ·
capacity_factor))``; an assignment past it falls back to its residual
stream (counted in ``MoEAux.drop_frac``).

Every row is dispatched by one ``dispatch_indices`` call, row b's expert
ids offset by ``b·E``; the call makes no host sync and has no
data-dependent shape, so a CUDA graph captures the block. The dispatch
buffer is ``(E, B·C, d)`` plus one trash row that every dropped
assignment writes to, for torch raises where JAX's ``mode="drop"``
scatter drops.

The expert products are plain batched matrix products (``repro``
computes them outside any kernel too). On the CPU both operands of the
gate and up products are widened to fp32, as ``repro``'s CPU branch does;
on the card they take bf16 operands with fp32 outputs
(``preferred_element_type=jnp.float32`` in ``repro``'s expert-parallel
branch), with no fp32 copy of the ``(E, d, f)`` weights.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dispatch import dispatch_indices
from repro_torch.core.dssoftmax import normal_
from repro_torch.device import on_card
from repro_torch.distributed import sharding
from repro_torch.kernels.ref import topk_stable


class MoEAux(NamedTuple):
    load_loss: torch.Tensor
    drop_frac: torch.Tensor


def init_moe(generator: torch.Generator, cfg: ModelConfig, n_layers: int, device="cuda"):
    """Seeded MoE params of ``n_layers`` layers, stacked on a leading
    ``(L, …)`` axis: router fp32 (d, E), ``w_gate``/``w_up`` (E, d, f),
    ``w_down`` (E, f, d) in the config dtype, each N(0, 1/fan_in) with
    ``repro``'s ``dense_init`` fan-in (the first axis; f for ``w_down``)."""
    d, mc, dt = cfg.d_model, cfg.moe, cfg.jdtype
    E, f = mc.num_experts, mc.d_ff_expert

    def init(shape, dtype, fan_in=None):
        w = torch.empty((n_layers,) + shape, dtype=dtype, device=device)
        return normal_(w, generator, 1.0 / math.sqrt(fan_in or shape[0]))

    return {
        "router": init((d, E), torch.float32),
        "w_gate": init((E, d, f), dt),
        "w_up": init((E, d, f), dt),
        "w_down": init((E, f, d), dt, fan_in=f),
    }


def capacity(cfg: ModelConfig, S: int) -> int:
    """Per-row expert capacity for a row of ``S`` tokens."""
    mc = cfg.moe
    return int(max(1, round(S * mc.top_k / mc.num_experts * mc.capacity_factor)))


class _BmmF32(torch.autograd.Function):
    """``torch.bmm(a, b, out_dtype=torch.float32)``, which has no
    derivative: the backward multiplies the fp32 cotangent with fp32 copies
    of the operands, as the CPU's widened product does, and rounds each
    gradient to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return da, db


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with fp32 outputs: bf16 operands on the card, both widened
    to fp32 on the CPU (which has no ``aten::bmm.dtype`` kernel)."""
    if on_card(a):
        return _BmmF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


def route(params, cfg: ModelConfig, x: torch.Tensor):
    """The router and the per-row dispatch of x (B, S, d) → (probs (B, S, E)
    fp32, top_p (B, S, K) renormalized, top_e (B, S, K), slot (B, S, K)
    long, valid (B, S, K) bool): the top-k experts of fp32 softmax(x·R),
    ties to the lower id as ``jax.lax.top_k`` breaks them, and each
    assignment's rank within its (row, expert), valid below the row's
    capacity."""
    B, S, _ = x.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    top_p, top_e = topk_stable(probs, K)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    # every row in one call: row b's ids offset by b·E
    rows = torch.arange(B, device=x.device)[:, None, None]
    slot, valid = dispatch_indices((top_e + rows * E).reshape(-1), B * E, capacity(cfg, S))
    return probs, top_p, top_e, slot.reshape(B, S, K).long(), valid.reshape(B, S, K)


def _expert_ffn(params, x: torch.Tensor, e, top_p, slot, valid, C: int) -> torch.Tensor:
    """The experts of ``params`` (E of them: ``w_gate`` (E, d, f), …) on
    the assignments ``valid`` marks: dispatch x (B, S, d) into (E, B·C, d)
    by expert ids ``e`` (B, S, K) in [0, E) and ``slot``, the gate and up
    products with fp32 outputs, the down product, and the combine weighted
    by ``top_p`` in fp32 → (B·S, d) fp32."""
    B, S, d = x.shape
    E, K = params["w_gate"].shape[0], e.shape[-1]
    rows = torch.arange(B, device=x.device)[:, None, None]

    # buffer row (e·B + b)·C + slot; dropped assignments go to the trash row
    base = (e * B + rows) * C                                        # (B, S, K)
    trash = E * B * C
    dst = torch.where(valid, base + slot, trash)
    buf = torch.zeros((trash + 1, d), dtype=x.dtype, device=x.device)
    xr = x.reshape(B * S, d)
    for k in range(K):
        buf.index_copy_(0, dst[..., k].reshape(-1), xr)
    buf = buf[:trash].view(E, B * C, d)

    g = F.silu(_bmm_f32(buf, params["w_gate"]))
    u = _bmm_f32(buf, params["w_up"])
    yb = torch.bmm((g * u).to(x.dtype), params["w_down"]).view(E * B * C, d)

    src = base + torch.clamp(slot, max=C - 1)
    w = torch.where(valid, top_p, 0.0)
    y = torch.zeros((B * S, d), dtype=torch.float32, device=x.device)
    for k in range(K):
        y = y + yb[src[..., k].reshape(-1)].float() * w[..., k].reshape(-1, 1)
    return y


def moe_ep_local(params, cfg: ModelConfig, x: torch.Tensor, top_e, top_p, slot, valid,
                 shard: int, n_shards: int) -> torch.Tensor:
    """One model shard's part of the expert-parallel FFN
    (``repro.models.moe._moe_ep_shardmap``'s region): ``params`` holds this
    shard's E/n_shards experts (the router is not read); the routing
    (``top_e``, ``top_p``, ``slot``, ``valid``: :func:`route` of x) is the
    global per-row one, so the drop pattern is the whole block's. The
    shard dispatches its own experts' assignments into (E_loc, B·C, d)
    buffers, runs their MLPs with fp32 accumulation, combines with the
    weights of its assignments (the others weigh 0) in fp32, and rounds the
    partial sum to the activation dtype → (B, S, d). The sum of the shards'
    partials in that dtype is the block's output."""
    B, S, d = x.shape
    E = cfg.moe.num_experts
    if E % n_shards or params["w_gate"].shape[0] != E // n_shards:
        raise ValueError(f"shard {shard} of {n_shards} needs E/{n_shards} = "
                         f"{E // n_shards} experts of {E}, got {params['w_gate'].shape[0]}")
    e_loc = E // n_shards
    e_local = top_e - shard * e_loc
    in_shard = valid & (e_local >= 0) & (e_local < e_loc)
    y = _expert_ffn(params, x, torch.clamp(e_local, 0, e_loc - 1), top_p, slot, in_shard,
                    capacity(cfg, S))
    return y.view(B, S, d).to(x.dtype)


def expert_parallel(cfg: ModelConfig, mesh) -> bool:
    """Whether ``moe_block`` on ``mesh`` takes the expert-parallel FFN: the
    mesh has a ``model`` axis that divides E (``repro.models.moe:132``; a
    ``model`` axis of 1 is one shard)."""
    if mesh is None:
        return False
    m = sharding.mesh_sizes(mesh).get("model")
    return m is not None and cfg.moe.num_experts % m == 0


def moe_block(params, cfg: ModelConfig, x: torch.Tensor, mesh=None):
    """x: (B, S, d) → ((B, S, d), MoEAux), Switch-style aux load loss.

    ``mesh`` (the mesh train step's; ``repro`` reads the ambient mesh) puts
    the rows of x on this rank's batch share: the aux loss's f and P and
    the drop fraction are then means over every batch rank's rows
    (``sharding.batch_sum``). Where :func:`expert_parallel` holds,
    ``params``' expert stacks are this rank's ``model`` block and the FFN
    runs expert-parallel (:func:`moe_ep_local` between
    ``sharding.model_enter`` on x and the combine weights and
    ``sharding.model_exit`` on the partial)."""
    B, S, d = x.shape
    C = capacity(cfg, S)
    probs, top_p, top_e, slot, valid = route(params, cfg, x)

    if expert_parallel(cfg, mesh):
        n = sharding.mesh_sizes(mesh)["model"]
        part = moe_ep_local(params, cfg, sharding.model_enter(x, mesh), top_e,
                            sharding.model_enter(top_p, mesh), slot, valid,
                            sharding.axis_index(mesh, "model"), n)
        y = sharding.model_exit(part, mesh)
    else:
        y = _expert_ffn(params, x, top_e, top_p, slot, valid, C).view(B, S, d).to(x.dtype)

    return y, switch_aux(probs, top_e, valid, mesh)


def switch_aux(probs, top_e, valid, mesh=None) -> MoEAux:
    """The Switch aux load loss E · Σ_e f_e · P_e (f: the top-1 token
    fraction, P: the mean router probability) and the drop fraction of
    :func:`route`'s outputs; with ``mesh`` (the mesh train step's) f, P and
    the drops are over every batch rank's tokens."""
    E = probs.shape[-1]
    top1 = top_e[..., 0].reshape(-1)
    ones = torch.ones(top1.shape, dtype=torch.float32, device=probs.device)
    counts = torch.zeros(E, device=probs.device).index_add_(0, top1, ones)
    f = sharding.batch_sum(counts, mesh) / (top1.numel() * sharding.batch_ranks(mesh))
    P = sharding.batch_mean(probs.reshape(-1, E), mesh)
    drop = 1.0 - sharding.batch_mean(valid.float().reshape(-1), mesh)
    return MoEAux(load_loss=E * torch.sum(f * P), drop_frac=drop)
