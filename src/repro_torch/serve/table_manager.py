"""Versioned serve-table resource and traffic-adaptive repacking.

The port of ``repro.serve.table_manager``:

* :class:`TableResource` — versioned holder of the current
  ``(table, gate, version)``; ``swap`` installs the new table and bumps
  the version. Swaps happen between decode steps, so a step reads one
  version whole.
* :class:`TrafficProfile` — a windowed O(K) host-side view of the
  per-expert dispatch/overflow counters the decode step returns
  (``ServeSession.traffic_profile()`` builds one).
* :func:`repack_for_traffic` — optional group-lasso re-prune
  (``kernels.lasso_prune`` + ``core.pruning.keep_one_copy``), selective
  mitosis of persistently overflowing experts (:func:`clone_selected`), a
  fresh ``pack_experts`` fitted to the surviving rows, and a capacity
  factor sized to the hottest expert.
* :class:`AdaptPolicy` — the knobs of ``ServeSession(adapt_policy=...)``,
  which runs this loop online, swapping only between decode steps.

Differences from ``repro``: there is no distributed port yet, so
``TableResource`` takes no mesh; it keeps no back buffer either (see its
docstring); the
mitosis noise comes from a ``torch.Generator`` where ``repro`` takes a
``jax.random`` key (``generator=None`` turns mitosis off, as ``key=None``
does), so its bits differ from JAX's.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import dssoftmax as ds
from repro_torch.core import pruning
from repro_torch.kernels import ops as kops

log = logging.getLogger("repro_torch.table_manager")


class TableResource:
    """Versioned owner of the serving table.

    Holds the CURRENT ``(table, gate, version)`` only. ``repro`` keeps the
    retired table in a back buffer because JAX may still be running a step
    dispatched on it; here the caching allocator releases a dropped
    tensor's memory in stream order, after the kernels queued on it, so
    holding the old table would only pin its device bytes after every
    swap. For DS heads ``table`` is a packed
    :class:`~repro_torch.core.dssoftmax.ServeTable` or
    :class:`~repro_torch.core.dssoftmax.QuantizedServeTable`; non-DS heads
    store their opaque head state here unchanged (a swap still versions it).
    """

    def __init__(self, table, gate: Optional[torch.Tensor] = None):
        self.version = 0
        self.gate = gate
        self.table = table

    def swap(self, new_table, gate: Optional[torch.Tensor] = None) -> int:
        """Install ``new_table`` (and optionally its gate) as the current
        version and drop the old one. Returns the new version."""
        self.table = new_table
        if gate is not None:
            self.gate = gate
        self.version += 1
        return self.version


@dataclass(frozen=True)
class TrafficProfile:
    """Windowed per-expert traffic: the O(K) accumulators
    :func:`repack_for_traffic` consumes.

    ``dispatched``/``overflow`` are (K,) int64 sums over the stats window;
    ``start_step``/``end_step`` are the session-step stamps bounding it
    (``steps`` decode steps in all)."""

    dispatched: np.ndarray
    overflow: np.ndarray
    steps: int
    start_step: int
    end_step: int

    @property
    def n_experts(self) -> int:
        return int(self.dispatched.shape[0])

    @property
    def total_dispatched(self) -> int:
        return int(self.dispatched.sum())

    @property
    def overflow_rate(self) -> float:
        """Window-wide overflowed/dispatched token fraction."""
        return float(self.overflow.sum()) / max(1.0, float(self.dispatched.sum()))

    @property
    def load_share(self) -> np.ndarray:
        """(K,) fraction of window traffic each expert received."""
        return self.dispatched / max(1, self.total_dispatched)

    def per_expert_overflow_rate(self) -> np.ndarray:
        """(K,) overflowed fraction of each expert's OWN traffic."""
        return self.overflow / np.maximum(self.dispatched, 1)

    def hot_experts(self, overflow_threshold: float, min_dispatch: int = 1) -> np.ndarray:
        """Indices of persistently overflowing experts: overflow rate above
        ``overflow_threshold`` on at least ``min_dispatch`` tokens."""
        rates = self.per_expert_overflow_rate()
        return np.nonzero((rates > overflow_threshold)
                          & (self.dispatched >= min_dispatch))[0]


def clone_selected(generator: torch.Generator, head_params: dict, state: ds.DSState,
                   experts: Sequence[int], noise: float = 1e-2):
    """Serving-side selective mitosis: clone only ``experts`` (K → K+m).

    Each selected parent keeps ``gate + eps`` and its offspring, appended
    at the END (indices K..K+m-1), gets ``gate - eps`` and the parent's
    expert rows and mask verbatim, so every existing expert index keeps
    its meaning across a swap. ``eps`` keeps the reference's dtype order:
    a normal draw in the gate's dtype from ``generator`` (on the
    generator's device), times ``noise``, times the population std of the
    fp32 gate cast to the gate's dtype. A zero gate gives ``eps = 0``."""
    sel = np.asarray(experts, np.int64).reshape(-1)
    gate = head_params["gate"]            # (K, d)
    w = head_params["experts"]            # (K, N, d)
    if sel.size == 0:
        return dict(head_params), state
    if sel.min() < 0 or sel.max() >= gate.shape[0]:
        raise ValueError(f"clone_selected expert ids {sel.tolist()} out of range "
                         f"[0, {gate.shape[0]})")
    idx = torch.from_numpy(sel).to(gate.device)
    draw = torch.randn((sel.size, gate.shape[1]), generator=generator,
                       dtype=gate.dtype, device=generator.device).to(gate.device)
    eps = draw * noise * torch.std(gate.float(), correction=0).to(gate.dtype)
    parent = gate[idx]
    new_gate = gate.clone()
    new_gate[idx] = parent + eps
    new_gate = torch.cat([new_gate, parent - eps])
    new_w = torch.cat([w, w[idx]])
    new_mask = torch.cat([state.mask, state.mask[idx]])
    return dict(head_params, gate=new_gate, experts=new_w), ds.DSState(mask=new_mask)


def suggested_capacity_factor(profile: TrafficProfile, n_experts_new: int,
                              headroom: float = 1.5,
                              base: Optional[float] = None) -> float:
    """Capacity factor sized so the observed hottest expert fits its
    grouped-dispatch buffer with ``headroom`` to spare: the grouped paths
    allocate ``round(B/K·cf)`` slots per expert, so a ``max_share`` traffic
    fraction needs ``cf >= max_share·K``. Uses the pre-mitosis share and
    never shrinks below ``base`` (the session's current factor)."""
    max_share = float(profile.load_share.max()) if profile.total_dispatched else 0.0
    cf = headroom * max_share * n_experts_new
    if base is not None:
        cf = max(cf, float(base))
    return float(cf)


@dataclass(frozen=True)
class RepackResult:
    """Everything :meth:`ServeSession.swap_table` needs: the evolved head
    params/state (inputs to the next repack), the freshly packed table and
    the capacity suggestion."""

    head_params: dict
    state: ds.DSState
    table: ds.ServeTable
    capacity_factor: float
    cloned: tuple
    rows_pruned: int


def repack_for_traffic(
    head_params: dict,
    state: ds.DSState,
    profile: TrafficProfile,
    *,
    generator: Optional[torch.Generator] = None,
    prune_gamma: Optional[float] = None,
    mitosis_overflow_threshold: float = 0.25,
    min_overflow_dispatch: int = 1,
    headroom: float = 1.5,
    base_capacity_factor: Optional[float] = None,
    noise: float = 1e-2,
    pad: Optional[int] = None,
) -> RepackResult:
    """Fit the serve table to the observed traffic, in three optional moves:

    1. **Re-prune** (``prune_gamma``): one ``kernels.lasso_prune`` pass on
       the head's device (on the card, the CUDA kernel) drops rows whose
       norm is at most ``gamma``; :func:`~repro_torch.core.pruning.keep_one_copy`
       keeps one copy of every class.
    2. **Mitosis** (``generator`` + overflowing experts): experts whose
       windowed overflow rate exceeds ``mitosis_overflow_threshold`` are
       cloned by :func:`clone_selected`.
    3. **Pack + capacity**: ``pack_experts`` with the pad fitted to the
       surviving rows (``pad=None``), and :func:`suggested_capacity_factor`.

    Pure with respect to its inputs; the caller decides when to swap the
    result in."""
    if profile.n_experts != head_params["gate"].shape[0]:
        raise ValueError(
            f"profile covers {profile.n_experts} experts but the gate has "
            f"{head_params['gate'].shape[0]}")
    rows_pruned = 0
    if prune_gamma is not None:
        w = head_params["experts"]
        norms, candidate = kops.lasso_prune(w, state.mask, prune_gamma, device=w.device)
        new_mask = pruning.keep_one_copy(candidate, norms, state.mask)
        rows_pruned = int(state.mask.sum()) - int(new_mask.sum())
        state = ds.DSState(mask=new_mask)

    hot = profile.hot_experts(mitosis_overflow_threshold, min_dispatch=min_overflow_dispatch)
    if generator is None:
        hot = hot[:0]  # no generator -> mitosis off, report nothing cloned
    if hot.size:
        head_params, state = clone_selected(generator, head_params, state, hot, noise=noise)

    table = ds.pack_experts(head_params, state, pad=pad)
    cf = suggested_capacity_factor(profile, head_params["gate"].shape[0],
                                   headroom=headroom, base=base_capacity_factor)
    log.info("repack_for_traffic: K=%d (cloned %s), V_pad=%d, %d rows pruned, "
             "capacity_factor -> %.2f (window overflow %.3f over %d steps)",
             head_params["gate"].shape[0], hot.tolist(), table.v_pad, rows_pruned,
             cf, profile.overflow_rate, profile.steps)
    return RepackResult(head_params=head_params, state=state, table=table,
                        capacity_factor=cf, cloned=tuple(int(e) for e in hot),
                        rows_pruned=rows_pruned)


@dataclass(frozen=True)
class AdaptPolicy:
    """Online adaptation knobs for ``ServeSession(adapt_policy=...)``.

    Every ``interval`` decode steps the session inspects its windowed
    :class:`TrafficProfile` (at least ``min_window_steps`` steps old); if
    the window overflow rate exceeds ``overflow_threshold`` it runs
    :func:`repack_for_traffic` and hot-swaps the result, between steps, at
    most ``max_swaps`` times per session. Swaps evolve the session's
    tracked ``(head_params, ds_state)`` pair, so repeated adaptations
    compound. The mitosis generator of swap n is seeded from
    ``(seed, n)``."""

    interval: int = 32
    overflow_threshold: float = 0.05
    mitosis_overflow_threshold: float = 0.25
    prune_gamma: Optional[float] = None
    headroom: float = 1.5
    max_swaps: int = 4
    min_window_steps: int = 8
    noise: float = 1e-2
    seed: int = 0
