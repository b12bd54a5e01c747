"""Deterministic fault injectors for serving chaos tests (a port of
``repro.testing.faults``).

Each injector plants exactly ONE reproducible fault, so a test can assert
the request lifecycle's typed outcome for it:

* :func:`poison_layer`: NaN an entire backbone layer; every request fails
  at prefill (``FAILED``) and the session keeps serving;
* :func:`poison_token_embedding`: NaN one embedding row; only requests
  whose prompt (or fed-back token) holds that id fail;
* :func:`poison_cache_slot`: NaN one slot's rows of the shared decode
  cache; that slot fails mid-flight, its batchmates are untouched;
* :func:`skew_gate`: zero the DS gate so every token routes to expert 0
  (sustained capacity overflow for the breaker and the adaptation loop);
* :func:`exhaust_pages` / :func:`release_hoarded_pages`: drain a paged
  session's free page list, so residents face arena pressure;
* :func:`poison_page`: NaN one page of the paged arena (typically a shared
  prefix page): every sharer fails on its next read, and the refcounts keep
  the free list whole;
* :func:`oversized_prompt`: a prompt that cannot fit the cache, rejected at
  ``submit()``;
* :func:`swap_storm`: repeated identity-repack table hot-swaps under load;
* :class:`RaisingStreamCB` / :class:`CancelAfter`: a ``stream_cb`` that
  raises for one request, and one that cancels a request from inside the
  callback.

Param injectors return NEW params (the input is never written). The cache
and page injectors write the session's cache IN PLACE on its own device,
between steps: the cache keeps its tensors, so a captured decode graph
reads the poison without capturing again.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def poison_layer(params, layer_idx: int):
    """NaN every float leaf of backbone layer ``layer_idx`` (row
    ``layer_idx`` of each stacked ``(L, …)`` leaf under ``params['layers']``).
    Every prefill and decode then emits NaN for every token, so all
    requests must end ``FAILED`` while the session keeps serving."""

    def poison(tree):
        if isinstance(tree, dict):
            return {k: poison(v) for k, v in tree.items()}
        if not tree.is_floating_point():
            return tree
        out = tree.clone()
        out[layer_idx] = float("nan")
        return out

    return dict(params, layers=poison(params["layers"]))


def poison_token_embedding(params, token_id: int):
    """NaN one row of the input embedding table: only prompts (or sampled
    feedback tokens) holding ``token_id`` produce non-finite activations,
    so the per-request quarantine must fail exactly those requests."""
    table = params["embed"]["table"].clone()
    table[token_id] = float("nan")
    return dict(params, embed=dict(params["embed"], table=table))


def poison_cache_slot(session, slot: int) -> None:
    """NaN slot ``slot``'s rows of the session's decode cache, in place (the
    slot axis of every cache leaf is 1): that resident's next decode step
    returns non-finite values and the session must quarantine it
    mid-flight. On a slot-split mesh session only the rank that holds the
    slot writes, into its own row, as ``repro`` puts the poisoned cache
    back on its placement."""
    row = session._own(slot) if session._mgr is None else session._arena_row(slot)
    if row is None:
        return
    for leaf in session._cache:
        if leaf.is_floating_point():
            leaf[:, row] = float("nan")


def exhaust_pages(session, keep: int = 0) -> list:
    """Hoard the paged session's free pages down to ``keep`` left. The
    hoarded pages are allocated (refcount 1) but mapped to no slot, so the
    next resident that needs a page hits an exhausted arena and the session
    must preempt and requeue its lowest-priority resident (or preempt
    itself). Returns the hoarded page ids for
    :func:`release_hoarded_pages`. Host-side only."""
    m = session._mgr
    hoard = []
    while m.pages_free > keep:
        hoard.append(m.alloc())
    return hoard


def release_hoarded_pages(session, hoard: list) -> None:
    """Return pages taken by :func:`exhaust_pages` to the free list."""
    for pid in hoard:
        session._mgr.decref(pid)


def poison_page(session, pid: int) -> None:
    """NaN page ``pid`` of the paged session's arena, in place (the page axis
    of every arena leaf is 1, so ``[:, pid]`` is one page across all
    layers). Poisoning a SHARED prefix page must quarantine every sharer
    without corrupting the free list: the refcounts drop one failing sharer
    at a time, and whichever sharer frees the page zeroes it. On a
    slot-split mesh session only the rank that holds the page's data
    writes, at the page's index in its own arena."""
    for leaf, kv in zip(session._cache, session._kv_leaf):
        row = session._arena_row(pid, state=not kv)
        if row is not None and leaf.is_floating_point() and leaf.shape[0]:
            leaf[:, row] = float("nan")


def skew_gate(params):
    """Zero the DS head's gate matrix: all gate logits tie, the first
    argmax routes EVERY token to expert 0, and a capacity-bounded serve
    path overflows on ~(B - capacity)/B of the batch each step —
    deterministic sustained overflow for the breaker and the adaptation
    loop. Retrieval stays exact (the grouped paths' overflow fixup re-runs
    the dropped tokens), confined to expert 0's rows."""
    head = dict(params["head"])
    head["gate"] = torch.zeros_like(head["gate"])
    return dict(params, head=head)


def swap_storm(session, head_params, ds_state, *, count: int = 4, every: int = 1) -> int:
    """Drain ``session`` while hot-swapping an identity-repacked table every
    ``every`` decode steps (``count`` swaps in all). Each swap packs the
    UNCHANGED ``(head_params, ds_state)`` pair again, so the table and gate
    swapped in equal the resident ones: residents' tokens must equal a
    storm-free run's, while every swap runs the whole protocol (version
    bump, telemetry reset, one head rebind). Swaps happen between steps.
    Returns the number of swaps made."""
    from repro_torch.core import dssoftmax as ds

    done = 0
    stepped = session.scheduler.has_work()
    while stepped:
        stepped = session.step()
        if done < count and stepped and session.n_steps % every == 0:
            session.swap_table(ds.pack_experts(head_params, ds_state),
                               new_gate=head_params["gate"])
            done += 1
    return done


def oversized_prompt(vocab: int, max_seq_len: int,
                     rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """A valid-token prompt one position too long for the session cache
    (``prompt_len + max_new_tokens - 1 > max_seq_len`` for any
    ``max_new_tokens >= 1``): rejected at ``submit()``."""
    rng = rng or np.random.RandomState(0)
    return rng.randint(0, vocab, max_seq_len + 1).astype(np.int32)


class RaisingStreamCB:
    """A ``stream_cb`` that raises for one request after ``after`` of its
    tokens (for every request, if ``target`` is None). Counts every call, so
    a test can assert that the loop kept streaming the others."""

    def __init__(self, target=None, after: int = 1):
        self.target = target
        self.after = after
        self.n_calls = 0
        self.n_target_calls = 0

    def __call__(self, req, token) -> None:
        self.n_calls += 1
        if self.target is not None and req is not self.target:
            return
        self.n_target_calls += 1
        if self.n_target_calls >= self.after:
            raise RuntimeError("injected stream_cb failure")


class CancelAfter:
    """A ``stream_cb`` that cancels ``target`` from INSIDE the callback once
    it has emitted ``after`` tokens: the emitting slot is released while the
    step loop still walks its snapshot of the active slots."""

    def __init__(self, session, target, after: int):
        self.session = session
        self.target = target
        self.after = after
        self.cancelled = False

    def __call__(self, req, token) -> None:
        if req is self.target and len(req.out_tokens) >= self.after and not self.cancelled:
            self.cancelled = self.session.cancel(self.target)
