"""Continuous-batching serving: ``ServeSession`` + ``Scheduler``.

Slot-based continuous batching over one model bundle: a fixed number of
decode slots share one contiguous KV cache and one decode step; every slot
carries its own sequence position, so a finished request releases its slot
mid-flight and the next queued prompt is prefilled into it while the other
slots keep decoding. Per-request
:class:`SamplingParams` control ``max_new_tokens``, ``eos_id``,
greedy/temperature sampling, a ``deadline_steps`` budget and the shed
``priority``; a ``stream_cb`` hook observes every emitted token.

Lifecycle contract (as in ``repro.train.serve``): every request ends in
exactly one terminal :class:`RequestStatus`; ``submit`` validates before
any compute; the admission queue is bounded by ``queue_limit``; a
non-finite top-k output quarantines only the poisoned slot (``FAILED``,
slot released and its cache rows zeroed).

Sampling is host-side numpy: a counter-based Philox stream keyed by
``(seed, emission index)`` drives Gumbel-max top-k sampling, copied from
``repro.train.serve`` so sampled streams match it token for token.

``quantize='int8'`` serves the DS table from int8 rows with per-row fp32
scales, gated for exactness as ``repro.train.serve`` gates it.

The packed table is a versioned resource
(:class:`~repro_torch.serve.table_manager.TableResource`):
``swap_table`` hot-swaps a repacked, re-pruned or mitosed table between
decode steps, and ``adapt_policy=`` runs the repack online from the
step-stamped per-expert stats window. An overflow circuit breaker degrades
a session whose capacity buffers keep overflowing (trip 1 doubles the
capacity factor; trip 2 serves through the ``'cuda_fused'`` kernel, which
has no capacity buffers, where ``repro`` moves to ``'jnp'``). Where
``repro`` re-traces its decode step, the port rebinds its head (once at
init, once per swap, once per breaker trip; ``stats()['decode_builds']``).

Where ``repro`` compiles the decode step once (``jax.jit``), the port
captures the step's backbone (``bundle.decode_hidden``: the embedding, the
layers and the final norm) once per session as a CUDA graph and replays it
every step; the DS head runs eagerly after the replay on the graph's
hidden-state output (its overflow fixup branches on the host). The backbone
reads no table, so swaps and breaker trips rebind the head and never
recapture (``stats()['decode_graphs']`` counts captures). On the CPU the
step runs eagerly.

Prefill into a slot is whole-prompt (one ``bundle.prefill`` at the prompt's
length; on the card its attention runs the ``flash_attention`` kernel) or
chunked (``prefill_chunk=C``: the prompt streams through
``bundle.prefill_chunk`` in right-padded (1, C) chunks written in place
into the slot's cache).

``paged=True`` replaces the per-slot cache rows with an arena of fixed-size
pages (:mod:`repro_torch.serve.paged_cache`): a host-side page table maps
each slot's positions to pages; with chunked prefill, requests that share
a chunk-aligned prompt prefix prefill it once and share its pages
copy-on-write; under arena pressure the session preempts the
lowest-priority resident and requeues it at the front of the queue. A
preempted request resumes by re-prefilling ``prompt ++ out_tokens[:-1]``
and continues its sampling stream at the preserved emission count. The
decode step runs the same attention math on the gathered page view.

``draft=(bundle, params, ds_state_or_table)`` turns on exact draft–verify
speculative decoding, as in ``repro.train.serve``: each step the draft
proposes ``gamma`` tokens per resident (sequential n_slots-token draft
decodes against the draft's own contiguous cache), the target scores every
resident's (gamma+1)-token block in one ``bundle.verify_step``-shaped call
(the chunk backbone at per-slot positions, the head over all
n_slots·(gamma+1) rows), and a host-side pass accepts: greedy emits the
longest draft prefix that matches the target's argmax chain plus the
target's token after it; sampled requests run rejection sampling over the
head's top-k candidates, every uniform keyed by ``(seed, emission index)``
(the acceptance rule and its Philox salts are copied from ``repro``, so
the same blocks draw the same uniforms). Unlike ``repro``'s, the draft
decodes the last proposal of a block the target accepted whole before its
next round, so its cache holds every accepted token. On the card the draft's backbone
and the verify backbone are each captured once as a CUDA graph (a
:class:`_DecodeGraph` of width 1 over the draft's params and cache, and
one of width gamma+1 over the target's), their heads eager after the
replays.

The recurrent-state families (ssm, hybrid) keep each slot's conv/ssm state
in the cache beside the shared attention block's K/V (a
:class:`~repro_torch.models.hybrid.HybridCache`): a whole-prompt prefill
writes the slot's state row, a chunked one threads it through the slot's
row from zero. Paged, each slot owns one state page of a state arena
(``state_arena`` pages, default ``4 * n_slots``), and a prefix registered
at a full-chunk boundary carries a snapshot page of the state there, which
an adopter copies into its own page. Their verify step leaves conv/ssm
untouched (a rejected token's update cannot be rolled back); after
acceptance ``bundle.commit_block`` advances each slot by its accepted
prefix through the one-token recurrence, eagerly. A state-family draft
copies its conv/ssm before proposing and commits from that copy, as
``repro``'s draft commits from its pre-block snapshot.

On a mesh (``mesh=``) each rank holds and steps only the slots of its
``(pod, data)`` coordinate, where ``repro``'s ``serve_cache_shardings``
places them (a paged arena: its block of pages, where
``serve_paged_cache_shardings`` places them); the host side (scheduler,
tokens, positions, page table, stats) stays global and the same on every
rank, and the head merges the ranks' rows.
"""
from __future__ import annotations

import collections
import enum
import gc
import logging
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.core import dssoftmax as ds
from repro_torch.device import check_on, resolve_device
from repro_torch.distributed import sharding
from repro_torch.models import heads
from repro_torch.models.model_zoo import (ModelBundle, cache_kv_leaves, cache_specs,
                                          paged_cache_specs)
from repro_torch.serve.paged_cache import N_RESERVED, PagedCacheManager, prefix_hash
from repro_torch.serve.table_manager import (
    AdaptPolicy,
    TableResource,
    TrafficProfile,
    repack_for_traffic,
)

log = logging.getLogger("repro_torch.serve")

# One Philox uniform stream per decision kind, each keyed by (seed, absolute
# emission index): a stream's uniforms do not depend on how speculative
# blocks were aligned, so a preempted request resumes identically.
_SALT_SAMPLE = 0x5A17_0001   # plain top-k Gumbel-max sampling
_SALT_DRAFT = 0x5A17_0002    # draft proposal sampling
_SALT_ACCEPT = 0x5A17_0003   # speculative accept/reject uniform
_SALT_RESID = 0x5A17_0004    # speculative residual draw
# eager decode steps on a side stream before the capture (lazy cuBLAS and
# allocator set-up must not happen under capture), as PyTorch's own
# make_graphed_callables warms up
GRAPH_WARMUP_STEPS = 3


def _uniforms(seed: int, salt: int, m: int, n: int) -> np.ndarray:
    """``n`` iid U[0,1) doubles from a counter-based Philox stream — a
    function of (seed, salt, m) alone. The emission index seeds the high
    counter word; the generator's own draws bump the low words."""
    bg = np.random.Philox(
        key=np.array([seed & 0xFFFF_FFFF_FFFF_FFFF, salt], np.uint64),
        counter=np.array([0, 0, 0, m], np.uint64),
    )
    return np.random.Generator(bg).random(n)


class RequestStatus(enum.Enum):
    """Request lifecycle states. ``QUEUED``/``ACTIVE`` are transient; the
    rest are terminal."""

    QUEUED = "queued"
    ACTIVE = "active"
    COMPLETED = "completed"
    REJECTED = "rejected"
    CANCELLED = "cancelled"
    TIMED_OUT = "timed_out"
    FAILED = "failed"


TERMINAL = frozenset({
    RequestStatus.COMPLETED,
    RequestStatus.REJECTED,
    RequestStatus.CANCELLED,
    RequestStatus.TIMED_OUT,
    RequestStatus.FAILED,
})


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding controls. ``temperature <= 0`` is greedy;
    otherwise tokens are sampled from the softmax over the head's top-k
    candidates (``top_k`` narrows them further). ``eos_id`` stops the
    request when emitted (included). ``deadline_steps`` bounds its
    lifetime in session decode steps from ``submit()``. ``priority``
    (higher first) orders admission and picks shed victims."""

    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    temperature: float = 0.0
    seed: int = 0
    top_k: Optional[int] = None
    deadline_steps: Optional[int] = None
    priority: int = 0


@dataclass(eq=False)  # identity equality: queue membership must never
class Request:        # compare prompt arrays elementwise
    prompt: np.ndarray          # (S,) int32
    # legacy shorthand for sampling=SamplingParams(max_new_tokens=n)
    max_new_tokens: Optional[int] = None
    out_tokens: List[int] = field(default_factory=list)
    sampling: Optional[SamplingParams] = None
    status: RequestStatus = RequestStatus.QUEUED
    error: Optional[str] = None
    submit_step: Optional[int] = None

    @property
    def done(self) -> bool:
        return self.status in TERMINAL

    @property
    def sampling_params(self) -> SamplingParams:
        if self.sampling is not None:
            if self.max_new_tokens is not None:
                raise ValueError(
                    "Request sets both the legacy max_new_tokens field "
                    f"({self.max_new_tokens}) and sampling= (max_new_tokens="
                    f"{self.sampling.max_new_tokens}); SamplingParams is the "
                    "single source of truth — drop the legacy field"
                )
            return self.sampling
        if self.max_new_tokens is not None:
            return SamplingParams(max_new_tokens=self.max_new_tokens)
        return SamplingParams()


@dataclass
class _Slot:
    """Host-side state of one occupied decode slot."""

    req: Request
    prompt_len: int
    n_emitted: int = 0
    admit_seq: int = 0  # admission order (the preemption tiebreak)

    @property
    def pos(self) -> int:
        """Cache position the next decode step writes for this slot."""
        return self.prompt_len + self.n_emitted - 1


class Scheduler:
    """Bounded priority admission queue + slot map (host-side bookkeeping).

    ``submit`` on a full queue sheds the lowest-priority request (newest
    among ties, possibly the incoming one) and returns it; ``pop_next``
    admits the highest priority, oldest first."""

    def __init__(self, n_slots: int, queue_limit: Optional[int] = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if queue_limit is not None and queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.n_slots = n_slots
        self.queue_limit = queue_limit
        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[_Slot]] = [None] * n_slots
        self.n_admitted = 0
        self.n_released = 0
        self.n_shed = 0

    def submit(self, req: Request) -> Optional[Request]:
        if req.sampling_params.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.queue_limit is not None and len(self.queue) >= self.queue_limit:
            victim = self._shed_victim(req)
            self.n_shed += 1
            if victim is req:
                return req
            self.queue.remove(victim)
            self.queue.append(req)
            return victim
        self.queue.append(req)
        return None

    def _shed_victim(self, incoming: Request) -> Request:
        victim_i, vp = 0, self.queue[0].sampling_params.priority
        for i, r in enumerate(self.queue):
            p = r.sampling_params.priority
            if p <= vp:  # <= keeps scanning → newest among equal priorities
                victim_i, vp = i, p
        if incoming.sampling_params.priority <= vp:
            return incoming
        return self.queue[victim_i]

    def pop_next(self) -> Request:
        best_i, bp = 0, self.queue[0].sampling_params.priority
        for i, r in enumerate(self.queue):
            p = r.sampling_params.priority
            if p > bp:  # strict > keeps the oldest among equals
                best_i, bp = i, p
        req = self.queue[best_i]
        del self.queue[best_i]
        return req

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def active(self) -> List[tuple]:
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def requeue(self, req: Request) -> None:
        """Put a preempted resident back at the FRONT of the queue: it keeps
        its seniority within its priority class (``pop_next`` is FIFO per
        class), so equal-priority churn cannot starve it."""
        self.queue.appendleft(req)

    def admit(self, i: int, req: Request, prompt_len: int) -> _Slot:
        if self.slots[i] is not None:
            raise RuntimeError(f"slot {i} is occupied")
        self.n_admitted += 1
        slot = _Slot(req=req, prompt_len=prompt_len, admit_seq=self.n_admitted)
        self.slots[i] = slot
        return slot

    def release(self, i: int) -> None:
        if self.slots[i] is None:
            raise RuntimeError(f"slot {i} is already free")
        self.slots[i] = None
        self.n_released += 1


def _zeros(specs, device):
    """A cache of zeros on ``device``, the NamedTuple of ``specs``."""
    return type(specs)(*(torch.zeros(s.shape, dtype=s.dtype, device=device) for s in specs))


def _arena_pages(arena: sharding.CacheBlock) -> int:
    """Pages of a rank's arena: its block, plus its own two reserved pages
    where the arena splits (page ids 0 and 1 name them on every rank)."""
    return arena.count + (N_RESERVED if arena.splits else 0)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class _DecodeGraph:
    """A step's backbone captured once as a CUDA graph, replayed every step.

    Width 1 is the decode backbone (one token per slot); width W > 1 the
    verify backbone ((n_slots, W) token blocks at per-slot starts). Holds
    the static device inputs the graph reads (tokens and positions as one
    ``(width + 1, n_slots)`` tensor: row w holds each slot's w-th token,
    the last row the slots' positions; the ``(n_slots, n_pg)`` page table
    of a paged session and, for a state family, the ``(n_slots,)`` state
    page ids) and its static output ``h``. The cache needs no
    copy: the session allocates it once and writes it only in place. The
    first ``GRAPH_WARMUP_STEPS`` calls run the backbone eagerly on a side
    stream; the next one captures it in a private memory pool
    (``torch.cuda.graph``) and replays. The graph records the tensors it
    read (the backbone's parameters and the cache leaves); a call that
    finds one of them replaced captures again. A failed capture raises:
    nothing falls back to the eager step."""

    def __init__(self, n_slots: int, tables: Optional[np.ndarray], device: torch.device,
                 width: int = 1, what: str = "decode step",
                 state_pid: Optional[np.ndarray] = None):
        self.device = device
        self.what = what
        # pinned staging: the copies into the static inputs are
        # asynchronous, and the host rewrites a staging buffer only in the
        # next call's load, after this call's read-back synchronized the
        # stream behind the copy
        self._stage = torch.zeros((width + 1, n_slots), dtype=torch.int64, pin_memory=True)
        self.tok_pos = torch.zeros((width + 1, n_slots), dtype=torch.int64, device=device)
        self._page_stage = self.pages = None
        if tables is not None:
            self._page_stage = torch.from_numpy(tables).pin_memory()
            self.pages = torch.zeros(tables.shape, dtype=self._page_stage.dtype, device=device)
        self._spid_stage = self.state_pages = None
        if state_pid is not None:
            self._spid_stage = torch.from_numpy(state_pid).pin_memory()
            self.state_pages = torch.zeros(state_pid.shape, dtype=self._spid_stage.dtype,
                                           device=device)
        self._stream = torch.cuda.Stream(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.h: Optional[torch.Tensor] = None
        self._captured: tuple = ()
        self._warmup_left = GRAPH_WARMUP_STEPS
        self.n_captures = 0

    def load(self, tok: np.ndarray, pos: np.ndarray, tables: Optional[np.ndarray],
             state_pid: Optional[np.ndarray] = None) -> None:
        """Copy the host's tokens ((n_slots,) or (n_slots, width)),
        positions, page table and state page ids in."""
        st = self._stage.numpy()
        st[:-1] = tok.reshape(len(pos), -1).T
        st[-1] = pos
        self.tok_pos.copy_(self._stage, non_blocking=True)
        if tables is not None:
            self._page_stage.numpy()[:] = tables
            self.pages.copy_(self._page_stage, non_blocking=True)
        if state_pid is not None:
            self._spid_stage.numpy()[:] = state_pid
            self.state_pages.copy_(self._spid_stage, non_blocking=True)

    def hidden(self, backbone, params, cache) -> torch.Tensor:
        """The backbone's hidden state for the inputs loaded:
        ``backbone(params, cache, tokens (width, n_slots), pos (n_slots,),
        pages, state_pages)``."""
        leaves = tuple(_leaves({n: p for n, p in params.items() if n != "head"})) + tuple(cache)
        if self.graph is not None and (len(leaves) != len(self._captured) or any(
                a is not b for a, b in zip(leaves, self._captured))):
            self.graph = self.h = None  # a tensor it reads was replaced
        run = lambda: backbone(params, cache, self.tok_pos[:-1], self.tok_pos[-1], self.pages,
                               self.state_pages)
        main = torch.cuda.current_stream(self.device)
        if self.graph is None and self._warmup_left > 0:
            self._warmup_left -= 1
            self._stream.wait_stream(main)
            with torch.cuda.stream(self._stream):
                h = run()
            main.wait_stream(self._stream)
            h.record_stream(main)
            return h
        if self.graph is None:
            graph = torch.cuda.CUDAGraph()
            # an unreachable graph (an earlier session's, held in a reference
            # cycle) destroyed by the collector mid-capture voids the capture:
            # collect first, and not during it
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, stream=self._stream):
                    h = run()
            except RuntimeError as e:
                raise RuntimeError(
                    f"capturing the {self.what} as a CUDA graph failed ({e}); "
                    "ServeSession(decode_graph=False) runs the step eagerly") from e
            finally:
                if collecting:
                    gc.enable()
            self.graph, self.h, self._captured = graph, h, leaves
            self.n_captures += 1
        self.graph.replay()
        return self.h


def _decode_backbone(bundle: ModelBundle, gather=None):
    """``bundle.decode_hidden`` in the form :meth:`_DecodeGraph.hidden` calls
    (``gather``: the session's FSDP gather, or None)."""
    return lambda p, cache, toks, pos, pages, spages=None: bundle.decode_hidden(
        p, cache, toks[0], pos, pages=pages, state_pages=spages, gather=gather)


def _verify_backbone(bundle: ModelBundle, gather=None):
    """``bundle.verify_hidden`` in the form :meth:`_DecodeGraph.hidden` calls."""
    return lambda p, cache, toks, pos, pages, spages=None: bundle.verify_hidden(
        p, cache, toks.T, pos, pages=pages, state_pages=spages, gather=gather)


class ServeSession:
    """Continuous-batching serving session over one model bundle.

    Args:
        bundle/params: the model (``repro_torch.models.build``), params on
            ``device``.
        ds_state_or_table: the DS mask state (packed here) or an already
            packed :class:`~repro_torch.core.dssoftmax.ServeTable` or
            :class:`~repro_torch.core.dssoftmax.QuantizedServeTable`; the
            head state for non-DS heads.
        n_slots: decode slots (the decode batch size).
        max_seq_len: shared cache length; every request must satisfy
            ``prompt_len + max_new_tokens - 1 <= max_seq_len``.
        k: top-k width returned by the head (candidates for sampling).
        kernel: serve-kernel override (name, policy name, or KernelPolicy);
            ``None`` uses ``cfg.ds.serve_kernel``.
        mesh: a ``DeviceMesh`` (``repro_torch.launch.mesh.parse_mesh``) for
            expert-parallel serving, driven by every rank of the mesh (one
            process per rank) with the same requests. The DS table is
            sharded experts → ``model`` (each rank keeps K/ep experts' rows,
            ``core.dssoftmax.shard_table``) and every head call runs
            ``serve_topk_sharded`` (the gate on every rank, the owner
            rank's retrieval, one O(B·k) all-gather merge). The cache is
            split over slots as ``repro``'s
            ``distributed.sharding.serve_cache_shardings`` places it: where
            the (pod, data) ranks n_b divide ``n_slots``, batch rank r holds
            and steps only slots ``[r·n_slots/n_b, (r+1)·n_slots/n_b)``
            (``sharding.serve_cache_block``), and the head merges the
            ranks' rows over the batch axes; elsewhere the cache is whole
            on every rank. A paged arena splits its pages the same way
            (``serve_paged_cache_shardings``, when the slots split too):
            a slot maps pages of its own rank's block only, each rank keeps
            its own reserved zero and garbage pages beside its block, and
            a prefix is adopted only by a slot of the rank that holds its
            pages. Every rank prefills every request (the owner keeps the
            rows; a chunked prefill's result comes from the owner), so the
            collectives stay in step. The host side stays global: every
            rank sees the same merged outputs and the same global
            per-expert stats, so every host decision (scheduling, policy,
            breaker, repack, sampling) is the same on all ranks. A draft
            stays whole on every rank.
        param_mode: ``'replicated'`` (default) or ``'fsdp'`` (requires
            ``mesh``): every backbone weight is stored split over the
            mesh's ``data`` axis (``distributed.sharding.
            serve_param_shardings``) and gathered per layer where the layer
            runs (``ServeParamGather``); streams stay token-identical.
        prefill_chunk: if set, prompts prefill through
            ``bundle.prefill_chunk`` in (1, C) chunks, the tail chunk
            right-padded and masked.
        stream_cb: ``cb(request, token)`` per emitted token; a raising
            callback FAILs only its own request.
        queue_limit: bound on the admission queue (``None``: unbounded).
        quantize: ``'int8'`` serves the DS table from int8 rows with
            per-row fp32 scales, quantized under the exactness gate
            (:func:`~repro_torch.core.dssoftmax.calibrate_quantized_table`):
            experts whose top-k ids flip against the fp oracle on the
            calibration activations beyond ``quantize_flip_threshold``
            serve full-precision fallback rows. The gate's report is
            ``stats()['quantize_report']``. A pre-quantized table passes
            through with no report.
        quantize_calib: calibration activations, an ``(n, d_model)``
            tensor or array, or an int ``n`` for n unit-gaussian fp32 draws
            from a ``torch.Generator`` seeded 17 (default 256).
        quantize_flip_threshold: per-expert flip-rate bound above which an
            expert falls back to full-precision rows. 0.0 makes the served
            table exact on the calibration trace; 1.0 disables fallback.
            Every later :meth:`swap_table` of an fp table (the adaptation
            loop's repacks included) re-runs the same gate, so the session
            stays quantized.
        overflow_threshold / overflow_window: the DS-head overflow circuit
            breaker. When the mean capacity-overflow rate over the last
            ``overflow_window`` decode steps exceeds ``overflow_threshold``,
            trip 1 doubles the effective ``capacity_factor`` and trip 2
            serves through the ``'cuda_fused'`` kernel, which has no
            capacity buffers (``repro`` takes ``'jnp'``); each trip rebinds
            the decode step.
        stats_window: length in decode steps of the step-stamped per-expert
            dispatch/overflow window behind ``stats()['*_window']`` and
            :meth:`traffic_profile`.
        adapt_policy: an :class:`~repro_torch.serve.table_manager.AdaptPolicy`
            that runs the online adaptation loop: every ``interval`` steps,
            when the window's overflow rate exceeds the policy's threshold,
            ``repack_for_traffic`` and :meth:`swap_table`, between decode
            steps. Needs a DS head and the raw DS mask state (not a packed
            table): repacking needs the (head, mask) pair.
        paged: replace the per-slot cache rows with the fixed-size-page
            arena. Tokens equal the contiguous cache's (the gathered page
            view feeds the same attention math); with ``prefill_chunk``,
            chunk-aligned prompt prefixes are prefilled once and shared
            copy-on-write, and arena exhaustion preempts and requeues the
            lowest-priority resident. Needs ``max_seq_len % page_size == 0``
            (and ``% prefill_chunk == 0`` when chunked).
        page_size: cache positions per page.
        page_arena: allocatable pages. Default ``n_slots * max_seq_len /
            page_size`` (the contiguous capacity), plus the reserved zero and
            garbage pages.
        state_arena: allocatable conv/ssm state pages of a paged ssm or
            hybrid session: one live page per resident plus the prefix
            snapshots. Default ``4 * n_slots``.
        prefix_sharing: register and adopt shared prompt prefixes (paged and
            chunked only).
        device: where the cache lives and the steps run; ``cuda`` unless
            the caller passes ``'cpu'``.
        decode_graph: capture the decode step's backbone once as a CUDA
            graph and replay it every step (the head runs eagerly after
            it); in a speculative session the draft's decode backbone and
            the verify backbone, one graph each. ``None``: on where
            ``device`` is CUDA, off on the CPU; ``False`` runs every step
            eagerly; ``True`` on the CPU raises.
        draft: ``(draft_bundle, draft_params, draft_ds_state_or_table)``, a
            same-vocab token-only decoder (any family but encdec) that turns on exact
            draft–verify speculative decoding: each step it proposes
            ``gamma`` tokens per resident from its own contiguous cache,
            the target scores every resident's ``gamma+1``-token block in
            one verify step, and a
            host-side pass emits the longest accepted prefix plus one target
            token. Greedy output equals the non-speculative stream wherever
            the verify and decode math agree on the argmax (on the CPU in
            fp32 everywhere a test looks); sampled output is distributed
            exactly as the target's. Requests must leave ``gamma`` cache
            positions of headroom (checked at ``submit``).
        gamma: draft tokens proposed per slot per speculative step (the
            verify block is ``gamma + 1`` wide).
    """

    def __init__(self, bundle: ModelBundle, params, ds_state_or_table, *,
                 n_slots: int = 8, max_seq_len: int = 256, k: int = 8,
                 kernel=None, mesh=None, param_mode: str = "replicated",
                 prefill_chunk: Optional[int] = None,
                 stream_cb: Optional[Callable[[Request, int], None]] = None,
                 queue_limit: Optional[int] = None,
                 quantize: Optional[str] = None,
                 quantize_calib=256,
                 quantize_flip_threshold: float = 0.0,
                 overflow_threshold: float = 0.5,
                 overflow_window: int = 8,
                 stats_window: int = 128,
                 adapt_policy: Optional[AdaptPolicy] = None,
                 paged: bool = False, page_size: int = 16,
                 page_arena: Optional[int] = None,
                 state_arena: Optional[int] = None,
                 prefix_sharing: bool = True,
                 device="cuda",
                 decode_graph: Optional[bool] = None,
                 draft: Optional[tuple] = None,
                 gamma: int = 4):
        self.device = resolve_device(device)
        cfg = bundle.cfg
        if cfg.family == "encdec":
            raise ValueError("ServeSession drives token-only prompts; the encdec family "
                             "needs per-request encoder frames")
        if decode_graph is None:
            decode_graph = self.device.type == "cuda"
        elif decode_graph and self.device.type != "cuda":
            raise ValueError(f"decode_graph=True needs a CUDA device (a CUDA graph captures "
                             f"the decode step); this session runs on {self.device}")
        if prefill_chunk is not None and bundle.prefill_chunk is None:
            raise ValueError(f"family {cfg.family!r} has no chunked prefill; "
                             "use whole-prompt prefill (prefill_chunk=None)")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if param_mode not in ("replicated", "fsdp"):
            raise ValueError(f"param_mode must be 'replicated' or 'fsdp', got {param_mode!r}")
        if param_mode == "fsdp" and mesh is None:
            raise ValueError("param_mode='fsdp' requires mesh=")
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the mesh runs on {mesh.device_type}, the session on "
                             f"{self.device.type}")
        if paged:
            if max_seq_len % page_size:
                raise ValueError(f"paged mode needs max_seq_len ({max_seq_len}) divisible "
                                 f"by page_size ({page_size})")
            if prefill_chunk is not None and max_seq_len % prefill_chunk:
                # a resumed request re-prefills prompt ++ emitted tokens; the
                # tail chunk's padded writes round that length up to a chunk
                # multiple, which must never index a page past the table
                raise ValueError(f"paged chunked prefill needs max_seq_len ({max_seq_len}) "
                                 f"divisible by prefill_chunk ({prefill_chunk})")
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        if quantize is not None and cfg.head != "ds":
            raise ValueError("quantize= requires a DS head (serve table)")
        if draft is not None:
            if gamma < 1:
                raise ValueError(f"gamma must be >= 1, got {gamma}")
            if bundle.verify_step is None:
                raise ValueError(f"family {cfg.family!r} has no verify_step; speculative "
                                 "decoding needs the chunk-shaped verify path")
            d_cfg = draft[0].cfg
            if d_cfg.family == "encdec":
                raise ValueError("the draft model must be a token-only decoder")
            if d_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(f"draft vocab_size ({d_cfg.vocab_size}) must match the "
                                 f"target's ({cfg.vocab_size}): acceptance compares token ids "
                                 "across the two distributions")
            if prefill_chunk is not None and draft[0].prefill_chunk is None:
                raise ValueError(f"draft family {d_cfg.family!r} has no chunked prefill; use "
                                 "whole-prompt prefill (prefill_chunk=None)")
        self.bundle = bundle
        self.cfg = cfg
        self.params = params
        self.param_mode = param_mode
        self.mesh = mesh
        self.n_slots = n_slots
        self.max_seq_len = max_seq_len
        self.k = k
        self.kernel = kernel
        self.prefill_chunk = prefill_chunk
        self.stream_cb = stream_cb
        self.requests: List[Request] = []
        self.n_steps = 0
        self._quantize = quantize
        self._quantize_calib = quantize_calib
        self._quantize_flip_threshold = float(quantize_flip_threshold)
        self._quantize_report: Optional[ds.ExactnessReport] = None
        self._head_params = None    # the (head, mask) pair tracked across
        self._ds_state = None       # adaptive swaps, so repacks compound
        check_on(self.device, params=params["embed"]["table"])
        if cfg.head == "ds":
            table = ds_state_or_table
            if not isinstance(table, (ds.ServeTable, ds.QuantizedServeTable)):
                self._ds_state = ds_state_or_table
                table = ds.pack_experts(params["head"], table)
            self._head_params = params["head"]
            check_on(self.device, table=ds.table_rows(table))
            if quantize is not None and isinstance(table, ds.ServeTable):
                table = self._quantize_pack(table, params["head"]["gate"])
            # placed on the mesh on the way in (experts → model, K padded to
            # a multiple of ep), at init and at every swap
            self._table_res = TableResource(table, gate=params["head"]["gate"], mesh=mesh)
        else:
            self._table_res = TableResource(ds_state_or_table)
        self._gather = None
        self._param_shardings = None
        # the whole gate (FSDP stores a slice of it): quantization reads it
        self._full_gate = params["head"].get("gate") if cfg.head == "ds" else None
        if param_mode == "fsdp":
            # after the table is packed (pack_experts reads the whole head):
            # each rank keeps its data-axis slice of every leaf that splits
            self._param_shardings = sharding.serve_param_shardings(mesh, params)
            self._gather = sharding.ServeParamGather(mesh, params)
            self.params = params = sharding.shard_tree(mesh, params, self._param_shardings)
            log.info("fsdp param storage: %.2f MB on this rank",
                     sharding.tree_shard_bytes(params) / 1e6)
        self._adapt_policy = adapt_policy
        self._n_swaps = 0
        self._rows_pruned = 0
        self._last_adapt_step = 0
        if adapt_policy is not None:
            if cfg.head != "ds":
                raise ValueError("adapt_policy requires a DS head")
            if self._ds_state is None:
                raise ValueError("adapt_policy needs the raw DS mask state to repack; "
                                 "pass ds_state, not a pre-packed ServeTable")
        self._mgr: Optional[PagedCacheManager] = None
        self._prefix_sharing = prefix_sharing and paged and prefill_chunk is not None
        self._n_preempted = 0
        self._n_prefill_chunks = 0
        self._n_prefill_chunks_saved = 0
        # per cache leaf: True for attention K/V (position-indexed), False
        # for the state families' conv/ssm (one row per slot or state page)
        self._kv_leaf = tuple(cache_kv_leaves(cfg))
        # this rank's slots: all of them, or its (pod, data) block where
        # serve_cache_shardings splits the slot axis
        self._slots = sharding.serve_cache_block(mesh, n_slots)
        nb = n_slots // self._slots.count
        self._kv_arena = self._state_arena = None
        if paged:
            has_state = not all(self._kv_leaf)
            n_alloc = page_arena if page_arena is not None else n_slots * (max_seq_len // page_size)
            n_state = (state_arena if state_arena is not None else 4 * n_slots) \
                if has_state else 0
            n_pages, n_spages = N_RESERVED + n_alloc, (N_RESERVED + n_state) if has_state else 0
            self._whole_specs = paged_cache_specs(cfg, n_pages, page_size, n_spages)
            # an arena splits its pages where serve_paged_cache_shardings
            # does, if the slots split too; a rank keeps its block and its
            # own two reserved pages
            self._kv_arena, self._state_arena = (
                sharding.serve_cache_block(mesh if self._slots.splits else None, n, paged=True)
                for n in (n_pages, n_spages))
            specs = paged_cache_specs(
                cfg, _arena_pages(self._kv_arena), page_size,
                _arena_pages(self._state_arena) if has_state else 0)
            self._mgr = PagedCacheManager(
                n_slots=n_slots, n_pages=n_pages, page_size=page_size,
                max_seq_len=max_seq_len, has_state=has_state,
                # a model without attention (pure ssm) has no K/V pages
                has_kv=any(kv and s.shape[0] for s, kv in zip(specs, self._kv_leaf)),
                n_state_pages=n_spages or None, slot_blocks=nb,
                kv_blocks=nb if self._kv_arena.splits else 1,
                state_blocks=nb if self._state_arena.splits else 1)
            log.info("paged cache: %d pages x %d positions (+%d state pages)", n_alloc,
                     page_size, n_state)
        else:
            self._whole_specs = cache_specs(cfg, ShapeConfig(
                name="serve", seq_len=max_seq_len, global_batch=n_slots, kind="decode"))
            specs = cache_specs(cfg, ShapeConfig(name="serve", seq_len=max_seq_len,
                                                 global_batch=self._slots.count, kind="decode"))
        self._cache = _zeros(specs, self.device)
        self._scratch = None  # a non-owner's chunked-prefill row, made at first use
        if self._slots.splits:
            log.info("slot-split cache: slots [%d, %d) of %d on this rank, %.2f MB of %.2f",
                     self._slots.offset, self._slots.offset + self._slots.count, n_slots,
                     *(b / 1e6 for b in self.cache_bytes()))
        # the backbone's FSDP gather where token rows differ by batch rank
        self._step_gather = (self._gather.for_local_rows()
                             if self._gather is not None and self._slots.splits else self._gather)
        self.scheduler = Scheduler(n_slots, queue_limit=queue_limit)
        self._tok = np.zeros(n_slots, np.int64)
        self._pos = np.zeros(n_slots, np.int64)
        _, tables, spid = self._step_inputs()
        # ---- speculative decoding (draft model) ----------------------------
        self.gamma = int(gamma)
        self._draft = None
        self._spec_stats = {"steps": 0, "slot_steps": 0, "accepted": 0, "emitted": 0}
        # After a block in which the target accepted every proposal, the
        # draft is fed its last proposal (one more draft decode before the
        # next round, for the slots that swept clean), so that its cache
        # holds every accepted token. repro's draft never decodes its last
        # proposal: after a clean sweep its cache keeps a stale row at that
        # position, and its later proposals read it. Set False before the
        # first step to propose what repro proposes (the parity tests do).
        self._draft_backfill = True
        self._backfill: dict = {}  # slot -> (its _Slot, token, position) the draft lacks
        self._draft_commits = False
        self._graph = self._draft_graph = self._verify_graph = None
        if draft is not None:
            d_bundle, d_params, d_state = draft
            check_on(self.device, draft_params=d_params["embed"]["table"])
            d_table = d_state
            if d_bundle.cfg.head == "ds" and not isinstance(
                    d_state, (ds.ServeTable, ds.QuantizedServeTable)):
                d_table = ds.pack_experts(d_params["head"], d_state)
            self._draft = {"bundle": d_bundle, "params": d_params, "table": d_table}
            # the draft's cache is always a contiguous (n_slots, max_seq_len)
            # block, even when the target is paged: speculation changes the
            # arena's accounting by the verify block's gamma rows only
            d_specs = cache_specs(d_bundle.cfg, ShapeConfig(
                name="serve_draft", seq_len=max_seq_len, global_batch=n_slots, kind="decode"))
            self._draft_cache = _zeros(d_specs, self.device)
            self._draft_kv_leaf = tuple(cache_kv_leaves(d_bundle.cfg))
            # a state-family draft commits each block from a copy of its
            # conv/ssm taken before the proposals; it never needs the
            # backfill (the commit covers every accepted token)
            self._draft_commits = d_bundle.verify_needs_state_commit
            self._draft_state = [leaf for leaf, kv in zip(self._draft_cache,
                                                          self._draft_kv_leaf) if not kv]
            d_cfg, k = d_bundle.cfg, self.k

            def _dhead(p, t, h):
                return heads.head_topk(p["head"], t, d_cfg, h, k, embed_table=p["embed"]["table"])

            self._draft_head = _dhead
            if decode_graph:
                self._draft_graph = _DecodeGraph(n_slots, None, self.device,
                                                 what="draft's decode step")
                self._verify_graph = _DecodeGraph(self._slots.count, tables, self.device,
                                                  width=self.gamma + 1, what="verify step",
                                                  state_pid=spid)
            log.info("speculative decoding: draft=%s gamma=%d (verify block %d x %d)",
                     d_bundle.cfg.name, self.gamma, n_slots, self.gamma + 1)
        elif decode_graph:
            self._graph = _DecodeGraph(self._slots.count, tables, self.device, state_pid=spid)
        self._outcomes: collections.Counter = collections.Counter()
        self._overflow_threshold = overflow_threshold
        self._overflow_hist: Deque[float] = collections.deque(maxlen=max(1, overflow_window))
        self._breaker_trips = 0
        self._eff_kernel = kernel              # trip 2 forces an uncapped path
        self._eff_capacity_factor = None       # None -> cfg.ds.capacity_factor
        self._expert_dispatched: Optional[np.ndarray] = None
        self._expert_overflow: Optional[np.ndarray] = None
        # step-stamped window over the same per-expert counters: each entry
        # is (n_steps stamp, dispatched (K,), overflow (K,))
        self._win: Deque[tuple] = collections.deque(maxlen=max(1, stats_window))
        self._n_decode_builds = 0
        self._build_decode_fn()

    # -- versioned table resource ---------------------------------------------

    @property
    def table(self):
        """The CURRENT table version, passed to every step; swaps happen only
        between steps, so a step reads one version whole."""
        return self._table_res.table

    @property
    def table_version(self) -> int:
        return self._table_res.version

    def _build_decode_fn(self) -> None:
        """(Re)bind the decode step's head to the effective kernel and
        capacity factor: once at init, once per :meth:`swap_table` and once
        per breaker trip (``decode_builds`` counts them). ``serve_topk``
        resolves the bound kernel against the table each step is given,
        which is the current version. The backbone reads no table, so a
        rebind leaves the decode graph as it is."""
        self._n_decode_builds += 1
        cfg, kernel, cf, k = self.cfg, self._eff_kernel, self._eff_capacity_factor, self.k
        mesh, gather, local = self.mesh, self._gather, self._slots.splits

        def _head(p, t, h):
            return heads.head_topk(p["head"], t, cfg, h, k, embed_table=p["embed"]["table"],
                                   kernel=kernel, mesh=mesh, gather=gather,
                                   capacity_factor=cf, with_stats=True, local_rows=local)

        self._head_fn = _head

    def _decode(self):
        """One decode step over this rank's slots from the host's tokens,
        positions and page table: ``bundle.decode_hidden`` (replayed from the
        decode graph, or eager), then the bound head (every rank's rows
        merged). Returns (vals, ids, stats) of all n_slots on the device."""
        loc, tables, spid = self._step_inputs()
        tok, pos = self._tok[loc], self._pos[loc]
        g = self._graph
        if g is not None:
            g.load(tok, pos, tables, spid)
            h = g.hidden(_decode_backbone(self.bundle, self._step_gather), self.params,
                         self._cache)
        else:
            dev = self.device
            h = self.bundle.decode_hidden(
                self.params, self._cache, torch.from_numpy(tok).to(dev),
                torch.from_numpy(pos).to(dev), pages=self._on_device(tables),
                state_pages=self._on_device(spid), gather=self._step_gather)
        return self._head_fn(self.params, self.table, h)

    def _state_pid(self) -> Optional[np.ndarray]:
        """The slots' state page ids of a paged state-family session (the
        host array the page table keeps), else None."""
        m = self._mgr
        return m.state_pid if m is not None and m.has_state else None

    # -- this rank's share of the cache -----------------------------------------

    def _step_inputs(self) -> tuple:
        """(this rank's slots as a slice of the host arrays, their page
        table rows and state page ids in this rank's arena, or None)."""
        b = self._slots
        loc = slice(b.offset, b.offset + b.count)
        m = self._mgr
        tables = None if m is None else self._arena_ids(m.tables[loc], self._kv_arena)
        spid = self._state_pid()
        if spid is not None:
            spid = self._arena_ids(spid[loc], self._state_arena)
        return loc, tables, spid

    @staticmethod
    def _arena_ids(pids, arena):
        """Global page ids → indices into this rank's arena: its block's
        pages follow the rank's own two reserved pages."""
        if not arena.splits:
            return pids
        return np.where(pids < N_RESERVED, pids, pids - arena.offset + N_RESERVED)

    def _own(self, i: int) -> Optional[int]:
        """Slot ``i``'s row in this rank's cache, or None where another
        batch rank holds the slot."""
        return self._slots.local(i)

    def _arena_row(self, pid: int, state: bool = False) -> Optional[int]:
        """Arena page ``pid`` (a state page: ``state``) as an index into this
        rank's arena, or None where this rank holds no data of it: a page of
        another rank's block, or a page of a whole arena that only other
        ranks' slots map."""
        m, arena = self._mgr, self._state_arena if state else self._kv_arena
        if arena.splits:
            return None if arena.local(pid) is None else int(self._arena_ids(pid, arena))
        if self._slots.splits:
            if state:
                maps = [i for i in range(self.n_slots)
                        if m.state_pid[i] == pid or pid in m.state_holdings[i]]
            else:
                maps = np.nonzero((m.tables == pid).any(axis=1))[0]
            owners = {m.slot_block(i) for i in maps}
            if owners and self._slots.index not in owners:
                return None
        return int(pid)

    @property
    def local_slots(self) -> sharding.CacheBlock:
        """The slots this rank holds and steps (all of them off a mesh, or
        where the mesh's batch ranks do not divide ``n_slots``)."""
        return self._slots

    def cache_bytes(self) -> tuple:
        """(this rank's resident cache bytes, the whole cache's)."""
        whole = sum(int(np.prod(s.shape)) * torch.empty((), dtype=s.dtype).element_size()
                    for s in self._whole_specs)
        return sharding.tree_shard_bytes(self._cache), whole

    def _scratch_row(self):
        """A zeroed contiguous ``(·, 1, ·)`` cache row, for a rank that runs
        the chunked prefill of a slot another rank holds."""
        if self._scratch is None:
            self._scratch = _zeros(cache_specs(self.cfg, ShapeConfig(
                name="scratch", seq_len=self.max_seq_len, global_batch=1, kind="decode")),
                self.device)
        for leaf in self._scratch:
            leaf.zero_()
        return self._scratch

    def _from_owner(self, i: int, vals, ids):
        """Slot ``i``'s owner's (1, k) prefill result on every rank: one
        all-gather over the batch ranks, whose blocks the owner's is picked
        from (the other ranks ran the chunks on a scratch row)."""
        if not self._slots.splits:
            return vals, ids
        group, b = sharding.batch_group(self.mesh), self._slots.owner(i)
        return sharding.collective(vals, group)[b], sharding.collective(ids, group)[b]

    def _on_device(self, a: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        return None if a is None else torch.from_numpy(a).to(self.device)

    def _draft_decode(self, tok: np.ndarray, pos: np.ndarray):
        """One draft decode over the slot batch: the draft's backbone
        (replayed from its graph, or eager) against its own cache, then its
        head. Returns (vals, ids) on the device."""
        d, g = self._draft, self._draft_graph
        if g is not None:
            g.load(tok, pos, None)
            h = g.hidden(_decode_backbone(d["bundle"]), d["params"], self._draft_cache)
        else:
            dev = self.device
            h = d["bundle"].decode_hidden(d["params"], self._draft_cache,
                                          torch.from_numpy(tok).to(dev),
                                          torch.from_numpy(pos).to(dev))
        return self._draft_head(d["params"], d["table"], h)

    def _verify(self, blocks: np.ndarray, pos0: np.ndarray):
        """One verify step over the (n_slots, W) blocks at per-slot starts
        ``pos0``: ``bundle.verify_hidden`` over this rank's slots (replayed
        from the verify graph, or eager), then the bound head over their
        rows, merged slot-major over every rank. Returns (vals, ids) of
        shape (n_slots, W, k) and the head's stats, on the device."""
        loc, tables, spid = self._step_inputs()
        blocks, pos0 = blocks[loc], pos0[loc]
        g = self._verify_graph
        if g is not None:
            g.load(blocks, pos0, tables, spid)
            h = g.hidden(_verify_backbone(self.bundle, self._step_gather), self.params,
                         self._cache)
        else:
            dev = self.device
            h = self.bundle.verify_hidden(
                self.params, self._cache, torch.from_numpy(blocks).to(dev),
                torch.from_numpy(pos0).to(dev), pages=self._on_device(tables),
                state_pages=self._on_device(spid), gather=self._step_gather)
        n, W, dm = h.shape
        vals, ids, stats = self._head_fn(self.params, self.table, h.reshape(n * W, dm))
        return (vals.reshape(self.n_slots, W, -1), ids.reshape(self.n_slots, W, -1), stats)

    # -- table hot-swap + online adaptation -----------------------------------

    def swap_table(self, new_table, new_gate=None, *,
                   capacity_factor: Optional[float] = None) -> int:
        """Hot-swap the serve table (and optionally its matching gate)
        between decode steps. Returns the new table version.

        In order: the gate and table are checked as one pair; a new gate
        (required when K changed) replaces ``params['head']['gate']``; an fp
        table swapped into a ``quantize='int8'`` session is re-quantized
        under the exactness gate against that gate, refreshing
        ``stats()['quantize_report']`` (a quantized table swaps in as it
        is); the :class:`TableResource` retires the old version; the
        per-expert counters, the window and the breaker history restart
        (K and V_pad may change); the decode step is rebound once.

        Backbone params and the KV cache do not depend on the table, so a
        resident request's tokens after the swap equal those of a fresh
        session on the new table replaying ``prompt ++ pre_swap_tokens``."""
        if self.cfg.head != "ds":
            raise ValueError("swap_table requires a DS head")
        if not isinstance(new_table, (ds.ServeTable, ds.QuantizedServeTable)):
            raise ValueError("swap_table takes a packed ServeTable or QuantizedServeTable")
        check_on(self.device, table=ds.table_rows(new_table))
        n_table = new_table.ids.shape[0]
        if new_gate is None:
            n_gate = self.params["head"]["gate"].shape[0]
            if n_table != n_gate:
                raise ValueError(
                    f"table has {n_table} experts but the resident gate has {n_gate} rows; "
                    "pass new_gate — gate and table swap as one pair")
        else:
            new_gate = torch.as_tensor(new_gate)
            if new_gate.shape[0] != n_table:
                raise ValueError(
                    f"gate rows ({new_gate.shape[0]}) must match table experts ({n_table})"
                    " — gate and table swap as one versioned pair")
            check_on(self.device, new_gate=new_gate)
            self._full_gate = new_gate
            if self._param_shardings is not None:
                # the path-keyed head/gate placement holds for any K
                new_gate = sharding.shard_tree(self.mesh, {"head": {"gate": new_gate}},
                                               self._param_shardings)["head"]["gate"]
            self.params = dict(self.params, head=dict(self.params["head"], gate=new_gate))
        if self._quantize is not None and isinstance(new_table, ds.ServeTable):
            new_table = self._quantize_pack(new_table, self._full_gate)
        version = self._table_res.swap(new_table, gate=self._full_gate)
        self._n_swaps += 1
        if capacity_factor is not None:
            self._eff_capacity_factor = float(capacity_factor)
        self._expert_dispatched = None
        self._expert_overflow = None
        self._win.clear()
        self._overflow_hist.clear()
        self._build_decode_fn()
        log.info("table swap -> v%d: K=%d V_pad=%d capacity_factor=%s (decode step rebound)",
                 version, n_table, new_table.v_pad, self._eff_capacity_factor)
        return version

    def traffic_profile(self) -> Optional[TrafficProfile]:
        """The stats window as a
        :class:`~repro_torch.serve.table_manager.TrafficProfile`, sliced to
        the real expert count (a mesh session's stats cover the dummy
        experts ``shard_table`` pads with, which get no traffic), or None
        until the current table version has served a decode step."""
        if not self._win:
            return None
        disp = np.sum([d for _, d, _ in self._win], axis=0, dtype=np.int64)
        over = np.sum([o for _, _, o in self._win], axis=0, dtype=np.int64)
        if self._full_gate is not None:
            kreal = int(self._full_gate.shape[0])
            disp, over = disp[:kreal], over[:kreal]
        return TrafficProfile(dispatched=disp, overflow=over, steps=len(self._win),
                              start_step=self._win[0][0], end_step=self._win[-1][0])

    def adapt_now(self) -> bool:
        """One adaptation pass now (the policy's interval and overflow
        threshold are ignored; the stats window must not be empty). True
        when a swap happened."""
        if self._adapt_policy is None:
            raise ValueError("adapt_now() requires adapt_policy=")
        prof = self.traffic_profile()
        if prof is None:
            return False
        self._last_adapt_step = self.n_steps
        return self._adapt(prof)

    def _maybe_adapt(self) -> None:
        """End-of-step adaptation check: swaps happen only here or in
        :meth:`adapt_now`, between decode steps."""
        pol = self._adapt_policy
        if pol is None or self._n_swaps >= pol.max_swaps:
            return
        if self.n_steps - self._last_adapt_step < pol.interval:
            return
        prof = self.traffic_profile()
        if prof is None or prof.steps < pol.min_window_steps:
            return
        self._last_adapt_step = self.n_steps
        if prof.overflow_rate <= pol.overflow_threshold:
            return
        self._adapt(prof)

    def _adapt(self, prof: TrafficProfile) -> bool:
        pol = self._adapt_policy
        if self._n_swaps >= pol.max_swaps:
            return False
        seed = np.random.SeedSequence((pol.seed, self._n_swaps)).generate_state(1, np.uint64)[0]
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        res = repack_for_traffic(
            self._head_params, self._ds_state, prof, generator=gen,
            prune_gamma=pol.prune_gamma,
            mitosis_overflow_threshold=pol.mitosis_overflow_threshold,
            headroom=pol.headroom, noise=pol.noise,
            base_capacity_factor=(self._eff_capacity_factor
                                  if self._eff_capacity_factor is not None
                                  else self.cfg.ds.capacity_factor))
        # evolve the tracked (head, mask) pair so later repacks compound
        self._head_params, self._ds_state = res.head_params, res.state
        self._rows_pruned += res.rows_pruned
        log.info("adaptive repack at step %d: window overflow %.3f over %d steps; "
                 "cloned=%s pruned=%d rows", self.n_steps, prof.overflow_rate, prof.steps,
                 res.cloned, res.rows_pruned)
        self.swap_table(res.table, new_gate=res.head_params["gate"],
                        capacity_factor=res.capacity_factor)
        return True

    # -- public API -----------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Validate and enqueue a request. Returns False if the bounded
        queue shed it (status ``REJECTED``). Invalid parameters raise
        ``ValueError`` naming the field, leaving the request ``REJECTED``."""
        if req.submit_step is not None or req.status is not RequestStatus.QUEUED:
            raise ValueError(f"request was already submitted (status={req.status.value!r})")

        def reject(msg: str) -> None:
            self._finish(req, RequestStatus.REJECTED, msg)
            raise ValueError(msg)

        try:
            sp = req.sampling_params
        except ValueError as e:
            reject(str(e))
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        S = len(prompt)
        if sp.max_new_tokens < 1:
            reject(f"max_new_tokens must be >= 1, got {sp.max_new_tokens}")
        if not np.isfinite(sp.temperature) or sp.temperature < 0.0:
            reject(f"temperature must be finite and >= 0 (0 = greedy), got {sp.temperature}")
        if sp.top_k is not None and sp.top_k < 1:
            reject(f"top_k must be >= 1, got {sp.top_k}")
        if sp.top_k is not None and sp.top_k > self.k:
            reject(f"top_k ({sp.top_k}) exceeds the head's candidate width "
                   f"k ({self.k}); the head only returns k candidates")
        if sp.deadline_steps is not None and sp.deadline_steps < 1:
            reject(f"deadline_steps must be >= 1, got {sp.deadline_steps}")
        if S < 1:
            reject("empty prompt")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            bad = prompt[(prompt < 0) | (prompt >= self.cfg.vocab_size)][0]
            reject(f"prompt contains token id {bad} outside [0, {self.cfg.vocab_size})")
        # a speculative step writes gamma draft positions past the slot's
        # last emitted token before acceptance prunes them
        spec_pad = self.gamma if self._draft is not None else 0
        if S + sp.max_new_tokens - 1 + spec_pad > self.max_seq_len:
            reject(f"prompt_len ({S}) + max_new_tokens ({sp.max_new_tokens}) - 1"
                   + (f" + speculative headroom ({spec_pad})" if spec_pad else "")
                   + f" exceeds max_seq_len ({self.max_seq_len})")
        if self.prefill_chunk is not None:
            # the tail chunk writes all prefill_chunk rows, padding included;
            # none may fall past the cache end
            cp = self.prefill_chunk
            needed = -(-S // cp) * cp
            if needed > self.max_seq_len:
                reject(f"chunked prefill rounds the prompt up to a multiple of "
                       f"prefill_chunk ({cp}): needs {needed} cache rows > max_seq_len "
                       f"({self.max_seq_len}); raise max_seq_len or lower prefill_chunk")
        if self._mgr is not None and self._mgr.has_kv:
            # the worst-case footprint must fit the arena ALONE: a request
            # that cannot run with every resident preempted would wedge the
            # queue
            worst = S + sp.max_new_tokens - 1 + spec_pad
            if self.prefill_chunk is not None:
                worst = max(worst, -(-S // self.prefill_chunk) * self.prefill_chunk)
            need = -(-worst // self._mgr.page_size)
            if need > self._mgr.slot_allocatable:
                reject(f"request needs {need} pages at its max length but the arena "
                       f"only has {self._mgr.slot_allocatable}"
                       + (" a slot" if self._mgr.kv_blocks > 1 else "")
                       + "; raise page_arena or shorten the request")
        req.submit_step = self.n_steps
        self.requests.append(req)
        victim = self.scheduler.submit(req)
        if victim is not None:
            self._finish(victim, RequestStatus.REJECTED,
                         f"shed: queue full (queue_limit={self.scheduler.queue_limit})")
        return victim is not req

    def cancel(self, req: Request) -> bool:
        """Abort a request: a queued one leaves the queue, an active one
        releases its slot. False if it already reached a terminal status."""
        if req.status in TERMINAL:
            return False
        if req in self.scheduler.queue:
            self.scheduler.queue.remove(req)
            self._finish(req, RequestStatus.CANCELLED)
            return True
        for i, slot in self.scheduler.active():
            if slot.req is req:
                self._finish_slot(i, RequestStatus.CANCELLED)
                return True
        return False

    @torch.no_grad()
    def step(self) -> bool:
        """Expire overdue queued requests, admit into free slots, then run
        ONE decode step over the slot batch (one draft–verify block when
        ``draft=`` is set). Returns True while work remains."""
        self._expire_queue()
        self._admit()
        if self._draft is not None:
            return self._step_speculative()
        if self._mgr is not None:
            self._prepare_decode_writes()
        act = self.scheduler.active()
        if not act:
            return self.scheduler.has_work()
        vals, ids, stats = self._decode()
        self.n_steps += 1
        vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
        self._record_load(stats)
        for i, slot in act:
            if self.scheduler.slots[i] is not slot:
                continue  # released mid-loop (e.g. cancel from a stream_cb)
            if not np.isfinite(vals[i]).all() or ids[i, 0] < 0:
                # quarantine ONLY this slot: decode math never mixes rows
                self._finish_slot(i, RequestStatus.FAILED,
                                  "non-finite decode output (slot quarantined)")
                continue
            t = self._sample(vals[i], ids[i], slot.req.sampling_params, slot.n_emitted)
            self._emit(i, slot, t)
        if self._adapt_policy is not None:
            # swaps happen only BETWEEN steps: the step above ran whole on
            # the old table version
            self._maybe_adapt()
        return self.scheduler.has_work()

    def _step_speculative(self) -> bool:
        """One draft–verify block: gamma sequential draft proposals per slot,
        ONE verify over every resident's (gamma+1)-token block, host-side
        exact acceptance, then per-slot emission (slots are released only
        after every device call of the step)."""
        W = self.gamma + 1
        if self._mgr is not None:
            # verify writes the whole block: secure [pos, pos+W) per slot
            self._prepare_decode_writes(width=W)
        act = self.scheduler.active()
        if not act:
            return self.scheduler.has_work()
        n = self.n_slots
        base_tok, base_pos = self._tok.copy(), self._pos.copy()
        # a state draft's conv/ssm before the proposals: its commit pass
        # re-advances them from here by each slot's accepted prefix
        d_state0 = [leaf.clone() for leaf in self._draft_state] if self._draft_commits else []
        if self._backfill:
            # the last proposal of each block a slot swept clean, fed to the
            # draft at its position; every other slot writes its own next
            # input, which the first round below writes again the same
            ftok, fpos = base_tok.copy(), base_pos.copy()
            for i, (slot, t, p) in self._backfill.items():
                if self.scheduler.slots[i] is slot:
                    ftok[i], fpos[i] = t, p
            self._backfill.clear()
            # the read-back orders the next call's staging write after
            # this call's copies
            self._draft_decode(ftok, fpos)[0].cpu()
        # -- draft proposals: gamma sequential n_slots-token draft decodes --
        dtok, dpos = base_tok.copy(), base_pos.copy()
        props = np.zeros((n, self.gamma), np.int64)
        # per (slot, j): the draft's (vals, ids) behind proposal j, or None
        # where the proposal is a point mass (a greedy draft row needs no q;
        # a poisoned draft row proposes token 0 as a point mass, and the
        # target supplies the real token)
        prop_q: list = [[None] * self.gamma for _ in range(n)]
        for j in range(self.gamma):
            dvals, dids = self._draft_decode(dtok, dpos)
            dvals, dids = dvals.cpu().numpy(), dids.cpu().numpy()
            for i, slot in act:
                sp = slot.req.sampling_params
                m = slot.n_emitted + j  # absolute index of the proposed token
                if not np.isfinite(dvals[i]).all() or dids[i, 0] < 0:
                    props[i, j] = dtok[i] = 0
                    continue
                if sp.temperature <= 0.0:
                    t = int(dids[i, 0])
                else:
                    k_eff = dids.shape[1] if sp.top_k is None else min(sp.top_k, dids.shape[1])
                    u = _uniforms(sp.seed, _SALT_DRAFT, m, k_eff)
                    with np.errstate(divide="ignore"):
                        g = -np.log(-np.log(u))
                    t = int(dids[i, int(np.argmax(
                        dvals[i, :k_eff].astype(np.float64) / sp.temperature + g))])
                    prop_q[i][j] = (dvals[i].copy(), dids[i].copy())
                props[i, j] = dtok[i] = t
            dpos += 1
        # -- ONE chunk-shaped verify over every block ------------------------
        blocks = np.zeros((n, W), np.int64)
        blocks[:, 0] = base_tok
        blocks[:, 1:] = props
        vvals, vids, stats = self._verify(blocks, base_pos)
        self.n_steps += 1
        vvals, vids = vvals.cpu().numpy(), vids.cpu().numpy()
        self._record_load(stats)
        # -- host-side exact acceptance --------------------------------------
        emitted: dict = {}
        n_valid = np.ones(n, np.int64)
        poisoned: List[int] = []
        for i, slot in act:
            if not np.isfinite(vvals[i]).all() or (vids[i, :, 0] < 0).any():
                poisoned.append(i)
                continue
            toks, n_acc = self._accept_block(vvals[i], vids[i], props[i], prop_q[i],
                                             slot.req.sampling_params, slot.n_emitted)
            emitted[i] = toks
            n_valid[i] = n_acc + 1
            self._spec_stats["slot_steps"] += 1
            self._spec_stats["accepted"] += n_acc
            if n_acc == self.gamma and self._draft_backfill and not self._draft_commits:
                self._backfill[i] = (slot, int(props[i, -1]), int(base_pos[i]) + self.gamma)
        self._spec_stats["steps"] += 1
        # -- commit the accepted prefixes (recurrent state cannot roll back) --
        if self.bundle.verify_needs_state_commit or self._draft_commits:
            dev = self.device
            blk, p0, nv = (torch.from_numpy(a).to(dev) for a in (blocks, base_pos, n_valid))
            if self.bundle.verify_needs_state_commit:
                loc, tables, spid = self._step_inputs()
                self.bundle.commit_block(
                    self.params, self._cache, blk[loc], p0[loc], nv[loc],
                    pages=self._on_device(tables), state_pages=self._on_device(spid),
                    gather=self._step_gather)
            if self._draft_commits:
                for leaf, old in zip(self._draft_state, d_state0):
                    leaf.copy_(old)
                d = self._draft
                d["bundle"].commit_block(d["params"], self._draft_cache, blk, p0, nv)
        # -- quarantine, then emit -------------------------------------------
        # (a KV-cache draft needs no rollback: its next round overwrites each
        # position past its accepted prefix before reading it, and stale
        # rows past that stay masked)
        for i in poisoned:
            self._finish_slot(i, RequestStatus.FAILED,
                              "non-finite verify output (slot quarantined)")
        for i, slot in act:
            if self.scheduler.slots[i] is not slot:
                continue
            for t in emitted.get(i, ()):
                self._emit(i, slot, t)
                # tokens actually emitted: eos, max_new_tokens or a deadline
                # cut an accepted block short
                self._spec_stats["emitted"] += 1
                if self.scheduler.slots[i] is not slot:
                    break
        if self._adapt_policy is not None:
            self._maybe_adapt()
        return self.scheduler.has_work()

    def _accept_block(self, vals_w: np.ndarray, ids_w: np.ndarray, props: np.ndarray,
                      prop_q: list, sp: SamplingParams, m0: int) -> tuple:
        """Exact acceptance of one slot's verified block (copied from
        ``repro.train.serve``). Returns ``(tokens_to_emit, n_accepted)``:
        the accepted draft prefix plus exactly one target token (the
        correction at the first mismatch or rejection, the bonus after a
        clean sweep).

        Greedy is a prefix match against the target's argmax chain. Sampled
        mode is speculative rejection sampling over the head's
        top-k-truncated distributions: accept proposal d ~ q with
        probability min(1, p(d)/q(d)); on rejection draw from the residual
        (p - q)^+ on the target's candidates. The emitted token is then
        distributed exactly as p, point-mass proposals and disjoint supports
        included. Every uniform keys on ``(seed, absolute emission
        index)``."""
        gamma = len(props)
        out: List[int] = []
        n_acc = 0
        if sp.temperature <= 0.0:
            for j in range(gamma):
                tgt = int(ids_w[j, 0])
                out.append(tgt)
                if int(props[j]) != tgt:
                    return out, n_acc  # the correction token
                n_acc += 1
            out.append(int(ids_w[gamma, 0]))  # the bonus token
            return out, n_acc
        k = ids_w.shape[1]
        k_eff = k if sp.top_k is None else min(sp.top_k, k)
        for j in range(gamma):
            m = m0 + j
            pv = vals_w[j, :k_eff].astype(np.float64) / sp.temperature
            pv -= pv.max()
            p = np.exp(pv)
            p /= p.sum()
            pid = ids_w[j, :k_eff].astype(np.int64)
            d_tok = int(props[j])
            q_on_p = np.zeros_like(p)  # q mapped onto the target's support
            if prop_q[j] is None:
                qd = 1.0  # a point mass on the proposal
                hits = np.nonzero(pid == d_tok)[0]
                if len(hits):
                    q_on_p[hits[0]] = 1.0
            else:
                dvals, dids = prop_q[j]
                dk_eff = len(dids) if sp.top_k is None else min(sp.top_k, len(dids))
                qv = dvals[:dk_eff].astype(np.float64) / sp.temperature
                qv -= qv.max()
                q = np.exp(qv)
                q /= q.sum()
                did = dids[:dk_eff].astype(np.int64)
                qd = float(q[np.nonzero(did == d_tok)[0][0]])
                for a, cid in enumerate(pid):
                    hit = np.nonzero(did == cid)[0]
                    if len(hit):
                        q_on_p[a] = q[hit[0]]
            hits = np.nonzero(pid == d_tok)[0]
            pd = float(p[hits[0]]) if len(hits) else 0.0
            u = float(_uniforms(sp.seed, _SALT_ACCEPT, m, 1)[0])
            if u * qd <= pd:  # accept with probability min(1, p/q)
                out.append(d_tok)
                n_acc += 1
                continue
            res = np.maximum(p - q_on_p, 0.0)
            z = res.sum()
            # z is the rejection probability on p's support; z <= 0 only
            # where q covers p exactly there: resample from p itself
            res = res / z if z > 0.0 else p
            r = float(_uniforms(sp.seed, _SALT_RESID, m, 1)[0])
            idx = int(np.searchsorted(np.cumsum(res), r, side="right"))
            out.append(int(pid[min(idx, k_eff - 1)]))
            return out, n_acc
        # a clean sweep: the bonus token is the plain stream's sample from
        # the last row, keyed like any other emission
        out.append(self._sample(vals_w[gamma], ids_w[gamma], sp, m0 + gamma))
        return out, n_acc

    def run(self, requests: Optional[List[Request]] = None) -> List[Request]:
        """Submit ``requests`` and step until the queue drains. Returns
        every request this session has served."""
        for r in requests or ():
            self.submit(r)
        while self.step():
            pass
        return self.requests

    def stats(self) -> dict:
        """Host-side counters: occupancy, per-outcome counts, shed count,
        per-expert dispatch/overflow totals over the current table version
        and the step-stamped window over them (``*_window`` keys with
        ``window_start_step``/``window_end_step``, what
        :meth:`traffic_profile` reads), the circuit breaker's state, the
        table-swap accounting (``table_version``, ``n_swaps``,
        ``decode_builds``; ``rows_pruned`` sums the adaptive repacks'
        re-prunes, a key ``repro`` does not have), ``decode_graphs`` (the
        decode backbone's CUDA graph captures: 0 on an eager session, 1
        once a graph session has warmed up; ``repro`` has no such key),
        ``draft_graphs`` and ``verify_graphs`` (the same for a speculative
        session's draft decode and verify backbones; the plain decode step
        never runs there), the int8 mode with
        its exactness-gate report (``ExactnessReport.as_dict()``, None when
        the table was not quantized here), for a paged session ``paged``:
        the page table's counters, ``preemptions``, ``prefill_chunks`` and
        ``prefill_chunks_saved``, and for a speculative session
        ``speculative`` with ``repro``'s keys: ``gamma``, ``spec_steps``,
        ``draft_accepted``, ``spec_emitted``, ``emitted_per_step`` and
        ``accepted_per_step`` (per verify step, summed over residents) and
        ``accept_rate`` (of the proposed tokens)."""
        o = self._outcomes
        hist = self._overflow_hist
        eff_cf = None
        if self.cfg.head == "ds":
            eff_cf = (self._eff_capacity_factor if self._eff_capacity_factor is not None
                      else self.cfg.ds.capacity_factor)
        out = {
            "n_admitted": self.scheduler.n_admitted,
            "n_released": self.scheduler.n_released,
            "n_steps": self.n_steps,
            "n_queued": len(self.scheduler.queue),
            "n_active": len(self.scheduler.active()),
            "n_completed": o[RequestStatus.COMPLETED],
            "n_rejected": o[RequestStatus.REJECTED],
            "n_cancelled": o[RequestStatus.CANCELLED],
            "n_timed_out": o[RequestStatus.TIMED_OUT],
            "n_failed": o[RequestStatus.FAILED],
            "n_shed": self.scheduler.n_shed,
            "overflow_rate": (sum(hist) / len(hist)) if hist else 0.0,
            "expert_dispatched": (None if self._expert_dispatched is None
                                  else self._expert_dispatched.tolist()),
            "expert_overflow": (None if self._expert_overflow is None
                                else self._expert_overflow.tolist()),
            "breaker_trips": self._breaker_trips,
            "effective_capacity_factor": eff_cf,
            "effective_kernel": self._eff_kernel,
            "table_version": self._table_res.version,
            "n_swaps": self._n_swaps,
            "decode_builds": self._n_decode_builds,
            "rows_pruned": self._rows_pruned,
            "decode_graphs": 0 if self._graph is None else self._graph.n_captures,
            "draft_graphs": 0 if self._draft_graph is None else self._draft_graph.n_captures,
            "verify_graphs": 0 if self._verify_graph is None else self._verify_graph.n_captures,
            "quantize": self._quantize,
            "quantize_report": (None if self._quantize_report is None
                                else self._quantize_report.as_dict()),
        }
        prof = self.traffic_profile()
        out["expert_dispatched_window"] = None if prof is None else prof.dispatched.tolist()
        out["expert_overflow_window"] = None if prof is None else prof.overflow.tolist()
        out["window_start_step"] = None if prof is None else prof.start_step
        out["window_end_step"] = None if prof is None else prof.end_step
        out["window_steps"] = 0 if prof is None else prof.steps
        out["overflow_rate_window"] = 0.0 if prof is None else prof.overflow_rate
        if self._mgr is not None:
            out["paged"] = {**self._mgr.stats(), "preemptions": self._n_preempted,
                            "prefill_chunks": self._n_prefill_chunks,
                            "prefill_chunks_saved": self._n_prefill_chunks_saved}
        if self._draft is not None:
            ss = self._spec_stats
            steps = max(1, ss["steps"])
            out["speculative"] = {
                "gamma": self.gamma,
                "spec_steps": ss["steps"],
                "draft_accepted": ss["accepted"],
                "spec_emitted": ss["emitted"],
                "emitted_per_step": ss["emitted"] / steps,
                "accepted_per_step": ss["accepted"] / steps,
                "accept_rate": ss["accepted"] / max(1, ss["slot_steps"] * self.gamma),
            }
        return out

    # -- internals ------------------------------------------------------------

    def _quantize_pack(self, table: ds.ServeTable, gate_w) -> ds.QuantizedServeTable:
        """Quantize a fp table under the exactness gate and keep its
        :class:`~repro_torch.core.dssoftmax.ExactnessReport`. The int form
        of ``quantize_calib`` redraws from the generator seeded 17, so every
        swap gates on the same activations."""
        calib = self._quantize_calib
        if isinstance(calib, int):
            gen = torch.Generator().manual_seed(17)
            calib = torch.randn((calib, self.cfg.d_model), generator=gen, dtype=torch.float32)
        calib = torch.as_tensor(calib).to(self.device)
        qtable, report = ds.calibrate_quantized_table(
            gate_w, table, calib, k=self.k, flip_threshold=self._quantize_flip_threshold)
        self._quantize_report = report
        log.info("int8 quantize: %d/%d calib flips raw, %d experts on fp fallback, "
                 "%d unguarded (gate %s)", report.n_flips_raw, report.n_tokens,
                 len(report.fallback_experts), report.n_unguarded_flips,
                 "PASSED" if report.passed else "FAILED")
        return qtable

    def _finish(self, req: Request, status: RequestStatus,
                error: Optional[str] = None) -> None:
        req.status = status
        if error is not None:
            req.error = error
        self._outcomes[status] += 1
        if status is RequestStatus.FAILED:
            log.warning("request FAILED: %s", error)

    def _finish_slot(self, i: int, status: RequestStatus,
                     error: Optional[str] = None) -> None:
        slot = self.scheduler.slots[i]
        self._finish(slot.req, status, error)
        self.scheduler.release(i)
        self._tok[i] = 0
        self._pos[i] = 0
        if self._mgr is not None:
            # drop every page reference; a FAILED tenant's pages are zeroed
            # as they return to the free list (a shared page survives
            # through its co-owners)
            self._release_slot_pages(i, scrub=status is RequestStatus.FAILED)
        elif status is RequestStatus.FAILED:
            self._scrub_slot(i)
        if self._draft is not None and status is RequestStatus.FAILED:
            # the draft's contiguous row may carry the same poison
            self._scrub(self._draft_cache, i)

    @staticmethod
    def _scrub(cache, i: int) -> None:
        # Zero every row of slot i: a later, shorter tenant's prefill would
        # not overwrite a residual NaN row, and masked attention still
        # multiplies it (0·NaN = NaN); conv/ssm state rows go too.
        for leaf in cache:
            leaf[:, i] = 0

    def _scrub_slot(self, i: int) -> None:
        """:meth:`_scrub` of slot ``i``'s row, on the rank that holds it."""
        li = self._own(i)
        if li is not None:
            self._scrub(self._cache, li)

    def _expire_queue(self) -> None:
        overdue = [r for r in self.scheduler.queue
                   if r.sampling_params.deadline_steps is not None
                   and self.n_steps - r.submit_step >= r.sampling_params.deadline_steps]
        for req in overdue:
            self.scheduler.queue.remove(req)
            self._finish(req, RequestStatus.TIMED_OUT,
                         f"deadline_steps={req.sampling_params.deadline_steps} "
                         "exceeded while queued")

    def _record_load(self, stats) -> None:
        disp = stats["dispatched"].cpu().numpy().astype(np.int64)
        over = stats["overflow"].cpu().numpy().astype(np.int64)
        if self._expert_dispatched is None or self._expert_dispatched.shape != disp.shape:
            # first step on this table version (swap_table resets them)
            self._expert_dispatched = np.zeros_like(disp)
            self._expert_overflow = np.zeros_like(over)
            self._win.clear()
        self._expert_dispatched += disp
        self._expert_overflow += over
        # n_steps already counts the step these stats came from
        self._win.append((self.n_steps, disp, over))
        self._overflow_hist.append(float(over.sum()) / max(float(disp.sum()), 1.0))
        self._maybe_trip_breaker()

    def _maybe_trip_breaker(self) -> None:
        """Degrade when capacity overflow stops being rare. Overflowed
        tokens stay exact (the grouped paths' fixup re-runs them), but a
        sustained rate means the capacity buffers are mis-sized and the
        fixup dominates the step. Trip 1 doubles the effective
        ``capacity_factor`` (from the config's); trip 2 serves through the
        ``'cuda_fused'`` kernel (fp and int8 bodies, exact), which has no
        capacity buffers and so never overflows. ``repro`` takes ``'jnp'``
        there; the port stays on a kernel (on CPU tensors the fused
        wrapper runs its plain version, as every wrapper does)."""
        if self.cfg.head != "ds" or self._breaker_trips >= 2:
            return
        hist = self._overflow_hist
        if len(hist) < hist.maxlen:
            return
        rate = sum(hist) / len(hist)
        if rate <= self._overflow_threshold:
            return
        self._breaker_trips += 1
        if self._breaker_trips == 1:
            base = self.cfg.ds.capacity_factor
            self._eff_capacity_factor = 2.0 * base
            log.warning("overflow breaker trip 1: mean rate %.3f > %.3f over %d steps; "
                        "capacity_factor %.2f -> %.2f (decode step rebound)",
                        rate, self._overflow_threshold, hist.maxlen, base,
                        self._eff_capacity_factor)
        else:
            self._eff_kernel = "cuda_fused"
            log.warning("overflow breaker trip 2: mean rate %.3f still > %.3f after the "
                        "capacity bump; serving through %r (decode step rebound)",
                        rate, self._overflow_threshold, self._eff_kernel)
        hist.clear()
        self._build_decode_fn()

    @torch.no_grad()
    def _admit(self) -> None:
        sched = self.scheduler
        while sched.queue:
            i = sched.free_slot()
            if i is None:
                return
            req = sched.pop_next()
            prompt = np.asarray(req.prompt, np.int64).reshape(-1)
            S = len(prompt)
            sp = req.sampling_params
            n_resume = len(req.out_tokens)
            # a preempted request re-prefills everything it produced but the
            # last token, which is fed back as the next decode input
            toks = (np.concatenate([prompt, np.asarray(req.out_tokens[:-1], np.int64)])
                    if n_resume else prompt)
            out = self._prefill_into_slot(toks, i, sp.priority)
            if out is None:
                # the arena is exhausted with nothing preemptible below this
                # priority: wait at the FRONT of the queue for the residents
                # (submit() checked that the request fits the arena alone)
                if sched.active():
                    sched.requeue(req)
                    return
                self._finish(req, RequestStatus.FAILED,
                             "page arena exhausted with no resident to wait for")
                continue
            vals, ids, pending = out
            vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
            if not np.isfinite(vals[0]).all() or ids[0, 0] < 0:
                # quarantine BEFORE admission: the slot stays free and the
                # rows this prefill wrote are zeroed
                self._finish(req, RequestStatus.FAILED,
                             "non-finite prefill output (request quarantined)")
                if self._mgr is not None:
                    self._release_slot_pages(i, scrub=True)
                else:
                    self._scrub_slot(i)
                continue
            # prefixes become adoptable only after the finite check
            for key, length, snap in pending:
                self._mgr.register_prefix(i, key, length, state_snapshot=snap)
            slot = sched.admit(i, req, S)
            req.status = RequestStatus.ACTIVE
            if self._draft is not None:
                # the draft mirrors the slot's token history in its own
                # contiguous cache (prefilled from scratch on a resume)
                self._draft_prefill_slot(toks, i)
            if n_resume:
                # the re-prefill's head output is dropped: those tokens were
                # emitted before the preemption; the sampling stream goes on
                # at the preserved emission count
                slot.n_emitted = n_resume
                self._tok[i] = req.out_tokens[-1]
                self._pos[i] = slot.pos
            else:
                self._emit(i, slot, self._sample(vals[0], ids[0], sp, 0))

    def _prefill_into_slot(self, toks: np.ndarray, i: int, priority: int):
        """Prefill ``toks`` into slot ``i``: ``(vals, ids, pending
        prefixes)``, or None when the arena could not supply the pages even
        after preemption (the slot is left with nothing mapped)."""
        S = len(toks)
        m = self._mgr
        li = self._own(i)  # None: another batch rank holds slot i
        pending: List[tuple] = []
        if m is not None and not self._alloc_state_page(i, priority):
            return None
        if self.prefill_chunk is None:
            if m is not None:
                if not self._prepare_kv_write_range(i, 0, S, priority):
                    self._release_slot_pages(i, scrub=False)
                    return None
                m.activate_slot(i)
            # every rank computes the prefill (its collectives stay in step);
            # the rank that holds slot i keeps the row
            vals, ids, row = self.bundle.prefill(
                self.params, self.table,
                {"tokens": torch.from_numpy(toks[None]).to(self.device)},
                k=self.k, kernel=self.kernel, mesh=self.mesh, gather=self._gather)
            if li is not None and m is None:
                self._insert(self._cache, self._kv_leaf, row, li, S)
            elif li is not None:
                pos = np.arange(S)
                pid = self._arena_ids(m.tables[i][pos // m.page_size], self._kv_arena)
                self._insert(self._cache, self._kv_leaf, row, li, S,
                             pages=(self._on_device(pid.astype(np.int64)),
                                    self._on_device(pos % m.page_size)),
                             state_page=(int(self._arena_ids(m.state_pid[i], self._state_arena))
                                         if m.has_state else None))
            return vals, ids, pending
        cp = self.prefill_chunk
        if m is None:
            # slot i's (·, 1, ·) rows, written in place (a scratch row where
            # another rank holds the slot); its recurrent state starts from
            # zeros, as a whole prompt's does
            cache = (self._slot_rows(self._cache, self._kv_leaf, li) if li is not None
                     else self._scratch_row())
            for lo in range(0, S, cp):
                vals, ids, _ = self._chunk(cache, toks, lo)
            return (*self._from_owner(i, vals, ids), pending)
        # paged chunked prefill, straight into the shared arena
        pos0 = 0
        if self._prefix_sharing:
            # max_len = S - 1: at least one tail chunk runs and gives the
            # head's top-k for this prompt
            e = m.match_prefix(toks, cp, S - 1, slot=i)
            if e is not None:
                m.adopt_prefix(i, e)
                if e.state is not None:
                    # the recurrent state at the prefix's end, copied into
                    # the slot's own page
                    self._copy_state_page(e.state[0], int(m.state_pid[i]), i)
                pos0 = e.length
                self._n_prefill_chunks_saved += pos0 // cp
        m.activate_slot(i)
        vals = ids = None
        # a rank that does not hold slot i runs the chunks on a scratch row:
        # its results are dropped for the owner's, but its collectives (the
        # FSDP gathers, the head's merge) stay in step
        cache = self._cache if li is not None else self._scratch_row()
        spages = None
        if m.has_state and li is not None:
            spages = self._on_device(self._arena_ids(m.state_pid[i:i + 1], self._state_arena))
        for lo in range(pos0, S, cp):
            # the chunk writes all cp rows (tail padding included), so the
            # prepared range covers the whole chunk
            if not self._prepare_kv_write_range(i, lo, lo + cp, priority):
                self._release_slot_pages(i, scrub=False)
                return None
            pages = (None if li is None
                     else self._on_device(self._arena_ids(m.tables[i:i + 1], self._kv_arena)))
            vals, ids, _ = self._chunk(cache, toks, lo, pages, spages)
            self._n_prefill_chunks += 1
            hi = min(lo + cp, S)
            if self._prefix_sharing and hi == lo + cp \
                    and not m.has_prefix(prefix_hash(toks[:hi]), hi, slot=i):
                # a state family's prefix carries a copy of the state at its
                # end (taken only from a free page: nobody is preempted for a
                # snapshot)
                snap = None
                if m.has_state:
                    snap = m.alloc_state(m.state_block(i))
                    if snap is None:
                        continue
                    self._copy_state_page(int(m.state_pid[i]), snap, i)
                    m.state_holdings[i].append(snap)
                pending.append((prefix_hash(toks[:hi]), hi, snap))
        return (*self._from_owner(i, vals, ids), pending)

    @staticmethod
    def _insert(cache, kv_leaf, row, i: int, S: int, pages=None, state_page=None) -> None:
        """Write a whole-prompt prefill's ``(·, 1, ·)`` cache ``row`` (S
        positions) into slot ``i``: K/V leaves at positions ``[0, S)``
        (through the page table row ``pages`` when paged; later positions
        keep stale rows, masked until this slot's own steps overwrite them),
        conv/ssm leaves whole (into ``state_page`` when paged)."""
        for leaf, r, kv in zip(cache, row, kv_leaf):
            if kv and pages is not None:
                leaf[:, pages[0], pages[1]] = r[:, 0]
            elif kv:
                leaf[:, i, :S] = r[:, 0]
            else:
                leaf[:, i if state_page is None else state_page] = r[:, 0].to(leaf.dtype)

    @staticmethod
    def _slot_rows(cache, kv_leaf, i: int):
        """Slot ``i``'s ``(·, 1, ·)`` rows of a contiguous cache as views,
        its conv/ssm rows zeroed (a prefill starts from zero state)."""
        rows = type(cache)(*(leaf[:, i:i + 1] for leaf in cache))
        for r, kv in zip(rows, kv_leaf):
            if not kv:
                r.zero_()
        return rows

    def _chunk(self, cache, toks: np.ndarray, lo: int, pages=None, state_pages=None):
        """One (1, prefill_chunk) chunk of ``toks`` from position ``lo``,
        right-padded with token 0, through ``bundle.prefill_chunk``."""
        cp = self.prefill_chunk
        tail = toks[lo: lo + cp]
        buf = np.zeros((1, cp), np.int64)
        buf[0, : len(tail)] = tail
        return self.bundle.prefill_chunk(
            self.params, self.table, cache, torch.from_numpy(buf).to(self.device), lo,
            len(tail), k=self.k, kernel=self.kernel, pages=pages, state_pages=state_pages,
            mesh=self.mesh, gather=self._gather)

    def _draft_prefill_slot(self, toks: np.ndarray, i: int) -> None:
        """Prefill the draft's cache row of slot ``i`` with the slot's whole
        token history (its head output is dropped: the draft first speaks
        in the next proposal round), whole-prompt or chunked as the
        session prefills."""
        d = self._draft
        if self.prefill_chunk is None:
            _, _, row = d["bundle"].prefill(
                d["params"], d["table"], {"tokens": torch.from_numpy(toks[None]).to(self.device)},
                k=self.k)
            self._insert(self._draft_cache, self._draft_kv_leaf, row, i, len(toks))
            return
        cp = self.prefill_chunk
        cache = type(self._draft_cache)(*(leaf[:, i:i + 1] for leaf in self._draft_cache))
        # a zeroed row, as repro prefills a zero row into the slot: a row the
        # draft never wrote (repro's schedule leaves one after a clean sweep)
        # holds zeros, not the previous occupant's K/V or state
        for leaf in cache:
            leaf.zero_()
        for lo in range(0, len(toks), cp):
            tail = toks[lo: lo + cp]
            buf = np.zeros((1, cp), np.int64)
            buf[0, : len(tail)] = tail
            d["bundle"].prefill_chunk(d["params"], d["table"], cache,
                                      torch.from_numpy(buf).to(self.device), lo, len(tail),
                                      k=self.k)

    # -- paged-arena management -------------------------------------------------

    def _alloc_state_page(self, i: int, priority: int) -> bool:
        """Give slot ``i`` a private, zeroed live state page (the recurrence
        starts from zeros, as a contiguous row's does), preempting
        strictly-lower-priority residents while the state arena is
        exhausted. True at once for a family without state."""
        m = self._mgr
        if not m.has_state:
            return True
        while True:
            pid = m.alloc_state(m.state_block(i))
            if pid is not None:
                break
            if not self._preempt_lowest_below(priority, i if m.state_blocks > 1 else None):
                return False
        m.state_pid[i] = pid
        self._zero_state_page(pid, i)
        return True

    def _copy_state_page(self, src: int, dst: int, i: int) -> None:
        """Copy state page ``src`` to ``dst`` (pages of slot ``i``), on the
        rank that holds the slot."""
        if self._own(i) is None:
            return
        src, dst = (int(self._arena_ids(p, self._state_arena)) for p in (src, dst))
        for leaf, kv in zip(self._cache, self._kv_leaf):
            if not kv:
                leaf[:, dst] = leaf[:, src]

    def _zero_state_page(self, pid: int, i: int) -> None:
        if self._own(i) is None:
            return
        pid = int(self._arena_ids(pid, self._state_arena))
        for leaf, kv in zip(self._cache, self._kv_leaf):
            if not kv:
                leaf[:, pid] = 0

    def _prepare_kv_write_range(self, i: int, lo: int, hi: int, priority: int) -> bool:
        """Make every page covering positions ``[lo, hi)`` of slot ``i``
        exclusively writable: fresh pages for unmapped entries, a copy for
        shared ones (copy-on-write: the copy runs here, before the write
        that needs it), preempting strictly-lower-priority residents while
        the arena is exhausted. False when even that failed; True at once
        for a model without K/V pages."""
        m = self._mgr
        if not m.has_kv:
            return True
        for j in range(lo // m.page_size, (hi - 1) // m.page_size + 1):
            while True:
                plan = m.prepare_write(i, j)
                if plan is not None:
                    break
                if not self._preempt_lowest_below(priority, i if m.kv_blocks > 1 else None):
                    return False
            if plan.kind == "cow" and self._own(i) is not None:
                src, dst = (int(self._arena_ids(p, self._kv_arena)) for p in (plan.src, plan.dst))
                for leaf, kv in zip(self._cache, self._kv_leaf):
                    if kv:
                        leaf[:, dst] = leaf[:, src]
        return True

    def _prepare_decode_writes(self, width: int = 1) -> None:
        """Before the decode step, secure each resident's write positions
        (``width`` of them: 1 for a decode step, gamma+1 for a verify
        block). A resident that cannot get its pages even after preempting
        every lower-priority batchmate preempts ITSELF: its freed pages
        unblock the others, and it resumes once capacity returns."""
        for i, slot in list(self.scheduler.active()):
            if self.scheduler.slots[i] is not slot:
                continue  # preempted by an earlier iteration
            pos = int(self._pos[i])
            if not self._prepare_kv_write_range(i, pos, pos + width,
                                                slot.req.sampling_params.priority):
                self._preempt_slot(i)

    def _preempt_lowest_below(self, priority: int, near: Optional[int] = None) -> bool:
        """Preempt the lowest-priority resident strictly below ``priority``
        (the newest admission among ties); ``near``: only among the slots
        of slot ``near``'s block, whose pages are the ones it can map.
        False when nobody qualifies: equal priority never preempts equal
        priority."""
        victim = None
        for i, slot in self.scheduler.active():
            if near is not None and self._mgr.slot_block(i) != self._mgr.slot_block(near):
                continue
            p = slot.req.sampling_params.priority
            if p >= priority:
                continue
            if victim is None:
                victim = (i, slot)
                continue
            vp = victim[1].req.sampling_params.priority
            if p < vp or (p == vp and slot.admit_seq > victim[1].admit_seq):
                victim = (i, slot)
        if victim is None:
            return False
        self._preempt_slot(victim[0])
        return True

    def _preempt_slot(self, i: int) -> None:
        """Preempt resident ``i`` and requeue it at the front: its page
        references drop (shared prefix pages survive through their
        co-owners) and the request keeps its emitted tokens for the resume."""
        slot = self.scheduler.slots[i]
        req = slot.req
        self._release_slot_pages(i, scrub=False)
        self.scheduler.release(i)
        self._tok[i] = 0
        self._pos[i] = 0
        req.status = RequestStatus.QUEUED
        self.scheduler.requeue(req)
        self._n_preempted += 1
        log.info("preempted slot %d (priority=%d, %d tokens emitted); requeued",
                 i, req.sampling_params.priority, slot.n_emitted)

    def _release_slot_pages(self, i: int, scrub: bool) -> None:
        """Drop every page reference of slot ``i`` (K/V pages, its state
        page and state snapshots) and point its table row at the garbage
        sink again. ``scrub`` zeroes each page that actually returns to the
        free list (FAILED tenants: their rows may be
        non-finite; a still-shared page is zeroed by whichever failing
        co-owner drops the last reference)."""
        m = self._mgr
        own = self._own(i) is not None
        for pid in m.mapped_kv_pages(i):
            if m.decref(pid) and scrub and own:
                p = int(self._arena_ids(pid, self._kv_arena))
                for leaf, kv in zip(self._cache, self._kv_leaf):
                    if kv:
                        leaf[:, p] = 0
        if m.has_state:
            # the live page, then the snapshots it registered or adopted
            live = int(m.state_pid[i])
            for pid in ([live] if live >= N_RESERVED else []) + list(m.state_holdings[i]):
                if m.decref_state(pid) and scrub:
                    self._zero_state_page(pid, i)
        m.reset_slot(i)

    def _sample(self, vals: np.ndarray, ids: np.ndarray, sp: SamplingParams,
                n_emitted: int) -> int:
        """One token from the head's (k,) top-k candidates: greedy, or
        Gumbel-max over a Philox stream keyed by (seed, n_emitted)."""
        if sp.temperature <= 0.0:
            return int(ids[0])
        k_eff = len(ids) if sp.top_k is None else min(sp.top_k, len(ids))
        u = _uniforms(sp.seed, _SALT_SAMPLE, n_emitted, k_eff)
        with np.errstate(divide="ignore"):
            g = -np.log(-np.log(u))  # Gumbel(0,1); u=0 -> -inf, never picked
        scores = np.asarray(vals[:k_eff], np.float64) / sp.temperature + g
        return int(ids[int(np.argmax(scores))])

    def _emit(self, i: int, slot: _Slot, token: int) -> None:
        req = slot.req
        sp = req.sampling_params
        req.out_tokens.append(token)
        slot.n_emitted += 1
        if self.stream_cb is not None:
            try:
                self.stream_cb(req, token)
            except Exception as e:  # a raising callback fails only its request
                self._finish_slot(i, RequestStatus.FAILED, f"stream_cb raised: {e!r}")
                return
        if req.status is not RequestStatus.ACTIVE:
            return  # cancelled inside the callback
        if (sp.eos_id is not None and token == sp.eos_id) \
                or slot.n_emitted >= sp.max_new_tokens:
            self._finish_slot(i, RequestStatus.COMPLETED)
            return
        if sp.deadline_steps is not None \
                and self.n_steps - req.submit_step >= sp.deadline_steps:
            self._finish_slot(i, RequestStatus.TIMED_OUT,
                              f"deadline_steps={sp.deadline_steps} exceeded mid-decode "
                              f"({slot.n_emitted} tokens emitted)")
            return
        self._tok[i] = token
        self._pos[i] = slot.pos
