"""Continuous-batching serving: ``ServeSession`` + ``Scheduler``.

Slot-based continuous batching over one model bundle: a fixed number of
decode slots share one contiguous KV cache and one decode step; every slot
carries its own sequence position, so a finished request releases its slot
mid-flight and the next queued prompt is prefilled into it (whole-prompt
prefill) while the other slots keep decoding. Per-request
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
has no capacity buffers, where ``repro`` moves to ``'jnp'``). The port has
no jit:
where ``repro`` re-traces its decode step, the port rebinds it (once at
init, once per swap, once per breaker trip; ``stats()['decode_builds']``).

Chunked prefill, the paged cache and speculative decoding are later slices.
"""
from __future__ import annotations

import collections
import enum
import logging
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.core import dssoftmax as ds
from repro_torch.device import check_on, resolve_device
from repro_torch.models.model_zoo import ModelBundle, cache_specs
from repro_torch.models.transformer import DecodeCache
from repro_torch.serve.table_manager import (
    AdaptPolicy,
    TableResource,
    TrafficProfile,
    repack_for_traffic,
)

log = logging.getLogger("repro_torch.serve")

_SALT_SAMPLE = 0x5A17_0001   # plain top-k Gumbel-max sampling


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

    def admit(self, i: int, req: Request, prompt_len: int) -> _Slot:
        if self.slots[i] is not None:
            raise RuntimeError(f"slot {i} is occupied")
        self.n_admitted += 1
        slot = _Slot(req=req, prompt_len=prompt_len)
        self.slots[i] = slot
        return slot

    def release(self, i: int) -> None:
        if self.slots[i] is None:
            raise RuntimeError(f"slot {i} is already free")
        self.slots[i] = None
        self.n_released += 1


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
        device: where the cache lives and the steps run; ``cuda`` unless
            the caller passes ``'cpu'``.
    """

    def __init__(self, bundle: ModelBundle, params, ds_state_or_table, *,
                 n_slots: int = 8, max_seq_len: int = 256, k: int = 8,
                 kernel=None,
                 stream_cb: Optional[Callable[[Request, int], None]] = None,
                 queue_limit: Optional[int] = None,
                 quantize: Optional[str] = None,
                 quantize_calib=256,
                 quantize_flip_threshold: float = 0.0,
                 overflow_threshold: float = 0.5,
                 overflow_window: int = 8,
                 stats_window: int = 128,
                 adapt_policy: Optional[AdaptPolicy] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        cfg = bundle.cfg
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        if quantize is not None and cfg.head != "ds":
            raise ValueError("quantize= requires a DS head (serve table)")
        self.bundle = bundle
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_seq_len = max_seq_len
        self.k = k
        self.kernel = kernel
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
            self._table_res = TableResource(table, gate=params["head"]["gate"])
        else:
            self._table_res = TableResource(ds_state_or_table)
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
        specs = cache_specs(cfg, ShapeConfig(name="serve", seq_len=max_seq_len,
                                             global_batch=n_slots, kind="decode"))
        self._cache = DecodeCache(*(torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                                    for s in specs))
        self.scheduler = Scheduler(n_slots, queue_limit=queue_limit)
        self._tok = np.zeros(n_slots, np.int64)
        self._pos = np.zeros(n_slots, np.int64)
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
        """(Re)bind the decode step to the effective kernel and capacity
        factor: once at init, once per :meth:`swap_table` and once per
        breaker trip (``decode_builds`` counts them). ``serve_topk``
        resolves the bound kernel against the table each step is given,
        which is the current version. The step is looked up on
        ``self.bundle`` at call time."""
        self._n_decode_builds += 1
        kernel, cf, k = self._eff_kernel, self._eff_capacity_factor, self.k

        def _decode(p, t, c, tok, pos):
            return self.bundle.decode_step(p, t, c, tok, pos, k=k, kernel=kernel,
                                           capacity_factor=cf, with_stats=True)

        self._decode_fn = _decode

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
            self.params = dict(self.params, head=dict(self.params["head"], gate=new_gate))
        if self._quantize is not None and isinstance(new_table, ds.ServeTable):
            new_table = self._quantize_pack(new_table, self.params["head"]["gate"])
        version = self._table_res.swap(new_table, gate=self.params["head"]["gate"])
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
        :class:`~repro_torch.serve.table_manager.TrafficProfile`, or None
        until the current table version has served a decode step. (No
        dummy experts to slice off: the port does not shard the table.)"""
        if not self._win:
            return None
        disp = np.sum([d for _, d, _ in self._win], axis=0, dtype=np.int64)
        over = np.sum([o for _, _, o in self._win], axis=0, dtype=np.int64)
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
        if S + sp.max_new_tokens - 1 > self.max_seq_len:
            reject(f"prompt_len ({S}) + max_new_tokens ({sp.max_new_tokens}) - 1 "
                   f"exceeds max_seq_len ({self.max_seq_len})")
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
        ONE decode step over the slot batch. Returns True while work
        remains."""
        self._expire_queue()
        self._admit()
        act = self.scheduler.active()
        if not act:
            return self.scheduler.has_work()
        vals, ids, self._cache, stats = self._decode_fn(
            self.params, self.table, self._cache,
            torch.from_numpy(self._tok).to(self.device),
            torch.from_numpy(self._pos).to(self.device))
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
        re-prunes, a key ``repro`` does not have), and the int8 mode with
        its exactness-gate report (``ExactnessReport.as_dict()``, None when
        the table was not quantized here)."""
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
        if status is RequestStatus.FAILED:
            self._scrub(i)

    def _scrub(self, i: int) -> None:
        # Zero every cache row of slot i: a later, shorter tenant's prefill
        # would not overwrite a residual NaN row, and masked attention
        # still multiplies it (0·NaN = NaN).
        self._cache.k[:, i] = 0
        self._cache.v[:, i] = 0

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
            vals, ids, row = self.bundle.prefill(
                self.params, self.table,
                {"tokens": torch.from_numpy(prompt[None]).to(self.device)},
                k=self.k, kernel=self.kernel)
            vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
            if not np.isfinite(vals[0]).all() or ids[0, 0] < 0:
                # quarantine BEFORE admission: the slot stays free
                self._finish(req, RequestStatus.FAILED,
                             "non-finite prefill output (request quarantined)")
                continue
            # positions >= S keep stale rows; they stay masked until this
            # slot's own decode steps overwrite them
            self._cache.k[:, i, :S] = row.k[:, 0]
            self._cache.v[:, i, :S] = row.v[:, 0]
            slot = sched.admit(i, req, S)
            req.status = RequestStatus.ACTIVE
            self._emit(i, slot, self._sample(vals[0], ids[0], sp, 0))

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
