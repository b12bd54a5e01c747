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
scales, gated for exactness as ``repro.train.serve`` gates it. Chunked
prefill, the paged cache, table hot-swap, the overflow circuit breaker and
speculative decoding are later slices.
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
        self._quantize_report: Optional[ds.ExactnessReport] = None
        check_on(self.device, params=params["embed"]["table"])
        if cfg.head == "ds":
            table = ds_state_or_table
            if not isinstance(table, (ds.ServeTable, ds.QuantizedServeTable)):
                table = ds.pack_experts(params["head"], table)
            check_on(self.device, table=ds.table_rows(table))
            if quantize is not None and isinstance(table, ds.ServeTable):
                table = self._quantize_pack(table, params["head"]["gate"], quantize_calib,
                                            float(quantize_flip_threshold))
            self.table = table
        else:
            self.table = ds_state_or_table
        specs = cache_specs(cfg, ShapeConfig(name="serve", seq_len=max_seq_len,
                                             global_batch=n_slots, kind="decode"))
        self._cache = DecodeCache(*(torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                                    for s in specs))
        self.scheduler = Scheduler(n_slots, queue_limit=queue_limit)
        self._tok = np.zeros(n_slots, np.int64)
        self._pos = np.zeros(n_slots, np.int64)
        self._outcomes: collections.Counter = collections.Counter()
        self._expert_dispatched: Optional[np.ndarray] = None
        self._expert_overflow: Optional[np.ndarray] = None

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
        vals, ids, self._cache, stats = self.bundle.decode_step(
            self.params, self.table, self._cache,
            torch.from_numpy(self._tok).to(self.device),
            torch.from_numpy(self._pos).to(self.device),
            k=self.k, kernel=self.kernel, with_stats=True,
        )
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
        per-expert dispatch/overflow totals over the decode steps, and the
        int8 mode with its exactness-gate report (``ExactnessReport.as_dict()``,
        None when the table was not quantized here)."""
        o = self._outcomes
        return {
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
            "expert_dispatched": (None if self._expert_dispatched is None
                                  else self._expert_dispatched.tolist()),
            "expert_overflow": (None if self._expert_overflow is None
                                else self._expert_overflow.tolist()),
            "quantize": self._quantize,
            "quantize_report": (None if self._quantize_report is None
                                else self._quantize_report.as_dict()),
        }

    # -- internals ------------------------------------------------------------

    def _quantize_pack(self, table: ds.ServeTable, gate_w, calib,
                       flip_threshold: float) -> ds.QuantizedServeTable:
        """Quantize a fp table under the exactness gate and keep its
        :class:`~repro_torch.core.dssoftmax.ExactnessReport`."""
        if isinstance(calib, int):
            gen = torch.Generator().manual_seed(17)
            calib = torch.randn((calib, self.cfg.d_model), generator=gen, dtype=torch.float32)
        calib = torch.as_tensor(calib).to(self.device)
        qtable, report = ds.calibrate_quantized_table(
            gate_w, table, calib, k=self.k, flip_threshold=flip_threshold)
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
        if self._expert_dispatched is None:
            self._expert_dispatched = np.zeros_like(disp)
            self._expert_overflow = np.zeros_like(over)
        self._expert_dispatched += disp
        self._expert_overflow += over

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
