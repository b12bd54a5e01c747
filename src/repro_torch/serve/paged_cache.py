"""Paged KV/state cache: host-side page table for the serving arena.

A copy of ``repro.serve.paged_cache`` (numpy only; the port imports
nothing of ``repro``), so the port's paged sessions allocate, share and
free pages exactly as the reference's do.

The contiguous serving cache gives every decode slot a private
``(·, slot, S_max, ·)`` row — N requests sharing a system prompt prefill
it N times, and an overloaded session can only shed. This module
replaces the per-slot rows with a **fixed-size-page arena**
(``(L, n_pages, page_size, KV, dh)`` for attention K/V;
``(L, n_state_pages, ...)`` for ssm/conv recurrent state) plus a pure
host-side :class:`PagedCacheManager`:

* a free list + per-page refcounts + per-slot page tables (one int32
  page id per ``page_size`` cache positions per slot);
* **copy-on-write prefix sharing**: chunk-aligned prompt prefixes are
  registered under a content hash; a later request with the same prefix
  increfs the donor's pages instead of re-prefilling them, and the
  first write into a still-shared page (the partially-covered boundary
  page, or the donor's own decode growth) copies it first
  (:meth:`prepare_write`);
* **generation counters**: prefix entries hold ``(page, gen)`` pairs and
  never own pages — a page returning to the free list bumps its
  generation, which invalidates every entry that referenced it, so the
  free-page count depends on slot refcounts alone (the chaos-suite
  leak-check invariant);
* **reserved pages**: page 0 (``PAGE_ZERO``) is all-zero forever and
  backs every *unmapped* table entry of an active slot — gathered rows
  beyond a slot's allocation are exact zeros, masked identically to the
  contiguous cache's zero tail; page 1 (``PAGE_GARBAGE``) absorbs the
  writes of *inactive* slot rows (the decode step always runs all
  ``n_slots`` rows) and is never mapped readable by an active slot,
  so a poisoned inactive row can never leak NaN into a resident.

Device-side copies/scrubs are the session's job (one-page in-place
copy/zero on the arena); the manager only says *which* pages to touch.
Preemption policy lives in ``ServeSession`` (the manager supplies the
metadata swap: release a victim's mappings, every page it shared
survives through its co-owners' refcounts).

**Blocks** (the port's, for a slot-split mesh session): the slots fall
into ``slot_blocks`` equal blocks, one a batch rank, and each rank holds
only its own slots' data. An arena split as well (``kv_blocks`` or
``state_blocks`` equal to ``slot_blocks``) is cut into that many equal
blocks of page ids, and a slot maps only pages of its own block, drawn
from that block's free list; an arena kept whole has one free list. Ids 0
and 1 stay the reserved pages on every rank (each rank keeps its own pair
beside its block). A prefix is adopted only by a slot of the block that
registered it: its pages hold data only on that rank. With one block of
each (the default) the manager is ``repro``'s.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

PAGE_ZERO = 0      # all-zero forever: unmapped reads of ACTIVE slots
PAGE_GARBAGE = 1   # write sink for INACTIVE slot rows; never mapped readable
N_RESERVED = 2


def prefix_hash(tokens: np.ndarray) -> bytes:
    """Content key for a prompt prefix (exact token identity)."""
    return hashlib.sha1(np.ascontiguousarray(tokens, np.int32).tobytes()).digest()


@dataclass
class PrefixEntry:
    """A registered chunk-aligned prompt prefix.

    Holds NO refcounts: ``kv``/``state`` are ``(page_id, generation)``
    pairs valid only while every page still carries the generation it
    had at registration (i.e. none has been freed since). ``state`` is
    the conv/ssm snapshot page at the boundary (ssm/hybrid families)."""

    length: int
    kv: List[Tuple[int, int]]
    state: Optional[Tuple[int, int]] = None


@dataclass
class WritePlan:
    """What :meth:`PagedCacheManager.prepare_write` decided for one
    (slot, page-index) about to be written. ``kind``:

    * ``'ok'``    — page exists and is exclusively owned; nothing to do;
    * ``'fresh'`` — a new page was mapped (``dst``); contents are stale
      garbage, every read of it is masked until written;
    * ``'cow'``   — the mapped page was shared; ``dst`` is the new
      private copy target and the session must copy ``src → dst`` before
      the step writes (in place: the copy must come first).
    """

    kind: str
    src: int
    dst: int


class PagedCacheManager:
    """Host-side bookkeeping for the paged serving arena (numpy only).

    Page ids < :data:`N_RESERVED` are the pinned zero/garbage pages and
    are never allocated. ``tables[slot, j]`` maps the slot's logical
    positions ``[j*page_size, (j+1)*page_size)`` to an arena page;
    inactive slots map everything to :data:`PAGE_GARBAGE` and active
    slots map their unallocated tail to :data:`PAGE_ZERO`.
    """

    def __init__(self, *, n_slots: int, n_pages: int, page_size: int,
                 max_seq_len: int, has_state: bool = False,
                 has_kv: bool = True,
                 n_state_pages: Optional[int] = None,
                 prefix_capacity: int = 512,
                 slot_blocks: int = 1, kv_blocks: int = 1, state_blocks: int = 1):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_seq_len % page_size:
            raise ValueError(
                f"max_seq_len ({max_seq_len}) must be a multiple of "
                f"page_size ({page_size})"
            )
        self.page_size = page_size
        self.pages_per_slot = max_seq_len // page_size
        if n_pages < N_RESERVED + 1:
            raise ValueError(
                f"n_pages must be >= {N_RESERVED + 1} "
                f"({N_RESERVED} reserved + at least one allocatable)"
            )
        self.n_slots = n_slots
        self.n_pages = n_pages
        self.has_state = has_state
        # attention-free families (pure ssm) carry no KV pages: the KV
        # arena leaves are zero-sized and only state pages are managed
        self.has_kv = has_kv
        self.n_state_pages = int(n_state_pages or 0)
        if has_state and self.n_state_pages < N_RESERVED + 1:
            raise ValueError(
                f"n_state_pages must be >= {N_RESERVED + 1}, "
                f"got {n_state_pages}"
            )

        for name, nb, n in (("slot", slot_blocks, n_slots), ("kv", kv_blocks, n_pages),
                            ("state", state_blocks, self.n_state_pages)):
            if nb not in (1, slot_blocks) or (n and n % nb):
                raise ValueError(f"{name}_blocks ({nb}) must be 1 or slot_blocks "
                                 f"({slot_blocks}) and divide {n}")
        self.slot_blocks = slot_blocks
        self.kv_blocks = kv_blocks
        self.state_blocks = state_blocks
        # LIFO free lists (one per block) keep the hot pages hot; ids
        # below N_RESERVED never enter them.
        self._free_blocks: List[List[int]] = _free_lists(n_pages, kv_blocks)
        self.ref = np.zeros(n_pages, np.int64)
        self.gen = np.zeros(n_pages, np.int64)
        self._state_free_blocks: List[List[int]] = (
            _free_lists(self.n_state_pages, state_blocks) if has_state else [[]])
        self.state_ref = np.zeros(self.n_state_pages, np.int64)
        self.state_gen = np.zeros(self.n_state_pages, np.int64)

        self.tables = np.full((n_slots, self.pages_per_slot), PAGE_GARBAGE,
                              np.int32)
        self.state_pid = np.full(n_slots, PAGE_GARBAGE, np.int32)
        # state pages a slot must decref on release beyond its live page:
        # its own registered snapshots + incref'd shared snapshots
        self.state_holdings: List[List[int]] = [[] for _ in range(n_slots)]

        # keyed by content hash (by (slot block, hash) over several blocks)
        self._prefix: Dict[object, PrefixEntry] = {}
        self._prefix_capacity = prefix_capacity

        # counters surfaced via ServeSession.stats()
        self.n_cow = 0
        self.n_prefix_hits = 0
        self.n_prefix_queries = 0
        self.tokens_reused = 0

    # -- blocks ---------------------------------------------------------------

    def slot_block(self, slot: int) -> int:
        """The block (batch rank) that holds ``slot``."""
        return int(slot) * self.slot_blocks // self.n_slots

    def kv_block(self, slot: int) -> int:
        """The KV free list ``slot`` draws from."""
        return self.slot_block(slot) if self.kv_blocks > 1 else 0

    def state_block(self, slot: int) -> int:
        return self.slot_block(slot) if self.state_blocks > 1 else 0

    def _pkey(self, slot: int, key: bytes):
        return key if self.slot_blocks == 1 else (self.slot_block(slot), key)

    # -- capacity -----------------------------------------------------------

    @property
    def _free(self) -> List[int]:
        """Every free KV page id, block by block (one block: the list)."""
        return [p for f in self._free_blocks for p in f]

    @property
    def allocatable(self) -> int:
        return self.n_pages - N_RESERVED

    @property
    def slot_allocatable(self) -> int:
        """The most pages one slot can ever map: its block's (block 0's,
        which also holds the reserved ids, is the smallest)."""
        return self.n_pages // self.kv_blocks - N_RESERVED

    @property
    def pages_free(self) -> int:
        return sum(map(len, self._free_blocks))

    @property
    def pages_in_use(self) -> int:
        return self.allocatable - self.pages_free

    @property
    def state_pages_free(self) -> int:
        return sum(map(len, self._state_free_blocks))

    @property
    def state_pages_in_use(self) -> int:
        return max(0, self.n_state_pages - N_RESERVED) - self.state_pages_free

    def shared_pages(self) -> List[int]:
        """KV pages currently mapped by more than one owner."""
        return [p for p in range(N_RESERVED, self.n_pages) if self.ref[p] > 1]

    # -- raw page ops -------------------------------------------------------

    def alloc(self, block: Optional[int] = None) -> Optional[int]:
        """Take one KV page off ``block``'s free list (ref = 1; ``None``:
        the first block with a free page); ``None`` when it is exhausted
        (the caller decides preempt vs defer)."""
        free = _pick(self._free_blocks, block)
        if not free:
            return None
        pid = free.pop()
        assert self.ref[pid] == 0
        self.ref[pid] = 1
        return pid

    def incref(self, pid: int) -> None:
        assert pid >= N_RESERVED and self.ref[pid] > 0
        self.ref[pid] += 1

    def decref(self, pid: int) -> bool:
        """Drop one reference; True when the page hit zero and was
        returned to the free list (generation bumped — every prefix
        entry referencing it is now invalid). The CALLER must scrub the
        page first when the owner failed poisoned."""
        assert pid >= N_RESERVED and self.ref[pid] > 0
        self.ref[pid] -= 1
        if self.ref[pid] == 0:
            self.gen[pid] += 1
            self._free_blocks[pid * self.kv_blocks // self.n_pages].append(pid)
            return True
        return False

    def alloc_state(self, block: Optional[int] = None) -> Optional[int]:
        free = _pick(self._state_free_blocks, block)
        if not free:
            return None
        pid = free.pop()
        assert self.state_ref[pid] == 0
        self.state_ref[pid] = 1
        return pid

    def incref_state(self, pid: int) -> None:
        assert pid >= N_RESERVED and self.state_ref[pid] > 0
        self.state_ref[pid] += 1

    def decref_state(self, pid: int) -> bool:
        assert pid >= N_RESERVED and self.state_ref[pid] > 0
        self.state_ref[pid] -= 1
        if self.state_ref[pid] == 0:
            self.state_gen[pid] += 1
            self._state_free_blocks[pid * self.state_blocks // self.n_state_pages].append(pid)
            return True
        return False

    # -- slot mapping / write preparation -----------------------------------

    def prepare_write(self, slot: int, idx: int) -> Optional[WritePlan]:
        """Make table entry ``idx`` of ``slot`` exclusively writable.

        Unmapped (zero/garbage) → map a fresh page; shared (ref > 1) →
        map a fresh page and report a CoW copy for the session to run;
        exclusive → no-op. Returns ``None`` when allocation fails (arena
        exhausted) with the table untouched."""
        pid = int(self.tables[slot, idx])
        if pid < N_RESERVED:
            new = self.alloc(self.kv_block(slot))
            if new is None:
                return None
            self.tables[slot, idx] = new
            return WritePlan("fresh", pid, new)
        if self.ref[pid] > 1:
            new = self.alloc(self.kv_block(slot))
            if new is None:
                return None
            self.tables[slot, idx] = new
            self.ref[pid] -= 1  # still > 0: co-owners keep it alive
            self.n_cow += 1
            return WritePlan("cow", pid, new)
        return WritePlan("ok", pid, pid)

    def mapped_kv_pages(self, slot: int) -> List[int]:
        return [int(p) for p in self.tables[slot] if p >= N_RESERVED]

    def reset_slot(self, slot: int) -> None:
        """Clear a slot's mappings AFTER its pages were decref'd: the
        whole row points at the garbage write sink again (inactive)."""
        self.tables[slot, :] = PAGE_GARBAGE
        self.state_pid[slot] = PAGE_GARBAGE
        self.state_holdings[slot].clear()

    def activate_slot(self, slot: int) -> None:
        """Flip a slot's unmapped entries from the garbage write sink to
        the zero page: an ACTIVE slot's unallocated tail must gather
        exact zeros (masked identically to the contiguous cache)."""
        row = self.tables[slot]
        row[row == PAGE_GARBAGE] = PAGE_ZERO

    # -- prefix registry ----------------------------------------------------

    def entry_valid(self, e: PrefixEntry) -> bool:
        for pid, g in e.kv:
            if pid < N_RESERVED or self.ref[pid] <= 0 or self.gen[pid] != g:
                return False
        if e.state is not None:
            pid, g = e.state
            if pid < N_RESERVED or self.state_ref[pid] <= 0 \
                    or self.state_gen[pid] != g:
                return False
        return True

    def register_prefix(self, slot: int, key: bytes, length: int,
                        state_snapshot: Optional[int] = None) -> None:
        """Record that ``slot``'s first ``length`` positions (a chunk
        boundary) hold the prefix hashed by ``key``. Weak: no refcounts
        are taken; the entry dies with the pages. ``state_snapshot`` is
        the already-copied conv/ssm boundary page for state families
        (owned by ``slot`` via its holdings)."""
        key = self._pkey(slot, key)
        old = self._prefix.get(key)
        if old is not None and old.length == length and self.entry_valid(old):
            return
        kv = []
        if self.has_kv:
            n_pg = -(-length // self.page_size)
            for j in range(n_pg):
                pid = int(self.tables[slot, j])
                if pid < N_RESERVED:  # should not happen; refuse to register
                    return
                kv.append((pid, int(self.gen[pid])))
        state = None
        if self.has_state:
            if state_snapshot is None:
                return  # a state family prefix without a snapshot is unusable
            state = (state_snapshot, int(self.state_gen[state_snapshot]))
        if len(self._prefix) >= self._prefix_capacity and key not in self._prefix:
            self._prefix.pop(next(iter(self._prefix)))  # FIFO evict
        self._prefix[key] = PrefixEntry(length=length, kv=kv, state=state)

    def has_prefix(self, key: bytes, length: int, slot: int = 0) -> bool:
        """True when ``key`` is registered at ``length`` by ``slot``'s block
        and still valid (callers use this to skip redundant snapshot
        copies)."""
        e = self._prefix.get(self._pkey(slot, key))
        return e is not None and e.length == length and self.entry_valid(e)

    def match_prefix(self, tokens: np.ndarray, chunk: int,
                     max_len: int, slot: int = 0) -> Optional[PrefixEntry]:
        """Longest chunk-aligned prefix of ``tokens`` with length <=
        ``max_len`` registered by ``slot``'s block and still valid (the
        caller passes ``len(tokens) - 1`` so at least one tail chunk always
        runs and produces the head's first top-k)."""
        self.n_prefix_queries += 1
        hi = (min(max_len, len(tokens)) // chunk) * chunk
        for m in range(hi, 0, -chunk):
            e = self._prefix.get(self._pkey(slot, prefix_hash(tokens[:m])))
            if e is not None and e.length == m and self.entry_valid(e):
                self.n_prefix_hits += 1
                self.tokens_reused += m
                return e
        return None

    def adopt_prefix(self, slot: int, e: PrefixEntry) -> None:
        """Map a matched prefix into ``slot``: incref every shared KV
        page and point the slot's leading table entries at them. The
        state snapshot (if any) is incref'd into the slot's holdings —
        the caller copies it into the slot's live state page."""
        for j, (pid, _) in enumerate(e.kv):
            self.incref(pid)
            self.tables[slot, j] = pid
        if e.state is not None:
            self.incref_state(e.state[0])
            self.state_holdings[slot].append(e.state[0])

    # -- stats --------------------------------------------------------------

    def stats(self) -> dict:
        q = self.n_prefix_queries
        return {
            "page_size": self.page_size,
            "pages_total": self.allocatable,
            "pages_in_use": self.pages_in_use,
            "pages_free": self.pages_free,
            "state_pages_in_use": self.state_pages_in_use,
            "state_pages_free": self.state_pages_free,
            "cow_copies": self.n_cow,
            "prefix_entries": len(self._prefix),
            "prefix_hits": self.n_prefix_hits,
            "prefix_queries": q,
            "prefix_hit_rate": (self.n_prefix_hits / q) if q else 0.0,
            "prefix_tokens_reused": self.tokens_reused,
        }


def _free_lists(n_pages: int, n_blocks: int) -> List[List[int]]:
    """One LIFO free list per block of ``n_pages // n_blocks`` ids (lowest
    id on top), the reserved ids left out."""
    w = n_pages // n_blocks
    return [list(range((b + 1) * w - 1, max(N_RESERVED, b * w) - 1, -1))
            for b in range(n_blocks)]


def _pick(lists: List[List[int]], block: Optional[int]) -> List[int]:
    if block is not None:
        return lists[block]
    return next((f for f in lists if f), lists[0])
