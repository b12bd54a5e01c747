"""Port parity: the paged KV cache (``repro_torch.serve.paged_cache``, a
copy of ``repro.serve.paged_cache``) and ``ServeSession(paged=True,
prefill_chunk=...)`` against ``repro``.

* The page table: one random operation sequence drives ``repro``'s
  ``PagedCacheManager`` and the port's; every return value, the tables,
  refcounts, generations, free lists and ``stats()`` must stay equal.
* Sessions: the single-device dense cases of ``tests/test_serve_paged.py``
  (token identity against the contiguous cache, mid-flight admits,
  validation, copy-on-write prefix sharing, preemption and resume, greedy
  and sampled) on the same JAX-initialized weights
  (``convert.params_from_jax``). Each port stream must equal ``repro``'s
  token for token; where ``repro``'s test compares with independent
  sessions, the reference is one ``repro`` session serving the requests
  one at a time (n_slots 1, chunked prefill), which ``repro`` holds
  bit-identical to them. The page counters of the sharing and preemption
  cases must equal a ``repro`` paged session's.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.core import dssoftmax as jds
from repro.models import build as jbuild
from repro.serve import PagedCacheManager as JPagedCacheManager
from repro.train import Request as JRequest
from repro.train import SamplingParams as JSamplingParams
from repro.train import ServeSession as JServeSession
from repro_torch import configs
from repro_torch.convert import flatten_paths, params_from_jax
from repro_torch.models import build
from repro_torch.serve import (
    N_RESERVED,
    PAGE_GARBAGE,
    PAGE_ZERO,
    PagedCacheManager,
    prefix_hash,
)
from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession


@functools.lru_cache(maxsize=None)
def _models():
    """repro's and the port's tiny qwen2 (vocab 128, 4 experts, fp32) on
    the same weights and pruned DS mask."""
    jcfg = jreduce_config(jget_config("qwen2-1.5b"), vocab=128).replace(
        ds=jget_config("qwen2-1.5b").ds.replace(num_experts=4), dtype="float32")
    tcfg = configs.reduce_config(configs.get_config("qwen2-1.5b"), vocab=128).replace(
        ds=configs.get_config("qwen2-1.5b").ds.replace(num_experts=4), dtype="float32")
    jb = jbuild(jcfg)
    params, state = jb.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    mask = np.asarray(state.mask) & (rng.rand(*state.mask.shape) < 0.5)
    mask[rng.randint(0, 4, mask.shape[1]), np.arange(mask.shape[1])] = True
    jstate = jds.DSState(mask=jax.numpy.asarray(mask))
    tree = flatten_paths(jax.tree.map(np.asarray, params))
    tree["ds_state/mask"] = mask
    tparams, tstate = params_from_jax(tree, tcfg, device="cpu")
    return (jb, params, jstate), (build(tcfg, device="cpu"), tparams, tstate)


def _jsession(**kw):
    jb, jp, js = _models()[0]
    return JServeSession(jb, jp, js, k=8, kernel="jnp", **kw)


def _session(**kw):
    tb, tp, ts = _models()[1]
    return ServeSession(tb, tp, ts, k=8, device="cpu", **kw)


def _spec(prompt, **sp):
    return (np.asarray(prompt, np.int32), sp)


def _run(make, Req, SP, specs, n_slots, **kw):
    """Serve ``specs`` ((prompt, SamplingParams kwargs) pairs) in one
    session; returns (streams, session)."""
    sess = make(n_slots=n_slots, **kw)
    reqs = [Req(prompt=p.copy(), sampling=SP(**sp)) for p, sp in specs]
    sess.run(reqs)
    assert all(r.status.value == "completed" for r in reqs)
    return [list(r.out_tokens) for r in reqs], sess


def _reference(specs, max_seq_len, chunk=4):
    """repro's tokens for each request served alone (one slot, chunked)."""
    return _run(_jsession, JRequest, JSamplingParams, specs, 1, max_seq_len=max_seq_len,
                prefill_chunk=chunk)[0]


def _assert_leak_free(sess):
    st = sess.stats()["paged"]
    assert st["pages_in_use"] == 0, st
    assert not sess.scheduler.has_work()


def _mixed(n=5, seed=0, max_new=(2, 6, 3, 5, 4)):
    rng = np.random.RandomState(seed)
    return [_spec(rng.randint(1, 128, rng.randint(3, 12)), max_new_tokens=max_new[i % 5])
            for i in range(n)]


def _shared_prefix(n, prefix_len, tail_len, seed=3, max_new=6):
    rng = np.random.RandomState(seed)
    sysp = rng.randint(1, 128, prefix_len)
    return [_spec(np.concatenate([sysp, rng.randint(1, 128, tail_len)]),
                  max_new_tokens=max_new) for _ in range(n)]


# ---------------------------------------------------------------------------
# The page table
# ---------------------------------------------------------------------------

def _state(m):
    return (m.tables.tolist(), m.ref.tolist(), m.gen.tolist(), list(m._free),
            m.state_pid.tolist(), sorted(m._prefix), m.stats())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_manager_matches_repro_on_one_operation_sequence(seed):
    """400 random operations (write preparation with fresh pages and
    copy-on-write, prefix registration, matching and adoption, activation,
    release) on 3 slots over a 10-page arena, both managers in step."""
    rng = np.random.RandomState(seed)
    kw = dict(n_slots=3, n_pages=N_RESERVED + 10, page_size=4, max_seq_len=16,
              prefix_capacity=4)
    mj, mt = JPagedCacheManager(**kw), PagedCacheManager(**kw)
    toks = [rng.randint(0, 3, 16).astype(np.int32) for _ in range(3)]
    for _ in range(400):
        op, slot = rng.randint(6), rng.randint(3)
        if op == 0:
            idx = rng.randint(4)
            out = [m.prepare_write(slot, idx) for m in (mj, mt)]
            assert (out[0] is None) == (out[1] is None)
            if out[0] is not None:
                assert (out[0].kind, out[0].src, out[0].dst) == \
                    (out[1].kind, out[1].src, out[1].dst)
        elif op == 1:
            freed = []
            for m in (mj, mt):
                freed.append([(p, m.decref(p)) for p in m.mapped_kv_pages(slot)])
                m.reset_slot(slot)
            assert freed[0] == freed[1]
            toks[slot] = rng.randint(0, 3, 16).astype(np.int32)
        elif op == 2:
            for m in (mj, mt):
                m.activate_slot(slot)
        elif op == 3:
            length = 4 * rng.randint(1, 5)
            key = prefix_hash(toks[slot][:length])
            for m in (mj, mt):
                m.register_prefix(slot, key, length)
        elif op == 4:
            ej, et = (m.match_prefix(toks[slot], 4, 15) for m in (mj, mt))
            assert (ej is None) == (et is None)
            if ej is not None:
                assert (ej.length, ej.kv) == (et.length, et.kv)
                other = (slot + 1) % 3
                if (mj.tables[other] < N_RESERVED).all():
                    mj.adopt_prefix(other, ej)
                    mt.adopt_prefix(other, et)
        else:
            p = [m.alloc() for m in (mj, mt)]
            assert p[0] == p[1]
            if p[0] is not None:
                for m in (mj, mt):
                    m.incref(p[0])
                    assert not m.decref(p[0])
                    assert m.decref(p[0])
        assert _state(mj) == _state(mt)


def test_manager_units():
    """``repro``'s page-table unit tests (``tests/test_serve_paged.py:82-145``)
    on the port's manager."""
    m = PagedCacheManager(n_slots=2, n_pages=N_RESERVED + 4, page_size=4, max_seq_len=16)
    assert m.allocatable == 4 and m.pages_free == 4
    p = m.alloc()
    m.incref(p)
    assert not m.decref(p) and m.decref(p) and m.pages_free == 4
    held = [m.alloc() for _ in range(4)]
    assert m.alloc() is None
    for q in held:
        m.decref(q)
    # fresh, ok, then copy-on-write once the page is shared
    plan = m.prepare_write(0, 0)
    assert plan.kind == "fresh" and m.prepare_write(0, 0).kind == "ok"
    m.incref(int(m.tables[0, 0]))
    m.tables[1, 0] = m.tables[0, 0]
    plan = m.prepare_write(0, 0)
    assert plan.kind == "cow" and plan.src != plan.dst and m.n_cow == 1
    # a freed page bumps its generation: the prefix entry dies
    m2 = PagedCacheManager(n_slots=1, n_pages=N_RESERVED + 4, page_size=4, max_seq_len=16)
    assert (m2.tables[0] == PAGE_GARBAGE).all()
    m2.prepare_write(0, 0)
    m2.prepare_write(0, 1)
    key = prefix_hash(np.arange(8, dtype=np.int32))
    m2.register_prefix(0, key, 8)
    assert m2.match_prefix(np.arange(12, dtype=np.int32), 4, 11).length == 8
    m2.activate_slot(0)
    assert (m2.tables[0, 2:] == PAGE_ZERO).all()
    for pid in m2.mapped_kv_pages(0):
        m2.decref(pid)
    m2.reset_slot(0)
    assert not m2.has_prefix(key, 8) and m2.pages_free == m2.allocatable


def test_manager_blocks():
    """The port's blocks (a slot-split mesh session's arena): 4 slots in 2
    blocks over a 12-page arena cut in two. A slot maps pages of its own
    block only (block 0 ids 2–5, beside the reserved 0 and 1; block 1 ids
    6–11), a freed page returns to its block's list, ``slot_allocatable``
    is the smaller block's, and a prefix registered by a slot of block 0
    is matched only by block 0's slots. Blocks must divide the slots and
    pages."""
    m = PagedCacheManager(n_slots=4, n_pages=12, page_size=4, max_seq_len=16, slot_blocks=2,
                          kv_blocks=2)
    assert (m.allocatable, m.slot_allocatable, m.pages_free) == (10, 4, 10)
    assert [m.slot_block(i) for i in range(4)] == [0, 0, 1, 1]
    assert [m.prepare_write(0, j).dst for j in range(4)] == [2, 3, 4, 5]
    assert m.prepare_write(1, 0) is None  # block 0 is dry, block 1 is not
    assert m.prepare_write(2, 0).dst == 6 and m.pages_free == 5
    key = prefix_hash(np.arange(8, dtype=np.int32))
    m.register_prefix(0, key, 8)
    assert m.has_prefix(key, 8, slot=1) and not m.has_prefix(key, 8, slot=2)
    assert m.match_prefix(np.arange(12, dtype=np.int32), 4, 11, slot=3) is None
    assert m.match_prefix(np.arange(12, dtype=np.int32), 4, 11, slot=1).length == 8
    for pid in m.mapped_kv_pages(0):
        m.decref(pid)
    m.reset_slot(0)
    assert sorted(m._free_blocks[0]) == [2, 3, 4, 5] and m.prepare_write(1, 0).dst in range(2, 6)
    with pytest.raises(ValueError, match="kv_blocks"):
        PagedCacheManager(n_slots=4, n_pages=11, page_size=4, max_seq_len=16, slot_blocks=2,
                          kv_blocks=2)


# ---------------------------------------------------------------------------
# Sessions: token identity against the contiguous cache and repro
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 4])
def test_paged_token_identity(chunk):
    """Mixed workload with slot churn (5 requests, 2 slots): the port's
    paged streams equal its contiguous ones and repro's, with no leaked
    page."""
    specs = _mixed(seed=1)
    want = _run(_jsession, JRequest, JSamplingParams, specs, 2, max_seq_len=32,
                prefill_chunk=4)[0]
    contiguous = _run(_session, Request, SamplingParams, specs, 2, max_seq_len=32,
                      prefill_chunk=chunk)[0]
    got, sess = _run(_session, Request, SamplingParams, specs, 2, max_seq_len=32,
                     prefill_chunk=chunk, paged=True, page_size=8)
    assert got == contiguous == want
    _assert_leak_free(sess)


def test_paged_mid_flight_admit_identical():
    """A request submitted while others decode lands in a freed slot whose
    pages were recycled."""
    specs = _mixed(n=4, seed=2)
    late = _spec(np.arange(5) + 7, max_new_tokens=4)
    want = _run(_jsession, JRequest, JSamplingParams, specs + [late], 2, max_seq_len=32,
                prefill_chunk=4)[0]
    sess = _session(n_slots=2, max_seq_len=32, prefill_chunk=4, paged=True, page_size=8)
    reqs = [Request(prompt=p.copy(), sampling=SamplingParams(**sp)) for p, sp in specs]
    for r in reqs:
        sess.submit(r)
    sess.step()
    sess.step()
    reqs.append(Request(prompt=late[0].copy(), sampling=SamplingParams(**late[1])))
    sess.submit(reqs[-1])
    while sess.step():
        pass
    assert [r.out_tokens for r in reqs] == want
    _assert_leak_free(sess)


def test_paged_validation():
    with pytest.raises(ValueError, match="page_size"):
        _session(max_seq_len=30, paged=True, page_size=8)
    with pytest.raises(ValueError, match="prefill_chunk"):
        _session(max_seq_len=32, paged=True, page_size=8, prefill_chunk=5)
    with pytest.raises(ValueError, match="prefill_chunk must be >= 1"):
        _session(max_seq_len=32, prefill_chunk=0)


def test_paged_submit_rejects_never_fitting_request():
    """A worst-case footprint beyond the whole arena is rejected at submit."""
    sess = _session(n_slots=2, max_seq_len=32, paged=True, page_size=8, page_arena=2)
    req = Request(prompt=np.arange(20, dtype=np.int32),
                  sampling=SamplingParams(max_new_tokens=4))
    with pytest.raises(ValueError, match="pages"):
        sess.submit(req)
    assert req.status is RequestStatus.REJECTED
    _assert_leak_free(sess)


def test_chunked_prefill_tail_past_cache_end_rejected():
    """``tests/test_serve_session.py:279``: a tail chunk past max_seq_len is
    rejected at submit; with room for it, chunked equals whole-prompt."""
    sess = _session(n_slots=1, max_seq_len=9, prefill_chunk=8)
    with pytest.raises(ValueError, match="prefill_chunk"):
        sess.submit(Request(prompt=np.arange(9, dtype=np.int32),
                            sampling=SamplingParams(max_new_tokens=1)))
    specs = [_spec(np.arange(9), max_new_tokens=2)]
    chunked = _run(_session, Request, SamplingParams, specs, 1, max_seq_len=16,
                   prefill_chunk=8)[0]
    whole = _run(_session, Request, SamplingParams, specs, 1, max_seq_len=16)[0]
    assert chunked == whole == _reference(specs, 16, chunk=8)


# ---------------------------------------------------------------------------
# Copy-on-write prefix sharing
# ---------------------------------------------------------------------------

def test_prefix_prefilled_once_and_divergence_identical():
    """4 requests behind a 16-token system prompt (chunk 4): the prefix's 4
    chunks run once, the other 3 adopt its pages; the streams equal
    independent ones and the page counters equal repro's."""
    specs = _shared_prefix(4, 16, 4)
    got, sess = _run(_session, Request, SamplingParams, specs, 4, max_seq_len=64,
                     prefill_chunk=4, paged=True, page_size=8)
    _, jsess = _run(_jsession, JRequest, JSamplingParams, specs, 4, max_seq_len=64,
                    prefill_chunk=4, paged=True, page_size=8)
    assert got == _reference(specs, 64)
    st = sess.stats()["paged"]
    assert st == jsess.stats()["paged"]
    assert st["prefix_hits"] == 3 and st["prefill_chunks_saved"] == 12
    assert st["prefix_tokens_reused"] == 48
    assert sess._n_prefill_chunks == sum(-(-len(p) // 4) for p, _ in specs) - 12
    _assert_leak_free(sess)


def test_cow_on_partially_shared_page():
    """A 12-token prefix ends mid-page (page_size 8): each adopter's own
    tail chunk writes into the shared boundary page, which is copied first."""
    specs = _shared_prefix(3, 12, 5, seed=4, max_new=8)
    got, sess = _run(_session, Request, SamplingParams, specs, 3, max_seq_len=64,
                     prefill_chunk=4, paged=True, page_size=8)
    _, jsess = _run(_jsession, JRequest, JSamplingParams, specs, 3, max_seq_len=64,
                    prefill_chunk=4, paged=True, page_size=8)
    assert got == _reference(specs, 64)
    st = sess.stats()["paged"]
    assert st == jsess.stats()["paged"]
    assert st["prefix_hits"] == 2 and st["cow_copies"] > 0
    _assert_leak_free(sess)


def test_prefix_sharing_disabled_still_paged():
    specs = _shared_prefix(3, 16, 4)
    want = _run(_session, Request, SamplingParams, specs, 3, max_seq_len=64,
                prefill_chunk=4)[0]
    got, sess = _run(_session, Request, SamplingParams, specs, 3, max_seq_len=64,
                     prefill_chunk=4, paged=True, page_size=8, prefix_sharing=False)
    assert got == want
    st = sess.stats()["paged"]
    assert st["prefix_hits"] == 0 and st["prefill_chunks_saved"] == 0
    _assert_leak_free(sess)


def test_paged_chunked_session_on_an_int8_table():
    """Prefix sharing over an int8 table (flip threshold 1.0: every expert
    on int8 rows, so the calibration draw does not matter) through the
    grouped and fused paths: the streams equal repro's int8 session's."""
    specs = _shared_prefix(3, 12, 5, seed=5)
    kw = dict(max_seq_len=64, prefill_chunk=4, paged=True, page_size=8, quantize="int8",
              quantize_flip_threshold=1.0, quantize_calib=16)
    want, jsess = _run(_jsession, JRequest, JSamplingParams, specs, 3, **kw)
    for kern in ("cuda_grouped", "cuda_fused"):
        got, sess = _run(functools.partial(_session, kernel=kern), Request, SamplingParams,
                         specs, 3, **kw)
        assert got == want
        assert sess.stats()["quantize_report"]["n_fallback"] == 0
        assert sess.stats()["paged"] == jsess.stats()["paged"]
        _assert_leak_free(sess)


# ---------------------------------------------------------------------------
# Priority preemption under arena pressure
# ---------------------------------------------------------------------------

def _preempt_pair(sampled):
    rng = np.random.RandomState(6)
    lo = dict(temperature=0.9, top_k=4, seed=11) if sampled else {}
    hi = dict(temperature=0.7, seed=22) if sampled else {}
    return (_spec(rng.randint(1, 100, 10), max_new_tokens=20, priority=0, **lo),
            _spec(rng.randint(1, 100, 10), max_new_tokens=20, priority=5, **hi))


@pytest.mark.parametrize("sampled", [False, True])
def test_preempted_request_resumes_identically(sampled):
    """A 5-page arena cannot hold both requests (4 pages each at full
    length): admitting the high-priority one preempts the low one, which
    resumes later with its whole stream (greedy or sampled: the host
    sampler keys on the emission index) equal to an uncontended run. The
    page counters, preemptions included, equal repro's."""
    specs = _preempt_pair(sampled)
    want = _reference(specs, 64)
    kw = dict(n_slots=2, max_seq_len=64, prefill_chunk=4, paged=True, page_size=8,
              page_arena=5, prefix_sharing=False)
    out = []
    for make, Req, SP in ((_session, Request, SamplingParams),
                          (_jsession, JRequest, JSamplingParams)):
        sess = make(**kw)
        low, high = (Req(prompt=p.copy(), sampling=SP(**sp)) for p, sp in specs)
        sess.submit(low)
        for _ in range(3):
            sess.step()
        assert low.status.value == "active"
        sess.submit(high)
        while sess.step():
            pass
        assert low.status.value == high.status.value == "completed"
        out.append(([low.out_tokens, high.out_tokens], sess.stats()["paged"]))
    (got, st), (jgot, jst) = out
    assert st["preemptions"] > 0 and st == jst
    assert got == jgot == want
    _assert_leak_free(sess)


def test_equal_priority_never_preempts_self_preempt_converges():
    """Equal priorities cannot evict each other; a resident that cannot
    grow preempts itself, and everyone completes with uncontended streams."""
    rng = np.random.RandomState(7)
    specs = [_spec(rng.randint(1, 100, 8), max_new_tokens=16) for _ in range(3)]
    kw = dict(max_seq_len=32, prefill_chunk=4, paged=True, page_size=8, page_arena=6,
              prefix_sharing=False)
    got, sess = _run(_session, Request, SamplingParams, specs, 3, **kw)
    _, jsess = _run(_jsession, JRequest, JSamplingParams, specs, 3, **kw)
    assert got == _reference(specs, 32)
    assert sess.stats()["paged"] == jsess.stats()["paged"]
    _assert_leak_free(sess)


def test_preemption_keeps_seniority():
    """A preempted resident re-enters at the FRONT of its priority class."""
    sess = _session(n_slots=1, max_seq_len=32, paged=True, page_size=8)
    victim = Request(prompt=np.arange(4, dtype=np.int32),
                     sampling=SamplingParams(max_new_tokens=4))
    sess.submit(victim)
    sess.step()
    later = Request(prompt=np.arange(4, dtype=np.int32) + 1,
                    sampling=SamplingParams(max_new_tokens=4))
    sess.submit(later)
    sess._preempt_slot(0)
    assert victim.status is RequestStatus.QUEUED
    assert sess.scheduler.queue[0] is victim
    sess.run()
    assert victim.status is RequestStatus.COMPLETED
    assert sess.stats()["paged"]["preemptions"] == 1
    _assert_leak_free(sess)


def test_paged_cache_specs_match_repro():
    """The arena's leaf shapes and dtypes, and the per-leaf K/V map."""
    from repro.models.model_zoo import cache_kv_leaves as jleaves
    from repro.models.model_zoo import paged_cache_specs as jspecs
    from repro_torch.models.model_zoo import cache_kv_leaves, paged_cache_specs

    jb, tb = _models()[0][0], _models()[1][0]
    for got, want in zip(paged_cache_specs(tb.cfg, 18, 8), jspecs(jb.cfg, 18, 8)):
        assert got.shape == want.shape and str(got.dtype)[6:] == str(want.dtype)
    assert tuple(cache_kv_leaves(tb.cfg)) == tuple(jleaves(jb.cfg)) == (True, True)
