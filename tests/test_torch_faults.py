"""Port parity: the fault injectors (``repro_torch.testing.faults``) and the
request lifecycle under them, against ``repro``.

The non-mesh scenarios of ``tests/test_serve_faults.py`` run on both
packages, on reduced qwen2-1.5b in fp32 (vocab 128, 4 experts) with the
same JAX-initialized weights (``convert.params_from_jax``), ``kernel="jnp"``,
every session prefilling in chunks of 4 (one compiled shape in ``repro``):
a poisoned embedding row, a poisoned layer, a poisoned cache slot
mid-decode, a poisoned shared page, a raising ``stream_cb``, a cancel from
inside the callback, a swap storm, exhausted pages then recovery, and the
paged chaos scenarios. Each scenario returns every request's status and
tokens, the session's outcome counters and, when paged, its page counters;
the port's must equal ``repro``'s, and the scenario's own expectations
(``tests/test_serve_faults.py``'s asserts) must hold on the port.
"""
import functools
import types

import jax
import numpy as np
import pytest
import torch

import repro.testing as jfaults
from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.core import dssoftmax as jds
from repro.models import build as jbuild
from repro.train import Request as JRequest
from repro.train import SamplingParams as JSamplingParams
from repro.train import ServeSession as JServeSession
from repro_torch import configs
from repro_torch import testing as tfaults
from repro_torch.convert import flatten_paths, params_from_jax
from repro_torch.core import dssoftmax as ds
from repro_torch.models import build
from repro_torch.train import Request, SamplingParams, ServeSession

VOCAB = 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and beside other
    test processes torch's default pool makes each small op wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _packages():
    """The two packages' session API, fault injectors and tiny model (the
    same weights and DS mask), keyed 'repro' and 'port'."""
    jcfg = jreduce_config(jget_config("qwen2-1.5b"), vocab=VOCAB).replace(
        ds=jget_config("qwen2-1.5b").ds.replace(num_experts=4), dtype="float32")
    tcfg = configs.reduce_config(configs.get_config("qwen2-1.5b"), vocab=VOCAB).replace(
        ds=configs.get_config("qwen2-1.5b").ds.replace(num_experts=4), dtype="float32")
    jb = jbuild(jcfg)
    params, state = jb.init(jax.random.PRNGKey(0))
    tree = flatten_paths(jax.tree.map(np.asarray, params))
    tree["ds_state/mask"] = np.asarray(state.mask)
    tparams, tstate = params_from_jax(tree, tcfg, device="cpu")
    return {
        "repro": types.SimpleNamespace(
            Session=JServeSession, Request=JRequest, SP=JSamplingParams, faults=jfaults,
            bundle=jb, params=params, state=state, table=jds.pack_experts(params["head"], state),
            kw={}),
        "port": types.SimpleNamespace(
            Session=ServeSession, Request=Request, SP=SamplingParams, faults=tfaults,
            bundle=build(tcfg, device="cpu"), params=tparams, state=tstate,
            table=ds.pack_experts(tparams["head"], tstate), kw=dict(device="cpu")),
    }


def _session(pk, params=None, table=None, **kw):
    # chunked prefill: one compiled prefill shape on repro's side
    kw.setdefault("prefill_chunk", 4)
    return pk.Session(pk.bundle, pk.params if params is None else params,
                      pk.table if table is None else table, kernel="jnp", **pk.kw, **kw)


def _requests(pk, n=4, seed=0, max_new=5, **sp):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, VOCAB, rng.randint(3, 8)).astype(np.int32) for _ in range(n)]
    return [pk.Request(prompt=p, sampling=pk.SP(max_new_tokens=max_new, **sp))
            for p in prompts]


def _clean(pk, reqs, **kw):
    """The fault-free run of the same prompts and sampling."""
    ref = [pk.Request(prompt=r.prompt.copy(), sampling=r.sampling_params) for r in reqs]
    _session(pk, **kw).run(ref)
    return [list(r.out_tokens) for r in ref]


def _absent_token(reqs, ref):
    """A token the clean requests never touch (prompt or emission)."""
    used = {int(t) for r in reqs for t in r.prompt} | {t for toks in ref for t in toks}
    return max(set(range(VOCAB)) - used)


def _outcome(sess, reqs):
    st = sess.stats()
    out = {"requests": [(r.status.value, list(r.out_tokens)) for r in reqs],
           "counts": {k: st[k] for k in ("n_admitted", "n_released", "n_completed",
                                         "n_rejected", "n_cancelled", "n_timed_out",
                                         "n_failed", "n_shed")}}
    if "paged" in st:
        out["paged"] = st["paged"]
    return out


def _no_page_leak(sess):
    st = sess.stats()["paged"]
    assert st["pages_in_use"] == 0 and st["state_pages_in_use"] == 0, st
    assert not sess.scheduler.has_work()


# -- the scenarios: each runs on one package and returns its outcome --------

def poisoned_embedding(pk):
    reqs = _requests(pk, n=4, max_new=5)
    clean = [r for i, r in enumerate(reqs) if i != 1]
    ref = _clean(pk, clean, n_slots=2, max_seq_len=32)
    tok = _absent_token(clean, ref)
    reqs[1].prompt[2] = tok
    sess = _session(pk, params=pk.faults.poison_token_embedding(pk.params, tok), n_slots=2,
                    max_seq_len=32)
    sess.run(reqs)
    assert reqs[1].status.value == "failed" and "prefill" in reqs[1].error
    assert [r.out_tokens for r in clean] == ref
    return _outcome(sess, reqs)


def poisoned_layer(pk):
    sess = _session(pk, params=pk.faults.poison_layer(pk.params, 0), n_slots=2, max_seq_len=32)
    reqs = _requests(pk, n=3, max_new=4)
    sess.run(reqs)
    assert all(r.status.value == "failed" and r.out_tokens == [] for r in reqs)
    return _outcome(sess, reqs)


def poisoned_cache_slot(pk):
    reqs = _requests(pk, n=2, seed=3, max_new=8)
    ref = _clean(pk, reqs, n_slots=2, max_seq_len=32)
    sess = _session(pk, n_slots=2, max_seq_len=32)
    for r in reqs:
        sess.submit(r)
    sess.step()
    sess.step()
    victim = next(i for i, s in sess.scheduler.active() if s.req is reqs[0])
    pk.faults.poison_cache_slot(sess, victim)
    while sess.step():
        pass
    assert reqs[0].status.value == "failed" and "quarantined" in reqs[0].error
    assert reqs[0].out_tokens == ref[0][:len(reqs[0].out_tokens)]
    assert reqs[1].out_tokens == ref[1]
    return _outcome(sess, reqs)


def raising_stream_cb(pk):
    reqs = _requests(pk, n=3, seed=2, max_new=6)
    ref = _clean(pk, reqs, n_slots=3, max_seq_len=32)
    sess = _session(pk, n_slots=3, max_seq_len=32)
    cb = pk.faults.RaisingStreamCB(target=reqs[2], after=2)
    sess.stream_cb = cb
    sess.run(reqs)
    assert reqs[2].status.value == "failed" and "stream_cb" in reqs[2].error
    assert reqs[2].out_tokens == ref[2][:2]
    assert [reqs[0].out_tokens, reqs[1].out_tokens] == ref[:2]
    assert cb.n_calls > cb.n_target_calls
    return _outcome(sess, reqs)


def cancel_inside_stream_cb(pk):
    reqs = _requests(pk, n=3, max_new=8)
    ref = _clean(pk, reqs, n_slots=3, max_seq_len=32)
    sess = _session(pk, n_slots=3, max_seq_len=32)
    cb = pk.faults.CancelAfter(sess, reqs[0], after=3)
    sess.stream_cb = cb
    sess.run(reqs)
    assert cb.cancelled and reqs[0].status.value == "cancelled"
    assert reqs[0].out_tokens == ref[0][:3]
    assert [reqs[1].out_tokens, reqs[2].out_tokens] == ref[1:]
    return _outcome(sess, reqs)


def swap_storm(pk):
    reqs = _requests(pk, n=6, max_new=8)
    ref = _clean(pk, reqs, n_slots=2, max_seq_len=32)
    sess = _session(pk, table=pk.state, n_slots=2, max_seq_len=32)
    for r in reqs:
        sess.submit(r)
    assert pk.faults.swap_storm(sess, pk.params["head"], pk.state, count=3, every=2) == 3
    assert [r.out_tokens for r in reqs] == ref
    st = sess.stats()
    assert st["n_swaps"] == 3 and st["table_version"] == 3 and st["decode_builds"] == 4
    return {**_outcome(sess, reqs), "swaps": (st["n_swaps"], st["table_version"],
                                              st["decode_builds"])}


def exhausted_pages_then_recovery(pk):
    rng = np.random.RandomState(11)
    low = pk.Request(prompt=rng.randint(1, 100, 8).astype(np.int32),
                     sampling=pk.SP(max_new_tokens=16, priority=0))
    high = pk.Request(prompt=rng.randint(1, 100, 8).astype(np.int32),
                      sampling=pk.SP(max_new_tokens=16, priority=5))
    ref = _clean(pk, [low, high], n_slots=1, max_seq_len=32, prefill_chunk=4)
    sess = _session(pk, n_slots=2, max_seq_len=32, prefill_chunk=4, paged=True, page_size=4,
                    prefix_sharing=False)
    sess.submit(low)
    sess.submit(high)
    for _ in range(2):
        sess.step()
    hoard = pk.faults.exhaust_pages(sess)
    steps = 0
    while sess.step() and sess.stats()["paged"]["preemptions"] == 0:
        steps += 1
        assert steps < 64, "pressure never triggered a preemption"
    assert low.status.value == "queued"
    pressured = sess.stats()["paged"]
    pk.faults.release_hoarded_pages(sess, hoard)
    sess.run()
    assert [low.out_tokens, high.out_tokens] == ref
    _no_page_leak(sess)
    return {**_outcome(sess, [low, high]), "under_pressure": pressured, "hoarded": len(hoard)}


def poisoned_shared_page(pk):
    rng = np.random.RandomState(12)
    sysp = rng.randint(1, 100, 16).astype(np.int32)
    reqs = [pk.Request(prompt=np.concatenate([sysp, rng.randint(1, 100, 4).astype(np.int32)]),
                       sampling=pk.SP(max_new_tokens=10)) for _ in range(3)]
    sess = _session(pk, n_slots=3, max_seq_len=64, prefill_chunk=4, paged=True, page_size=8)
    for r in reqs:
        sess.submit(r)
    sess.step()
    assert sess.stats()["paged"]["prefix_hits"] == 2
    shared = sess._mgr.shared_pages()
    assert shared
    pk.faults.poison_page(sess, shared[0])
    sess.run()
    assert all(r.status.value == "failed" and "quarantined" in r.error for r in reqs)
    _no_page_leak(sess)
    fresh = pk.Request(prompt=rng.randint(1, 100, 6).astype(np.int32),
                       sampling=pk.SP(max_new_tokens=5))
    ref = _clean(pk, [fresh], n_slots=1, max_seq_len=32, prefill_chunk=4)
    sess.run([fresh])
    assert fresh.out_tokens == ref[0]
    _no_page_leak(sess)
    return {**_outcome(sess, reqs + [fresh]), "shared": shared}


def paged_chaos(pk):
    mk = lambda **kw: _session(pk, n_slots=2, max_seq_len=32, prefill_chunk=4, paged=True,
                               page_size=8, **kw)
    out = {}
    # 1) a poisoned embedding fails only its request at prefill
    reqs = _requests(pk, n=3, seed=13, max_new=4)
    clean = reqs[1:]
    ref = _clean(pk, clean, n_slots=2, max_seq_len=32, prefill_chunk=4)
    tok = _absent_token(clean, ref)
    reqs[0].prompt[0] = tok
    sess = mk()
    sess.params = pk.faults.poison_token_embedding(pk.params, tok)
    sess.run(reqs)
    assert reqs[0].status.value == "failed" and [r.out_tokens for r in clean] == ref
    _no_page_leak(sess)
    out["poisoned"] = _outcome(sess, reqs)
    # 2) a raising stream_cb
    reqs = _requests(pk, n=3, seed=14, max_new=5)
    sess = mk()
    sess.stream_cb = pk.faults.RaisingStreamCB(target=reqs[1], after=2)
    sess.run(reqs)
    assert reqs[1].status.value == "failed"
    _no_page_leak(sess)
    out["raising_cb"] = _outcome(sess, reqs)
    # 3) a mid-flight cancel and a queued deadline
    sess = mk()
    reqs = _requests(pk, n=2, seed=15, max_new=8)
    waiter = pk.Request(prompt=np.arange(4, dtype=np.int32),
                        sampling=pk.SP(max_new_tokens=4, deadline_steps=2))
    for r in reqs:
        sess.submit(r)
    sess.step()
    sess.submit(waiter)
    sess.cancel(reqs[0])
    sess.run()
    assert reqs[0].status.value == "cancelled" and reqs[1].status.value == "completed"
    assert waiter.status.value in ("timed_out", "completed")
    _no_page_leak(sess)
    out["cancel_deadline"] = _outcome(sess, reqs + [waiter])
    return out


SCENARIOS = [poisoned_embedding, poisoned_layer, poisoned_cache_slot, raising_stream_cb,
             cancel_inside_stream_cb, swap_storm, exhausted_pages_then_recovery,
             poisoned_shared_page, paged_chaos]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_fault_scenario_matches_repro(scenario):
    pks = _packages()
    assert scenario(pks["port"]) == scenario(pks["repro"])


def test_param_injectors_leave_their_input_alone():
    pk = _packages()["port"]
    before = {k: v.clone() for k, v in pk.params["layers"]["attn"].items()}
    bad = tfaults.poison_layer(pk.params, 1)
    assert torch.isnan(bad["layers"]["attn"]["wq"][1]).all()
    assert torch.isfinite(bad["layers"]["attn"]["wq"][0]).all()
    for k, v in before.items():
        assert torch.equal(pk.params["layers"]["attn"][k], v)
    emb = tfaults.poison_token_embedding(pk.params, 5)["embed"]["table"]
    assert torch.isnan(emb[5]).all() and torch.isfinite(pk.params["embed"]["table"]).all()
    assert tfaults.oversized_prompt(VOCAB, 16).shape == (17,)
    np.testing.assert_array_equal(tfaults.oversized_prompt(VOCAB, 16),
                                  jfaults.oversized_prompt(VOCAB, 16))


def test_cache_injectors_write_in_place():
    """The cache and page injectors poison the session's own tensors (the
    decode graph on the card keeps reading them without capturing again)."""
    pk = _packages()["port"]
    sess = _session(pk, n_slots=2, max_seq_len=16)
    k = sess._cache.k
    tfaults.poison_cache_slot(sess, 1)
    assert sess._cache.k is k and torch.isnan(k[:, 1]).all() and not torch.isnan(k[:, 0]).any()
    sess = _session(pk, n_slots=2, max_seq_len=16, paged=True, page_size=8)
    k = sess._cache.k
    tfaults.poison_page(sess, 3)
    assert sess._cache.k is k and torch.isnan(k[:, 3]).all() and not torch.isnan(k[:, 2]).any()
