"""Port parity: exact draft–verify speculative decoding
(``ServeSession(draft=..., gamma=...)``, ``models.transformer.verify_step``,
``launch/serve.py --draft``) against ``repro`` on the same JAX-initialized
weights (``convert.params_from_jax``).

* ``verify_step`` on reduced qwen2-1.5b and llama3.2-3b: a (B, W) block at
  per-row starts against a seeded cache, ids equal, values within rtol
  1e-6, atol 2e-6 (``tests/test_kernels.py:103``), caches within fp32
  roundoff.
* Sessions on reduced llama3.2-3b in fp32 (vocab 128, 4 experts, a pruned
  mask), 5 mixed requests through 2 slots, gamma 3, as
  ``tests/test_serve_spec.py`` runs them: a self-draft and a shallow draft
  (the target's first layer under its own embedding and head), contiguous,
  chunked and paged. Greedy streams equal ``repro``'s speculative streams
  and the port's own non-speculative stream; ``stats()["speculative"]``
  equals ``repro``'s dict for dict. Sampled streams (temperature 0.8,
  top-k 4) equal ``repro``'s for the same seeds. These parity runs set
  ``_draft_backfill`` False (``repro``'s draft schedule); with the port's
  schedule greedy streams stay the same, the self-draft accepts every
  proposal, and after every step the self-draft's cache holds the target's
  rows at every accepted position, greedy and sampled. ``repro``'s sessions
  prefill in chunks of 4 (token-identical to its whole-prompt prefill,
  ``tests/test_serve_spec.py::test_speculative_chunked_prefill_identity``)
  so each compiles once.
* ``_accept_block`` equals ``repro``'s on seeded blocks, greedy and sampled;
  ``repro``'s chi-squared exactness test and greedy prefix test, ported.
* The headroom check at ``submit``, the draft's validation, and the
  launcher on the CPU.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.core import dssoftmax as jds
from repro.models import build as jbuild
from repro.models.transformer import DecodeCache as JDecodeCache
from repro.train import Request as JRequest
from repro.train import SamplingParams as JSamplingParams
from repro.train import ServeSession as JServeSession
from repro_torch import configs
from repro_torch.convert import flatten_paths, params_from_jax
from repro_torch.core import dssoftmax as ds
from repro_torch.models import build
from repro_torch.models.transformer import DecodeCache
from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession

VOCAB = 128
HEAD_TOL = dict(rtol=1e-6, atol=2e-6)
GAMMA = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and beside other
    test processes torch's default pool makes each small op wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, n_layers=None):
    jcfg = jreduce_config(jget_config(arch), vocab=VOCAB).replace(dtype="float32")
    tcfg = configs.reduce_config(configs.get_config(arch), vocab=VOCAB).replace(dtype="float32")
    if n_layers is not None:
        jcfg, tcfg = jcfg.replace(n_layers=n_layers), tcfg.replace(n_layers=n_layers)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _models(arch, shallow=False):
    """repro's and the port's reduced model on the same weights and pruned
    DS mask; ``shallow``: the target's first layer alone under the same
    embedding and head (a draft that agrees with the target only in part)."""
    jcfg, tcfg = _cfgs(arch, 1 if shallow else None)
    params, state = jbuild(_cfgs(arch)[0]).init(jax.random.PRNGKey(0))
    if shallow:
        params = dict(params, layers=jax.tree.map(lambda x: x[:1], params["layers"]))
    rng = np.random.RandomState(3)
    mask = np.asarray(state.mask) & (rng.rand(*state.mask.shape) < 0.5)
    mask[rng.randint(0, 4, mask.shape[1]), np.arange(mask.shape[1])] = True
    tree = flatten_paths(jax.tree.map(np.asarray, params))
    tree["ds_state/mask"] = mask
    tparams, tstate = params_from_jax(tree, tcfg, device="cpu")
    return ((jbuild(jcfg), params, jds.DSState(mask=jax.numpy.asarray(mask))),
            (build(tcfg, device="cpu"), tparams, tstate))


# ---------------------------------------------------------------------------
# verify_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama3.2-3b"])
@pytest.mark.parametrize("paged", [False, True])
def test_verify_step_matches_repro(arch, paged):
    """A (3, 4) block at per-row starts 0, 5 and 11 against a seeded cache
    (contiguous, or an arena of 8-position pages through a page table):
    (B, W, k) ids equal, values within the head tolerance, the written
    caches within fp32 roundoff of repro's."""
    (jb, jp, js), (tb, tp, ts) = _models(arch)
    jtable, ttable = jds.pack_experts(jp["head"], js), ds.pack_experts(tp["head"], ts)
    cfg = tb.cfg
    B, W, S = 3, 4, 24
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, VOCAB, (B, W)).astype(np.int32)
    pos0 = np.array([0, 5, 11], np.int32)
    if paged:
        n_pages, ps = 12, 8
        shape = (cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.hd)
        pages = rng.permutation(np.arange(2, n_pages))[:B * (S // ps)].reshape(B, S // ps)
        pages = pages.astype(np.int32)
    else:
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
        pages = None
    ck, cv = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    jkw = {} if pages is None else {"pages": jax.numpy.asarray(pages)}
    jv, ji, jc = jax.jit(lambda p, t, c, x, q: jb.verify_step(p, t, c, x, q, k=8, kernel="jnp",
                                                               **jkw))(
        jp, jtable, JDecodeCache(k=jax.numpy.asarray(ck), v=jax.numpy.asarray(cv)),
        jax.numpy.asarray(tokens), jax.numpy.asarray(pos0))
    cache = DecodeCache(k=torch.from_numpy(ck.copy()), v=torch.from_numpy(cv.copy()))
    tv, ti, tc = tb.verify_step(tp, ttable, cache, torch.from_numpy(tokens),
                                torch.from_numpy(pos0), k=8, kernel="jnp",
                                pages=None if pages is None else torch.from_numpy(pages))
    assert tv.shape == ti.shape == (B, W, 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **HEAD_TOL)
    assert tc.k is cache.k  # written in place
    for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------

def _mixed(n=5, seed=0, max_new=(2, 6, 3, 5, 4), **sp):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, VOCAB, rng.randint(3, 12)).astype(np.int32),
             dict(max_new_tokens=max_new[i % len(max_new)], **sp)) for i in range(n)]


MODES = {"contiguous": {}, "chunked": dict(prefill_chunk=4),
         "paged": dict(paged=True, page_size=8, prefill_chunk=4)}


@functools.lru_cache(maxsize=None)
def _repro_run(draft, mode, sampled):
    """repro's speculative streams and stats (``mode`` contiguous runs its
    chunk-4 prefill, see the module docstring)."""
    (jb, jp, js), _ = _models("llama3.2-3b")
    d = (jb, jp, js) if draft == "self" else _models("llama3.2-3b", shallow=True)[0]
    kw = dict(MODES[mode])
    kw.setdefault("prefill_chunk", 4)
    sess = JServeSession(jb, jp, js, n_slots=2, max_seq_len=32, k=8, kernel="jnp",
                         draft=d, gamma=GAMMA, **kw)
    specs = _mixed(**(dict(temperature=0.8, top_k=4, seed=9) if sampled else {}))
    reqs = [JRequest(prompt=p.copy(), sampling=JSamplingParams(**sp)) for p, sp in specs]
    sess.run(reqs)
    assert all(r.status.value == "completed" for r in reqs)
    return [list(r.out_tokens) for r in reqs], sess.stats()["speculative"]


def _port_session(draft, mode, kernel="jnp", backfill=False):
    """The port's session; ``backfill=False`` (repro's draft schedule) where
    the run is held against repro's."""
    _, (tb, tp, ts) = _models("llama3.2-3b")
    kw = dict(MODES[mode])
    if draft is not None:
        kw.update(draft=(tb, tp, ts) if draft == "self"
                  else _models("llama3.2-3b", shallow=True)[1], gamma=GAMMA)
    sess = ServeSession(tb, tp, ts, n_slots=2, max_seq_len=32, k=8, kernel=kernel,
                        device="cpu", **kw)
    sess._draft_backfill = backfill
    return sess


def _port_run(draft, mode, sampled=False, kernel="jnp", backfill=False):
    """The port's streams and session (``backfill`` as for ``_port_session``)."""
    sess = _port_session(draft, mode, kernel, backfill)
    specs = _mixed(**(dict(temperature=0.8, top_k=4, seed=9) if sampled else {}))
    reqs = [Request(prompt=p.copy(), sampling=SamplingParams(**sp)) for p, sp in specs]
    sess.run(reqs)
    assert all(r.status is RequestStatus.COMPLETED for r in reqs)
    return [list(r.out_tokens) for r in reqs], sess


@pytest.mark.parametrize("draft", ["self", "shallow"])
@pytest.mark.parametrize("mode", ["contiguous", "chunked", "paged"])
def test_greedy_speculative_stream_matches_repro_and_baseline(draft, mode):
    want, want_stats = _repro_run(draft, mode, False)
    got, sess = _port_run(draft, mode)
    base, _ = _port_run(None, mode)
    assert got == want
    assert got == base, "speculation changed the greedy stream"
    st = sess.stats()
    assert st["speculative"] == want_stats
    assert st["speculative"]["spec_emitted"] == sum(map(len, got)) - len(got)
    # the shallow draft is rejected somewhere, so corrections ran; the
    # self-draft too at times: without the backfill, after a clean sweep its
    # cache misses the last proposal's K/V, as repro's does
    assert 0.0 < st["speculative"]["accept_rate"] < 1.0
    assert st["decode_graphs"] == st["draft_graphs"] == st["verify_graphs"] == 0  # CPU: eager
    if mode == "paged":
        assert st["paged"]["pages_in_use"] == 0


@pytest.mark.parametrize("mode", ["contiguous", "paged"])
def test_draft_backfill_keeps_the_draft_cache_whole(mode):
    """With the backfill (the default), after every clean sweep the draft
    decodes its last proposal, so its cache holds every accepted token:
    the self-draft then proposes the target's own greedy chain and
    accepts every proposal (fp32 on the CPU: its decode math and the
    verify's chunk math agree on every argmax here). Greedy streams stay
    the baseline's, for the shallow draft too; a sampled stream repeats."""
    base, _ = _port_run(None, mode)
    for draft in ("self", "shallow"):
        got, sess = _port_run(draft, mode, backfill=True)
        assert got == base
        if draft == "self":
            assert sess.stats()["speculative"]["accept_rate"] == 1.0
    one, _ = _port_run("shallow", mode, sampled=True, backfill=True)
    assert one == _port_run("shallow", mode, sampled=True, backfill=True)[0]


@pytest.mark.parametrize("mode", ["contiguous", "chunked"])
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("backfill", [True, False])
def test_self_draft_cache_holds_every_accepted_token(mode, sampled, backfill):
    """A self-draft's cache against the target's, after every step: every
    position before the last accepted one holds the target's K/V (decode
    and chunk math, fp32) with the port's schedule, greedy and sampled,
    and the self-draft accepts every proposal. With repro's schedule
    (``backfill=False``) a clean sweep leaves the draft a stale row there."""
    sess = _port_session("self", mode, backfill=backfill)
    specs = _mixed(max_new=(12,), **(dict(temperature=0.8, top_k=4, seed=9) if sampled else {}))
    reqs = [Request(prompt=p.copy(), sampling=SamplingParams(**sp)) for p, sp in specs]
    for r in reqs:
        sess.submit(r)
    stale = 0
    while sess.step():
        for i, _ in sess.scheduler.active():
            n = int(sess._pos[i]) - 1
            for got, want in ((sess._draft_cache.k, sess._cache.k),
                              (sess._draft_cache.v, sess._cache.v)):
                close = torch.isclose(got[:, i, :n], want[:, i, :n], rtol=1e-4, atol=1e-5)
                stale += int((~close.flatten(2).all(-1)).any(0).sum())
    assert all(r.status is RequestStatus.COMPLETED for r in reqs)
    if backfill:
        assert stale == 0
        assert sess.stats()["speculative"]["accept_rate"] == 1.0
    else:
        assert stale > 0


def test_speculative_stream_on_the_kernel_paths():
    """Every port serve path (its wrappers' plain versions on CPU tensors)
    verifies to the same greedy stream: the verify head runs at B·W rows."""
    want, _ = _repro_run("shallow", "contiguous", False)
    for kern in ("cuda_grouped", "cuda_fused", "auto"):
        assert _port_run("shallow", "contiguous", kernel=kern)[0] == want


@pytest.mark.parametrize("draft", ["self", "shallow"])
def test_sampled_speculative_stream_matches_repro(draft):
    want, want_stats = _repro_run(draft, "contiguous", True)
    got, sess = _port_run(draft, "contiguous", sampled=True)
    assert got == want
    assert sess.stats()["speculative"] == want_stats
    again, _ = _port_run(draft, "contiguous", sampled=True)
    assert again == got


def test_speculative_preempted_request_resumes_identically():
    """A low-priority resident preempted by a high-priority arrival on a
    speculative paged session resumes (re-prefilling target and draft) and
    ends with the stream of an uncontended run."""
    _, (tb, tp, ts) = _models("llama3.2-3b")
    d = _models("llama3.2-3b", shallow=True)[1]
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, 100, 8).astype(np.int32) for _ in range(2)]

    def solo(p):
        r = Request(prompt=p, sampling=SamplingParams(max_new_tokens=12))
        ServeSession(tb, tp, ts, n_slots=1, max_seq_len=32, k=8, kernel="jnp",
                     device="cpu").run([r])
        return r.out_tokens

    sess = ServeSession(tb, tp, ts, n_slots=2, max_seq_len=32, k=8, kernel="jnp",
                        device="cpu", paged=True, page_size=4, page_arena=9,
                        prefill_chunk=4, prefix_sharing=False, draft=d, gamma=GAMMA)
    low = Request(prompt=prompts[0], sampling=SamplingParams(max_new_tokens=12, priority=0))
    sess.submit(low)
    for _ in range(2):
        sess.step()
    high = Request(prompt=prompts[1], sampling=SamplingParams(max_new_tokens=12, priority=5))
    sess.submit(high)
    sess.run()
    assert sess.stats()["paged"]["preemptions"] > 0
    assert low.out_tokens == solo(prompts[0]) and high.out_tokens == solo(prompts[1])
    assert sess.stats()["paged"]["pages_in_use"] == 0


# ---------------------------------------------------------------------------
# The acceptance rule
# ---------------------------------------------------------------------------

def _acceptor(cls):
    """``_accept_block``/``_sample`` of ``cls`` bound to a bare host object:
    the rule is host math and reads no session state."""
    h = type("Host", (), {})()
    h._sample = cls._sample.__get__(h)
    h._accept_block = cls._accept_block.__get__(h)
    return h


@pytest.mark.parametrize("temperature,top_k", [(0.0, None), (0.8, None), (1.0, 3)])
def test_accept_block_equals_repro(temperature, top_k):
    """200 seeded blocks (gamma 4, k 8; proposals drawn from the target's
    and a draft's candidates, with point masses and foreign tokens mixed
    in): the same tokens and accept counts."""
    mine, ref = _acceptor(ServeSession), _acceptor(JServeSession)
    rng = np.random.RandomState(5)
    k, gamma = 8, 4
    for t in range(200):
        vals_w = -np.sort(-rng.randn(gamma + 1, k), axis=1).astype(np.float32)
        ids_w = np.stack([rng.permutation(20)[:k] for _ in range(gamma + 1)]).astype(np.int32)
        props = np.empty(gamma, np.int64)
        pq_mine, pq_ref = [], []
        for j in range(gamma):
            kind = rng.randint(3)
            dv = -np.sort(-rng.randn(k)).astype(np.float32)
            di = rng.permutation(20)[:k].astype(np.int32)
            if kind == 0:    # the target's own argmax chain
                props[j] = ids_w[j, 0]
                pq = None
            elif kind == 1:  # a point mass on any token
                props[j] = rng.randint(20)
                pq = None
            else:            # a draw from the draft's candidates
                props[j] = di[rng.randint(k if top_k is None else top_k)]
                pq = (dv, di)
            pq_mine.append(pq)
            pq_ref.append(pq)
        sp_kw = dict(temperature=temperature, top_k=top_k, seed=t)
        got = mine._accept_block(vals_w, ids_w, props, pq_mine, SamplingParams(**sp_kw), 3 * t)
        want = ref._accept_block(vals_w, ids_w, props.astype(np.int32), pq_ref,
                                 JSamplingParams(**sp_kw), 3 * t)
        assert (list(got[0]), got[1]) == (list(want[0]), want[1])


def _softmax(v):
    e = np.exp(v - v.max())
    return e / e.sum()


@pytest.mark.parametrize("point_mass", [False, True])
def test_acceptance_distribution_exact(point_mass):
    """chi-squared (``tests/test_serve_spec.py``'s test, on the port's
    rule): over many independent blocks the first token a gamma-1 round
    emits is distributed exactly as the target's softmax, for an
    overlapping draft distribution and for the point-mass fallback."""
    h = _acceptor(ServeSession)
    k = 8
    rng = np.random.RandomState(42)
    tvals = np.sort(rng.randn(k))[::-1].copy()
    dvals = np.sort(rng.randn(k))[::-1].copy()
    ids = np.arange(k, dtype=np.int64)
    p, q = _softmax(tvals), _softmax(dvals)
    vals_w, ids_w = np.stack([tvals, tvals]), np.stack([ids, ids])
    sp = SamplingParams(temperature=1.0, seed=0)
    n_trials, counts = 4000, np.zeros(k)
    for t in range(n_trials):
        if point_mass:
            d, pq = 2, [None]
        else:
            d, pq = int(rng.choice(k, p=q)), [(dvals, ids)]
        out, _ = h._accept_block(vals_w, ids_w, np.array([d], np.int64), pq, sp, m0=10 * t)
        counts[out[0]] += 1
    expected = n_trials * p
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 24.32, f"chi2={chi2:.2f} vs crit 24.32 (df=7, a=1e-3)"


def test_acceptance_greedy_prefix_and_correction():
    h = _acceptor(ServeSession)
    vals_w = np.tile(np.array([4.0, 3.0, 2.0, 1.0]), (4, 1))
    ids_w = np.tile(np.array([7, 3, 5, 1], np.int64), (4, 1))
    sp = SamplingParams(temperature=0.0)
    assert h._accept_block(vals_w, ids_w, np.array([7, 7, 7]), [None] * 3, sp, 0) \
        == ([7, 7, 7, 7], 3)
    assert h._accept_block(vals_w, ids_w, np.array([7, 3, 7]), [None] * 3, sp, 0) == ([7, 7], 1)


# ---------------------------------------------------------------------------
# Validation and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prompt_len,max_new", [(8, 8), (4, 8), (13, 1), (12, 1)])
@pytest.mark.parametrize("paged", [False, True])
def test_headroom_check_at_submit_matches_repro(prompt_len, max_new, paged):
    """``prompt_len + max_new_tokens - 1 + gamma <= max_seq_len`` (16, gamma
    4), and on a paged arena of 3 pages of 4 the worst case's pages: each
    request is rejected by the port where repro rejects it."""
    (jb, jp, js), (tb, tp, ts) = _models("llama3.2-3b")
    kw = dict(paged=True, page_size=4, page_arena=3) if paged else {}
    prompt = np.arange(1, prompt_len + 1, dtype=np.int32)
    verdicts = []
    for Sess, Req, SP, m in ((JServeSession, JRequest, JSamplingParams, (jb, jp, js)),
                             (ServeSession, Request, SamplingParams, (tb, tp, ts))):
        extra = {} if Sess is JServeSession else dict(device="cpu")
        sess = Sess(*m, n_slots=1, max_seq_len=16, k=8, kernel="jnp", draft=m, gamma=4,
                    **kw, **extra)
        r = Req(prompt=prompt, sampling=SP(max_new_tokens=max_new))
        try:
            sess.submit(r)
            verdicts.append("accepted")
        except ValueError as e:
            assert r.status.value == "rejected"
            verdicts.append(str(e).split(" ")[0])
    assert verdicts[0] == verdicts[1]
    if not paged:
        assert verdicts[1] == ("accepted" if prompt_len + max_new - 1 + 4 <= 16 else "prompt_len")


def test_draft_validation():
    _, (tb, tp, ts) = _models("llama3.2-3b")
    mk = lambda **kw: ServeSession(tb, tp, ts, n_slots=1, max_seq_len=16, device="cpu", **kw)
    with pytest.raises(ValueError, match="gamma"):
        mk(draft=(tb, tp, ts), gamma=0)
    encdec = dataclasses.replace(tb, cfg=tb.cfg.replace(family="encdec"))
    with pytest.raises(ValueError, match="the draft model must be a token-only decoder"):
        mk(draft=(encdec, tp, ts))
    wide = dataclasses.replace(tb, cfg=tb.cfg.replace(vocab_size=2 * VOCAB))
    with pytest.raises(ValueError, match="vocab_size"):
        mk(draft=(wide, tp, ts))
    with pytest.raises(ValueError, match="verify_step"):
        ServeSession(dataclasses.replace(tb, verify_step=None), tp, ts, n_slots=1,
                     max_seq_len=16, device="cpu", draft=(tb, tp, ts))
    sess = mk(draft=(tb, tp, ts), gamma=2)
    st = sess.stats()
    assert st["speculative"]["gamma"] == 2 and st["speculative"]["spec_steps"] == 0
    assert "speculative" not in mk().stats()


def test_launch_serve_speculative_cpu(capsys):
    from repro_torch.launch import serve as launch_serve

    sess = launch_serve.main(["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
                              "--draft", "llama3.2-3b", "--gamma", "3", "--batch", "3",
                              "--slots", "2", "--new-tokens", "5"])
    st = sess.stats()
    assert st["n_completed"] == 3 and st["speculative"]["gamma"] == 3
    out = capsys.readouterr().out
    assert "speculative (gamma=3)" in out and "completed=3" in out
    sess = launch_serve.main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                              "--paged", "--prefill-chunk", "4", "--shared-prefix", "8",
                              "--batch", "3", "--slots", "2", "--new-tokens", "4"])
    assert sess.stats()["paged"]["prefix_hits"] >= 1
    # a mesh wider than this 1-process world, and fsdp without a mesh
    with pytest.raises(ValueError, match="needs 8 ranks"):
        launch_serve.main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                           "--mesh", "1x8"])
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                           "--param-mode", "fsdp"])


def test_graph_backbone_adapters_call_the_bundle():
    """The forms the step graphs call (``tokens (width, n_slots)``, as the
    graph's static input holds them) give what the bundle's backbones
    give on the (n_slots, width) blocks."""
    from repro_torch.train import serve

    _, (tb, tp, _) = _models("llama3.2-3b")
    cfg = tb.cfg
    rng = np.random.RandomState(2)
    blocks = torch.from_numpy(rng.randint(0, VOCAB, (2, 4)))
    pos = torch.tensor([3, 9])
    shape = (cfg.n_layers, 2, 16, cfg.n_kv_heads, cfg.hd)
    c0 = torch.from_numpy(rng.randn(*shape).astype(np.float32))

    def cache():
        return DecodeCache(k=c0.clone(), v=c0.clone())

    a = serve._verify_backbone(tb)(tp, cache(), blocks.T, pos, None)
    b = tb.verify_hidden(tp, cache(), blocks, pos)
    assert a.shape == (2, 4, cfg.d_model) and torch.equal(a, b)
    a = serve._decode_backbone(tb)(tp, cache(), blocks.T[:1], pos, None)
    assert torch.equal(a, tb.decode_hidden(tp, cache(), blocks[:, 0], pos))
