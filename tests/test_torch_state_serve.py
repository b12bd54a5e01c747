"""Port parity: ``ServeSession`` over the ssm and hybrid families (state
caches, state pages, the commit pass) against ``repro``'s session, on the
same JAX-initialized weights (reduced mamba2-130m and zamba2-7b, vocab 96,
4 experts, fp32, a pruned DS mask), greedy, ``kernel="jnp"`` unless named.

Each port stream must equal ``repro``'s token for token:

* whole-prompt, chunked (chunk 4) and paged chunked prefill;
* paged with prefix sharing: 4 requests behind a 16-token system prompt,
  ``stats()["paged"]`` dict for dict (3 prefix hits, 12 chunks saved);
* paged with preemption: a state arena of one page for two slots, so the
  high-priority arrival preempts the resident, which resumes with its
  uncontended stream; ``stats()["paged"]`` dict for dict;
* speculative, a self-draft at gamma 2 (contiguous and paged), and an ssm
  draft for a dense target (reduced llama3.2-3b): ``stats()["speculative"]``
  equal ``repro``'s with ``_draft_backfill`` False;
* an int8 table (flip threshold 1.0: every expert on int8 rows) through
  the grouped kernel's plain version;
* a table swap mid-flight (``repro``'s repack, handed to both sessions);
* quarantine: a poisoned embedding row fails exactly the request that
  holds it, the others complete with ``repro``'s clean streams.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.core import dssoftmax as jds
from repro.models import build as jbuild
from repro.serve.table_manager import TrafficProfile as JTrafficProfile
from repro.serve.table_manager import repack_for_traffic as jrepack
from repro.train import Request as JRequest
from repro.train import SamplingParams as JSamplingParams
from repro.train import ServeSession as JServeSession
from repro_torch import configs
from repro_torch.convert import MASK_KEY, flatten_paths, params_from_jax, table_from_jax, \
    to_tensor
from repro_torch.models import build
from repro_torch.testing import poison_token_embedding
from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession

VOCAB = 96
ARCHS = ("mamba2-130m", "zamba2-7b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and beside other
    test processes torch's default pool makes each small op wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jreduce_config(jget_config(arch), vocab=VOCAB).replace(dtype="float32")
    tcfg = configs.reduce_config(configs.get_config(arch), vocab=VOCAB).replace(dtype="float32")
    jb = jbuild(jcfg)
    params, state = jb.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    mask = np.asarray(state.mask) & (rng.rand(*state.mask.shape) < 0.5)
    mask[rng.randint(0, mask.shape[0], mask.shape[1]), np.arange(mask.shape[1])] = True
    tree = flatten_paths(jax.tree.map(np.asarray, params))
    tree[MASK_KEY] = mask
    tparams, tstate = params_from_jax(tree, tcfg, device="cpu")
    return ((jb, params, jds.DSState(mask=jnp.asarray(mask))),
            (build(tcfg, device="cpu"), tparams, tstate))


def _spec(prompt, **sp):
    return (np.asarray(prompt, np.int32), sp)


def _mixed(n=5, seed=0, max_new=(2, 6, 3, 5, 4)):
    rng = np.random.RandomState(seed)
    return [_spec(rng.randint(1, VOCAB, rng.randint(3, 12)), max_new_tokens=max_new[i % 5])
            for i in range(n)]


def _pair(arch, specs, n_slots=2, max_seq_len=32, jdraft=None, tdraft=None, **kw):
    """Serve ``specs`` in repro's session and the port's with the same
    arguments; returns ((streams, session), (streams, session))."""
    (jb, jp, js), (tb, tp, ts) = _models(arch)
    kernel = kw.pop("kernel", "jnp")  # the port's; repro serves through "jnp"
    out = []
    for cls, Req, SP, model, draft, extra in (
            (JServeSession, JRequest, JSamplingParams, (jb, jp, js), jdraft,
             dict(kernel="jnp")),
            (ServeSession, Request, SamplingParams, (tb, tp, ts), tdraft,
             dict(kernel=kernel, device="cpu"))):
        dkw = {} if draft is None else dict(draft=draft)
        sess = cls(*model, n_slots=n_slots, max_seq_len=max_seq_len, k=8, **dkw, **kw, **extra)
        if cls is ServeSession:
            sess._draft_backfill = False  # repro's draft schedule
        reqs = [Req(prompt=p.copy(), sampling=SP(**sp)) for p, sp in specs]
        sess.run(reqs)
        assert all(r.status.value == "completed" for r in reqs), [r.error for r in reqs]
        out.append(([list(r.out_tokens) for r in reqs], sess))
    return out


MODES = {"whole": {}, "chunked": dict(prefill_chunk=4),
         "paged_chunked": dict(prefill_chunk=4, paged=True, page_size=8)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_streams_match_repro(arch, mode):
    """More requests than slots (mid-flight admits into used rows and
    pages): token for token, every page free after."""
    (want, _), (got, sess) = _pair(arch, _mixed(), **MODES[mode])
    assert got == want
    if "paged" in MODES[mode]:
        st = sess.stats()["paged"]
        assert st["pages_in_use"] == 0 and st["state_pages_in_use"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_sharing_matches_repro(arch):
    rng = np.random.RandomState(3)
    sysp = rng.randint(1, VOCAB, 16)
    specs = [_spec(np.concatenate([sysp, rng.randint(1, VOCAB, 4)]), max_new_tokens=6)
             for _ in range(4)]
    (want, jsess), (got, sess) = _pair(arch, specs, n_slots=4, max_seq_len=64,
                                       prefill_chunk=4, paged=True, page_size=8)
    assert got == want
    st = sess.stats()["paged"]
    assert st == jsess.stats()["paged"]
    assert st["prefix_hits"] == 3 and st["prefill_chunks_saved"] == 12
    assert st["pages_in_use"] == 0 and st["state_pages_in_use"] == 0
    # the same session without sharing gives the same streams
    _, (alone, _) = _pair(arch, specs, n_slots=4, max_seq_len=64, prefill_chunk=4, paged=True,
                          page_size=8, prefix_sharing=False)
    assert alone == got


@pytest.mark.parametrize("arch", ARCHS)
def test_preemption_resumes_like_repro(arch):
    """One state page for two slots: admitting the priority-5 request
    preempts the resident (priority 0), which later re-prefills prompt ++
    its tokens and completes with its uncontended stream."""
    rng = np.random.RandomState(6)
    specs = (_spec(rng.randint(1, VOCAB, 10), max_new_tokens=12, priority=0),
             _spec(rng.randint(1, VOCAB, 10), max_new_tokens=12, priority=5))
    (jb, jp, js), (tb, tp, ts) = _models(arch)
    kw = dict(n_slots=2, max_seq_len=32, k=8, prefill_chunk=4, paged=True, page_size=8,
              state_arena=1, prefix_sharing=False)
    out = []
    for make, Req, SP in ((lambda: ServeSession(tb, tp, ts, kernel="jnp", device="cpu", **kw),
                           Request, SamplingParams),
                          (lambda: JServeSession(jb, jp, js, kernel="jnp", **kw),
                           JRequest, JSamplingParams)):
        sess = make()
        low, high = (Req(prompt=p.copy(), sampling=SP(**sp)) for p, sp in specs)
        sess.submit(low)
        for _ in range(3):
            sess.step()
        sess.submit(high)
        while sess.step():
            pass
        assert low.status.value == high.status.value == "completed"
        out.append(([low.out_tokens, high.out_tokens], sess.stats()["paged"]))
    (got, st), (want, jst) = out
    assert st["preemptions"] > 0 and st == jst and got == want
    alone = [_pair(arch, [s], n_slots=1)[1][0][0] for s in specs]
    assert got == alone


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_self_draft_speculation_matches_repro(arch, paged):
    """A self-draft at gamma 2: the target's verify leaves conv/ssm alone
    and its commit pass advances them; the draft commits from the copy it
    took before proposing."""
    (jb, jp, js), (tb, tp, ts) = _models(arch)
    kw = dict(prefill_chunk=4, gamma=2)
    if paged:
        kw.update(paged=True, page_size=8)
    (want, jsess), (got, sess) = _pair(arch, _mixed(), max_seq_len=40, jdraft=(jb, jp, js),
                                       tdraft=(tb, tp, ts), **kw)
    assert got == want
    assert sess.stats()["speculative"] == jsess.stats()["speculative"]
    plain = _pair(arch, _mixed(), max_seq_len=40, prefill_chunk=4)[1][0]
    assert got == plain


def test_ssm_draft_for_a_dense_target_matches_repro():
    """reduced llama3.2-3b served with a mamba2-130m draft (same vocab)."""
    def dense():
        jcfg = jreduce_config(jget_config("llama3.2-3b"), vocab=VOCAB).replace(dtype="float32")
        tcfg = configs.reduce_config(configs.get_config("llama3.2-3b"), vocab=VOCAB).replace(
            dtype="float32")
        jb = jbuild(jcfg)
        params, state = jb.init(jax.random.PRNGKey(1))
        tree = flatten_paths(jax.tree.map(np.asarray, params))
        tree[MASK_KEY] = np.asarray(state.mask)
        tparams, tstate = params_from_jax(tree, tcfg, device="cpu")
        return (jb, params, state), (build(tcfg, device="cpu"), tparams, tstate)

    (jb, jp, js), (tb, tp, ts) = dense()
    jdraft, tdraft = _models("mamba2-130m")
    out = []
    for cls, Req, SP, model, draft, extra in (
            (JServeSession, JRequest, JSamplingParams, (jb, jp, js), jdraft, {}),
            (ServeSession, Request, SamplingParams, (tb, tp, ts), tdraft, dict(device="cpu"))):
        sess = cls(*model, n_slots=2, max_seq_len=40, k=8, kernel="jnp", draft=draft,
                   gamma=3, **extra)
        if cls is ServeSession:
            sess._draft_backfill = False
            assert sess._draft_commits
        reqs = [Req(prompt=p.copy(), sampling=SP(**sp)) for p, sp in _mixed(seed=2)]
        sess.run(reqs)
        out.append(([list(r.out_tokens) for r in reqs], sess.stats()["speculative"]))
    (want, jst), (got, st) = out
    assert got == want and st == jst


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_table_matches_repro(arch):
    kw = dict(prefill_chunk=4, quantize="int8", quantize_flip_threshold=1.0, quantize_calib=16,
              kernel="cuda_grouped")
    (want, _), (got, sess) = _pair(arch, _mixed(seed=4), **kw)
    assert got == want
    assert sess.stats()["quantize_report"]["n_fallback"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_table_swap_mid_flight_matches_repro(arch):
    """repro's repack of the hot-expert profile, swapped into both sessions
    after 3 steps: the streams stay equal (the recurrent state never reads
    the table, so it survives the swap)."""
    (jb, jp, js), (tb, tp, ts) = _models(arch)
    prof = JTrafficProfile(dispatched=np.array([100, 10, 5, 5]),
                           overflow=np.array([40, 0, 0, 0]), steps=10, start_step=0,
                           end_step=10)
    res = jrepack(jp["head"], js, prof, key=jax.random.PRNGKey(3))
    ttable = table_from_jax({f: np.asarray(v) for f, v in res.table._asdict().items()}, "cpu")
    tgate = to_tensor(np.asarray(res.head_params["gate"]), "cpu")
    out = []
    for sess, Req, SP, table, gate in (
            (JServeSession(jb, jp, js, n_slots=2, max_seq_len=32, k=8, kernel="jnp"),
             JRequest, JSamplingParams, res.table, res.head_params["gate"]),
            (ServeSession(tb, tp, ts, n_slots=2, max_seq_len=32, k=8, kernel="jnp",
                          device="cpu"), Request, SamplingParams, ttable, tgate)):
        reqs = [Req(prompt=p.copy(), sampling=SP(**sp)) for p, sp in _mixed(n=3, seed=5)]
        for r in reqs:
            sess.submit(r)
        for _ in range(3):
            sess.step()
        sess.swap_table(table, new_gate=gate, capacity_factor=res.capacity_factor)
        while sess.step():
            pass
        assert all(r.status.value == "completed" for r in reqs)
        out.append([list(r.out_tokens) for r in reqs])
    assert out[0] == out[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_quarantine_of_a_poisoned_request(arch):
    """A NaN embedding row held by one prompt (a token the clean requests
    never use): that request FAILS, the others complete with repro's clean
    streams, and the slot's state rows are zeroed for the next tenant."""
    specs = _mixed(n=3, seed=5, max_new=(4, 4, 4, 4, 4))
    (clean, _), _ = _pair(arch, specs[1:])
    used = {int(t) for p, _ in specs[1:] for t in p} | {t for s in clean for t in s}
    bad = next(t for t in range(1, VOCAB) if t not in used)
    specs[0][0][0] = bad
    _, (tb, tp, ts) = _models(arch)
    sess = ServeSession(tb, poison_token_embedding(tp, bad), ts, n_slots=2, max_seq_len=16,
                        k=8, kernel="jnp", device="cpu")
    reqs = [Request(prompt=p.copy(), sampling=SamplingParams(**sp)) for p, sp in specs]
    sess.run(reqs)
    assert reqs[0].status is RequestStatus.FAILED and "quarantined" in reqs[0].error
    assert [r.status for r in reqs[1:]] == [RequestStatus.COMPLETED] * 2
    assert [list(r.out_tokens) for r in reqs[1:]] == clean
    assert all(bool(torch.isfinite(leaf).all()) for leaf in sess._cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_takes_the_state_archs(arch, capsys):
    """The serve launcher on the CPU: reduced configs, paged chunked with a
    shared prefix, and a self-draft."""
    from repro_torch.launch import serve as launch_serve

    sess = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "3",
                              "--slots", "2", "--new-tokens", "4", "--paged",
                              "--prefill-chunk", "4", "--shared-prefix", "8",
                              "--draft", arch, "--gamma", "2"])
    assert sess.cfg.family in ("ssm", "hybrid") and sess.stats()["n_completed"] == 3
    out = capsys.readouterr().out
    assert "completed=3" in out and "speculative" in out
