"""Port parity: the vlm family (the vision-prefix embedding of
``models/transformer.py``) against ``repro`` on ``reduce_config`` of
internvl2-26b (8 stub patches, d 64) with the same JAX-initialized weights
(``convert.params_from_jax``) and a pruned DS mask.

* ``embed_inputs`` with ``batch["patches"]``: the patches (cast to the
  embedding dtype) come first, positions run over patches and text,
  ``label_mask`` marks the text: equal to ``repro``'s.
* ``train_loss`` with patches: the CE covers the text positions only;
  total and CE within rtol 1e-5, atol 1e-6 (fp32 sums in other orders).
* Whole-prompt ``prefill`` with patches, then two decode steps after it:
  ids equal, head values within rtol 1e-6, atol 2e-6
  (``tests/test_kernels.py:103``), the hidden state the head sees and the
  caches within fp32 rtol 1e-5, atol 1e-5. In bf16 (the JAX side jitted
  with ``xla_allow_excess_precision=False``) the hidden state and the
  caches within one bf16 ulp (2^-7 relative) of their largest magnitude:
  at rope theta 1e6 and 13 positions a cos or sin that differs in its last
  fp32 bit rounds some bf16 elements the other way. The head is then held
  on ``repro``'s own hidden state (values within rtol 1e-6, atol 2e-6),
  and the port's whole path gives ``repro``'s ids.
* ``ServeSession`` stays token-only, as ``repro``'s: a reduced internvl2
  session's greedy streams equal ``repro``'s on the same text requests.
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
from repro.models import heads as jheads
from repro.models import transformer as jtransformer
from repro.models.transformer import DecodeCache as JDecodeCache
from repro.train import Request as JRequest
from repro.train import SamplingParams as JSamplingParams
from repro.train import ServeSession as JServeSession
from repro_torch import configs
from repro_torch.convert import flatten_paths, params_from_jax, to_tensor
from repro_torch.core import dssoftmax as ds
from repro_torch.models import build, heads, transformer
from repro_torch.models.transformer import DecodeCache
from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession
from repro_torch.train.train_step import value_and_grad

ARCH = "internvl2-26b"
VOCAB = 128
F32 = dict(rtol=1e-5, atol=1e-5)
HEAD_TOL = dict(rtol=1e-6, atol=2e-6)
STRICT = {"xla_allow_excess_precision": False}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and beside other
    test processes torch's default pool makes each small op wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(dtype="float32"):
    jcfg = jreduce_config(jget_config(ARCH), vocab=VOCAB).replace(dtype=dtype)
    tcfg = configs.reduce_config(configs.get_config(ARCH), vocab=VOCAB).replace(dtype=dtype)
    jb = jbuild(jcfg)
    params, state = jb.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    mask = np.asarray(state.mask) & (rng.rand(*state.mask.shape) < 0.5)
    mask[rng.randint(0, mask.shape[0], mask.shape[1]), np.arange(mask.shape[1])] = True
    tree = flatten_paths(jax.tree.map(np.asarray, params))
    tree["ds_state/mask"] = mask
    tparams, tstate = params_from_jax(tree, tcfg, device="cpu")
    return ((jb, params, jds.DSState(mask=jnp.asarray(mask))),
            (build(tcfg, device="cpu"), tparams, tstate))


def _batch(B=2, S=5, seed=1, extra=0):
    rng = np.random.RandomState(seed)
    P, d = 8, 64
    return (rng.randint(0, VOCAB, (B, S + extra)).astype(np.int32),
            rng.randn(B, P, d).astype(np.float32))


def test_embed_inputs_prepends_the_patches():
    (jb, jp, _), (tb, tp, _) = _models()
    assert tb.cfg.vision.num_patches == 8 and tb.cfg.family == "vlm"
    tokens, patches = _batch()
    jx, jpos, jmask = jtransformer.embed_inputs(
        jp, jb.cfg, {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)})
    tx, tpos, tmask = transformer.embed_inputs(
        tp, tb.cfg, {"tokens": torch.from_numpy(tokens), "patches": torch.from_numpy(patches)})
    assert tx.shape == (2, 13, 64)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert not tmask[:, :8].any() and tmask[:, 8:].all()
    # text only: repro's label_mask is None too
    tx2, _, tmask2 = transformer.embed_inputs(tp, tb.cfg, {"tokens": torch.from_numpy(tokens)})
    assert tmask2 is None and torch.equal(tx2, tx[:, 8:])


def test_train_loss_with_patches_matches_repro():
    (jb, jp, js), (tb, tp, ts) = _models()
    tokens, patches = _batch(extra=1)
    jl, jm = jax.jit(lambda p, b: jb.train_loss(p, js, b))(
        jp, {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)})
    (tl, tm), _ = value_and_grad(tb, tp, ts, {"tokens": torch.from_numpy(tokens),
                                              "patches": torch.from_numpy(patches)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5, atol=1e-6)
    assert float(tm["moe_aux"]) == 0.0
    # the CE is over the text only: other patches leave the labels alone
    (tl2, tm2), _ = value_and_grad(tb, tp, ts, {"tokens": torch.from_numpy(tokens),
                                                "patches": torch.from_numpy(patches * 3.0)})
    assert float(tm2["ce"]) != float(tm["ce"])


def _capture(monkeypatch, module, sink):
    orig = module.head_topk

    def wrapped(head_params, table, cfg, h, k, *a, **kw):
        sink.append(h)
        return orig(head_params, table, cfg, h, k, *a, **kw)

    monkeypatch.setattr(module, "head_topk", wrapped)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_with_patches_then_decode_match_repro(monkeypatch, dtype):
    (jb, jp, js), (tb, tp, ts) = _models(dtype)
    jt, tt = jds.pack_experts(jp["head"], js), ds.pack_experts(tp["head"], ts)
    jh, th = [], []
    _capture(monkeypatch, jheads, jh)
    _capture(monkeypatch, heads, th)
    tokens, patches = _batch()
    jpatch = jnp.asarray(patches).astype(jb.cfg.jdtype)
    tpatch = to_tensor(np.asarray(jpatch), "cpu")

    def tol(want):
        if dtype == "float32":
            return F32
        return dict(rtol=0, atol=2.0 ** -7 * float(np.abs(want).max()))

    def run(fn):
        def wrapped(*a):
            return fn(*a), jh[-1].astype(jnp.float32)
        return jax.jit(wrapped, compiler_options=STRICT)

    def head_on(jhid, tv):
        """fp32: the port's values ``tv``; bf16: the port's head on repro's
        hidden state."""
        if dtype == "float32":
            return tv
        h = torch.from_numpy(np.array(jhid)).to(tb.cfg.jdtype)
        return heads.head_topk(tp["head"], tt, tb.cfg, h, 8, embed_table=tp["embed"]["table"],
                               kernel="jnp")[0]

    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    (jv, ji, jc), jhid = run(lambda p, t, b: jb.prefill(p, t, b, kernel="jnp"))(
        jp, jt, {"tokens": jnp.asarray(tokens), "patches": jpatch})
    tv, ti, tc = tb.prefill(tp, tt, {"tokens": torch.from_numpy(tokens).long(),
                                     "patches": tpatch}, kernel="jnp")
    assert tc.k.shape[2] == 13  # the cache holds the patches' positions too
    np.testing.assert_allclose(th[-1].float().numpy(), np.asarray(jhid), **tol(jhid))
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(a.float().numpy(), f32(b), **tol(f32(b)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(head_on(jhid, tv).numpy(), np.asarray(jv), **HEAD_TOL)

    grow = lambda c: jnp.concatenate([c, jnp.zeros(c.shape[:2] + (4,) + c.shape[3:], c.dtype)],
                                     axis=2)
    jcache = JDecodeCache(k=grow(jc.k), v=grow(jc.v))
    tcache = DecodeCache(k=to_tensor(np.asarray(jcache.k), "cpu"),
                         v=to_tensor(np.asarray(jcache.v), "cpu"))
    dec = run(lambda p, t, c, tok, pos: jb.decode_step(p, t, c, tok, pos, kernel="jnp"))
    tok, pos = np.array(ji[:, 0]), np.array([13, 13], np.int32)
    for step in range(2):
        (jv, ji, jcache), jhid = dec(jp, jt, jcache, jnp.asarray(tok), jnp.asarray(pos + step))
        tv, ti, tcache = tb.decode_step(tp, tt, tcache, torch.from_numpy(tok).long(),
                                        torch.from_numpy(pos + step).long(), kernel="jnp")
        np.testing.assert_allclose(th[-1].float().numpy(), np.asarray(jhid), **tol(jhid))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(head_on(jhid, tv).numpy(), np.asarray(jv), **HEAD_TOL)
        tok = np.array(ji[:, 0])


def test_text_only_session_matches_repro():
    (jb, jp, js), (tb, tp, ts) = _models()
    rng = np.random.RandomState(9)
    specs = [(rng.randint(1, VOCAB, n).astype(np.int32), m)
             for n, m in ((5, 4), (11, 6), (7, 3))]
    jsess = JServeSession(jb, jp, js, n_slots=2, max_seq_len=24, k=8, kernel="jnp",
                          prefill_chunk=4)
    jreqs = [JRequest(prompt=p.copy(), sampling=JSamplingParams(max_new_tokens=m))
             for p, m in specs]
    jsess.run(jreqs)
    tsess = ServeSession(tb, tp, ts, n_slots=2, max_seq_len=24, k=8, kernel="jnp",
                         device="cpu")
    treqs = [Request(prompt=p.copy(), sampling=SamplingParams(max_new_tokens=m))
             for p, m in specs]
    tsess.run(treqs)
    assert all(r.status is RequestStatus.COMPLETED for r in treqs)
    assert [list(r.out_tokens) for r in treqs] == [list(r.out_tokens) for r in jreqs]
