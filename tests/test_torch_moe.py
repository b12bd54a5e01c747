"""Port parity: the moe family (``repro_torch.models.moe``, the moe branches
of ``models/transformer.py``, ``ServeSession`` on a moe model) against
``repro`` on the same JAX-initialized weights (``convert.params_from_jax``).

* ``moe_block`` on ``reduce_config`` of olmoe-1b-7b and qwen3-moe-235b-a22b
  (4 experts, top-2, d 64, f 64) in fp32: the router's top-k ids and the
  per-row slots equal ``repro``'s, the renormalized top-k probabilities,
  the output and the aux losses within rtol 1e-5, atol 1e-5 (fp32 sums in
  other orders), at the default capacity factor 1.25 and at 0.5, where
  assignments are dropped (``drop_frac > 0``). In bf16 (the JAX side
  jitted with ``xla_allow_excess_precision=False``, as the dense bf16
  tests do) the output within one bf16 ulp (2^-7 relative) of its largest
  magnitude, the ids and slots equal.
* A row's output does not depend on the other rows (dispatch is per row),
  and right-padding a row (a chunk's tail) never displaces its real tokens:
  bit for bit.
* ``train_loss`` with the aux: the total (CE + head aux + router_aux_weight
  × the layers' load losses), CE and ``moe_aux`` within rtol 1e-5, and the
  gradients of every leaf (the router's through the aux and the top-k
  weights, the experts' through the dispatch) within 1e-5 of the leaf's
  largest element.
* ``prefill_chunk`` and ``verify_step`` of the reduced moe archs and of
  reduced internvl2-26b (text only, as ``ServeSession`` serves it): ids
  equal, head values within rtol 1e-6, atol 2e-6
  (``tests/test_kernels.py:103``), caches within fp32 roundoff.
* ``ServeSession`` on reduced olmoe-1b-7b (fp32, vocab 128, a pruned mask):
  greedy streams equal ``repro``'s session on the same requests, whole
  prompt, chunked and paged, and speculative (self-draft, gamma 2, with
  ``_draft_backfill`` False, ``repro``'s draft schedule).
* ``launch/serve.py`` serves the three new archs' reduced configs.
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
from repro.core.dispatch import dispatch_indices as jdispatch_indices
from repro.models import build as jbuild
from repro.models import moe as jmoe
from repro.models.transformer import DecodeCache as JDecodeCache
from repro.train import Request as JRequest
from repro.train import SamplingParams as JSamplingParams
from repro.train import ServeSession as JServeSession
from repro_torch import configs
from repro_torch.convert import flatten_paths, params_from_jax, to_tensor
from repro_torch.core import dssoftmax as ds
from repro_torch.models import build, moe
from repro_torch.models.transformer import DecodeCache
from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession
from repro_torch.train.train_step import value_and_grad

VOCAB = 128
MOE_ARCHS = ("olmoe-1b-7b", "qwen3-moe-235b-a22b")
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


def _cfgs(arch, dtype="float32", cf=None):
    jcfg = jreduce_config(jget_config(arch), vocab=VOCAB).replace(dtype=dtype)
    tcfg = configs.reduce_config(configs.get_config(arch), vocab=VOCAB).replace(dtype=dtype)
    if cf is not None:
        jcfg = jcfg.replace(moe=jcfg.moe.__class__(**{**vars(jcfg.moe), "capacity_factor": cf}))
        tcfg = tcfg.replace(moe=tcfg.moe.__class__(**{**vars(tcfg.moe), "capacity_factor": cf}))
    return jcfg, tcfg


def _moe_params(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, {k: to_tensor(np.asarray(v), "cpu") for k, v in jp.items()}


def _jroute(jp, jcfg, x):
    """repro's router and per-row dispatch, as ``repro.models.moe.moe_block``
    writes them (lines 116-130)."""
    B, S, _ = x.shape
    E, K = jcfg.moe.num_experts, jcfg.moe.top_k
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x.astype(jnp.float32), jp["router"]), -1)
    top_p, top_e = jax.lax.top_k(probs, K)
    top_p = top_p / jnp.sum(top_p, axis=-1, keepdims=True)
    C = int(max(1, round(S * K / E * jcfg.moe.capacity_factor)))
    slot, valid = jax.vmap(lambda e: jdispatch_indices(e.reshape(-1), E, C))(top_e)
    return top_p, top_e, slot.reshape(B, S, K), valid.reshape(B, S, K), C


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_block_matches_repro(arch, cf):
    jcfg, tcfg = _cfgs(arch, cf=cf)
    jp, tp = _moe_params(jcfg)
    x = np.random.RandomState(1).randn(3, 7, jcfg.d_model).astype(np.float32)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_block(p, jcfg, x))(jp, jnp.asarray(x))
    ty, taux = moe.moe_block(tp, tcfg, torch.from_numpy(x))
    top_p, top_e, slot, valid, C = _jroute(jp, jcfg, jnp.asarray(x))
    _, tp_p, tp_e, t_slot, t_valid = moe.route(tp, tcfg, torch.from_numpy(x))
    assert moe.capacity(tcfg, 7) == C
    np.testing.assert_array_equal(tp_e.numpy(), np.asarray(top_e))
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(slot))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(valid))
    np.testing.assert_allclose(tp_p.numpy(), np.asarray(top_p), **F32)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(float(taux.load_loss), float(jaux.load_loss), **F32)
    np.testing.assert_allclose(float(taux.drop_frac), float(jaux.drop_frac), **F32)
    assert float(taux.drop_frac) == pytest.approx(1.0 - float(np.asarray(valid).mean()))
    if cf == 0.5:
        assert float(taux.drop_frac) > 0.0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_bf16_matches_repro(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = _moe_params(jcfg)
    x = np.random.RandomState(2).randn(2, 9, jcfg.d_model).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jy, _ = jax.jit(lambda p, x: jmoe.moe_block(p, jcfg, x), compiler_options=STRICT)(jp, jx)
    tx = to_tensor(np.asarray(jx), "cpu")
    ty, _ = moe.moe_block(tp, tcfg, tx)
    assert ty.dtype == torch.bfloat16
    _, top_e, slot, valid, _ = _jroute(jp, jcfg, jx)
    _, _, tp_e, t_slot, t_valid = moe.route(tp, tcfg, tx)
    np.testing.assert_array_equal(tp_e.numpy(), np.asarray(top_e))
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(slot))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(valid))
    want = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(ty.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


def test_moe_rows_are_independent():
    """Row 1's output is the same bit for bit whatever rows 0 and 2 hold,
    and alone (B 1) within fp32 roundoff."""
    _, tcfg = _cfgs("olmoe-1b-7b")
    _, tp = _moe_params(_cfgs("olmoe-1b-7b")[0])
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(3, 8, tcfg.d_model).astype(np.float32))
    y, _ = moe.moe_block(tp, tcfg, x)
    other = x.clone()
    other[0], other[2] = x[2] * 2.0, -x[0]
    y2, _ = moe.moe_block(tp, tcfg, other)
    assert torch.equal(y2[1], y[1])
    alone, _ = moe.moe_block(tp, tcfg, x[1:2])
    torch.testing.assert_close(alone[0], y[1], rtol=1e-6, atol=1e-6)


def test_right_padding_never_displaces_real_tokens():
    """A row of 5 real tokens padded to a chunk of 8: whatever the padding
    holds, the real tokens' outputs are the same bit for bit (padding sorts
    after them within each expert), and equal repro's."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b", cf=0.5)  # C 2 for 8 tokens: drops happen
    jp, tp = _moe_params(jcfg)
    rng = np.random.RandomState(4)
    real = rng.randn(1, 5, tcfg.d_model).astype(np.float32)
    outs = []
    for pad in (np.zeros((1, 3, tcfg.d_model), np.float32),
                rng.randn(1, 3, tcfg.d_model).astype(np.float32),
                np.repeat(real[:, :1], 3, axis=1)):  # pads that copy token 0
        x = np.concatenate([real, pad], axis=1)
        y, _ = moe.moe_block(tp, tcfg, torch.from_numpy(x))
        jy, _ = jmoe.moe_block(jp, jcfg, jnp.asarray(x))
        np.testing.assert_allclose(y[:, :5].numpy(), np.asarray(jy)[:, :5], **F32)
        outs.append(y[:, :5])
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


# ---------------------------------------------------------------------------
# The model: train_loss, chunked prefill, verify
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(arch):
    """repro's and the port's reduced fp32 model on the same weights and a
    pruned DS mask."""
    jcfg, tcfg = _cfgs(arch)
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_loss_with_the_moe_aux_matches_repro(arch):
    (jb, jp, js), (tb, tp, ts) = _models(arch)
    tokens = np.random.RandomState(5).randint(0, VOCAB, (2, 13)).astype(np.int32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p, b: jb.train_loss(p, js, b),
                                              has_aux=True))(jp, {"tokens": jnp.asarray(tokens)})
    (tl, tm), grads = value_and_grad(tb, tp, ts, {"tokens": torch.from_numpy(tokens)})
    assert float(tm["moe_aux"]) > 0.0
    for got, want in ((tl, jl), (tm["ce"], jm["ce"]), (tm["moe_aux"], jm["moe_aux"])):
        np.testing.assert_allclose(float(got), float(want), **F32)
    want_total = float(jm["ce"] + jm["head_aux_total"]) + 0.01 * float(jm["moe_aux"])
    np.testing.assert_allclose(float(tl), want_total, **F32)
    assert grads["layers"]["moe"]["router"].abs().sum() > 0  # the aux reaches the router
    # the gradients too, each leaf within 1e-5 of its largest element
    jgf = flatten_paths(jax.tree.map(np.asarray, jg))
    for path, want in jgf.items():
        node = grads
        for key in path.split("/"):
            node = node[key]
        np.testing.assert_allclose(node.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=path)


@pytest.mark.parametrize("arch", MOE_ARCHS + ("internvl2-26b",))
def test_prefill_chunk_and_verify_match_repro(arch):
    """A 10-token prompt in chunks of 4 (the last padded) into a zero cache,
    then a (1, 3) verify block after it: every chunk's and the block's
    top-k equal repro's, the caches within fp32 roundoff."""
    (jb, jp, js), (tb, tp, ts) = _models(arch)
    jt, tt = jds.pack_experts(jp["head"], js), ds.pack_experts(tp["head"], ts)
    cfg = tb.cfg
    prompt = np.random.RandomState(6).randint(0, VOCAB, 10).astype(np.int32)
    shape = (cfg.n_layers, 1, 16, cfg.n_kv_heads, cfg.hd)
    jcache = JDecodeCache(k=jnp.zeros(shape), v=jnp.zeros(shape))
    tcache = DecodeCache(k=torch.zeros(shape), v=torch.zeros(shape))
    chunk = jax.jit(lambda p, t, c, x, lo, nv: jb.prefill_chunk(p, t, c, x, lo, nv, kernel="jnp"))
    for lo in range(0, 10, 4):
        buf = np.zeros((1, 4), np.int32)
        tail = prompt[lo: lo + 4]
        buf[0, : len(tail)] = tail
        jv, ji, jcache = chunk(jp, jt, jcache, jnp.asarray(buf), lo, len(tail))
        tv, ti, tcache = tb.prefill_chunk(tp, tt, tcache, torch.from_numpy(buf).long(), lo,
                                          len(tail), kernel="jnp")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **HEAD_TOL)
    block = np.array([[int(ji[0, 0]), 5, 77]], np.int32)
    pos0 = np.array([10], np.int32)
    jv, ji, jcache = jax.jit(lambda p, t, c, x, q: jb.verify_step(p, t, c, x, q, kernel="jnp"))(
        jp, jt, jcache, jnp.asarray(block), jnp.asarray(pos0))
    tv, ti, tcache = tb.verify_step(tp, tt, tcache, torch.from_numpy(block),
                                    torch.from_numpy(pos0), kernel="jnp")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **HEAD_TOL)
    for a, b in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


# ---------------------------------------------------------------------------
# ServeSession on reduced olmoe-1b-7b
# ---------------------------------------------------------------------------

# two prompt lengths, so repro's whole-prompt prefill compiles twice
PROMPT_LENS = (6, 9, 6, 9)
MAX_NEW = (5, 3, 6, 4)
MODES = {"whole": {}, "chunked_paged": dict(prefill_chunk=4, paged=True, page_size=8),
         "speculative": dict(prefill_chunk=4)}


def _requests(cls, sp_cls):
    rng = np.random.RandomState(8)
    return [cls(prompt=rng.randint(1, VOCAB, n).astype(np.int32),
                sampling=sp_cls(max_new_tokens=m)) for n, m in zip(PROMPT_LENS, MAX_NEW)]


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_session_streams_match_repro(mode):
    (jb, jp, js), (tb, tp, ts) = _models("olmoe-1b-7b")
    kw = dict(MODES[mode])
    jkw, tkw = dict(kw), dict(kw)
    if mode == "speculative":
        jkw.update(draft=(jb, jp, js), gamma=2)
        tkw.update(draft=(tb, tp, ts), gamma=2)
    jsess = JServeSession(jb, jp, js, n_slots=2, max_seq_len=32, k=8, kernel="jnp", **jkw)
    jreqs = _requests(JRequest, JSamplingParams)
    jsess.run(jreqs)
    tsess = ServeSession(tb, tp, ts, n_slots=2, max_seq_len=32, k=8, kernel="jnp",
                         device="cpu", **tkw)
    tsess._draft_backfill = False  # repro's draft schedule
    treqs = _requests(Request, SamplingParams)
    tsess.run(treqs)
    assert all(r.status is RequestStatus.COMPLETED for r in treqs)
    assert [list(r.out_tokens) for r in treqs] == [list(r.out_tokens) for r in jreqs]
    st = tsess.stats()
    if mode == "speculative":
        assert st["speculative"] == jsess.stats()["speculative"]
    if "paged" in kw:
        assert st["paged"]["pages_in_use"] == 0


@pytest.mark.parametrize("arch,extra", [
    ("olmoe-1b-7b", ["--draft", "olmoe-1b-7b", "--gamma", "2"]),
    ("qwen3-moe-235b-a22b", ["--paged", "--prefill-chunk", "4"]),
    ("internvl2-26b", ["--quantize", "int8"])])
def test_launch_serve_takes_the_moe_and_vlm_archs(arch, extra, capsys):
    """The serve launcher on the CPU serves each new arch's reduced config
    (a self-draft, the paged chunked cache, an int8 table)."""
    from repro_torch.launch import serve as launch_serve

    sess = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "3",
                              "--slots", "2", "--new-tokens", "4", *extra])
    assert sess.cfg.family in ("moe", "vlm") and sess.stats()["n_completed"] == 3
    assert "completed=3" in capsys.readouterr().out
