"""Port parity: the ssm and hybrid families (``repro_torch.models.hybrid``,
their branches of ``model_zoo`` and ``convert``) against ``repro`` on the
same JAX-initialized weights, in fp32.

Models: reduced mamba2-130m (2 layers), reduced zamba2-7b (3 layers, the
shared block after each) and a zamba2-7b with a remainder group
(``attn_period`` 2, 5 layers: [m m A] x 2 + [m]), d 64, vocab 96.

* ``prefill``, ``prefill_chunk`` (a 10-token prompt in chunks of 4 into a
  zero cache), ``decode_step`` at per-row positions and ``verify_step``:
  ids equal, head values within rtol 1e-6, atol 2e-6
  (``tests/test_kernels.py:103``), every cache leaf within 1e-5.
* ``verify_step`` leaves conv/ssm bit for bit unchanged; ``commit_block``
  with per-row ``n_valid`` equals ``repro``'s and one-token decoding of each
  row's accepted prefix.
* ``train_loss`` within rtol 1e-5 and its gradients (each element within
  2^-8 of its leaf's largest, the RMS of the difference within 1e-4 of it:
  ``GRAD_ATOL``, ``GRAD_RMS``); ``convert.params_from_jax`` carries every leaf over and
  ``check_shapes`` names a wrong one.
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
from repro.models.hybrid import HybridCache as JHybridCache
from repro_torch import configs
from repro_torch.convert import (MASK_KEY, check_shapes, flatten_paths, params_from_jax,
                                 to_tensor)
from repro_torch.core import dssoftmax as ds
from repro_torch.models import build
from repro_torch.models.hybrid import HybridCache
from repro_torch.models.model_zoo import cache_kv_leaves, cache_specs, paged_cache_specs
from repro_torch.train.train_step import value_and_grad

VOCAB = 96
HEAD_TOL = dict(rtol=1e-6, atol=2e-6)
F32 = dict(rtol=1e-5, atol=1e-5)
# a gradient leaf's bounds, relative to its largest element: the SSD's
# intra-chunk products take bf16 operands, so their cotangents are rounded to
# bf16 on both sides, and a one-ulp fp32 difference ahead of that rounding
# moves a term by a bf16 ulp now and then: each element within one bf16 ulp
# (2^-8), the RMS of the difference within 1e-4 (the transformer families'
# tests hold every element to 1e-5)
GRAD_ATOL, GRAD_RMS = 2.0 ** -8, 1e-4
# the remainder case: 5 layers at period 2 -> [m m A] x 2 + [m]
ARCHS = {"mamba2-130m": {}, "zamba2-7b": {}, "zamba2-7b-rem": dict(attn_period=2, n_layers=5)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and beside other
    test processes torch's default pool makes each small op wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(name):
    arch = name.removesuffix("-rem")
    jcfg = jreduce_config(jget_config(arch), vocab=VOCAB).replace(dtype="float32", **ARCHS[name])
    tcfg = configs.reduce_config(configs.get_config(arch), vocab=VOCAB).replace(
        dtype="float32", **ARCHS[name])
    jb = jbuild(jcfg)
    params, state = jb.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    mask = np.asarray(state.mask) & (rng.rand(*state.mask.shape) < 0.5)
    mask[rng.randint(0, mask.shape[0], mask.shape[1]), np.arange(mask.shape[1])] = True
    tree = flatten_paths(jax.tree.map(np.asarray, params))
    tree[MASK_KEY] = mask
    tparams, tstate = params_from_jax(tree, tcfg, device="cpu")
    jstate = jds.DSState(mask=jnp.asarray(mask))
    return ((jb, params, jstate, jds.pack_experts(params["head"], jstate)),
            (build(tcfg, device="cpu"), tparams, tstate, ds.pack_experts(tparams["head"], tstate)))


def _to_torch(jcache):
    return HybridCache(*(to_tensor(np.asarray(x), "cpu") for x in jcache))


def _close(tcache, jcache, tol=F32):
    for a, b in zip(tcache, jcache):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


def _zero_caches(cfg, B, S):
    specs = cache_specs(cfg, configs.ShapeConfig(name="t", seq_len=S, global_batch=B,
                                                 kind="decode"))
    tcache = HybridCache(*(torch.zeros(s.shape, dtype=s.dtype) for s in specs))
    jcache = JHybridCache(*(jnp.zeros(s.shape, jnp.float32) for s in specs))
    return tcache, jcache


def test_layout_matches_repro():
    from repro.models import hybrid as jhybrid
    from repro_torch.models import hybrid

    for name in ARCHS:
        (jb, *_), (tb, *_) = _models(name)
        assert hybrid._layout(tb.cfg) == jhybrid._layout(jb.cfg)
    full = configs.get_config("zamba2-7b")
    assert hybrid._layout(full) == (13, 3) and hybrid.n_attn_apps(full) == 13
    assert hybrid._groups(full) == [6] * 13 + [3]
    assert hybrid._layout(_models("zamba2-7b-rem")[1][0].cfg) == (2, 1)
    assert hybrid._layout(configs.get_config("mamba2-130m")) == (0, 24)


@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_and_decode_match_repro(name):
    """A whole-prompt prefill (B 2, S 9), then three decode steps at per-row
    positions against the prefilled cache grown by 4 positions."""
    (jb, jp, _, jt), (tb, tp, _, tt) = _models(name)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, VOCAB, (2, 9)).astype(np.int32)
    jv, ji, jc = jax.jit(lambda p, t, b: jb.prefill(p, t, b, kernel="jnp"))(
        jp, jt, {"tokens": jnp.asarray(tokens)})
    tv, ti, tc = tb.prefill(tp, tt, {"tokens": torch.from_numpy(tokens).long()}, kernel="jnp")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **HEAD_TOL)
    _close(tc, jc)
    grow = lambda c: jnp.concatenate([c, jnp.zeros(c.shape[:2] + (4,) + c.shape[3:], c.dtype)],
                                     axis=2)
    jcache = jc._replace(attn_k=grow(jc.attn_k), attn_v=grow(jc.attn_v))
    tcache = _to_torch(jcache)
    dec = jax.jit(lambda p, t, c, tok, pos: jb.decode_step(p, t, c, tok, pos, kernel="jnp"))
    tok = np.asarray(ji[:, 0])
    pos = np.array([9, 7], np.int32)
    for step in range(3):
        jv, ji, jcache = dec(jp, jt, jcache, jnp.asarray(tok), jnp.asarray(pos + step))
        tv, ti, tcache = tb.decode_step(tp, tt, tcache, torch.tensor(tok, dtype=torch.long),
                                        torch.from_numpy(pos + step).long(), kernel="jnp")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **HEAD_TOL)
        _close(tcache, jcache)
        tok = np.asarray(ji[:, 0])


@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_chunk_verify_and_commit_match_repro(name):
    """A 10-token prompt in chunks of 4 (the last padded) into a zero cache,
    then a (2, 3) verify block (each row a copy of the prompt's state) and
    the commit of 1 and 3 accepted tokens."""
    (jb, jp, _, jt), (tb, tp, _, tt) = _models(name)
    cfg = tb.cfg
    prompt = np.random.RandomState(6).randint(0, VOCAB, 10).astype(np.int32)
    tcache, jcache = _zero_caches(cfg, 1, 16)
    chunk = jax.jit(lambda p, t, c, x, lo, nv: jb.prefill_chunk(p, t, c, x, lo, nv, kernel="jnp"),
                    static_argnums=(4, 5))
    for lo in range(0, 10, 4):
        buf = np.zeros((1, 4), np.int32)
        tail = prompt[lo: lo + 4]
        buf[0, : len(tail)] = tail
        jv, ji, jcache = chunk(jp, jt, jcache, jnp.asarray(buf), lo, len(tail))
        tv, ti, tcache = tb.prefill_chunk(tp, tt, tcache, torch.from_numpy(buf).long(), lo,
                                          len(tail), kernel="jnp")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **HEAD_TOL)
    _close(tcache, jcache)
    # the whole prompt's state, as a chunked stream hands it on
    _, _, whole = tb.prefill(tp, tt, {"tokens": torch.from_numpy(prompt[None]).long()},
                             kernel="jnp")
    np.testing.assert_allclose(tcache.ssm.numpy(), whole.ssm.numpy(), rtol=2e-4, atol=2e-4)
    # two slots holding that state, a verify block each
    two = lambda c: type(c)(*(jnp.concatenate([x, x], axis=1) for x in c))
    jcache = two(jcache)
    tcache = _to_torch(jcache)
    block = np.array([[int(ji[0, 0]), 5, 77], [int(ji[0, 0]), 12, 3]], np.int32)
    pos0 = np.array([10, 10], np.int32)
    before = [t.clone() for t in (tcache.conv, tcache.ssm)]
    jv, ji, jcache = jax.jit(lambda p, t, c, x, q: jb.verify_step(p, t, c, x, q, kernel="jnp"))(
        jp, jt, jcache, jnp.asarray(block), jnp.asarray(pos0))
    tv, ti, tcache = tb.verify_step(tp, tt, tcache, torch.from_numpy(block).long(),
                                    torch.from_numpy(pos0).long(), kernel="jnp")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **HEAD_TOL)
    assert torch.equal(tcache.conv, before[0]) and torch.equal(tcache.ssm, before[1])
    _close(tcache, jcache)
    nv = np.array([1, 3], np.int32)
    pre = HybridCache(*(t.clone() for t in tcache))
    jcache = jax.jit(lambda p, c, x, q, n: jb.commit_block(p, c, x, q, n))(
        jp, jcache, jnp.asarray(block), jnp.asarray(pos0), jnp.asarray(nv))
    tb.commit_block(tp, tcache, torch.from_numpy(block).long(), torch.from_numpy(pos0).long(),
                    torch.from_numpy(nv).long())
    _close(tcache, jcache)
    # one-token decodes of the block from the pre-commit cache: row r's
    # state after its n_valid of them
    for t in range(3):
        tb.decode_step(tp, tt, pre, torch.from_numpy(block[:, t]).long(),
                       torch.from_numpy(pos0 + t).long(), kernel="jnp")
        for r in np.nonzero(nv == t + 1)[0]:
            for got, want in ((tcache.conv[:, r], pre.conv[:, r]),
                              (tcache.ssm[:, r], pre.ssm[:, r])):
                if cfg.family == "ssm":  # the same one-token recurrence, bit for bit
                    assert torch.equal(got, want), (r, t)
                else:  # the shared block attends as a chunk, not as a decode step
                    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(ARCHS))
def test_paged_state_pages_equal_contiguous_rows(name):
    """decode_step with the conv/ssm leaves as an arena of state pages (and
    the shared block's K/V through a page table) gives the contiguous
    cache's values, and writes only the slots' own state pages."""
    (_, _, _, _), (tb, tp, _, tt) = _models(name)
    cfg = tb.cfg
    rng = np.random.RandomState(2)
    tokens = torch.from_numpy(rng.randint(0, VOCAB, (2, 8))).long()
    _, _, row = tb.prefill(tp, tt, {"tokens": tokens}, kernel="jnp")
    zero, _ = _zero_caches(cfg, 2, 16)
    tcache = HybridCache(conv=row.conv.clone(), ssm=row.ssm.clone(), attn_k=zero.attn_k,
                         attn_v=zero.attn_v)
    tcache.attn_k[:, :, :8] = row.attn_k
    tcache.attn_v[:, :, :8] = row.attn_v
    specs = paged_cache_specs(cfg, 6, 8, 5)
    paged = HybridCache(*(torch.zeros(s.shape, dtype=s.dtype) for s in specs))
    pages = torch.tensor([[2, 3], [4, 5]])
    spages = torch.tensor([3, 1])
    for b in range(2):
        paged.conv[:, spages[b]] = tcache.conv[:, b]
        paged.ssm[:, spages[b]] = tcache.ssm[:, b]
        for j in range(2):
            paged.attn_k[:, pages[b, j]] = tcache.attn_k[:, b, 8 * j:8 * j + 8]
            paged.attn_v[:, pages[b, j]] = tcache.attn_v[:, b, 8 * j:8 * j + 8]
    untouched = [paged.ssm[:, i].clone() for i in (0, 2, 4)]
    tok, pos = torch.tensor([3, 9]), torch.tensor([8, 8])
    v1, i1, _ = tb.decode_step(tp, tt, tcache, tok, pos, kernel="jnp")
    v2, i2, _ = tb.decode_step(tp, tt, paged, tok, pos, kernel="jnp", pages=pages,
                               state_pages=spages)
    assert torch.equal(i1, i2)
    torch.testing.assert_close(v1, v2, rtol=1e-6, atol=1e-6)
    for b in range(2):
        torch.testing.assert_close(paged.ssm[:, spages[b]], tcache.ssm[:, b], rtol=1e-6,
                                   atol=1e-6)
    assert all(torch.equal(paged.ssm[:, i], u) for i, u in zip((0, 2, 4), untouched))


@pytest.mark.parametrize("name", list(ARCHS))
def test_train_loss_and_grads_match_repro(name):
    (jb, jp, js, _), (tb, tp, ts, _) = _models(name)
    tokens = np.random.RandomState(5).randint(0, VOCAB, (2, 13)).astype(np.int32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p, b: jb.train_loss(p, js, b),
                                              has_aux=True))(jp, {"tokens": jnp.asarray(tokens)})
    (tl, tm), grads = value_and_grad(tb, tp, ts, {"tokens": torch.from_numpy(tokens)})
    for got, want in ((tl, jl), (tm["ce"], jm["ce"])):
        np.testing.assert_allclose(float(got), float(want), **F32)
    jgf = flatten_paths(jax.tree.map(np.asarray, jg))
    for path, want in jgf.items():
        node = grads
        for key in path.split("/"):
            node = node[key]
        big = float(np.abs(want).max())
        np.testing.assert_allclose(node.numpy(), want, rtol=1e-5, atol=GRAD_ATOL * big,
                                   err_msg=path)
        assert float(np.sqrt(np.mean((node.numpy() - want) ** 2))) <= GRAD_RMS * big, path


def test_params_from_jax_carries_every_leaf():
    (jb, jp, _, _), (tb, tp, _, _) = _models("zamba2-7b")
    tree = flatten_paths(jax.tree.map(np.asarray, jp))
    got = flatten_paths({k: v for k, v in tp.items()})
    for path, want in tree.items():
        assert np.array_equal(got[path], want), path
    assert set(tp["layers"]["mamba"]) == {"in_zx", "in_bc", "in_dt", "conv_w", "conv_b", "A_log",
                                          "dt_bias", "D", "norm_scale", "out_proj"}
    assert set(tp["shared_attn"]) == {"ln1", "attn", "ln2", "mlp"}
    tree[MASK_KEY] = np.ones((4, tb.cfg.padded_vocab), bool)
    bad = dict(tree, **{"layers/mamba/in_zx": tree["layers/mamba/in_zx"][:, :, :-1]})
    with pytest.raises(ValueError, match="layers/mamba/in_zx"):
        params_from_jax(bad, tb.cfg, device="cpu")
    with pytest.raises(KeyError, match="shared_attn/attn/wq"):
        check_shapes({k: v for k, v in tree.items() if k != "shared_attn/attn/wq"}, tb.cfg)
    ssm_cfg = _models("mamba2-130m")[1][0].cfg
    ssm_tree = flatten_paths(jax.tree.map(np.asarray, _models("mamba2-130m")[0][1]))
    ssm_tree[MASK_KEY] = tree[MASK_KEY]
    check_shapes(ssm_tree, ssm_cfg)
    with pytest.raises(ValueError, match="shared_attn"):
        check_shapes({**ssm_tree, "shared_attn/attn/wq": tree["shared_attn/attn/wq"]}, ssm_cfg)


def test_cache_specs_match_repro():
    from repro.configs import ShapeConfig as JShapeConfig
    from repro.models.model_zoo import cache_kv_leaves as jleaves
    from repro.models.model_zoo import cache_specs as jcache_specs
    from repro.models.model_zoo import paged_cache_specs as jpaged

    for arch in ("mamba2-130m", "zamba2-7b"):
        tcfg, jcfg = configs.get_config(arch), jget_config(arch)
        shape = dict(name="s", seq_len=64, global_batch=3, kind="decode")
        for got, want in ((cache_specs(tcfg, configs.ShapeConfig(**shape)),
                           jcache_specs(jcfg, JShapeConfig(**shape))),
                          (paged_cache_specs(tcfg, 10, 16, 7), jpaged(jcfg, 10, 16, 7))):
            for a, b in zip(got, want):
                assert a.shape == b.shape and str(a.dtype)[6:] == str(b.dtype)
        assert tuple(cache_kv_leaves(tcfg)) == tuple(jleaves(jcfg)) == (False, False, True, True)
