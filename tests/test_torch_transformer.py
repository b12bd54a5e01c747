"""Port parity: the dense transformer (``repro_torch.models``) against
``repro.models`` on ``reduce_config(get_config("qwen2-1.5b"))`` with
JAX-initialized weights carried over by ``convert.params_from_jax`` and a
pruned random DS mask.

Compared: the final hidden state the head sees (captured at
``heads.head_topk`` on both sides), the K/V caches, and the head's top-k,
after prefill and after two decode steps at per-slot positions.

The JAX side runs under ``jax.jit(..., compiler_options=
{"xla_allow_excess_precision": False})``. XLA's CPU default keeps fp32
between fused bf16 operations, so it rounds fewer times than its program
says; with the option off it rounds every bf16 intermediate where the
program does, as the port does op by op.

Tolerances. Ids equal everywhere. Head values rtol 1e-6, atol 2e-6
(``tests/test_kernels.py:103``). Hidden states and caches: fp32 rtol 1e-5,
atol 1e-5 (two layers of fp32 matmuls, softmax and rsqrt whose library
implementations differ by ulps); bf16 atol 1.6e-2, one bf16 ulp at the
largest magnitudes here (~4): both sides round at the same points, but an
fp32 sum that differs in its last bit can still round to the neighbouring
bf16 value.
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
from repro.models.transformer import DecodeCache as JDecodeCache
from repro_torch import configs
from repro_torch.convert import flatten_paths, params_from_jax, to_tensor
from repro_torch.core import dssoftmax as ds
from repro_torch.models import build, heads
from repro_torch.models.transformer import DecodeCache as TDecodeCache

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=0.0, atol=1.6e-2)}
HEAD_TOL = dict(rtol=1e-6, atol=2e-6)


def _capture(monkeypatch, module, sink):
    """Record the hidden states every head_topk call receives (tracers on
    the JAX side, returned by :func:`_strict_jit`)."""
    orig = module.head_topk

    def wrapped(head_params, table, cfg, h, k, *a, **kw):
        sink.append(h)
        return orig(head_params, table, cfg, h, k, *a, **kw)

    monkeypatch.setattr(module, "head_topk", wrapped)


def _strict_jit(fn, sink):
    """jit ``fn`` with bf16 excess precision off; also return the hidden
    state its head call saw."""
    def run(*args):
        out = fn(*args)
        return out, sink[-1].astype(jnp.float32)

    return jax.jit(run, compiler_options={"xla_allow_excess_precision": False})


@functools.lru_cache(maxsize=None)
def _models(dtype):
    jcfg = jreduce_config(jget_config("qwen2-1.5b"), vocab=256).replace(dtype=dtype)
    tcfg = configs.reduce_config(configs.get_config("qwen2-1.5b"), vocab=256).replace(dtype=dtype)
    jb = jbuild(jcfg)
    params, state = jb.init(jax.random.PRNGKey(0))
    # prune: each class keeps its experts with probability 0.6 (at least one)
    rng = np.random.RandomState(0)
    mask = np.asarray(state.mask) & (rng.rand(*state.mask.shape) < 0.6)
    mask[rng.randint(0, mask.shape[0], mask.shape[1]), np.arange(mask.shape[1])] = True
    state = jds.DSState(mask=jnp.asarray(mask))
    tree = flatten_paths(jax.tree.map(np.asarray, params))
    tree["ds_state/mask"] = mask
    tparams, tstate = params_from_jax(tree, tcfg, device="cpu")
    return (jb, params, jds.pack_experts(params["head"], state),
            build(tcfg, device="cpu"), tparams, ds.pack_experts(tparams["head"], tstate))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_repro(monkeypatch, dtype):
    jb, jp, jt, tb, tp, tt = _models(dtype)
    np.testing.assert_array_equal(tt.ids.numpy(), np.asarray(jt.ids))
    jh, th = [], []
    _capture(monkeypatch, jheads, jh)
    _capture(monkeypatch, heads, th)
    tol = TOL[dtype]
    f32 = lambda a: np.asarray(a.astype(jnp.float32)) if hasattr(a, "astype") else a
    rng = np.random.RandomState(1)
    B, S = 3, 9
    tokens = rng.randint(0, 256, (B, S)).astype(np.int32)

    pre = _strict_jit(lambda p, t, b: jb.prefill(p, t, b, kernel="jnp"), jh)
    (jv, ji, jc), jhid = pre(jp, jt, {"tokens": jnp.asarray(tokens)})
    tv, ti, tc = tb.prefill(tp, tt, {"tokens": torch.from_numpy(tokens).long()}, kernel="jnp")
    np.testing.assert_allclose(th[-1].float().numpy(), np.asarray(jhid), **tol)
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(a.float().numpy(), f32(b), **tol)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **HEAD_TOL)

    # grow the caches, then decode two steps at per-row positions
    grow = lambda c, n: jnp.concatenate(
        [c, jnp.zeros(c.shape[:2] + (n,) + c.shape[3:], c.dtype)], axis=2)
    jcache = JDecodeCache(k=grow(jc.k, 4), v=grow(jc.v, 4))
    tcache = TDecodeCache(k=to_tensor(np.asarray(jcache.k), "cpu"),
                          v=to_tensor(np.asarray(jcache.v), "cpu"))
    dec = _strict_jit(lambda p, t, c, tok, pos: jb.decode_step(p, t, c, tok, pos,
                                                               kernel="jnp"), jh)
    tok = np.asarray(ji[:, 0])
    pos = np.array([S, S - 2, S - 5], np.int32)  # slots at their own lengths
    for step in range(2):
        (jv, ji, jcache), jhid = dec(jp, jt, jcache, jnp.asarray(tok), jnp.asarray(pos + step))
        tv, ti, tcache = tb.decode_step(tp, tt, tcache, torch.tensor(tok, dtype=torch.long),
                                        torch.from_numpy(pos + step).long(), kernel="jnp")
        np.testing.assert_allclose(th[-1].float().numpy(), np.asarray(jhid), **tol)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **HEAD_TOL)
        for a, b in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
            np.testing.assert_allclose(a.float().numpy(), f32(b), **tol)
        tok = np.asarray(ji[:, 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_decode_hidden_then_head_is_decode_step(monkeypatch, dtype, paged):
    """``decode_hidden`` followed by ``heads.head_topk`` gives what
    ``decode_step`` gives, bit for bit (values, ids, the hidden state its
    head saw and the cache it wrote), on a random cache at per-row
    positions, contiguous or paged (disjoint shuffled pages; row 2's last
    page the zero page, past its position). Both match ``repro``'s
    ``decode_step`` on the same inputs to the tolerances of
    ``test_prefill_and_decode_match_repro``."""
    jb, jp, jt, tb, tp, tt = _models(dtype)
    jh, th = [], []
    _capture(monkeypatch, jheads, jh)
    _capture(monkeypatch, heads, th)
    tol = TOL[dtype]
    cfg = tb.cfg
    rng = np.random.RandomState(6)
    B, L, KV, dh = 3, cfg.n_layers, cfg.n_kv_heads, cfg.hd
    tok = rng.randint(0, 256, B).astype(np.int32)
    pos = np.array([9, 3, 6], np.int32)
    if paged:
        ps, n_pg = 4, 4
        pages = (2 + rng.permutation(B * n_pg)).reshape(B, n_pg).astype(np.int32)
        pages[2, 3] = 0
        shape = (L, 2 + B * n_pg, ps, KV, dh)
    else:
        pages, shape = None, (L, B, 16, KV, dh)
    kv = [rng.randn(*shape).astype(np.float32) for _ in range(2)]
    if paged:
        for a in kv:
            a[:, 0] = 0.0  # the zero page
    jcache = JDecodeCache(*(jnp.asarray(a).astype(jb.cfg.jdtype) for a in kv))
    caches = [TDecodeCache(*(to_tensor(np.asarray(a), "cpu") for a in jcache)) for _ in range(2)]
    ttok, tpos = torch.from_numpy(tok).long(), torch.from_numpy(pos).long()
    tpages = None if pages is None else torch.from_numpy(pages)

    h = tb.decode_hidden(tp, caches[0], ttok, tpos, pages=tpages)
    split = heads.head_topk(tp["head"], tt, cfg, h, 8, embed_table=tp["embed"]["table"],
                            kernel="jnp")
    whole = tb.decode_step(tp, tt, caches[1], ttok, tpos, kernel="jnp", pages=tpages)
    assert torch.equal(th[0], h) and torch.equal(th[1], h)
    assert torch.equal(split[0], whole[0]) and torch.equal(split[1], whole[1])
    assert whole[2] is caches[1]
    assert torch.equal(caches[0].k, caches[1].k) and torch.equal(caches[0].v, caches[1].v)

    dec = _strict_jit(lambda p, t, c, tk, ps_, pg: jb.decode_step(
        p, t, c, tk, ps_, kernel="jnp", pages=pg), jh)
    (jv, ji, jcache), jhid = dec(jp, jt, jcache, jnp.asarray(tok), jnp.asarray(pos),
                                 None if pages is None else jnp.asarray(pages))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    np.testing.assert_allclose(h.float().numpy(), np.asarray(jhid), **tol)
    np.testing.assert_array_equal(split[1].numpy(), np.asarray(ji))
    np.testing.assert_allclose(split[0].numpy(), np.asarray(jv), **HEAD_TOL)
    for a, b in ((caches[0].k, jcache.k), (caches[0].v, jcache.v)):
        np.testing.assert_allclose(a.float().numpy(), f32(b), **tol)


def test_long_prompt_runs_chunked_attention(monkeypatch):
    """A prompt longer than attn_q_chunk (64 in the reduced config) takes
    chunked_causal_attention (two 64-row query chunks, an unmasked history
    chunk merged online) on both sides."""
    jb, jp, jt, tb, tp, tt = _models("float32")
    jh, th = [], []
    _capture(monkeypatch, jheads, jh)
    _capture(monkeypatch, heads, th)
    tokens = np.random.RandomState(2).randint(0, 256, (1, 128)).astype(np.int32)
    pre = _strict_jit(lambda p, t, b: jb.prefill(p, t, b, kernel="jnp"), jh)
    (_, ji, jc), jhid = pre(jp, jt, {"tokens": jnp.asarray(tokens)})
    _, ti, tc = tb.prefill(tp, tt, {"tokens": torch.from_numpy(tokens).long()}, kernel="jnp")
    np.testing.assert_allclose(th[-1].numpy(), np.asarray(jhid), **TOL["float32"])
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL["float32"])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_params_from_jax_rejects_wrong_shapes():
    tcfg = configs.reduce_config(configs.get_config("qwen2-1.5b"), vocab=256)
    with pytest.raises(KeyError):
        params_from_jax({}, tcfg, device="cpu")
    _, jp, _, _, _, _ = _models("float32")
    tree = flatten_paths(jax.tree.map(np.asarray, jp))
    tree["ds_state/mask"] = np.ones((4, 512), bool)
    tree["layers/attn/wq"] = tree["layers/attn/wq"][:1]
    with pytest.raises(ValueError, match="wq"):
        params_from_jax(tree, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# Chunked prefill: attention_prefill_chunk and prefill_chunk
# ---------------------------------------------------------------------------

def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("mode", ["scalar", "per_row", "paged", "paged_per_row"])
def test_attention_prefill_chunk_matches_repro(mode):
    """One layer's chunk attention against a partly filled cache: the
    output and the caches it writes (in place on the port's side), for a
    scalar pos0, per-row pos0 and the paged arena (a page table mapping
    logical pages to shuffled arena pages). fp32 rtol 1e-5, atol 1e-5."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    jb, jp, _, tb, tp, _ = _models("float32")
    cfg_j, cfg_t = jb.cfg, tb.cfg
    rng = np.random.RandomState(4)
    B, C, KV, dh = 3, 4, cfg_t.n_kv_heads, cfg_t.hd
    x = rng.randn(B, C, cfg_t.d_model).astype(np.float32)
    pos0 = np.array([0, 5, 9], np.int32) if mode.endswith("per_row") else 6
    if mode.startswith("paged"):
        ps, n_pg, n_pages = 4, 4, 16
        ck = rng.randn(n_pages, ps, KV, dh).astype(np.float32)
        pages = np.stack([rng.permutation(np.arange(2, n_pages))[:n_pg]
                          for _ in range(B)]).astype(np.int32)
        pages[1:, :] = pages[1:, ::-1]  # rows see their pages in other orders
        pages[2] = np.where(np.arange(n_pg) < 3, pages[2], 0)
    else:
        ck = rng.randn(B, 16, KV, dh).astype(np.float32)
        pages = None
    cv = ck[::-1].copy() * 0.5
    jout, jk, jv = jlayers.attention_prefill_chunk(
        _layer0(jp["layers"]["attn"]), cfg_j, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos0), pages=None if pages is None else jnp.asarray(pages))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tpos = torch.from_numpy(pos0).long() if isinstance(pos0, np.ndarray) else pos0
    tout, rk, rv = tlayers.attention_prefill_chunk(
        {n: w[0] for n, w in tp["layers"]["attn"].items()}, cfg_t, torch.from_numpy(x), tk, tv,
        tpos, pages=None if pages is None else torch.from_numpy(pages))
    assert rk is tk and rv is tv  # written in place
    tol = TOL["float32"]
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **tol)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_chunk_matches_repro_and_whole_prompt(dtype):
    """A 10-token prompt through three chunks of 4 (the last one padded)
    into a zero (L, 1, 16, KV, dh) cache: the caches and every chunk's
    top-k equal repro's (bf16 under strict rounding), and the last chunk's
    ids equal the whole-prompt prefill's."""
    jb, jp, jt, tb, tp, tt = _models(dtype)
    tol = TOL[dtype]
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    prompt = np.random.RandomState(5).randint(0, 256, 10).astype(np.int32)
    L, KV, dh = tb.cfg.n_layers, tb.cfg.n_kv_heads, tb.cfg.hd
    zeros = np.zeros((L, 1, 16, KV, dh), np.float32)
    jcache = JDecodeCache(k=jnp.asarray(zeros).astype(jb.cfg.jdtype),
                          v=jnp.asarray(zeros).astype(jb.cfg.jdtype))
    tcache = TDecodeCache(k=torch.zeros(zeros.shape, dtype=tb.cfg.jdtype),
                          v=torch.zeros(zeros.shape, dtype=tb.cfg.jdtype))
    chunk = jax.jit(lambda p, t, c, toks, lo, nv: jb.prefill_chunk(p, t, c, toks, lo, nv,
                                                                   kernel="jnp"),
                    compiler_options={"xla_allow_excess_precision": False})
    for lo in range(0, 10, 4):
        buf = np.zeros((1, 4), np.int32)
        tail = prompt[lo: lo + 4]
        buf[0, : len(tail)] = tail
        jv, ji, jcache = chunk(jp, jt, jcache, jnp.asarray(buf), lo, len(tail))
        tv, ti, tcache = tb.prefill_chunk(tp, tt, tcache, torch.from_numpy(buf).long(), lo,
                                          len(tail), kernel="jnp")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **HEAD_TOL)
    for a, b in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        np.testing.assert_allclose(a.float().numpy(), f32(b), **tol)
    # the last chunk again with a per-row n_valid tensor: same head output
    again = TDecodeCache(k=tcache.k.clone(), v=tcache.v.clone())
    tv2, ti2, _ = tb.prefill_chunk(tp, tt, again, torch.from_numpy(buf).long(), lo,
                                   torch.tensor([len(tail)]), kernel="jnp")
    assert torch.equal(ti2, ti) and torch.equal(tv2, tv)
    _, whole_ids, _ = tb.prefill(tp, tt, {"tokens": torch.from_numpy(prompt[None]).long()},
                                 kernel="jnp")
    np.testing.assert_array_equal(ti.numpy(), whole_ids.numpy())
