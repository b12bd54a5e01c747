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
