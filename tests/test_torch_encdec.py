"""Port parity: the encdec family (``repro_torch.models.encdec``, the
``layernorm`` and ``cross_attention_block`` of ``models.layers``, the encdec
branches of ``model_zoo``, ``convert``, ``ServeSession`` and
``launch/train.py``) against ``repro`` on the same JAX-initialized weights
(``convert.params_from_jax``), in fp32 unless named.

Models: reduced whisper-base and reduced paper-envi (2 encoder and 2
decoder layers, d 64, H 4, vocab 96, K 4), 6 stub frames.

* ``layernorm``: fp32 within rtol/atol 1e-6; bf16 within one bf16 ulp
  (2^-8 of the value), the two fp32 statistics differing in their last bits.
* ``sinusoidal`` at F 1500, d 512 (whisper-base's frames): ``jnp.power``
  and ``torch.pow`` may part by an fp32 ulp, and the angle reaches ~1,499
  rad, so each element is held to 4 fp32 ulps of its angle (plus 1e-6),
  and after the cast to bf16 (what ``encode`` adds) to one bf16 ulp.
* ``cross_attention_block``, ``encode``: within 1e-5.
* ``prefill``: ids equal, values within rtol 1e-6, atol 2e-6
  (``tests/test_kernels.py:103``), every cache leaf within 1e-5.
* ``decode_step`` with a vector and a scalar ``pos`` over four greedy
  steps, on the prefilled cache zero-padded by ``encdec.pad_self_cache``
  (``repro`` decodes on the same padded cache): tokens equal, values as
  prefill's, the self cache within 1e-5.
* ``train_loss`` within rtol 1e-5 and every gradient leaf against
  ``jax.grad`` within rtol 1e-5 plus 1e-5 of the leaf's largest element,
  with ``remat='layer'`` and ``'none'``.
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
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro_torch import configs
from repro_torch.convert import MASK_KEY, check_shapes, flatten_paths, params_from_jax, to_tensor
from repro_torch.core import dssoftmax as ds
from repro_torch.models import build, encdec, layers
from repro_torch.models.encdec import EncDecCache
from repro_torch.train.train_step import value_and_grad

VOCAB = 96
FRAMES = 6
ARCHS = ("whisper-base", "paper-envi")
HEAD_TOL = dict(rtol=1e-6, atol=2e-6)
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and beside other
    test processes torch's default pool makes each small op wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(arch, remat="none"):
    jcfg = jreduce_config(jget_config(arch), vocab=VOCAB).replace(dtype="float32", remat=remat)
    tcfg = configs.reduce_config(configs.get_config(arch), vocab=VOCAB).replace(
        dtype="float32", remat=remat)
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


def _batch(seed, B=2, S=5, d=64):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(B, FRAMES, d)).astype(np.float32),
            rng.randint(0, VOCAB, (B, S)).astype(np.int32))


def _close(tcache, jcache, tol=F32):
    for a, b in zip(tcache, jcache):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_repro(dtype):
    rng = np.random.RandomState(0)
    x = (rng.normal(size=(3, 7, 64)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=64).astype(np.float32),
         "bias": rng.normal(size=64).astype(np.float32)}
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(jlayers.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jx)
                      .astype(jnp.float32))
    got = layers.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                           to_tensor(np.asarray(jx), "cpu"))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8, atol=1e-6)


def test_sinusoidal_matches_repro():
    F, d = 1500, 512
    want = np.asarray(jencdec.sinusoidal(F, d))
    got = encdec.sinusoidal(F, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (F, d)
    ang = np.arange(F, dtype=np.float64)[:, None] / 10000.0 ** (2 * np.arange(d // 2) / d)
    ang = np.concatenate([ang, ang], axis=1)
    tol = 4 * np.finfo(np.float32).eps * ang + 1e-6
    assert (np.abs(got.numpy() - want) <= tol).all()
    bf = got.to(torch.bfloat16).float().numpy()
    jbf = np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(bf, jbf, rtol=2.0 ** -8, atol=1e-6)


def test_cross_attention_block_matches_repro():
    (_, jp, _, _), (tb, tp, _, _) = _models("whisper-base")
    rng = np.random.RandomState(2)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    memory = rng.normal(size=(2, FRAMES, 64)).astype(np.float32)
    jca = jax.tree.map(lambda a: a[1], jp["dec_layers"]["cross_attn"])
    tca = {k: v[1] for k, v in tp["dec_layers"]["cross_attn"].items()}
    want = jlayers.cross_attention_block(jca, _models("whisper-base")[0][0].cfg, jnp.asarray(x),
                                         jnp.asarray(memory))
    got = layers.cross_attention_block(tca, tb.cfg, torch.from_numpy(x), torch.from_numpy(memory))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_encode_matches_repro(arch):
    (jb, jp, _, _), (tb, tp, _, _) = _models(arch)
    frames, _ = _batch(1)
    want = jax.jit(lambda p, f: jencdec.encode(p, jb.cfg, f))(jp, jnp.asarray(frames))
    got = encdec.encode(tp, tb.cfg, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _prefill_both(arch, seed=4):
    (jb, jp, _, jt), (tb, tp, _, tt) = _models(arch)
    frames, tokens = _batch(seed)
    jv, ji, jc = jax.jit(lambda p, t, b: jb.prefill(p, t, b, kernel="jnp"))(
        jp, jt, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)})
    tv, ti, tc = tb.prefill(tp, tt, {"frames": torch.from_numpy(frames),
                                     "tokens": torch.from_numpy(tokens).long()}, kernel="jnp")
    return (jv, ji, jc), (tv, ti, tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_repro(arch):
    (jv, ji, jc), (tv, ti, tc) = _prefill_both(arch)
    assert isinstance(tc, EncDecCache)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **HEAD_TOL)
    _close(tc, jc)
    cfg = _models(arch)[1][0].cfg
    assert tuple(tc.self_k.shape) == (cfg.n_layers, 2, 5, cfg.n_kv_heads, cfg.hd)
    assert tuple(tc.cross_k.shape) == (cfg.n_layers, 2, FRAMES, cfg.n_kv_heads, cfg.hd)


@pytest.mark.parametrize("scalar", [False, True], ids=["vector_pos", "scalar_pos"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_repro_on_the_padded_cache(arch, scalar):
    """Four greedy steps from the prompt's end: a vector ``pos`` whose rows
    part (row 1 two positions back), or one scalar ``pos`` for both rows."""
    (jb, jp, _, jt), (tb, tp, _, tt) = _models(arch)
    (_, ji, jc), (_, ti, tc) = _prefill_both(arch)
    S, smax = 5, 12
    tcache = encdec.pad_self_cache(tc, smax)
    pad = lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, smax - S), (0, 0), (0, 0)))
    jcache = jc._replace(self_k=pad(jc.self_k), self_v=pad(jc.self_v))
    _close(tcache, jcache)
    dec = jax.jit(lambda p, t, c, tok, pos: jb.decode_step(p, t, c, tok, pos, kernel="jnp"))
    tok = np.asarray(ji[:, 0])
    pos = np.array([S, S - 2], np.int32)
    for step in range(4):
        if scalar:
            jpos, tpos = jnp.int32(S + step), S + step
        else:
            jpos, tpos = jnp.asarray(pos + step), torch.from_numpy(pos + step).long()
        jv, ji, jcache = dec(jp, jt, jcache, jnp.asarray(tok), jpos)
        tv, ti, tcache = tb.decode_step(tp, tt, tcache, torch.from_numpy(tok).long(), tpos,
                                        kernel="jnp")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **HEAD_TOL)
        _close(tcache, jcache)
        tok = np.asarray(ji[:, 0])


def test_decode_with_stats_and_a_capacity_factor():
    (jb, jp, _, jt), (tb, tp, _, tt) = _models("whisper-base")
    (_, ji, jc), (_, _, tc) = _prefill_both("whisper-base")
    tcache = encdec.pad_self_cache(tc, 8)
    pad = lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, 3), (0, 0), (0, 0)))
    jcache = jc._replace(self_k=pad(jc.self_k), self_v=pad(jc.self_v))
    tok = np.asarray(ji[:, 0])
    jv, ji2, _, jst = jb.decode_step(jp, jt, jcache, jnp.asarray(tok), jnp.int32(5),
                                     kernel="grouped", capacity_factor=0.5, with_stats=True)
    tv, ti2, _, tst = tb.decode_step(tp, tt, tcache, torch.from_numpy(tok).long(), 5,
                                     kernel="cuda_grouped", capacity_factor=0.5,
                                     with_stats=True)
    np.testing.assert_array_equal(ti2.numpy(), np.asarray(ji2))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **HEAD_TOL)
    for key in ("dispatched", "overflow"):
        np.testing.assert_array_equal(tst[key].numpy(), np.asarray(jst[key]))


def test_pad_self_cache():
    (_, _, _), (_, _, tc) = _prefill_both("paper-envi")
    grown = encdec.pad_self_cache(tc, 9)
    assert grown.self_k.shape[2] == 9 and torch.equal(grown.self_k[:, :, :5], tc.self_k)
    assert not grown.self_v[:, :, 5:].any() and grown.cross_k is tc.cross_k
    with pytest.raises(ValueError, match="below"):
        encdec.pad_self_cache(tc, 4)


@pytest.mark.parametrize("remat", ["layer", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_repro(arch, remat):
    (jb, jp, js, _), (tb, tp, ts, _) = _models(arch, remat)
    frames, tokens = _batch(5, S=8)
    jbatch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p, b: jb.train_loss(p, js, b),
                                              has_aux=True))(jp, jbatch)
    (tl, tm), grads = value_and_grad(tb, tp, ts, {"frames": torch.from_numpy(frames),
                                                  "tokens": torch.from_numpy(tokens)})
    assert set(tm) == set(jm)
    for got, want in ((tl, jl), (tm["ce"], jm["ce"])):
        np.testing.assert_allclose(float(got), float(want), **F32)
    jgf = flatten_paths(jax.tree.map(np.asarray, jg))
    for path, want in jgf.items():
        node = grads
        for key in path.split("/"):
            node = node[key]
        big = float(np.abs(want).max())
        np.testing.assert_allclose(node.numpy(), want, rtol=1e-5, atol=1e-5 * big, err_msg=path)


def test_cache_specs_and_seq_axes_match_repro():
    from repro.configs import ShapeConfig as JShapeConfig
    from repro.models.model_zoo import cache_seq_axes as jaxes
    from repro.models.model_zoo import cache_specs as jspecs
    from repro_torch.models.model_zoo import cache_seq_axes, cache_specs

    for arch in configs.ARCHS + ("paper-ptb", "paper-wiki2", "paper-envi", "paper-casia"):
        tcfg, jcfg = configs.get_config(arch), jget_config(arch)
        assert tuple(cache_seq_axes(tcfg)) == tuple(jaxes(jcfg)), arch
        assert type(cache_seq_axes(tcfg))._fields == type(jaxes(jcfg))._fields
        shape = dict(name="s", seq_len=48, global_batch=3, kind="decode")
        for a, b in zip(cache_specs(tcfg, configs.ShapeConfig(**shape)),
                        jspecs(jcfg, JShapeConfig(**shape))):
            assert a.shape == b.shape and str(a.dtype)[6:] == str(b.dtype), arch
    whisper = configs.get_config("whisper-base")
    assert cache_seq_axes(whisper) == EncDecCache(self_k=2, self_v=2, cross_k=-1, cross_v=-1)
    specs = cache_specs(whisper, configs.ShapeConfig("d", 448, 8, "decode"))
    assert specs.cross_k.shape == (6, 8, 1500, 8, 64) and specs.self_v.shape == (6, 8, 448, 8, 64)


def test_refusals_raise_repros_errors():
    """``ServeSession`` refuses an encdec model, and an encdec draft;
    ``paged_cache_specs`` and ``cache_kv_leaves`` have no encdec cache: each
    with ``repro``'s message."""
    from repro.models.model_zoo import cache_kv_leaves as jleaves
    from repro.models.model_zoo import paged_cache_specs as jpaged
    from repro.train.serve import ServeSession as JServeSession
    from repro_torch.models.model_zoo import cache_kv_leaves, paged_cache_specs
    from repro_torch.train import ServeSession

    (jb, jp, _, jt), (tb, tp, _, tt) = _models("whisper-base")

    def message(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    assert message(lambda: ServeSession(tb, tp, tt, n_slots=1, max_seq_len=16, device="cpu")) \
        == message(lambda: JServeSession(jb, jp, jt, n_slots=1, max_seq_len=16))
    jdense, tdense = _dense()
    assert message(lambda: ServeSession(tdense[0], tdense[1], tdense[2], n_slots=1,
                                        max_seq_len=16, device="cpu", draft=(tb, tp, tt))) \
        == message(lambda: JServeSession(jdense[0], jdense[1], jdense[2], n_slots=1,
                                         max_seq_len=16, draft=(jb, jp, jt))) \
        == "the draft model must be a token-only decoder"
    tcfg = configs.get_config("whisper-base")
    jcfg = jget_config("whisper-base")
    assert message(lambda: paged_cache_specs(tcfg, 8, 16)) == message(
        lambda: jpaged(jcfg, 8, 16)) == "no paged cache for family 'encdec'"
    assert message(lambda: cache_kv_leaves(tcfg)) == message(lambda: jleaves(jcfg))
    assert tb.prefill_chunk is None and tb.verify_step is None and tb.verify_hidden is None
    assert tb.commit_block is None and not tb.verify_needs_state_commit


@functools.lru_cache(maxsize=None)
def _dense():
    """A reduced paper-ptb (dense) on the same vocab, as the draft's target."""
    jcfg = jreduce_config(jget_config("paper-ptb"), vocab=VOCAB).replace(dtype="float32")
    tcfg = configs.reduce_config(configs.get_config("paper-ptb"), vocab=VOCAB).replace(
        dtype="float32")
    jb = jbuild(jcfg)
    jp, js = jb.init(jax.random.PRNGKey(1))
    tb = build(tcfg, device="cpu")
    tp, ts = tb.init(torch.Generator().manual_seed(1))
    return ((jb, jp, jds.pack_experts(jp["head"], js)),
            (tb, tp, ds.pack_experts(tp["head"], ts)))


def test_params_from_jax_carries_every_leaf():
    (_, jp, _, _), (tb, tp, _, _) = _models("whisper-base")
    tree = flatten_paths(jax.tree.map(np.asarray, jp))
    got = flatten_paths(tp)
    assert set(got) == set(tree)
    for path, want in tree.items():
        assert np.array_equal(got[path], want), path
    tree[MASK_KEY] = np.ones((4, tb.cfg.padded_vocab), bool)
    bad = dict(tree, **{"dec_layers/cross_attn/wk": tree["dec_layers/cross_attn/wk"][:, :, :-1]})
    with pytest.raises(ValueError, match="dec_layers/cross_attn/wk"):
        params_from_jax(bad, tb.cfg, device="cpu")
    with pytest.raises(KeyError, match="enc_norm/bias"):
        check_shapes({k: v for k, v in tree.items() if k != "enc_norm/bias"}, tb.cfg)
    with pytest.raises(ValueError, match="final_norm/scale"):
        check_shapes({**tree, "final_norm/scale": np.ones(64, np.float32)}, tb.cfg)
    (jb, jp_dense, _), _ = _dense()
    ptb_tree = flatten_paths(jax.tree.map(np.asarray, jp_dense))
    ptb_tree[MASK_KEY] = np.ones((4, VOCAB), bool)
    check_shapes(ptb_tree, jb.cfg)
    with pytest.raises(ValueError, match="pos_embed"):
        check_shapes({**ptb_tree, "pos_embed": tree["pos_embed"]}, jb.cfg)


def test_launch_train_batches_carry_the_frames(tmp_path, monkeypatch):
    """``launch/train.py`` on reduced whisper-base on the CPU: every batch
    carries ``RandomState(i).normal`` frames (B, 8, 64), as ``repro``'s
    launcher makes them, and every step's loss is finite."""
    from repro_torch.launch import train as launch_train
    from repro_torch.train import Trainer

    seen = []
    orig = Trainer._to_device

    def to_device(self, batch):
        seen.append({k: np.asarray(v) for k, v in batch.items()})
        return orig(self, batch)

    monkeypatch.setattr(Trainer, "_to_device", to_device)
    tr = launch_train.main(["--arch", "whisper-base", "--reduced", "--device", "cpu",
                            "--steps", "3", "--batch", "2", "--seq", "8",
                            "--ckpt-dir", str(tmp_path)])
    assert len(tr.metrics_history) == 3 and len(seen) == 3
    for i, b in enumerate(seen):
        assert set(b) == {"tokens", "frames"} and b["tokens"].shape == (2, 9)
        want = np.random.RandomState(i).normal(size=(2, 8, 64)).astype(np.float32)
        assert np.array_equal(b["frames"], want)
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_history)
