"""Port parity: the dense configs llama3.2-3b, granite-20b and deepseek-67b,
the moe configs olmoe-1b-7b and qwen3-moe-235b-a22b, the vlm config
internvl2-26b, the state configs mamba2-130m (ssm) and zamba2-7b (hybrid)
and the encdec configs whisper-base and paper-envi (``repro_torch.configs``)
against ``repro.configs``, and the shape check of
``convert.params_from_jax``.

* ``get_config`` gives each config with ``repro``'s field values (every
  field the port's ``ModelConfig`` has; the nested ``ds``, ``moe`` and
  ``vision`` configs field by field).
* ``reduce_config`` of each builds a model whose whole-prompt prefill and
  two decode steps at per-row positions give ``repro``'s ids, with values
  within rtol 1e-6, atol 2e-6 (``tests/test_kernels.py:103``), in fp32 on
  the same JAX-initialized weights. granite-20b runs the gelu MLP (no gate)
  and one kv head; the moe configs their MoE FFN (4 experts, top-2);
  internvl2-26b a text-only prompt (its patches: ``test_torch_vlm.py``).
* ``convert.check_shapes`` accepts each config's full-width shape set
  (zero-stride numpy views, no memory), and refuses a swiglu tree without
  its FFN gate (``layers/mlp/w_gate``, or ``layers/moe/w_gate`` for an MoE
  block) or with one of the wrong shape, a gelu tree with a gate, and an
  MLP in a moe tree or an MoE block in another; for the state configs a
  wrong ``layers/mamba/in_zx`` and a transformer layer in their tree; for
  the encdec configs a wrong leaf of each stack, a missing final norm and
  a decoder-only leaf in their tree. (Model parity:
  ``tests/test_torch_hybrid.py``, ``tests/test_torch_encdec.py``.)
"""
import dataclasses
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
from repro.models.transformer import DecodeCache as JDecodeCache
from repro_torch import configs
from repro_torch.convert import MASK_KEY, _expected_shapes, check_shapes, flatten_paths, \
    params_from_jax, to_tensor
from repro_torch.core import dssoftmax as ds
from repro_torch.models import build
from repro_torch.models.transformer import DecodeCache

ARCHS = ("llama3.2-3b", "granite-20b", "deepseek-67b", "olmoe-1b-7b", "qwen3-moe-235b-a22b",
         "internvl2-26b")
STATE_ARCHS = ("mamba2-130m", "zamba2-7b")
ENCDEC_ARCHS = ("whisper-base", "paper-envi")
NESTED = ("ds", "moe", "vision")
HEAD_TOL = dict(rtol=1e-6, atol=2e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and beside other
    test processes torch's default pool makes each small op wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS + STATE_ARCHS + ENCDEC_ARCHS)
def test_get_config_equals_repro(arch):
    mine, ref = configs.get_config(arch), jget_config(arch)
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if f.name in NESTED and a is not None:
            # two dataclasses of different classes never compare equal
            assert b is not None, (arch, f.name)
            assert {g.name for g in dataclasses.fields(a)} <= {g.name for g in
                                                               dataclasses.fields(b)}
            for g in dataclasses.fields(a):
                assert getattr(a, g.name) == getattr(b, g.name), (arch, f.name, g.name)
        else:
            assert a == b, (arch, f.name)
    if mine.moe is not None:  # every field of repro's, none left out
        assert {g.name for g in dataclasses.fields(mine.moe)} == {
            g.name for g in dataclasses.fields(ref.moe)}
    assert mine.padded_vocab == ref.padded_vocab and mine.hd == ref.hd
    assert mine.d_inner == ref.d_inner and mine.ssm_nheads == ref.ssm_nheads
    red = configs.reduce_config(mine, vocab=256)
    jred = jreduce_config(ref, vocab=256)
    if arch in STATE_ARCHS + ENCDEC_ARCHS:
        for f in dataclasses.fields(red):
            if f.name not in NESTED:
                assert getattr(red, f.name) == getattr(jred, f.name), (arch, f.name)
    else:
        assert (red.n_layers, red.d_model, red.n_heads, red.n_kv_heads, red.act,
                red.tie_embeddings) == (2, 64, 4, min(mine.n_kv_heads, 2), mine.act,
                                        mine.tie_embeddings)
    for name in ("moe", "vision"):
        a, b = getattr(red, name), getattr(jred, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b), (arch, name)


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jreduce_config(jget_config(arch), vocab=256).replace(dtype="float32")
    tcfg = configs.reduce_config(configs.get_config(arch), vocab=256).replace(dtype="float32")
    jb = jbuild(jcfg)
    params, state = jb.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    mask = np.asarray(state.mask) & (rng.rand(*state.mask.shape) < 0.6)
    mask[rng.randint(0, mask.shape[0], mask.shape[1]), np.arange(mask.shape[1])] = True
    state = jds.DSState(mask=jnp.asarray(mask))
    tree = flatten_paths(jax.tree.map(np.asarray, params))
    tree[MASK_KEY] = mask
    tparams, tstate = params_from_jax(tree, tcfg, device="cpu")
    return (jb, params, jds.pack_experts(params["head"], state),
            build(tcfg, device="cpu"), tparams, ds.pack_experts(tparams["head"], tstate))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_prefill_and_decode_match_repro(arch):
    jb, jp, jt, tb, tp, tt = _models(arch)
    ffn = "moe" if tb.cfg.moe is not None else "mlp"
    assert set(tp["layers"]) == {"ln1", "attn", "ln2", ffn}
    assert ("w_gate" in tp["layers"][ffn]) == (tb.cfg.act == "swiglu")
    rng = np.random.RandomState(1)
    B, S = 3, 9
    tokens = rng.randint(0, 256, (B, S)).astype(np.int32)
    jv, ji, jc = jax.jit(lambda p, t, b: jb.prefill(p, t, b, kernel="jnp"))(
        jp, jt, {"tokens": jnp.asarray(tokens)})
    tv, ti, tc = tb.prefill(tp, tt, {"tokens": torch.from_numpy(tokens).long()}, kernel="jnp")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **HEAD_TOL)
    grow = lambda c: jnp.concatenate([c, jnp.zeros(c.shape[:2] + (4,) + c.shape[3:], c.dtype)],
                                     axis=2)
    jcache = JDecodeCache(k=grow(jc.k), v=grow(jc.v))
    tcache = DecodeCache(k=to_tensor(np.asarray(jcache.k), "cpu"),
                         v=to_tensor(np.asarray(jcache.v), "cpu"))
    dec = jax.jit(lambda p, t, c, tok, pos: jb.decode_step(p, t, c, tok, pos, kernel="jnp"))
    tok = np.asarray(ji[:, 0])
    pos = np.array([S, S - 2, S - 5], np.int32)
    for step in range(2):
        jv, ji, jcache = dec(jp, jt, jcache, jnp.asarray(tok), jnp.asarray(pos + step))
        tv, ti, tcache = tb.decode_step(tp, tt, tcache, torch.tensor(tok, dtype=torch.long),
                                        torch.from_numpy(pos + step).long(), kernel="jnp")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **HEAD_TOL)
        for a, b in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
        tok = np.asarray(ji[:, 0])


def _zero_views(cfg, act=None):
    """Every leaf the config needs at full width as a zero-stride view."""
    shapes = _expected_shapes(cfg if act is None else cfg.replace(act=act))
    return {p: np.broadcast_to(np.zeros((), bool if p == MASK_KEY else np.float32), s)
            for p, s in shapes.items()}


@pytest.mark.parametrize("arch", ("qwen2-1.5b",) + ARCHS)
def test_check_shapes_takes_the_full_width_set(arch):
    cfg = configs.get_config(arch)
    tree = _zero_views(cfg)
    check_shapes(tree, cfg)
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    gate = "layers/moe/w_gate" if cfg.moe is not None else "layers/mlp/w_gate"
    assert (gate in tree) == (cfg.act == "swiglu")
    assert tree["head/experts"].shape == (cfg.ds.num_experts, cfg.padded_vocab, d)
    if cfg.moe is not None:
        E, f = cfg.moe.num_experts, cfg.moe.d_ff_expert
        assert tree["layers/moe/router"].shape == (L, d, E)
        assert tree[gate].shape == (L, E, d, f) and tree["layers/moe/w_down"].shape == (L, E, f, d)
        assert not any(p.startswith("layers/mlp/") for p in tree)
        wrong = np.broadcast_to(np.float32(0), (L, E, f, d))
        mlp = dict(tree, **{"layers/mlp/w_up": np.broadcast_to(np.float32(0), (L, d, ff))})
        with pytest.raises(ValueError, match="layers/mlp/w_up"):
            check_shapes(mlp, cfg)
    else:
        wrong = np.broadcast_to(np.float32(0), (L, ff, d))
        stray = dict(tree, **{"layers/moe/router": np.broadcast_to(np.float32(0), (L, d, 4))})
        with pytest.raises(ValueError, match="layers/moe/router"):
            check_shapes(stray, cfg)
    if cfg.act == "swiglu":
        gateless = {p: a for p, a in tree.items() if p != gate}
        with pytest.raises(KeyError, match=gate):
            check_shapes(gateless, cfg)
        with pytest.raises(KeyError, match=gate):
            params_from_jax(gateless, cfg, device="cpu")
        bad = dict(tree, **{gate: wrong})
        with pytest.raises(ValueError, match=gate):
            check_shapes(bad, cfg)
        with pytest.raises(ValueError, match=gate):
            params_from_jax(bad, cfg, device="cpu")
    else:
        gated = _zero_views(cfg, act="swiglu")
        with pytest.raises(ValueError, match="w_gate"):
            check_shapes(gated, cfg)


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_check_shapes_takes_the_state_full_width_set(arch):
    """The full-width leaves of an ssm or hybrid config (zamba2-7b: 81
    stacked Mamba2 blocks and one shared attention+MLP block); a wrong
    ``layers/mamba/in_zx`` raises naming it, as does a transformer layer's
    leaf in the tree or, for the pure ssm, a shared block."""
    cfg = configs.get_config(arch)
    tree = _zero_views(cfg)
    check_shapes(tree, cfg)
    L, d, di = cfg.n_layers, cfg.d_model, cfg.d_inner
    assert tree["layers/mamba/in_zx"].shape == (L, d, 2 * di)
    assert tree["layers/mamba/out_proj"].shape == (L, di, d)
    assert tree["layers/mamba/conv_w"].shape == (L, 4, di + 2 * cfg.ssm_state)
    assert ("shared_attn/attn/wq" in tree) == (cfg.family == "hybrid")
    if cfg.family == "hybrid":
        assert tree["shared_attn/attn/wq"].shape == (d, 3584) and cfg.hd == 112
        assert tree["shared_attn/mlp/w_gate"].shape == (d, cfg.d_ff)
    assert not any(p.startswith("layers/attn/") for p in tree)
    bad = dict(tree, **{"layers/mamba/in_zx": np.broadcast_to(np.float32(0), (L, d, di))})
    with pytest.raises(ValueError, match="layers/mamba/in_zx"):
        check_shapes(bad, cfg)
    with pytest.raises(ValueError, match="layers/mamba/in_zx"):
        params_from_jax(bad, cfg, device="cpu")
    with pytest.raises(KeyError, match="layers/mamba/A_log"):
        check_shapes({p: a for p, a in tree.items() if p != "layers/mamba/A_log"}, cfg)
    stray = dict(tree, **{"layers/attn/wq": np.broadcast_to(np.float32(0), (L, d, d))})
    with pytest.raises(ValueError, match="layers/attn/wq"):
        check_shapes(stray, cfg)
    dense = configs.get_config("llama3.2-3b")
    with pytest.raises(ValueError, match="layers/mamba/in_zx"):
        check_shapes(dict(_zero_views(dense), **{"layers/mamba/in_zx": tree["layers/mamba/in_zx"]}),
                     dense)


@pytest.mark.parametrize("arch", ENCDEC_ARCHS)
def test_check_shapes_takes_the_encdec_full_width_set(arch):
    """The full-width leaves of an encdec config (whisper-base: 6 encoder
    and 6 decoder layers, the 32,768 learned decoder positions); a wrong
    leaf of each stack raises naming it, as do a missing final norm and a
    decoder-only model's ``layers/…`` or ``final_norm/…`` in the tree; an
    MLP gate where the config has none (whisper-base's gelu), or none where
    it has one (paper-envi's swiglu)."""
    from repro_torch.models.model_zoo import MAX_TARGET_LEN

    cfg = configs.get_config(arch)
    tree = _zero_views(cfg)
    check_shapes(tree, cfg)
    Le, Ld, d, ff = cfg.n_encoder_layers, cfg.n_layers, cfg.d_model, cfg.d_ff
    assert tree["pos_embed"].shape == (MAX_TARGET_LEN, d)
    assert tree["enc_layers/attn/wq"].shape == (Le, d, cfg.n_heads * cfg.hd)
    assert tree["dec_layers/cross_attn/wk"].shape == (Ld, d, cfg.n_kv_heads * cfg.hd)
    assert tree["dec_layers/ln_x/bias"].shape == (Ld, d) and tree["enc_norm/scale"].shape == (d,)
    assert not any(p.startswith(("layers/", "final_norm/")) for p in tree)
    for stack in ("enc_layers", "dec_layers"):
        assert (f"{stack}/mlp/w_gate" in tree) == (cfg.act == "swiglu")
    for leaf, shape in (("enc_layers/mlp/w_up", (Le, d, ff + 1)),
                        ("dec_layers/self_attn/wo", (Ld, 2 * d, d)),
                        ("pos_embed", (448, d))):
        with pytest.raises(ValueError, match=leaf):
            check_shapes(dict(tree, **{leaf: np.broadcast_to(np.float32(0), shape)}), cfg)
    with pytest.raises(KeyError, match="dec_norm/scale"):
        check_shapes({p: a for p, a in tree.items() if p != "dec_norm/scale"}, cfg)
    with pytest.raises(ValueError, match="layers/attn/wq"):
        check_shapes(dict(tree, **{"layers/attn/wq": tree["enc_layers/attn/wq"]}), cfg)
    if cfg.act == "swiglu":  # paper-envi
        with pytest.raises(KeyError, match="dec_layers/mlp/w_gate"):
            check_shapes({p: a for p, a in tree.items() if p != "dec_layers/mlp/w_gate"}, cfg)
    else:  # whisper-base
        with pytest.raises(ValueError, match="w_gate"):
            check_shapes(_zero_views(cfg, act="swiglu"), cfg)
