"""Port parity: ``repro_torch.optim`` (Adam as ``repro`` writes it, global-
norm clipping, the three schedules) against ``repro.optim`` on identical
numpy inputs.

Tolerances: Adam's new params and moments fp32 rtol 1e-6, atol 1e-7 on
identical gradients (the same fp32 formula; a first step is ≈ lr·sign(g),
so the gradients fed in are the same arrays, not recomputed); bf16 params
within one bf16 ulp (the fp32 updates agree to ~1e-7 relative, and a
value that lands within that of a rounding boundary may round either
way); the clip scale and norm rtol 1e-6; the schedules rtol 1e-6 (fp32
``cos`` against XLA's), plus atol 1e-7·lr for the cosine's tail, where
``1 + cos`` near π cancels and a one-ulp difference in ``cos`` is a large
relative one in the result).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adam_init as jadam_init
from repro.optim import adam_update as jadam_update
from repro.optim import clip_by_global_norm as jclip
from repro.optim import make_schedule as jmake_schedule
from repro_torch.convert import to_tensor
from repro_torch.optim import OptState, adam_init, adam_update, clip_by_global_norm, make_schedule
from repro_torch.utils import flatten_dict, tree_global_norm, unflatten_dict

TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return {"a": {"w": rng.randn(5, 7).astype(dtype), "b": rng.randn(7).astype(dtype)},
            "head": {"gate": rng.randn(3, 7).astype(dtype)}}


def _to_torch(tree, dtype=None):
    out = {k: torch.from_numpy(np.array(v)) for k, v in flatten_dict(tree).items()}
    if dtype is not None:
        out = {k: v.to(dtype) for k, v in out.items()}
    return unflatten_dict(out)


def _np_tree(tree):
    return {k: (v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32))
            for k, v in flatten_dict(tree).items()}


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adam_update_matches_repro_over_steps(weight_decay):
    params = _tree(0)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    jst, tst = jadam_init(jp), adam_init(tp)
    for step in range(4):
        grads = _tree(10 + step)
        grads["a"]["w"] *= 10.0 ** (-step)   # small gradients amplify ε's placement
        lr = 1e-2 * (step + 1)
        jp, jst = jadam_update(jp, jax.tree.map(jnp.asarray, grads), jst, lr, b1=0.9, b2=0.95,
                               eps=1e-8, weight_decay=weight_decay)
        tp, tst = adam_update(tp, _to_torch(grads), tst, lr, b1=0.9, b2=0.95, eps=1e-8,
                              weight_decay=weight_decay)
        for a, b in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v)):
            ta, jb = _np_tree(a), _np_tree(jax.tree.map(np.asarray, b))
            for k in jb:
                np.testing.assert_allclose(ta[k], jb[k], **TOL, err_msg=f"step {step} {k}")
        assert int(tst.step) == int(jst.step) == step + 1
        assert tst.step.dtype == torch.int32


def test_adam_update_is_functional_and_casts_back():
    params = _to_torch(_tree(1), torch.bfloat16)
    before = {k: v.clone() for k, v in flatten_dict(params).items()}
    st = adam_init(params)
    assert all(v.dtype == torch.float32 for v in flatten_dict(st.m).values())
    new, st2 = adam_update(params, _to_torch(_tree(2), torch.bfloat16), st, torch.tensor(1e-3))
    for k, v in flatten_dict(params).items():  # the inputs are untouched
        assert torch.equal(v, before[k])
    assert int(st.step) == 0 and all(float(m.abs().sum()) == 0 for m in flatten_dict(st.m).values())
    assert all(v.dtype == torch.bfloat16 for v in flatten_dict(new).values())
    assert all(v.dtype == torch.float32 for v in flatten_dict(st2.v).values())


def test_adam_update_bf16_params_match_repro():
    """bf16 params, fp32 moments: the update runs in fp32 and casts back."""
    import ml_dtypes

    params = _tree(3)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params)
    tp = _to_torch(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp), torch.bfloat16)
    grads = _tree(4)
    jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), grads)
    tg = unflatten_dict({k: to_tensor(np.asarray(v).astype(ml_dtypes.bfloat16), "cpu")
                         for k, v in flatten_dict(jax.tree.map(np.asarray, jg)).items()})
    jp2, _ = jadam_update(jp, jg, jadam_init(jp), 3e-3)
    tp2, _ = adam_update(tp, tg, adam_init(tp), 3e-3)
    ta, jb = _np_tree(tp2), _np_tree(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp2))
    for k in jb:
        ulp = np.abs(jb[k]) * 2.0 ** -7 + 1e-30
        assert (np.abs(ta[k] - jb[k]) <= ulp).all(), k


@pytest.mark.parametrize("max_norm", [0.5, 1e9])
def test_clip_by_global_norm_matches_repro(max_norm):
    grads = _tree(5)
    jg, jn = jclip(jax.tree.map(jnp.asarray, grads), max_norm)
    tg, tn = clip_by_global_norm(_to_torch(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(tree_global_norm(_to_torch(grads))), float(jn), rtol=1e-6)
    ta, jb = _np_tree(tg), _np_tree(jax.tree.map(np.asarray, jg))
    for k in jb:
        np.testing.assert_allclose(ta[k], jb[k], **TOL)
    if max_norm < float(jn):
        np.testing.assert_allclose(float(tree_global_norm(tg)), max_norm, rtol=1e-5)


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
def test_schedules_match_repro(kind):
    js, ts = jmake_schedule(kind, 3e-4, 10, 50), make_schedule(kind, 3e-4, 10, 50)
    for step in (0, 1, 5, 9, 10, 11, 30, 49, 50, 70):
        want = float(js(step))
        tol = dict(rtol=1e-6, atol=1e-7 * 3e-4)
        np.testing.assert_allclose(float(ts(step)), want, **tol, err_msg=str(step))
        np.testing.assert_allclose(float(ts(torch.tensor(step, dtype=torch.int32))), want, **tol)
    with pytest.raises(ValueError):
        make_schedule("bogus", 1.0, 1, 2)


def test_opt_state_fields():
    assert OptState._fields == ("step", "m", "v")
