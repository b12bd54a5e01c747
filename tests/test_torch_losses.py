"""Port parity: the DS-Softmax training losses (``repro_torch.core.losses``,
``gating.sparse_gate_matrix``, ``dssoftmax.loss``/``loss_rows``/
``total_loss``, ``pruning.prune_step``) against ``repro`` on the same
seeded numpy inputs, values and gradients (``jax.grad`` against
``torch.autograd``).

Tolerances (fp32 throughout): values and gradients rtol 1e-5, atol 1e-6 —
the two sides sum in different orders (XLA's dot against torch's matmul,
``logsumexp`` and ``sqrt`` library ulps), so bit equality is not promised;
masks, expert ids and dispatch slots must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DSSoftmaxConfig as JDSConfig
from repro.core import dssoftmax as jds
from repro.core import gating as jgating
from repro.core import losses as jlosses
from repro.core import pruning as jpruning
from repro_torch.configs.base import DSSoftmaxConfig
from repro_torch.core import dssoftmax as ds
from repro_torch.core import gating, losses, pruning

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and with several
    test processes on the host torch's default thread pool (one thread per
    core in each process) makes each small op wait on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _leaf(a):
    return torch.tensor(a, requires_grad=True)


def _experts(seed=0, K=4, N=40, d=16, small_rows=()):
    rng = np.random.RandomState(seed)
    w = (rng.randn(K, N, d) / np.sqrt(d)).astype(np.float32)
    for k, n in small_rows:
        w[k, n] *= 1e-4
    mask = rng.rand(K, N) < 0.8
    for k, n in small_rows:
        mask[k, n] = True
    return w, mask


def test_row_norms_group_and_expert_lasso_values_and_grads():
    w, mask = _experts(small_rows=[(0, 1), (2, 5)])
    gamma = 0.05
    tw = _leaf(w)
    for jf, tf in ((lambda a: jnp.sum(jlosses.row_norms(a, jnp.asarray(mask)) * 0.5),
                    lambda a: torch.sum(losses.row_norms(a, torch.from_numpy(mask)) * 0.5)),
                   (lambda a: jlosses.group_lasso(a, jnp.asarray(mask), gamma),
                    lambda a: losses.group_lasso(a, torch.from_numpy(mask), gamma)),
                   (lambda a: jlosses.expert_lasso(a, jnp.asarray(mask)),
                    lambda a: losses.expert_lasso(a, torch.from_numpy(mask)))):
        jv, jg = jax.value_and_grad(jf)(jnp.asarray(w))
        tv = tf(tw)
        (tg,) = torch.autograd.grad(tv, tw)
        np.testing.assert_allclose(_np(tv), np.asarray(jv), **TOL)
        np.testing.assert_allclose(_np(tg), np.asarray(jg), **TOL)
    # the threshold excludes rows under gamma: the small rows add nothing
    norms = losses.row_norms(torch.from_numpy(w), torch.from_numpy(mask))
    assert mask[0, 1] and mask[2, 5]
    assert float(norms[0, 1]) < gamma and float(norms[2, 5]) < gamma
    # a masked row's norm is sqrt(1e-12), and its gradient finite
    np.testing.assert_allclose(_np(norms)[~mask], 1e-6, rtol=1e-5)


def test_cv_squared_and_load_balance():
    rng = np.random.RandomState(1)
    x = rng.rand(6).astype(np.float32)
    tx = _leaf(x)
    jv, jg = jax.value_and_grad(jlosses.load_balance)(jnp.asarray(x))
    tv = losses.load_balance(tx)
    (tg,) = torch.autograd.grad(tv, tx)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), **TOL)
    np.testing.assert_allclose(_np(tg), np.asarray(jg), **TOL)
    batch = rng.rand(3, 5).astype(np.float32)
    np.testing.assert_allclose(_np(losses.cv_squared(torch.from_numpy(batch))),
                               np.asarray(jlosses.cv_squared(jnp.asarray(batch))), **TOL)


def test_sparse_gate_matrix_ties_and_gradient():
    G = np.array([[0.2, 0.5, 0.3, 0.0],
                  [0.4, 0.1, 0.4, 0.1],      # tie: the lowest index keeps it
                  [0.25, 0.25, 0.25, 0.25]], np.float32)
    w = np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0
    out = gating.sparse_gate_matrix(torch.from_numpy(G))
    np.testing.assert_array_equal(_np(out), np.asarray(jgating.sparse_gate_matrix(jnp.asarray(G))))
    np.testing.assert_array_equal((_np(out) != 0).argmax(1), [1, 0, 0])
    assert ((_np(out) != 0).sum(1) == 1).all()
    # G gets the gradient through the kept entry only; the mask gets none
    jg = jax.grad(lambda a: jnp.sum(jgating.sparse_gate_matrix(a) * w))(jnp.asarray(G))
    tG = _leaf(G)
    (tg,) = torch.autograd.grad(torch.sum(gating.sparse_gate_matrix(tG) * torch.from_numpy(w)),
                                tG)
    np.testing.assert_array_equal(_np(tg), np.asarray(jg))


def _head(seed, K=4, N=48, d=16, T=40, dtype=np.float32):
    rng = np.random.RandomState(seed)
    gate = (rng.randn(K, d) / np.sqrt(d)).astype(dtype)
    experts = (rng.randn(K, N, d) / np.sqrt(d)).astype(dtype)
    mask = rng.rand(K, N) < 0.7
    mask[rng.randint(0, K, N), np.arange(N)] = True
    h = rng.randn(T, d).astype(dtype)
    labels = rng.randint(0, N, T).astype(np.int32)
    return gate, experts, mask, h, labels


CFGS = {"zero": dict(mask_mode="zero", gamma=0.05),
        "neg_inf": dict(mask_mode="neg_inf", gamma=0.05)}


def _loss_pair(fn_j, fn_t, gate, experts, mask, h):
    """Values and gradients (gate, experts, h) of a scalar loss, both sides."""
    jv, jg = jax.jit(jax.value_and_grad(fn_j, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(gate), jnp.asarray(experts), jnp.asarray(h))
    leaves = [_leaf(a) for a in (gate, experts, h)]
    tv = fn_t(*leaves)
    tg = torch.autograd.grad(tv[0], leaves)
    return jv, jg, tv, tg


@pytest.mark.parametrize("mode", sorted(CFGS))
@pytest.mark.parametrize("dispatch,cf", [("dense", 2.0), ("sorted", 2.0), ("sorted", 0.5)])
def test_loss_matches_repro(mode, dispatch, cf):
    gate, experts, mask, h, labels = _head(2)
    jcfg, tcfg = JDSConfig(**CFGS[mode]), DSSoftmaxConfig(**CFGS[mode])
    jm, tm = jds.DSState(mask=jnp.asarray(mask)), ds.DSState(mask=torch.from_numpy(mask))

    def fj(g, e, hh):
        full, (ce, aux) = jds.total_loss({"gate": g, "experts": e}, jm, hh, jnp.asarray(labels),
                                         jcfg, dispatch=dispatch, capacity_factor=cf)
        return full, (ce, aux)

    def ft(g, e, hh):
        return ds.total_loss({"gate": g, "experts": e}, tm, hh, torch.from_numpy(labels), tcfg,
                             dispatch=dispatch, capacity_factor=cf)

    (jfull, (jce, jaux)), jg, (tfull, (tce, taux)), tg = _loss_pair(fj, ft, gate, experts, mask, h)
    np.testing.assert_allclose(_np(tfull), np.asarray(jfull), **TOL)
    np.testing.assert_allclose(_np(tce), np.asarray(jce), **TOL)
    for f in jds.DSAux._fields:
        np.testing.assert_allclose(_np(getattr(taux, f)), np.asarray(getattr(jaux, f)), **TOL,
                                   err_msg=f)
    if cf < 1:  # the small capacity overflows: tokens are dropped
        assert float(taux.drop_frac) > 0.1
    for a, b, name in zip(tg, jg, ("gate", "experts", "h")):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL, err_msg=name)


@pytest.mark.parametrize("S,with_label_mask", [(16, False), (64, False), (64, True),
                                               (256, False)])
def test_loss_rows_matches_repro(S, with_label_mask):
    """One expert at a time: S 16 at K 4 gives capacity 5 and S 64 capacity
    20 (one chunk an expert); S 256 capacity 80 (two chunks an expert,
    under checkpoint)."""
    B, K, N, d = 3, 4, 48, 16
    gate, experts, mask, _, _ = _head(4, K=K, N=N, d=d)
    rng = np.random.RandomState(5)
    h = rng.randn(B, S, d).astype(np.float32)
    labels = rng.randint(0, N, (B, S)).astype(np.int32)
    lm = (rng.rand(B, S) < 0.7) if with_label_mask else None
    cfg = dict(mask_mode="zero", gamma=0.05)
    jcfg, tcfg = JDSConfig(**cfg), DSSoftmaxConfig(**cfg)
    jm, tm = jds.DSState(mask=jnp.asarray(mask)), ds.DSState(mask=torch.from_numpy(mask))

    def fj(g, e, hh):
        ce, aux = jds.loss_rows({"gate": g, "experts": e}, jm, hh, jnp.asarray(labels), jcfg,
                                label_mask=None if lm is None else jnp.asarray(lm))
        return ce + 0.5 * aux.lasso + 0.25 * aux.expert_lasso + 2.0 * aux.load, (ce, aux)

    def ft(g, e, hh):
        ce, aux = ds.loss_rows({"gate": g, "experts": e}, tm, hh, torch.from_numpy(labels), tcfg,
                               label_mask=None if lm is None else torch.from_numpy(lm))
        return ce + 0.5 * aux.lasso + 0.25 * aux.expert_lasso + 2.0 * aux.load, (ce, aux)

    (jt, (jce, jaux)), jg, (tt, (tce, taux)), tg = _loss_pair(fj, ft, gate, experts, mask, h)
    np.testing.assert_allclose(_np(tt), np.asarray(jt), **TOL)
    np.testing.assert_allclose(_np(tce), np.asarray(jce), **TOL)
    for f in jds.DSAux._fields:
        np.testing.assert_allclose(_np(getattr(taux, f)), np.asarray(getattr(jaux, f)), **TOL,
                                   err_msg=f)
    for a, b, name in zip(tg, jg, ("gate", "experts", "h")):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL, err_msg=name)


@pytest.mark.parametrize("task_loss,threshold", [(1.0, 2.0), (3.0, 2.0), (1.0, float("inf"))])
def test_prune_step_matches_repro(task_loss, threshold):
    """Rows under gamma go when the task loss is under the threshold and
    stay otherwise; a class whose every alive row falls under gamma keeps
    its largest (keep-one-copy); a never-alive column stays dead."""
    w, mask = _experts(seed=6, small_rows=[(0, 3), (1, 3), (2, 3), (3, 3), (1, 7)])
    mask[:, 3] = True
    mask[:, 9] = False
    gamma = 0.05
    jm = jpruning.prune_step(jnp.asarray(w), jnp.asarray(mask), jnp.float32(task_loss),
                             gamma=gamma, threshold=threshold)
    tm = pruning.prune_step(torch.from_numpy(w), torch.from_numpy(mask),
                            torch.tensor(task_loss), gamma=gamma, threshold=threshold)
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    if task_loss < threshold:
        assert _np(tm)[:, 3].sum() == 1 and not _np(tm)[1, 7]
    else:
        np.testing.assert_array_equal(_np(tm), mask)
    assert not _np(tm)[:, 9].any()
    # update_mask reads the config's gamma and threshold
    cfg = DSSoftmaxConfig(gamma=gamma, prune_task_loss_threshold=threshold)
    st = ds.update_mask({"experts": torch.from_numpy(w)}, ds.DSState(mask=torch.from_numpy(mask)),
                        torch.tensor(task_loss), cfg)
    np.testing.assert_array_equal(_np(st.mask), np.asarray(jm))


def test_logits_dense_and_serve_full_probs_match_repro():
    gate, experts, mask, h, _ = _head(7)
    jcfg = JDSConfig()
    jz, (je, jgv, jG) = jds.logits_dense({"gate": jnp.asarray(gate),
                                          "experts": jnp.asarray(experts)},
                                         jds.DSState(mask=jnp.asarray(mask)), jnp.asarray(h), jcfg)
    tp = {"gate": torch.from_numpy(gate), "experts": torch.from_numpy(experts)}
    tz, (te, tgv, tG) = ds.logits_dense(tp, ds.DSState(mask=torch.from_numpy(mask)),
                                        torch.from_numpy(h), DSSoftmaxConfig())
    np.testing.assert_allclose(_np(tz), np.asarray(jz), **TOL)
    np.testing.assert_array_equal(_np(te), np.asarray(je))
    jt = jds.pack_experts({"gate": jnp.asarray(gate), "experts": jnp.asarray(experts)},
                          jds.DSState(mask=jnp.asarray(mask)))
    tt = ds.pack_experts(tp, ds.DSState(mask=torch.from_numpy(mask)))
    jprob = jds.serve_full_probs(jnp.asarray(gate), jt, jnp.asarray(h), 48)
    tprob = ds.serve_full_probs(torch.from_numpy(gate), tt, torch.from_numpy(h), 48)
    np.testing.assert_allclose(_np(tprob), np.asarray(jprob), **TOL)
    np.testing.assert_allclose(_np(tprob).sum(1), 1.0, rtol=1e-5)
    assert ds.as_serve_table(type("R", (), {"table": tt})()) is tt and ds.as_serve_table(tt) is tt
