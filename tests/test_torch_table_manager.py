"""Port parity: ``lasso_prune``, ``core.pruning`` and
``serve.table_manager`` against ``repro`` on the same numpy-seeded inputs.

- ``kernels.lasso_prune`` (its plain version on CPU tensors) against
  ``repro.kernels.lasso_prune`` in interpret mode and ``ref.lasso_prune_ref``,
  f32 and bf16: norms to rtol 1e-6, atol 1e-6 (fp32 sums of exact squares
  in another order), masks equal. Every threshold sits at the midpoint of
  two adjacent sorted norms at least 1e-4 apart (relative), so no norm is
  within summation-order noise of it.
- ``keep_one_copy`` (a never-alive column, a tie in the argmax),
  ``apply_mask``, ``expert_sizes``, ``redundancy``: equal.
- ``TrafficProfile``, ``suggested_capacity_factor``: the numbers of
  ``tests/test_serve_adapt.py``.
- ``repack_for_traffic``: with ``prune_gamma`` and no generator, and with
  mitosis at ``noise=0.0`` (eps is 0 on both sides): the port's table
  equals ``repro``'s after ``convert.table_from_jax``, ids and rows
  exactly. With noise, the offspring check holds with its tolerance set
  from the gate's dtype.
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
from repro.core import pruning as jpruning
from repro.kernels import ref as jref
from repro.kernels.lasso_prune import lasso_prune as pallas_lasso_prune
from repro.models import build as jbuild
from repro.serve import TrafficProfile as JTrafficProfile
from repro.serve import repack_for_traffic as jrepack
from repro.serve import suggested_capacity_factor as jsuggest
from repro_torch.convert import head_from_jax, table_from_jax, to_tensor
from repro_torch.core import pruning
from repro_torch.kernels import ops, ref
from repro_torch.serve import (
    TableResource,
    TrafficProfile,
    clone_selected,
    repack_for_traffic,
    suggested_capacity_factor,
)
from repro_torch.testing import gamma_between

RTOL = ATOL = 1e-6
HOT0 = dict(dispatched=[100, 10, 5, 5], overflow=[40, 0, 0, 0], steps=10,
            start_step=1, end_step=10)


def np_norms(w) -> np.ndarray:
    return np.sqrt(np.sum(np.asarray(w, np.float64) ** 2, axis=-1))


def profiles(**kw):
    arrays = {k: np.asarray(v, np.int64) if isinstance(v, list) else v for k, v in kw.items()}
    return JTrafficProfile(**arrays), TrafficProfile(**arrays)


@functools.lru_cache(maxsize=None)
def _head(dtype="float32"):
    """repro's 2-layer qwen2 DS head (K 4, vocab 128), a mask pruning each
    class from about half its experts, and the same pair in the port."""
    cfg = jreduce_config(jget_config("qwen2-1.5b"), vocab=128).replace(
        ds=jget_config("qwen2-1.5b").ds.replace(num_experts=4), dtype=dtype)
    params, state = jbuild(cfg).init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    mask = np.asarray(state.mask) & (rng.rand(*state.mask.shape) < 0.5)
    mask[rng.randint(0, 4, mask.shape[1]), np.arange(mask.shape[1])] = True
    mask &= np.asarray(state.mask)  # vocab-padding columns stay dead
    jhead = {k: params["head"][k] for k in ("gate", "experts")}
    thead, tstate = head_from_jax({k: np.asarray(v) for k, v in jhead.items()}, mask,
                                  device="cpu")
    return jhead, jds.DSState(mask=jnp.asarray(mask)), thead, tstate


def same_table(tt, jt):
    """The port's table equals repro's, field by field and bit for bit."""
    want = table_from_jax({f: np.asarray(v) for f, v in jt._asdict().items()}, device="cpu")
    assert type(tt) is type(want)
    for f in want._fields:
        got = getattr(tt, f)
        assert got.dtype == getattr(want, f).dtype and torch.equal(got, getattr(want, f)), f


# ---------------------------------------------------------------------------
# lasso_prune
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N,d", [(2, 128, 16), (4, 1024, 64), (3, 256, 20)])
def test_lasso_prune_matches_pallas_and_oracle(K, N, d, dtype):
    rng = np.random.RandomState(K * N + d)
    jw = jnp.asarray(rng.randn(K, N, d).astype(np.float32) * 0.2).astype(dtype)
    mask = rng.rand(K, N) < 0.9
    mask[-1] = False  # an expert with every row masked
    w = np.asarray(jw)
    gamma = gamma_between(np_norms(w), mask, 0.5)
    n_p, m_p = pallas_lasso_prune(jw, jnp.asarray(mask), gamma, interpret=True)
    n_r, m_r = jref.lasso_prune_ref(jw, jnp.asarray(mask), gamma)
    tw, tmask = to_tensor(w, "cpu"), torch.from_numpy(mask)
    before = ops.lasso_prune.launches
    norms, new_mask = ops.lasso_prune(tw, tmask, gamma, device="cpu")
    assert ops.lasso_prune.launches == before  # the plain version counts nothing
    assert norms.dtype == torch.float32 and new_mask.dtype == torch.bool
    for jn, jm in ((n_p, m_p), (n_r, m_r)):
        np.testing.assert_allclose(norms.numpy(), np.asarray(jn), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(new_mask.numpy(), np.asarray(jm))
    assert (norms[~tmask] == 0).all() and not new_mask[~tmask].any()
    assert 0 < int(new_mask.sum()) < int(tmask.sum())  # gamma prunes some, not all
    got = ref.lasso_prune_ref(tw, tmask, gamma)
    assert torch.equal(got[0], norms) and torch.equal(got[1], new_mask)


def test_lasso_prune_wrapper_checks_its_inputs():
    w, m = torch.zeros(2, 8, 4), torch.ones(2, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match=r"\(K, N\)"):
        ops.lasso_prune(w, m[:, :4], device="cpu")
    with pytest.raises(TypeError, match="bool"):
        ops.lasso_prune(w, m.float(), device="cpu")


# ---------------------------------------------------------------------------
# core.pruning
# ---------------------------------------------------------------------------

def test_keep_one_copy_and_mask_helpers_match_repro():
    rng = np.random.RandomState(0)
    K, N = 4, 12
    prev = rng.rand(K, N) < 0.7
    prev[:, 0] = False                       # column 0 was never alive
    prev[:, 1] = True
    norms = np.where(prev, rng.rand(K, N) + 0.1, 0.0).astype(np.float32)
    norms[[1, 3], 1] = norms[:, 1].max() + 1.0   # argmax tie: the first (1) wins
    cand = prev & (norms > 0.6)
    cand[:, [0, 1, 2]] = False               # every copy of columns 0-2 pruned
    prev[:, 2] = False
    prev[2, 2] = True
    norms[:, 2] = np.where(prev[:, 2], 0.3, 0.0)
    got = pruning.keep_one_copy(torch.from_numpy(cand), torch.from_numpy(norms),
                                torch.from_numpy(prev))
    want = np.asarray(jpruning.keep_one_copy(jnp.asarray(cand), jnp.asarray(norms),
                                             jnp.asarray(prev)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[:, 0].any()                               # stays dead
    assert got[:, 1].tolist() == [False, True, False, False]  # first maximum
    assert got[:, 2].tolist() == [False, False, True, False]  # its only copy
    w = rng.randn(K, N, 3).astype(np.float32)
    tw, tm = torch.from_numpy(w), torch.from_numpy(prev)
    np.testing.assert_array_equal(pruning.apply_mask(tw, tm).numpy(),
                                  np.asarray(jpruning.apply_mask(w, prev)))
    for fn, jfn in ((pruning.expert_sizes, jpruning.expert_sizes),
                    (pruning.redundancy, jpruning.redundancy)):
        out = fn(tm)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), np.asarray(jfn(jnp.asarray(prev))))


# ---------------------------------------------------------------------------
# TrafficProfile / suggested_capacity_factor / TableResource
# ---------------------------------------------------------------------------

def test_traffic_profile_and_capacity_factor_match_repro():
    jp, tp = profiles(**HOT0)
    assert tp.n_experts == jp.n_experts == 4
    assert tp.total_dispatched == jp.total_dispatched == 120
    assert tp.overflow_rate == jp.overflow_rate == pytest.approx(40 / 120)
    np.testing.assert_array_equal(tp.load_share, jp.load_share)
    np.testing.assert_array_equal(tp.per_expert_overflow_rate(), jp.per_expert_overflow_rate())
    for thr, md in ((0.25, 1), (0.5, 1), (0.1, 200)):
        np.testing.assert_array_equal(tp.hot_experts(thr, md), jp.hot_experts(thr, md))
    assert tp.hot_experts(0.25).tolist() == [0]
    # the hottest expert holds 100/120 of the window -> cf >= 1.5 * (5/6) * K
    cf = suggested_capacity_factor(tp, n_experts_new=5, headroom=1.5)
    assert cf == jsuggest(jp, n_experts_new=5, headroom=1.5) == pytest.approx(1.5 * (100 / 120) * 5)
    assert suggested_capacity_factor(tp, 5, headroom=1.5, base=50.0) == 50.0
    je, te = profiles(dispatched=[0, 0], overflow=[0, 0], steps=10, start_step=1, end_step=10)
    assert suggested_capacity_factor(te, 2, base=2.0) == jsuggest(je, 2, base=2.0) == 2.0


def test_table_resource_versions_and_back_buffer():
    _, _, head, state = _head()
    from repro_torch.core import dssoftmax as ds

    t0 = ds.pack_experts(head, state)
    res = TableResource(t0, gate=head["gate"])
    assert res.version == 0 and res.table is t0 and res.gate is head["gate"]
    t1 = ds.pack_experts(head, state)
    gate1 = head["gate"] + 1
    assert res.swap(t1, gate=gate1) == 1
    assert res.table is t1 and res.gate is gate1 and res.version == 1
    # no back buffer: the retired table is not held (the allocator frees
    # its memory in stream order once the last step queued on it is done)
    assert not any(v is t0 for v in vars(res).values())
    assert res.swap(t0) == 2 and res.gate is gate1   # no gate: the gate stays
    opaque = {"w": np.ones(3)}               # a non-DS head's state is versioned too
    res = TableResource(opaque)
    assert res.swap({"w": np.zeros(3)}) == 1 and res.table is not opaque


# ---------------------------------------------------------------------------
# repack_for_traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["prune", "mitosis_noise0", "prune_and_mitosis_noise0"])
def test_repack_matches_repro(dtype, case):
    jhead, jstate, head, state = _head(dtype)
    jp, tp = profiles(**HOT0)
    kw, jkw = {}, {}
    if "prune" in case:
        gamma = gamma_between(np_norms(np.asarray(jhead["experts"])), jstate.mask, 0.3)
        kw["prune_gamma"] = jkw["prune_gamma"] = gamma
    if "mitosis" in case:
        kw.update(generator=torch.Generator().manual_seed(1), noise=0.0)
        jkw.update(key=jax.random.PRNGKey(1), noise=0.0)
    jres = jrepack(jhead, jstate, jp, **jkw)
    mask_in = state.mask.clone()
    res = repack_for_traffic(head, state, tp, **kw)
    assert res.cloned == jres.cloned == (((0,) if "mitosis" in case else ()))
    assert res.rows_pruned == jres.rows_pruned
    assert (res.rows_pruned > 0) == ("prune" in case)
    assert res.capacity_factor == jres.capacity_factor
    np.testing.assert_array_equal(res.state.mask.numpy(), np.asarray(jres.state.mask))
    want_gate = to_tensor(np.asarray(jres.head_params["gate"]), "cpu")
    assert torch.equal(res.head_params["gate"], want_gate)
    same_table(res.table, jres.table)
    # the input pair is left as it was (pure with respect to its inputs)
    assert torch.equal(state.mask, mask_in) and head["gate"].shape[0] == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_repack_mitosis_appends_offspring(dtype):
    """The offspring check on both sides, its tolerance from the gate's
    dtype: parent + offspring = (g + eps) + (g - eps), each rounded once to
    the gate's dtype, so |sum - 2g| <= (eps_dtype / 2)(|g| + |eps|)."""
    jhead, jstate, head, state = _head(dtype)
    jp, tp = profiles(**HOT0)
    jres = jrepack(jhead, jstate, jp, key=jax.random.PRNGKey(0))
    res = repack_for_traffic(head, state, tp, generator=torch.Generator().manual_seed(0))
    fin = torch.finfo(getattr(torch, dtype)).eps
    for g, g2, table in ((np.asarray(jhead["gate"], np.float32),
                          np.asarray(jres.head_params["gate"], np.float32), jres.table),
                         (head["gate"].float().numpy(), res.head_params["gate"].float().numpy(),
                          res.table)):
        assert g2.shape == (5, g.shape[1])
        eps = np.abs(g2[0] - g2[4]).max() / 2
        assert eps > 0
        np.testing.assert_allclose(g2[0] + g2[4], 2.0 * g[0], rtol=fin, atol=fin * eps)
        np.testing.assert_array_equal(g2[1:4], g[1:4])
        ids = np.asarray(table.ids)
        np.testing.assert_array_equal(ids[4], ids[0])
    assert res.cloned == jres.cloned == (0,)
    same_table(res.table, jres.table)  # rows and ids do not depend on eps


def test_repack_without_generator_skips_mitosis_and_checks_the_profile():
    _, _, head, state = _head()
    _, tp = profiles(**HOT0)
    res = repack_for_traffic(head, state, tp, generator=None)
    assert res.cloned == () and res.head_params["gate"].shape[0] == 4
    _, bad = profiles(dispatched=[1] * 6, overflow=[0] * 6, steps=1, start_step=1, end_step=1)
    with pytest.raises(ValueError, match="6 experts"):
        repack_for_traffic(head, state, bad)
    with pytest.raises(ValueError, match="out of range"):
        clone_selected(torch.Generator(), head, state, [4])
