"""Port parity: the ``dss_topk_grouped`` and ``dss_topk_fused`` kernel
wrappers (their plain versions, which is what they run on CPU tensors)
against ``repro``'s Pallas kernels in interpret mode on the same seeded
inputs.

Tolerances: ids equal everywhere (ties included: duplicated rows make
them exact, and the lowest packed position must win on both sides);
values rtol 1e-6, atol 2e-6 (``tests/test_kernels.py:103``: fp32 sums of
exact products in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as pallas_ops
from repro_torch.convert import to_tensor
from repro_torch.kernels import ops, ref

RTOL, ATOL = 1e-6, 2e-6


def _t(a):
    return to_tensor(np.asarray(a), "cpu")


def _table(K=4, d=32, v_pad=512, dtype=jnp.float32, seed=0, empty=None, dup=False):
    """Packed-table stand-in: expert e holds its real rows first, then
    padding (id -1, zero weights). ``dup`` copies every even row onto the
    next one, so their logits tie exactly."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(K, v_pad, d) / np.sqrt(d)).astype(np.float32)
    if dup:
        w[:, 1::2] = w[:, 0::2]
    ids = rng.permutation(4 * K * v_pad)[: K * v_pad].reshape(K, v_pad).astype(np.int32)
    sizes = rng.randint(v_pad // 2, v_pad + 1, K)
    if empty is not None:
        sizes[empty] = 0
    pad = np.arange(v_pad)[None, :] >= sizes[:, None]
    ids[pad] = -1
    w[pad] = 0.0
    return np.asarray(jnp.asarray(w, dtype)), ids


def _grouped_inputs(K, d, C, dtype, seed):
    rng = np.random.RandomState(seed + 100)
    buf = np.asarray(jnp.asarray(rng.randn(K, C, d).astype(np.float32), dtype))
    g_buf = rng.rand(K, C).astype(np.float32)
    g_buf[:, -1] = 0.0  # an empty slot
    return buf, g_buf


def _check(got, want, rows=None):
    gv, gi = (np.asarray(x) for x in got)
    wv, wi = (np.asarray(x) for x in want)
    if rows is not None:
        gv, gi, wv, wi = gv[rows], gi[rows], wv[rows], wi[rows]
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL)


def _grouped_jnp_oracle(w, ids, buf, g_buf, k):
    """repro's grouped math in jnp (``core/dssoftmax.py:986``)."""
    z = jnp.einsum("kcd,kvd->kcv", buf, w, preferred_element_type=jnp.float32)
    z = z * g_buf[..., None]
    z = jnp.where(ids[:, None, :] >= 0, z, -1e9)
    vals, pos = jax.lax.top_k(z, k)
    return vals, jnp.take_along_axis(jnp.broadcast_to(ids[:, None, :], z.shape), pos, axis=2)


# (dtype, B, k, v_pad, all-padding expert); C = B / K * 2. The first two
# also run through the Pallas kernel (interpret mode costs seconds a call).
GROUPED_CASES = [
    (jnp.float32, 256, 8, 512, None),
    (jnp.float32, 16, 8, 900, 2),
    (jnp.bfloat16, 16, 1, 512, None),
    (jnp.float32, 16, 1, 512, None),
    (jnp.float32, 256, 1, 256, 0),
    (jnp.bfloat16, 16, 8, 512, None),
    (jnp.bfloat16, 256, 8, 192, None),
    (jnp.bfloat16, 256, 1, 900, None),
]


@pytest.mark.parametrize("case", range(len(GROUPED_CASES)))
def test_grouped_matches_repro(case):
    """Duplicated rows make ties exact; an all-padding expert emits
    exactly (-1e9, -1); a v_pad that no block divides keeps its trailing
    rows."""
    dtype, B, k, v_pad, empty = GROUPED_CASES[case]
    K, d = 4, 32
    C = B // K * 2
    w, ids = _table(K, d, v_pad, dtype, seed=case, empty=empty, dup=True)
    buf, g_buf = _grouped_inputs(K, d, C, dtype, seed=case)
    got = ops.dss_topk_grouped(_t(w), _t(ids), _t(buf), _t(g_buf), k, device="cpu")
    assert got[0].shape == (K, C, k) and got[0].dtype == torch.float32
    assert got[1].dtype == torch.int32
    args = (jnp.asarray(w), jnp.asarray(ids), jnp.asarray(buf), jnp.asarray(g_buf))
    # empty slots (g = 0) are left out: every logit there is ±0, and
    # jax.lax.top_k orders -0 below +0 where the kernels see a tie. Their
    # outputs are never read back.
    _check(got, _grouped_jnp_oracle(*args, k), rows=g_buf > 0)
    if case < 2:
        _check(got, pallas_ops.dss_topk_grouped(*args, k, interpret=True))
    if empty is not None:
        assert (got[1][empty] == -1).all() and (got[0][empty] == -1e9).all()


@pytest.mark.parametrize("dtype,B,k,e_base,K_real", [
    (jnp.bfloat16, 16, 8, 0, 4), (jnp.float32, 64, 8, 2, 8)])
def test_fused_matches_pallas_kernel(dtype, B, k, e_base, K_real):
    """Includes a sharded-style call: 4 local experts at e_base 2 of an
    8-expert gate, so some tokens are foreign and must emit (-inf, -1)."""
    K, d = 4, 32
    rng = np.random.RandomState(B + e_base)
    gate = np.asarray(jnp.asarray(rng.randn(K_real, d).astype(np.float32), dtype))
    h = np.asarray(jnp.asarray(rng.randn(B, d).astype(np.float32), dtype))
    w, ids = _table(K, d, 900, dtype, seed=B, dup=True)
    got = ops.dss_topk_fused(_t(gate), _t(w), _t(ids), _t(h), k, e_base=e_base, device="cpu")
    want = pallas_ops.dss_topk_fused(jnp.asarray(gate), jnp.asarray(w), jnp.asarray(ids),
                                     jnp.asarray(h), k, e_base=jnp.asarray([e_base], jnp.int32),
                                     interpret=True)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _check(got[:2], want[:2])
    local = got[2].numpy() - e_base
    foreign = (local < 0) | (local >= K)
    assert foreign.any() == bool(e_base)
    assert np.isneginf(got[0].numpy()[foreign]).all()
    assert not np.isinf(got[0].numpy()[~foreign]).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,k", [(16, 1), (256, 8)])
def test_fused_matches_repro_jnp_serve_path(dtype, B, k):
    """The fused wrapper against repro's jnp serve oracle (top1_gate +
    per-token gather) on the same gate and packed table."""
    from repro.core import dssoftmax as jds

    K, d = 4, 32
    rng = np.random.RandomState(B)
    gate = np.asarray(jnp.asarray(rng.randn(K, d).astype(np.float32), dtype))
    h = np.asarray(jnp.asarray(rng.randn(B, d).astype(np.float32), dtype))
    w, ids = _table(K, d, 640, getattr(jnp, dtype), seed=B + k, dup=True)
    got = ops.dss_topk_fused(_t(gate), _t(w), _t(ids), _t(h), k, device="cpu")
    want = jds.serve_topk(jnp.asarray(gate), jds.ServeTable(ids=jnp.asarray(ids),
                                                            weights=jnp.asarray(w)),
                          jnp.asarray(h), k, kernel="jnp")
    _check(got[:2], want)


def test_fused_equals_gate_then_gather_path():
    """The fused kernel's gating (first argmax of the logits, g = 1/Σexp)
    gives the same retrieval as gate_top1 + the per-token gather when no
    probabilities tie."""
    K, d, B, k = 4, 32, 64, 8
    rng = np.random.RandomState(7)
    gate = rng.randn(K, d).astype(np.float32)
    h = rng.randn(B, d).astype(np.float32)
    w, ids = _table(K, d, 300, seed=7)
    v1, i1, e1 = ops.dss_topk_fused(_t(gate), _t(w), _t(ids), _t(h), k, device="cpu")
    e2, g2 = ops.gate_top1(_t(gate), _t(h), device="cpu")
    np.testing.assert_array_equal(e1.numpy(), e2.numpy())
    z = torch.einsum("bvd,bd->bv", _t(w)[e2.long()], _t(h)) * g2[:, None]
    sel_ids = _t(ids)[e2.long()]
    z = torch.where(sel_ids >= 0, z, ref.NEG_INF)
    v2, pos = ref.topk_stable(z, k)
    np.testing.assert_array_equal(i1.numpy(), torch.gather(sel_ids, 1, pos).numpy())
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), rtol=RTOL, atol=ATOL)

