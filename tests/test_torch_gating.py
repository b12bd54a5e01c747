"""Port parity: gating and dispatch (``repro_torch.core.gating`` /
``core.dispatch``) and the ``gate_top1`` kernel wrapper against
``repro``'s functions and its Pallas kernel (interpret mode) on the same
seeded inputs.

Tolerances: expert ids, slots and ``valid`` are equal; gate values agree
to rtol 1e-5 (``tests/test_kernels.py``'s gate tolerance — fp32 softmax
with a different exp implementation on each side)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core import dssoftmax as jds
from repro.core import gating as jgating
from repro.kernels import gate_top1 as pallas_gate_top1
from repro_torch.core import dispatch, gating
from repro_torch.core import dssoftmax as ds
from repro_torch.kernels import ops


def _inputs(K, d, B, dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    u = rng.randn(K, d).astype(np.float32) / np.sqrt(d)
    h = rng.randn(B, d).astype(np.float32)
    return u.astype(dtype), h.astype(dtype)


@pytest.mark.parametrize("K,d,B", [(4, 32, 16), (8, 64, 256), (64, 256, 128)])
def test_top1_gate_matches_repro(K, d, B):
    u, h = _inputs(K, d, B)
    ei, g, G = gating.top1_gate(torch.from_numpy(u), torch.from_numpy(h))
    ji, jg, jG = jgating.top1_gate(jnp.asarray(u), jnp.asarray(h))
    assert ei.dtype == torch.int32
    np.testing.assert_array_equal(ei.numpy(), np.asarray(ji))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5)
    np.testing.assert_allclose(G.numpy(), np.asarray(jG), rtol=1e-5, atol=1e-7)


def test_top1_gate_picks_first_of_tied_experts():
    """Duplicated gate rows make the softmax tie exactly; both sides take
    the lowest expert index."""
    u, h = _inputs(4, 32, 16)
    u[3] = u[1]
    u[2] = u[0]
    ei, _, _ = gating.top1_gate(torch.from_numpy(u), torch.from_numpy(h))
    ji, _, _ = jgating.top1_gate(jnp.asarray(u), jnp.asarray(h))
    np.testing.assert_array_equal(ei.numpy(), np.asarray(ji))
    assert set(ei.tolist()) <= {0, 1}


@pytest.mark.parametrize("K,d,B", [(4, 32, 16), (64, 256, 128)])
def test_gate_top1_wrapper_matches_pallas_kernel(K, d, B):
    u, h = _inputs(K, d, B, seed=1)
    i1, g1 = ops.gate_top1(torch.from_numpy(u), torch.from_numpy(h), device="cpu")
    i2, g2 = pallas_gate_top1(jnp.asarray(u), jnp.asarray(h), interpret=True)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i2))
    np.testing.assert_allclose(g1.numpy(), np.asarray(g2), rtol=1e-5)
    assert ops.gate_top1.launches == 0  # the plain version is no launch


def test_gate_top1_wrapper_bf16_matches_repro_gate():
    u, h = _inputs(8, 64, 32, dtype=jnp.bfloat16, seed=2)
    i1, g1 = ops.gate_top1(torch.from_numpy(u.view(np.int16).copy()).view(torch.bfloat16),
                           torch.from_numpy(h.view(np.int16).copy()).view(torch.bfloat16),
                           device="cpu")
    ji, jg, _ = jgating.top1_gate(jnp.asarray(u), jnp.asarray(h))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji))
    np.testing.assert_allclose(g1.numpy(), np.asarray(jg), rtol=1e-5)


@pytest.mark.parametrize("K,A,capacity", [(4, 16, 2), (4, 256, 32), (16, 8, 1), (8, 100, 7)])
def test_dispatch_indices_and_load_match_repro(K, A, capacity):
    rng = np.random.RandomState(A)
    e = rng.randint(0, K, A).astype(np.int32)
    e[: A // 3] = 1  # skew one expert so it overflows
    slot, valid = dispatch.dispatch_indices(torch.from_numpy(e), K, capacity)
    js, jv = jdispatch.dispatch_indices(jnp.asarray(e), K, capacity)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(js))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    assert not valid.all()
    d1, o1 = dispatch.dispatch_load(torch.from_numpy(e), K, valid)
    d2, o2 = jdispatch.dispatch_load(jnp.asarray(e), K, jnp.asarray(jv))
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d2))
    np.testing.assert_array_equal(o1.numpy(), np.asarray(o2))


def test_dispatch_load_drops_out_of_range_ids():
    e = np.array([0, 3, 4, 4, 1, 9], np.int32)  # ids >= K = 4 are dropped
    d1, o1 = dispatch.dispatch_load(torch.from_numpy(e), 4)
    d2, o2 = jdispatch.dispatch_load(jnp.asarray(e), 4)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d2))
    np.testing.assert_array_equal(o1.numpy(), np.asarray(o2))


@pytest.mark.parametrize("capacity", [1, 2])
def test_dispatch_and_grouping_take_the_sentinel_expert(capacity):
    """Ids equal to K (the sentinel the int8 grouped path routes fallback
    tokens to) get JAX's slot and valid bit for bit (JAX clamps the
    gather), and _group_tokens leaves them out of buf and g_buf, as
    JAX's mode="drop" scatter does."""
    K, d = 4, 8
    e = np.array([0, 3, 4, 1, 4, 0], np.int32)
    slot, valid = dispatch.dispatch_indices(torch.from_numpy(e), K, capacity)
    js, jv = jdispatch.dispatch_indices(jnp.asarray(e), K, capacity)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(js))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    if capacity == 1:
        assert slot.tolist() == [0, 0, 1, 0, 2, 1]
        assert valid.tolist() == [True, True, False, True, False, False]
    rng = np.random.RandomState(0)
    h = rng.randn(len(e), d).astype(np.float32)
    g = rng.rand(len(e)).astype(np.float32) + 0.5
    buf, g_buf, _, _ = ds._group_tokens(torch.from_numpy(h), torch.from_numpy(g),
                                        torch.from_numpy(e), K, capacity)
    jbuf, jg_buf, _, _ = jds._group_tokens(jnp.asarray(h), jnp.asarray(g), jnp.asarray(e),
                                           K, capacity)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(g_buf.numpy(), np.asarray(jg_buf))
    sentinel_rows = {tuple(h[i]) for i in np.nonzero(e == K)[0]}
    assert not any(tuple(r) in sentinel_rows for r in buf.reshape(-1, d).numpy())


@pytest.mark.parametrize("B", [8, 64])
def test_gate_top1_wrapper_ties_match_pallas_kernel(B):
    """At the serve width (K 16, d 1536), experts 3 and 11 have identical
    rows that win every token: the wrapper's plain version (what the CUDA
    bodies are held to) and the Pallas kernel both give the lower expert,
    with equal gate values."""
    K, d = 16, 1536
    u, h = _inputs(K, d, B, seed=3)
    h = np.abs(h)
    u[3] = u[11] = np.full(d, 0.05, np.float32)
    i1, g1 = ops.gate_top1(torch.from_numpy(u), torch.from_numpy(h), device="cpu")
    i2, g2 = pallas_gate_top1(jnp.asarray(u), jnp.asarray(h), interpret=True)
    np.testing.assert_array_equal(i1.numpy(), np.full(B, 3))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i2))
    np.testing.assert_allclose(g1.numpy(), np.asarray(g2), rtol=1e-5)
