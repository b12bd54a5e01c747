"""Port parity: ``repro_torch.core.mitosis`` against ``repro.core.mitosis``.

``clone_experts`` at ``noise=0`` is bit-equal to ``repro``'s (gate,
experts, mask; fp32 and bf16). With noise the two draw from different
generators, so what is held is the structure: the offspring's expert rows
and masks are exact copies, and each pair of offspring gate rows sums to
twice the parent's within one rounding of the dtype (fp32: rtol 2^-23,
bf16: 2^-7, each offspring ``gate ± eps`` rounded once).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dssoftmax as jds
from repro.core import mitosis as jmitosis
from repro_torch.convert import head_from_jax
from repro_torch.core import dssoftmax as ds
from repro_torch.core import mitosis

ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}


def _head(dtype, K=4, N=24, d=8):
    rng = np.random.RandomState(0)
    head = {"gate": jnp.asarray(rng.randn(K, d).astype(np.float32)).astype(dtype),
            "experts": jnp.asarray(rng.randn(K, N, d).astype(np.float32)).astype(dtype)}
    mask = rng.rand(K, N) < 0.6
    return head, mask


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clone_experts_bit_equal_at_zero_noise(dtype):
    jhead, mask = _head(dtype)
    jh2, js2 = jmitosis.clone_experts(jax.random.PRNGKey(0), jhead,
                                      jds.DSState(mask=jnp.asarray(mask)), noise=0.0)
    thead, tstate = head_from_jax(jax.tree.map(np.asarray, jhead), mask, device="cpu")
    th2, ts2 = mitosis.clone_experts(torch.Generator().manual_seed(0), thead, tstate, noise=0.0)
    for f in ("gate", "experts"):
        assert th2[f].dtype == thead[f].dtype
        np.testing.assert_array_equal(_f32(th2[f]), _f32(jh2[f]))
    np.testing.assert_array_equal(ts2.mask.numpy(), np.asarray(js2.mask))
    assert th2["gate"].shape[0] == 2 * thead["gate"].shape[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clone_experts_with_noise(dtype):
    jhead, mask = _head(dtype)
    thead, tstate = head_from_jax(jax.tree.map(np.asarray, jhead), mask, device="cpu")
    K = thead["gate"].shape[0]
    th2, ts2 = mitosis.clone_experts(torch.Generator().manual_seed(3), thead, tstate, noise=1e-2)
    g, g2 = _f32(thead["gate"]), _f32(th2["gate"])
    assert not np.array_equal(g2[:K], g2[K:])        # the offspring diverge
    np.testing.assert_allclose(g2[:K] + g2[K:], 2 * g, rtol=0,
                               atol=4 * ULP[dtype] * np.abs(g).max())
    # the noise is small against the gate's spread
    assert np.abs(g2[:K] - g).max() < 0.1 * g.std()
    for half in (slice(0, K), slice(K, 2 * K)):
        np.testing.assert_array_equal(_f32(th2["experts"][half]), _f32(thead["experts"]))
        np.testing.assert_array_equal(ts2.mask[half].numpy(), mask)
    # the same generator state draws the same noise
    th3, _ = mitosis.clone_experts(torch.Generator().manual_seed(3), thead, tstate, noise=1e-2)
    assert torch.equal(th3["gate"], th2["gate"])


def test_memory_ratio_and_schedule_match_repro():
    _, mask = _head("float32")
    assert mitosis.memory_ratio(ds.DSState(mask=torch.from_numpy(mask))) == \
        jmitosis.memory_ratio(jds.DSState(mask=jnp.asarray(mask)))
    for start, target in ((2, 16), (2, 2), (3, 20), (8, 64), (4, 6)):
        assert mitosis.mitosis_schedule(start, target) == jmitosis.mitosis_schedule(start, target)
