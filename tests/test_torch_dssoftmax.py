"""Port parity: the serving half of DS-Softmax (``repro_torch.core.dssoftmax``)
and the serve-kernel registry against ``repro.core.dssoftmax`` on the same
seeded inputs.

Every port path (``jnp``, ``grouped`` and, through their wrappers' plain
versions on CPU tensors, ``cuda_grouped`` and ``cuda_fused``) is held
against repro's ``jnp`` oracle. Tolerances: ids equal; fp32 values
rtol 1e-6, atol 2e-6 (``tests/test_kernels.py:103``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DSSoftmaxConfig as JDSConfig
from repro.core import dssoftmax as jds
from repro_torch.convert import to_tensor
from repro_torch.core import dssoftmax as ds
from repro_torch.kernels import registry

RTOL, ATOL = 1e-6, 2e-6
PORT_PATHS = ("jnp", "grouped", "cuda_grouped", "cuda_fused")


def _t(a):
    return to_tensor(np.asarray(a), "cpu")


def _fixture(dtype=jnp.float32, K=4, d=32, n_classes=900, keep=0.5, pad=None):
    params, state = jds.init(jax.random.PRNGKey(0), d, n_classes,
                             JDSConfig(num_experts=K), dtype=dtype)
    mask = jax.random.uniform(jax.random.PRNGKey(2), (K, n_classes)) < keep
    state = jds.DSState(mask=mask)
    jtable = jds.pack_experts(params, state, pad=pad)
    tparams = {"gate": _t(params["gate"]), "experts": _t(params["experts"])}
    ttable = ds.pack_experts(tparams, ds.DSState(mask=_t(mask)), pad=pad)
    return params, jtable, tparams, ttable


@pytest.fixture(scope="module")
def fx32():
    return _fixture(jnp.float32)


@pytest.fixture(scope="module")
def fx16():
    return _fixture(jnp.bfloat16)


def _h(B, d=32, dtype=jnp.float32, seed=1):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (B, d)).astype(dtype))


def test_pack_experts_matches_repro(fx32, fx16):
    for _, jtable, _, ttable in (fx32, fx16):
        np.testing.assert_array_equal(ttable.ids.numpy(), np.asarray(jtable.ids))
        np.testing.assert_array_equal(ttable.weights.float().numpy(),
                                      np.asarray(jtable.weights.astype(jnp.float32)))
        assert ttable.ids.dtype == torch.int32 and ttable.v_pad == jtable.v_pad


def test_pack_experts_rejects_a_pad_that_truncates(fx32):
    _, _, tparams, _ = fx32
    state = ds.DSState(mask=torch.ones((4, 900), dtype=torch.bool))
    with pytest.raises(ValueError, match="truncate"):
        ds.pack_experts(tparams, state, pad=899)


@pytest.fixture(scope="module")
def oracle(fx32, fx16):
    """repro's jnp serve oracle per (B, dtype), computed once each."""
    cache = {}

    def get(B, dtype):
        if (B, dtype) not in cache:
            params, jtable, _, _ = fx32 if dtype == "float32" else fx16
            h = _h(B, dtype=getattr(jnp, dtype))
            cache[B, dtype] = h, jds.serve_topk(params["gate"], jtable, jnp.asarray(h), 8,
                                                kernel="jnp")
        return cache[B, dtype]

    return get


@pytest.mark.parametrize("kern", PORT_PATHS)
@pytest.mark.parametrize("B", [16, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_topk_matches_repro_oracle(fx32, fx16, oracle, kern, B, dtype):
    _, _, tparams, ttable = fx32 if dtype == "float32" else fx16
    h, (v2, i2) = oracle(B, dtype)
    v1, i1 = ds.serve_topk(tparams["gate"], ttable, _t(h), 8, kernel=kern, device="cpu")
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i2))
    np.testing.assert_allclose(v1.numpy(), np.asarray(v2), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def grouped_oracle(fx32):
    """repro's grouped path with stats per (cf, B), computed once each."""
    params, jtable, _, _ = fx32
    cache = {}

    def get(cf, B):
        if (cf, B) not in cache:
            h = _h(B, seed=4)
            cache[cf, B] = h, jds.serve_topk(params["gate"], jtable, jnp.asarray(h), 8,
                                             kernel="grouped", capacity_factor=cf,
                                             with_stats=True)
        return cache[cf, B]

    return get


@pytest.mark.parametrize("kern", ["grouped", "cuda_grouped"])
@pytest.mark.parametrize("cf,B", [(0.25, 256), (1.0, 16)])
def test_grouped_capacity_overflow_exact(fx32, grouped_oracle, kern, cf, B):
    """cf 0.25 overflows most of the batch: every overflowed token is fixed
    up exactly; the overflow telemetry equals repro's."""
    _, _, tparams, ttable = fx32
    h, (v2, i2, st2) = grouped_oracle(cf, B)
    v1, i1, st1 = ds.serve_topk(tparams["gate"], ttable, _t(h), 8, kernel=kern,
                                capacity_factor=cf, with_stats=True, device="cpu")
    assert int(st1["overflow"].sum()) > 0
    np.testing.assert_array_equal(st1["overflow"].numpy(), np.asarray(st2["overflow"]))
    np.testing.assert_array_equal(st1["dispatched"].numpy(), np.asarray(st2["dispatched"]))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i2))
    np.testing.assert_allclose(v1.numpy(), np.asarray(v2), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kern", ["grouped", "cuda_grouped"])
def test_grouped_overflow_last_token_exact(fx32, kern):
    """Every token steered to expert 0 (capacity 2 at B=8, cf=1): the last
    token overflows and must get its own exact top-k
    (``tests/test_kernels.py:162``)."""
    params, jtable, tparams, ttable = fx32
    gate = np.zeros((4, 32), np.float32)
    gate[0] = 1.0
    h = np.abs(_h(8, seed=5)) + 0.1
    v1, i1 = ds.serve_topk(_t(gate), ttable, _t(h), 8, kernel=kern, capacity_factor=1.0,
                           device="cpu")
    v2, i2 = jds.serve_topk(jnp.asarray(gate), jtable, jnp.asarray(h), 8, kernel="jnp")
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i2))
    np.testing.assert_allclose(v1.numpy(), np.asarray(v2), rtol=RTOL, atol=ATOL)


def test_non_multiple_v_pad_exact():
    """An explicit serve pad of 192 (no 64- or 128-row tile divides it)."""
    params, jtable, tparams, ttable = _fixture(n_classes=180, keep=1.1, pad=192)
    assert ttable.v_pad == 192
    h = _h(16, seed=6)
    v2, i2 = jds.serve_topk(params["gate"], jtable, jnp.asarray(h), 8, kernel="jnp")
    for kern in ("cuda_grouped", "cuda_fused"):
        v1, i1 = ds.serve_topk(tparams["gate"], ttable, _t(h), 8, kernel=kern, device="cpu")
        np.testing.assert_array_equal(i1.numpy(), np.asarray(i2))
        np.testing.assert_allclose(v1.numpy(), np.asarray(v2), rtol=RTOL, atol=ATOL)


def test_capacity_uses_python_round():
    """round(B/K·cf) is banker's rounding, as repro computes it."""
    ctx = registry.KernelContext(B=10, d=8, K=8, v_pad=128, capacity_factor=2.0)
    assert ctx.capacity == round(2.5) == 2


def test_registry_names_and_unknown_kernel(fx32):
    assert registry.kernel_names() == ("jnp", "grouped", "cuda_grouped", "cuda_fused",
                                       "cuda_pertoken")
    _, _, tparams, ttable = fx32
    with pytest.raises(ValueError, match="unknown serve kernel"):
        ds.serve_topk(tparams["gate"], ttable, _t(_h(4)), 8, kernel="pallas", device="cpu")
    with pytest.raises(ValueError):
        registry.FixedPolicy("pallas_grouped")
    assert registry.FixedPolicy("cuda_fused").resolve(None) == "cuda_fused"


@pytest.mark.parametrize("B,backend,expected", [
    (1, "cpu", "jnp"), (8, "cpu", "jnp"), (2048, "cpu", "grouped"),
    (1, "cuda", "cuda_fused"), (8, "cuda", "cuda_fused"), (2048, "cuda", "cuda_grouped"),
])
def test_auto_policy_at_serving_shapes(B, backend, expected):
    """qwen2-1.5b head shapes (K 16, V_pad 12032, d 1536, bf16): the CUDA
    kernels are never picked on the CPU; on CUDA the fused kernel wins at
    decode and the grouped one at batch shapes."""
    hist = []
    ctx = registry.KernelContext(B=B, d=1536, K=16, v_pad=12032, k=8, backend=backend,
                                 wbytes=2, hbytes=2)
    assert registry.AutoPolicy(history=hist).resolve(ctx) == expected
    assert hist == [(B, expected)]
