"""Port parity: the serving half of DS-Softmax (``repro_torch.core.dssoftmax``)
and the serve-kernel registry against ``repro.core.dssoftmax`` on the same
seeded inputs.

Every port path (``jnp``, ``grouped`` and, through their wrappers' plain
versions on CPU tensors, ``cuda_grouped`` and ``cuda_fused``) is held
against repro's ``jnp`` oracle. Tolerances: ids equal; fp32 values
rtol 1e-6, atol 2e-6 (``tests/test_kernels.py:103``)."""
import importlib

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
    base = ("jnp", "grouped", "cuda_grouped", "cuda_fused", "cuda_pertoken")
    assert registry.kernel_names() == base + tuple(f"{n}_ep" for n in base)
    _, _, tparams, ttable = fx32
    with pytest.raises(ValueError, match="unknown serve kernel"):
        ds.serve_topk(tparams["gate"], ttable, _t(_h(4)), 8, kernel="pallas", device="cpu")
    with pytest.raises(ValueError):
        registry.FixedPolicy("pallas_grouped")
    assert registry.FixedPolicy("cuda_fused").resolve(None) == "cuda_fused"


@pytest.mark.parametrize("B,backend,expected", [
    (1, "cpu", "jnp"), (8, "cpu", "jnp"), (2048, "cpu", "grouped"),
    (1, "cuda", "cuda_fused"), (8, "cuda", "cuda_fused"), (2048, "cuda", "cuda_grouped"),
    (64, "cuda", "cuda_grouped"), (40, "cuda", "cuda_fused"),
])
def test_auto_policy_at_serving_shapes(B, backend, expected):
    """qwen2-1.5b head shapes (K 16, V_pad 12032, d 1536, bf16): the CUDA
    kernels are never picked on the CPU; on CUDA the fused kernel wins at
    decode and at a speculative verify step of 8 slots at gamma 4 (B 40,
    C 5, where the tokens that overflow the grouped path's capacity, 0.83
    expected, each cost a gather of their expert's rows), and the grouped
    one at batch shapes."""
    hist = []
    ctx = registry.KernelContext(B=B, d=1536, K=16, v_pad=12032, k=8, backend=backend,
                                 wbytes=2, hbytes=2)
    assert registry.AutoPolicy(history=hist).resolve(ctx) == expected
    assert hist == [(B, expected)]


@pytest.mark.parametrize("B,K,d,reads", [
    (1, 16, 1536, 1), (8, 16, 1536, 8), (16, 16, 1536, 16),
    # past min(B, K), an expert is read once more per token group (6 at d 1536)
    (2048, 16, 1536, 16 + (2048 - 16) // 6), (300, 4, 128, 4 + 296 // 8),
])
def test_cost_cuda_fused_prices_each_chosen_expert_per_token_group(B, K, d, reads):
    """The fused path's bytes: the chosen experts' rows once per token
    group (at most min(B, K) experts), plus the gate, h, the expert ids and
    gate values and the outputs."""
    assert registry.fused_expert_reads(B, K, d) == reads
    for quantized in (False, True):
        ctx = registry.KernelContext(B=B, d=d, K=K, v_pad=12032, k=8, backend="cuda",
                                     wbytes=1 if quantized else 2, hbytes=2, quantized=quantized)
        row = d * ctx.wbytes + (4 if quantized else 0)
        want = reads * 12032 * row + K * d * 2 + B * d * 2 + B * 8 + B * 8 * 8
        assert registry.get_spec("cuda_fused").bytes_moved(ctx) == want


@pytest.mark.parametrize("B,K,d,reads", [
    # decode: one pass per live expert while C fits one token group (6 at d 1536)
    (1, 16, 1536, 1), (8, 16, 1536, 8), (16, 16, 1536, 16),
    # C 8 > 6: past min(B, K), an expert is read once more per token group
    (64, 16, 1536, 16 + 48 // 6), (10, 2, 1536, 2 + 8 // 6),
    # C 6 fits one group of 8 at d 128: each of the 4 experts once
    (12, 4, 128, 4),
])
def test_cost_cuda_grouped_prices_live_experts_per_token_group(B, K, d, reads):
    """The grouped path at decode capacities (the decode body): the live
    experts' rows once per token group (at most min(B, K) experts, and at
    most ⌈C / group⌉ passes each), the buffers' round trip and the
    (K, C, k) outputs. Where the capacity is above TILED_ABOVE the
    tensor-core body serves bf16 tokens instead: every expert's rows once
    per token tile, or its products at the bf16 tensor-core rate where
    those take longer (C 256)."""
    grouped = importlib.import_module("repro_torch.kernels.dss_topk_grouped")
    for quantized in (False, True):
        ctx = registry.KernelContext(B=B, d=d, K=K, v_pad=12032, k=8, backend="cuda",
                                     wbytes=1 if quantized else 2, hbytes=2, quantized=quantized)
        C = ctx.capacity
        assert registry.grouped_expert_reads(B, K, C, d) == reads
        row = d * ctx.wbytes + (4 if quantized else 0)
        passes = reads
        if C <= grouped.TILED_ABOVE:
            assert registry.grouped_body(ctx) == grouped.DECODE
        else:
            assert registry.grouped_body(ctx) == grouped.WGMMA
            passes = K  # one token tile
        want = passes * 12032 * row + 2 * K * C * d * 2 + K * C * 8 * 8 + B * 8 * 8
        fixup = int(registry.expected_overflow(B, K, C) * 12032) * (3 * row + 8 * d)
        assert registry.fixup_rows(ctx) == int(registry.expected_overflow(B, K, C) * 12032)
        assert registry.get_spec("cuda_grouped").bytes_moved(ctx) == want + fixup
    big = registry.KernelContext(B=2048, d=1536, K=16, v_pad=12032, k=8, backend="cuda",
                                 wbytes=2, hbytes=2)
    assert big.capacity == 256
    assert registry.get_spec("cuda_grouped").bytes_moved(big) == (
        16 * 12032 * 1536 * 2 + 2 * 16 * 256 * 1536 * 2 + 16 * 256 * 8 * 8 + 2048 * 8 * 8)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("B", [64, 2048])
def test_cost_cuda_grouped_prices_the_bound_of_its_body(B, quantized):
    """qwen2-1.5b's head (K 16, V_pad 12,032, d 1536, bf16 tokens) at B 64
    (C 8) and 2048 (C 256): the tensor-core body, priced at the larger of
    its bytes and its 2·K·C·V_pad·d products at 989 TFLOP/s expressed as
    bytes at 3.35 TB/s. int8 rows at C 256 are bound by the products. An
    fp32 batch runs the CUDA-core tiled body, bound by its products at
    67 TFLOP/s over the token tiles a top-1 dispatch of B tokens leaves
    live (``tiled_live_tiles``: 23.6 of the 32 128-slot tiles at C 256),
    each tile's rows read once and 2·tiles·128·V_pad·d products priced."""
    ctx = registry.KernelContext(B=B, d=1536, K=16, v_pad=12032, k=8, backend="cuda",
                                 wbytes=1 if quantized else 2, hbytes=2, quantized=quantized)
    C = ctx.capacity
    row = 1536 * ctx.wbytes + (4 if quantized else 0)
    nbytes = 16 * 12032 * row + 2 * 16 * C * 1536 * 2 + 16 * C * 64 + B * 64
    ops = int(2 * 16 * C * 12032 * 1536 * 3.35e12 / 989e12)
    fixup = registry.fixup_rows(ctx) * (3 * row + 8 * 1536)
    got = registry.get_spec("cuda_grouped").bytes_moved(ctx)
    assert got == max(nbytes, ops) + fixup
    assert (max(nbytes, ops) == ops) == (quantized and B == 2048)
    assert registry.resolve_kernel("auto", ctx) == "cuda_grouped"
    fp32 = registry.KernelContext(B=B, d=1536, K=16, v_pad=12032, k=8, backend="cuda",
                                  wbytes=1 if quantized else 4, hbytes=4, quantized=quantized)
    grouped = importlib.import_module("repro_torch.kernels.dss_topk_grouped")
    body = grouped.select_body(C, torch.float32)
    assert registry.grouped_body(fp32) == body
    if B == 2048:
        assert body == grouped.TILED
        row = 1536 * fp32.wbytes + (4 if quantized else 0)
        tiles = registry.tiled_live_tiles(2048, 16, 256, 128)
        nbytes = tiles * 12032 * row + 2 * 16 * 256 * 1536 * 4 + 16 * 256 * 64 + 2048 * 64
        ops = 2 * tiles * 128 * 12032 * 1536 * 3.35e12 / 67e12
        assert registry.get_spec("cuda_grouped").bytes_moved(fp32) == int(max(nbytes, ops)) \
            == int(ops)


@pytest.mark.parametrize("B,K,C,n_tile", [(40, 4, 20, 16), (9, 3, 8, 2), (7, 2, 128, 128),
                                           (5, 1, 20, 16), (3, 4, 64, 16)])
def test_tiled_live_tiles_is_the_expected_count_of_a_random_dispatch(B, K, C, n_tile):
    """The tiled body's live token tiles, in exact rational arithmetic: each
    of B tokens picks one of K experts with probability 1/K, an expert's
    slots fill from the first, and its tile j is live when more than
    j·n_tile tokens chose it."""
    from fractions import Fraction
    from math import comb

    p = Fraction(1, K)
    pmf = [comb(B, x) * p ** x * (1 - p) ** (B - x) for x in range(B + 1)]
    want = K * sum(sum(pmf[j * n_tile + 1:]) for j in range(-(-C // n_tile)))
    assert registry.tiled_live_tiles(B, K, C, n_tile) == pytest.approx(float(want), rel=1e-9)


@pytest.mark.parametrize("B,K,C", [(40, 16, 5), (64, 16, 8), (8, 16, 1), (9, 3, 2), (5, 1, 2),
                                   (3, 4, 64)])
def test_expected_overflow_is_the_expected_overflow_of_a_random_dispatch(B, K, C):
    """The grouped paths' overflowed tokens, in exact rational arithmetic:
    each of B tokens picks one of K experts with probability 1/K, and an
    expert chosen X times at capacity C leaves max(0, X − C) to the gather
    fixup."""
    from fractions import Fraction
    from math import comb

    p = Fraction(1, K)
    want = K * sum((x - C) * comb(B, x) * p ** x * (1 - p) ** (B - x) for x in range(C + 1, B + 1))
    assert registry.expected_overflow(B, K, C) == pytest.approx(float(want), rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("d,v_pad,quantized,expected", [
    (1536, 12032, False, "cuda_fused"), (1536, 12032, True, "cuda_fused"),
    (3072, 10112, False, "cuda_grouped"), (6144, 7808, False, "cuda_grouped"),
    (8192, 16128, True, "cuda_grouped")])
def test_auto_policy_at_the_verify_batch(d, v_pad, quantized, expected):
    """A verify step of 8 slots at gamma 4 (B 40, bf16 tokens) at the head
    shapes of qwen2-1.5b (K 16, C 5) and of llama3.2-3b, granite-20b and
    deepseek-67b (V_pad of their stand-in masks): at d 1536 the expected
    overflow's gather fixup tips it to the fused kernel; at d 3072 and up
    (K 8 there: C 10, 0.10 tokens expected over) the fused kernel reads an
    expert once per token or two, and the grouped kernel's one pass wins."""
    K = 16 if d <= 3072 else 8
    ctx = registry.KernelContext(B=40, d=d, K=K, v_pad=v_pad, k=8, backend="cuda",
                                 wbytes=1 if quantized else 2, hbytes=2, quantized=quantized)
    assert registry.resolve_kernel("auto", ctx) == expected


def test_tiled_live_tiles_at_the_batch_path_is_what_a_gate_left_live():
    """At the fp32 batch path's shape (B 2048, K 16, C 256, 128-slot tiles)
    the price counts 23.6 of the 32 token tiles live: chip_smoke.py's gate
    on random weights left 25 and 23 live (fp32 rows and their int8
    table), a balanced dispatch would leave 16."""
    tiles = registry.tiled_live_tiles(2048, 16, 256, 128)
    assert 23 <= tiles <= 25
    assert round(tiles, 1) == 23.6


@pytest.mark.parametrize("hbytes,wbytes,quantized", [(4, 4, False), (4, 1, True), (2, 2, False),
                                                     (2, 1, True)])
@pytest.mark.parametrize("B", [8, 64, 2048])
def test_cost_grouped_adds_its_products_on_the_card_only(B, hbytes, wbytes, quantized):
    """The plain grouped path: on the CPU its bytes (rows once per expert,
    the buffers' round trip, the (K, C, V_pad) logits written and read
    back, the outputs); on the card the same plus its bmm's 2·K·C·V_pad·d
    products over every slot, at 67 TFLOP/s for fp32 tokens and 989 for
    bf16, expressed as bytes at 3.35 TB/s."""
    kw = dict(B=B, d=1536, K=16, v_pad=12032, k=8, wbytes=wbytes, hbytes=hbytes,
              quantized=quantized)
    cpu = registry.KernelContext(backend="cpu", **kw)
    cuda = registry.KernelContext(backend="cuda", **kw)
    C = cpu.capacity
    row = 1536 * wbytes + (4 if quantized else 0)
    nbytes = (16 * 12032 * row + 2 * 16 * C * 1536 * hbytes + 2 * 16 * C * 12032 * 4
              + B * 8 * 8 + registry.fixup_rows(cpu) * (3 * row + 8 * 1536))
    spec = registry.get_spec("grouped")
    assert spec.bytes_moved(cpu) == nbytes
    rate = 67e12 if hbytes == 4 else 989e12
    assert spec.bytes_moved(cuda) == nbytes + int(2 * 16 * C * 12032 * 1536 * 3.35e12 / rate)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("B,backend,expected", [
    (2048, "cuda", "cuda_grouped"), (1, "cuda", "cuda_fused"), (8, "cuda", "cuda_fused"),
    (1, "cpu", "jnp"), (8, "cpu", "jnp"), (64, "cpu", "grouped"), (2048, "cpu", "grouped")])
def test_auto_policy_for_fp32_tokens(B, backend, expected, quantized):
    """qwen2-1.5b's head shape with fp32 tokens on an fp32 table or its
    int8 table: on the card 'auto' sends a batch of 2048 to the grouped
    kernel (its CUDA-core tiled body) and decode batches to the fused
    kernel; the CPU picks stay those of the bytes model."""
    ctx = registry.KernelContext(B=B, d=1536, K=16, v_pad=12032, k=8, backend=backend,
                                 wbytes=1 if quantized else 4, hbytes=4, quantized=quantized)
    assert registry.resolve_kernel("auto", ctx) == expected
