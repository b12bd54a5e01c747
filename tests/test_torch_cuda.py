"""On the card: the hand-written CUDA kernels against their plain PyTorch
versions on the same CUDA tensors, and a small ServeSession whose greedy
streams must be identical on every serve path. Every test here is marked
``cuda`` and skips on a host without CUDA; run them on a GPU host with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX (the GPU host has none). Tolerances: ids equal;
values atol 1e-5 (fp32 sums of exact products in another order, over
d ≤ 256 here)."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _table(dev, K, v_pad, d, dtype, seed, empty=None, dup=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((K, v_pad, d), generator=g, device=dev) / d ** 0.5
    if dup:
        w[:, 1::2] = w[:, 0::2]
    ids = torch.randperm(4 * K * v_pad, generator=g, device=dev)[: K * v_pad].reshape(K, v_pad)
    sizes = torch.randint(v_pad // 2, v_pad + 1, (K,), generator=g, device=dev)
    if empty is not None:
        sizes[empty] = 0
    pad = torch.arange(v_pad, device=dev)[None, :] >= sizes[:, None]
    ids = torch.where(pad, -1, ids).to(torch.int32)
    w = torch.where(pad[..., None], 0.0, w)
    return w.to(dtype).contiguous(), ids, g


def _same(got, want, atol=1e-5):
    assert torch.equal(got[1], want[1])
    fin = torch.isfinite(want[0])
    assert torch.equal(fin, torch.isfinite(got[0]))
    torch.testing.assert_close(got[0][fin], want[0][fin], rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,d,B", [(4, 32, 16), (16, 256, 300), (64, 64, 8)])
def test_gate_top1_kernel(dev, dtype, K, d, B):
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(B)
    u = torch.randn((K, d), generator=g, device=dev).to(dtype)
    h = torch.randn((B, d), generator=g, device=dev).to(dtype)
    n = ops.gate_top1.launches
    i1, g1 = ops.gate_top1(u, h)
    i2, g2 = ref.gate_top1_ref(u, h)
    assert ops.gate_top1.launches == n + 1
    assert torch.equal(i1, i2)
    torch.testing.assert_close(g1, g2, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,v_pad,k,empty", [(8, 512, 8, None), (70, 900, 8, 2),
                                             (3, 192, 1, None), (256, 4096, 16, 0)])
def test_grouped_kernel(dev, dtype, C, v_pad, k, empty):
    from repro_torch.kernels import ops, ref

    K, d = 4, 128
    w, ids, g = _table(dev, K, v_pad, d, dtype, seed=C, empty=empty, dup=True)
    buf = torch.randn((K, C, d), generator=g, device=dev).to(dtype)
    g_buf = torch.rand((K, C), generator=g, device=dev)
    got = ops.dss_topk_grouped(w, ids, buf, g_buf, k)
    _same(got, ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k))
    if empty is not None:
        assert (got[1][empty] == -1).all() and (got[0][empty] == -1e9).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,k,e_base,K_real", [(8, 8, 0, 4), (37, 1, 0, 4), (128, 8, 2, 8)])
def test_fused_kernel(dev, dtype, B, k, e_base, K_real):
    from repro_torch.kernels import ops, ref

    K, d = 4, 128
    w, ids, g = _table(dev, K, 900, d, dtype, seed=B, dup=True)
    gate = torch.randn((K_real, d), generator=g, device=dev).to(dtype)
    h = torch.randn((B, d), generator=g, device=dev).to(dtype)
    got = ops.dss_topk_fused(gate, w, ids, h, k, e_base=e_base)
    want = ref.dss_topk_fused_ref(gate, w, ids, h, k, e_base)
    assert torch.equal(got[2], want[2])
    _same(got[:2], want[:2])


def _int8_table(dev, K, v_pad, d, seed, empty=None):
    w, ids, g = _table(dev, K, v_pad, d, torch.float32, seed, empty=empty, dup=True)
    scales = w.abs().amax(-1) / 127
    scales = torch.where(scales > 0, scales, 1.0)
    q = torch.round(w / scales[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scales, ids, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,v_pad,k,empty", [(1, 512, 8, None), (70, 900, 8, 2),
                                             (256, 4096, 16, 0)])
def test_grouped_kernel_int8(dev, dtype, C, v_pad, k, empty):
    from repro_torch.kernels import ops, ref

    K, d = 4, 128
    q, scales, ids, g = _int8_table(dev, K, v_pad, d, seed=C, empty=empty)
    buf = torch.randn((K, C, d), generator=g, device=dev).to(dtype)
    g_buf = torch.rand((K, C), generator=g, device=dev)
    n = ops.launch_counts()
    got = ops.dss_topk_grouped(q, ids, buf, g_buf, k, scales=scales)
    after = ops.launch_counts()
    assert after["dss_topk_grouped_q"] == n["dss_topk_grouped_q"] + 1
    assert after["dss_topk_grouped"] == n["dss_topk_grouped"]
    _same(got, ref.dss_topk_grouped_ref(q, ids, buf, g_buf, k, scales=scales))
    if empty is not None:
        assert (got[1][empty] == -1).all() and (got[0][empty] == -1e9).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,k,e_base,K_real", [(8, 8, 0, 4), (128, 8, 2, 8)])
def test_fused_kernel_int8(dev, dtype, B, k, e_base, K_real):
    from repro_torch.kernels import ops, ref

    K, d = 4, 128
    q, scales, ids, g = _int8_table(dev, K, 900, d, seed=B)
    gate = torch.randn((K_real, d), generator=g, device=dev).to(dtype)
    h = torch.randn((B, d), generator=g, device=dev).to(dtype)
    n = ops.launch_counts()["dss_topk_fused_q"]
    got = ops.dss_topk_fused(gate, q, ids, h, k, scales=scales, e_base=e_base)
    assert ops.launch_counts()["dss_topk_fused_q"] == n + 1
    want = ref.dss_topk_fused_ref(gate, q, ids, h, k, e_base, scales=scales)
    assert torch.equal(got[2], want[2])
    _same(got[:2], want[:2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,k", [(8, 8), (37, 1), (300, 16)])
def test_pertoken_kernel(dev, dtype, B, k):
    """Expert 1 holds 5 real rows: its tokens' tails are (-1e9, -1)."""
    from repro_torch.kernels import ops, ref

    K, d, v_pad = 4, 128, 900
    w, ids, g = _table(dev, K, v_pad, d, dtype, seed=B, dup=True)
    ids[1, 5:] = -1
    w[1, 5:] = 0
    h = torch.randn((B, d), generator=g, device=dev).to(dtype)
    e = torch.randint(0, K, (B,), generator=g, device=dev).to(torch.int32)
    e[0] = 1
    gv = torch.rand((B,), generator=g, device=dev)
    n = ops.launch_counts()["dss_topk"]
    got = ops.dss_topk(w, ids, h, e, gv, k)
    assert ops.launch_counts()["dss_topk"] == n + 1
    h_scaled = (h.float() * gv[:, None]).to(dtype)
    _same(got, ref.dss_topk_ref(w, ids, h_scaled, e, k))
    short = e == 1
    if k > 5:
        assert (got[1][short, 5:] == -1).all() and (got[0][short, 5:] == -1e9).all()


def test_quantized_serve_with_fallback_experts(dev):
    """An int8 table with half its experts on fp fallback: cuda_grouped
    and cuda_fused give the jnp path's ids on the card."""
    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops

    K, d, v_pad = 8, 128, 640
    w, ids, g = _table(dev, K, v_pad, d, torch.bfloat16, seed=3)
    gate = torch.randn((K, d), generator=g, device=dev).to(torch.bfloat16)
    h = torch.randn((64, d), generator=g, device=dev).to(torch.bfloat16)
    qt = ds.quantize_table(ds.ServeTable(ids=ids, weights=w),
                           fb_mask=torch.arange(K) % 2 == 1)
    assert qt.n_fallback == K // 2
    want = ds.serve_topk(gate, qt, h, 8, kernel="jnp")
    ops.reset_launch_counts()
    for kern in ("cuda_grouped", "cuda_fused"):
        _same(ds.serve_topk(gate, qt, h, 8, kernel=kern, capacity_factor=1.0), want,
              atol=1e-4)
    c = ops.launch_counts()
    assert c["dss_topk_grouped_q"] == 1 and c["dss_topk_fused_q"] == 1
    assert c["dss_topk_grouped"] == c["dss_topk_fused"] == 0


def test_session_streams_identical_on_every_path(dev):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.train import Request, SamplingParams, ServeSession

    cfg = reduce_config(get_config("qwen2-1.5b"), vocab=1024)
    bundle = build(cfg)
    params, state = bundle.init(torch.Generator(device=dev).manual_seed(0))
    table = ds.pack_experts(params["head"], state)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 1024, rng.randint(3, 90)).astype(np.int32) for _ in range(6)]
    streams = {}
    for kern in ("jnp", "grouped", "cuda_grouped", "cuda_fused"):
        ops.reset_launch_counts()
        sess = ServeSession(bundle, params, table, n_slots=2, max_seq_len=128, kernel=kern)
        reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=6)) for p in prompts]
        sess.run(reqs)
        streams[kern] = [r.out_tokens for r in reqs]
        counts = ops.launch_counts()
        if kern == "cuda_grouped":
            assert counts["gate_top1"] > 0 and counts["dss_topk_grouped"] > 0
        elif kern == "cuda_fused":
            assert counts["dss_topk_fused"] > 0
        else:
            assert not any(counts.values())
    assert all(s == streams["jnp"] for s in streams.values())


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_session_streams_identical_fp32_and_int8(dev, quantize):
    """fp32 weights (the g fold of cuda_pertoken rounds nothing there) and
    an int8 table with fallback experts: every path's greedy streams
    equal the jnp path's, and each path launches its own kernel bodies."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.train import Request, SamplingParams, ServeSession

    cfg = reduce_config(get_config("qwen2-1.5b"), vocab=1024).replace(dtype="float32")
    bundle = build(cfg)
    params, state = bundle.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 1024, rng.randint(3, 60)).astype(np.int32) for _ in range(5)]
    kerns = ("jnp", "cuda_grouped", "cuda_fused") + (("cuda_pertoken",) if quantize is None
                                                     else ())
    need = {"cuda_grouped": "dss_topk_grouped", "cuda_fused": "dss_topk_fused",
            "cuda_pertoken": "dss_topk"}
    streams = {}
    for kern in kerns:
        ops.reset_launch_counts()
        sess = ServeSession(bundle, params, state, n_slots=2, max_seq_len=128, kernel=kern,
                            quantize=quantize, quantize_calib=64,
                            quantize_flip_threshold=0.3)
        reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=6)) for p in prompts]
        sess.run(reqs)
        streams[kern] = [r.out_tokens for r in reqs]
        counts = ops.launch_counts()
        if kern in need:
            assert counts[need[kern] + ("_q" if quantize else "")] > 0, (kern, counts)
        else:
            assert not any(counts.values())
    assert all(s == streams["jnp"] for s in streams.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N,d,offset", [(4, 1000, 64, 0), (3, 257, 100, 0), (2, 64, 7, 0),
                                          (16, 4096, 1536, 0), (3, 300, 1536, 1),
                                          (2, 129, 37, 3)])
def test_lasso_prune_kernel(dev, dtype, K, N, d, offset):
    """Norms rtol 1e-5 (fp32 sums of exact bf16 squares, or of fp32 fmas,
    in another order), masks equal; expert 1 is all masked; ``offset``
    shifts the rows off 16-byte alignment (scalar head and tail)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.testing import gamma_between

    g = torch.Generator(device=dev).manual_seed(N + d)
    flat = torch.empty(K * N * d + offset, dtype=dtype, device=dev)
    w = flat[offset:].view(K, N, d)
    w.copy_(torch.randn((K, N, d), generator=g, device=dev) * 0.2)
    mask = torch.rand((K, N), generator=g, device=dev) < 0.8
    mask[1] = False
    gamma = gamma_between(ref.lasso_prune_ref(w, mask, 0.0)[0], mask, 0.5)
    n = ops.lasso_prune.launches
    norms, new_mask = ops.lasso_prune(w, mask, gamma)
    assert ops.lasso_prune.launches == n + 1
    want_n, want_m = ref.lasso_prune_ref(w, mask, gamma)
    assert torch.equal(new_mask, want_m)
    torch.testing.assert_close(norms, want_n, rtol=1e-5, atol=1e-6)
    assert (norms[~mask] == 0).all() and not new_mask[1].any()
    assert 0 < int(new_mask.sum()) < int(mask.sum())


def test_lasso_prune_kernel_above_2_31_elements(dev):
    """64-bit row offsets: (2, 2^20 + 3, 1100) bf16 holds 2.3e9 elements."""
    from repro_torch.kernels import ops, ref
    from repro_torch.testing import gamma_between

    K, N, d = 2, (1 << 20) + 3, 1100
    if torch.cuda.mem_get_info()[0] < 24 * 2**30:
        pytest.skip("needs 24 GiB of free device memory")
    g = torch.Generator(device=dev).manual_seed(9)
    w = torch.empty((K, N, d), dtype=torch.bfloat16, device=dev)
    for e in range(K):
        w[e] = torch.randn((N, d), generator=g, device=dev) * 0.2
    assert w.numel() > 2**31
    mask = torch.rand((K, N), generator=g, device=dev) < 0.9
    gamma = gamma_between(ref.lasso_prune_ref(w, mask, 0.0)[0], mask, q=0.25)
    norms, new_mask = ops.lasso_prune(w, mask, gamma)
    want_n, want_m = ref.lasso_prune_ref(w, mask, gamma)
    assert torch.equal(new_mask, want_m)
    torch.testing.assert_close(norms, want_n, rtol=1e-5, atol=1e-6)
    assert bool(new_mask[-1, -1]) == bool(want_m[-1, -1])  # the last row is reached


def test_adaptive_session_launches_lasso_prune(dev):
    """A skewed session on cuda_grouped re-prunes through the kernel: one
    swap, the window's overflow cleared, lasso_prune launched, and the
    streams equal a jnp session adapting the same way."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import build
    from repro_torch.serve import AdaptPolicy
    from repro_torch.testing import gamma_between, skew_gate
    from repro_torch.train import Request, SamplingParams, ServeSession

    cfg = reduce_config(get_config("qwen2-1.5b"), vocab=1024).replace(dtype="float32")
    cfg = cfg.replace(ds=cfg.ds.replace(capacity_factor=0.25))
    bundle = build(cfg)
    params, state = bundle.init(torch.Generator(device=dev).manual_seed(0))
    params = skew_gate(params)
    gamma = gamma_between(ref.lasso_prune_ref(params["head"]["experts"], state.mask, 0.0)[0],
                          state.mask, q=0.3)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 1024, rng.randint(3, 30)).astype(np.int32) for _ in range(8)]
    streams = {}
    for kern in ("jnp", "cuda_grouped"):
        ops.reset_launch_counts()
        sess = ServeSession(bundle, params, state, n_slots=8, max_seq_len=64, kernel=kern,
                            overflow_threshold=1.1,
                            adapt_policy=AdaptPolicy(interval=4, min_window_steps=2,
                                                     overflow_threshold=-1.0,
                                                     mitosis_overflow_threshold=0.1,
                                                     max_swaps=1, prune_gamma=gamma))
        reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=12)) for p in prompts]
        sess.run(reqs)
        s = sess.stats()
        assert s["n_swaps"] == 1 and s["decode_builds"] == 2
        assert ops.launch_counts()["lasso_prune"] == 1
        if kern == "cuda_grouped":
            assert s["overflow_rate_window"] == 0.0 and ops.launch_counts()["gate_top1"] > 0
        streams[kern] = [r.out_tokens for r in reqs]
    assert streams["cuda_grouped"] == streams["jnp"]


def test_breaker_trip_2_serves_through_the_fused_kernel(dev):
    """On skewed traffic the breaker trips twice on cuda_grouped; after
    trip 2 the session launches dss_topk_fused (no capacity buffers) and
    never the grouped body, and its streams equal a jnp session's on the
    same skewed params."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.testing import skew_gate
    from repro_torch.train import Request, SamplingParams, ServeSession

    cfg = reduce_config(get_config("qwen2-1.5b"), vocab=1024).replace(dtype="float32")
    cfg = cfg.replace(ds=cfg.ds.replace(capacity_factor=0.25))
    bundle = build(cfg)
    params, state = bundle.init(torch.Generator(device=dev).manual_seed(0))
    params = skew_gate(params)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 1024, rng.randint(3, 30)).astype(np.int32) for _ in range(8)]
    streams = {}
    for kern in ("jnp", "cuda_grouped"):
        sess = ServeSession(bundle, params, state, n_slots=8, max_seq_len=64, kernel=kern,
                            overflow_threshold=0.3, overflow_window=4)
        reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=16)) for p in prompts]
        for r in reqs:
            sess.submit(r)
        after_trip2 = None
        while sess.step():
            if after_trip2 is None and sess.stats()["breaker_trips"] == 2:
                ops.reset_launch_counts()
                after_trip2 = True
        s = sess.stats()
        streams[kern] = [r.out_tokens for r in reqs]
        if kern == "jnp":
            assert s["breaker_trips"] == 0
            continue
        assert after_trip2 and s["breaker_trips"] == 2 and s["decode_builds"] == 3
        assert s["effective_kernel"] == "cuda_fused"
        counts = ops.launch_counts()
        assert counts["dss_topk_fused"] > 0 and counts["dss_topk_grouped"] == 0, counts
    assert streams["cuda_grouped"] == streams["jnp"]
