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
