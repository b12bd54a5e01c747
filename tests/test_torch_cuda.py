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
@pytest.mark.parametrize("K,d,B", [(4, 32, 16), (16, 256, 300), (64, 64, 8),
                                   # d that no 16-byte load divides: one element per load
                                   (8, 37, 9), (8, 37, 700)])
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
@pytest.mark.parametrize("K,B", [(16, 1), (16, 8), (16, 2048), (64, 8), (64, 600)])
def test_gate_top1_kernel_serve_shapes(dev, dtype, K, B):
    """qwen2-1.5b's d 1536 at the serving path's B (1 at prefill, 8 at
    decode) and at larger B (one block per token), with the gate drawn as
    the model draws it, N(0, 1/d) (unit-scale logits: at |z| ~ 40, as
    unscaled rows give, two fp32 summation orders alone part g by ~2e-5
    relative)."""
    from repro_torch.kernels import ops, ref

    d = 1536
    g = torch.Generator(device=dev).manual_seed(B + K)
    u = (torch.randn((K, d), generator=g, device=dev) * d ** -0.5).to(dtype)
    h = torch.randn((B, d), generator=g, device=dev).to(dtype)
    n = ops.gate_top1.launches
    i1, g1 = ops.gate_top1(u, h)
    i2, g2 = ref.gate_top1_ref(u, h)
    assert ops.gate_top1.launches == n + 1
    assert torch.equal(i1, i2)
    torch.testing.assert_close(g1, g2, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("B", [8, 2048])
def test_gate_top1_kernel_ties_go_to_the_lower_expert(dev, B):
    """Experts 3 and 11 have identical rows that win every token: their
    logits and probabilities are equal, and idx is the lower expert,
    exactly as the plain version's first argmax gives."""
    from repro_torch.kernels import ops, ref

    K, d = 16, 1536
    g = torch.Generator(device=dev).manual_seed(11)
    h = torch.randn((B, d), generator=g, device=dev).abs().to(torch.bfloat16)
    u = (torch.randn((K, d), generator=g, device=dev) * 0.01).to(torch.bfloat16)
    u[3] = u[11] = torch.full((d,), 0.05, device=dev).to(torch.bfloat16)
    i1, g1 = ops.gate_top1(u, h)
    i2, g2 = ref.gate_top1_ref(u, h)
    assert torch.equal(i2, torch.full_like(i2, 3))
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
    from repro_torch.kernels.dss_topk_grouped import select_body

    n = ops.launch_counts()
    got = ops.dss_topk_grouped(w, ids, buf, g_buf, k)
    body = select_body(C, dtype)
    assert ops.launch_counts()[body] == n[body] + 1
    _same(got, ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k))
    if empty is not None:
        assert (got[1][empty] == -1).all() and (got[0][empty] == -1e9).all()


# (B, k, d, e_base, K_real): B 1 to 300, k 1 to 64, d 37 and 200 (rows no
# 16-byte load aligns to) beside 128; e_base > 0 leaves foreign tokens,
# K_real < K experts that no token can choose. v_pad 900 is no multiple of
# any row chunk.
FUSED_CASES = [(1, 8, 128, 0, 4), (8, 8, 128, 0, 4), (8, 64, 128, 0, 4), (37, 1, 37, 0, 4),
               (128, 8, 200, 2, 8), (300, 64, 128, 0, 3), (300, 8, 37, 1, 4), (8, 1, 200, 0, 3)]
FUSED_V_PAD, FUSED_K, FUSED_EMPTY = 900, 4, 1


def _fused_inputs(dev, dtype, B, d, e_base, K_real, seed):
    """fp32 rows (K 4, v_pad 900, rows 2i and 2i+1 equal) with local
    expert 1 all padding and chosen by token 0 whenever it is on the
    gate; rows 5 all zero; rows cb - 1 and cb (cb the kernel's chunk length
    for the number of experts these tokens choose: the first row chunk's
    boundary) equal, at 2.5 times the others' scale so they
    reach the top k of many tokens. Returns (gate, h, w fp32, ids)."""
    from repro_torch.kernels.dss_topk_fused import launch_plan
    from repro_torch.kernels.retrieve_stream import chunk_rows

    K, v_pad = FUSED_K, FUSED_V_PAD
    w, ids, g = _table(dev, K, v_pad, d, torch.float32, seed=seed, empty=FUSED_EMPTY, dup=True)
    gate = torch.randn((K_real, d), generator=g, device=dev).to(dtype)
    h = torch.randn((B, d), generator=g, device=dev).to(dtype)
    if e_base + FUSED_EMPTY < K_real:
        gate[e_base + FUSED_EMPTY] = 2 * h[0]
    w[:, 5] = 0.0
    local = torch.argmax(h.float() @ gate.float().T, -1) - e_base
    n_sel = int(torch.unique(local[(local >= 0) & (local < K)]).numel())
    cb = chunk_rows(n_sel, v_pad, launch_plan(B, K, v_pad, d, dtype).grid)
    real = (ids[:, cb - 1] >= 0) & (ids[:, cb] >= 0)
    w[real, cb - 1] *= 2.5
    w[real, cb] = w[real, cb - 1]
    return gate, h, w, ids


def _check_fused(got, want, e_base, K_real):
    assert torch.equal(got[2], want[2])
    _same(got[:2], want[:2])
    local = want[2].long() - e_base
    mine = (local >= 0) & (local < FUSED_K)
    assert not torch.isinf(got[0][mine]).any()
    assert (got[1][~mine] == -1).all() and torch.isneginf(got[0][~mine]).all()
    if e_base + FUSED_EMPTY < K_real:  # token 0 chose the all-padding expert
        assert int(want[2][0]) == e_base + FUSED_EMPTY
        assert (got[1][0] == -1).all() and (got[0][0] == -1e9).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,k,d,e_base,K_real", FUSED_CASES)
def test_fused_kernel(dev, dtype, B, k, d, e_base, K_real):
    from repro_torch.kernels import ops, ref

    gate, h, w, ids = _fused_inputs(dev, dtype, B, d, e_base, K_real, seed=B + d)
    w = w.to(dtype)
    n = ops.launch_counts()["dss_topk_fused"]
    got = ops.dss_topk_fused(gate, w, ids, h, k, e_base=e_base)
    assert ops.launch_counts()["dss_topk_fused"] == n + 1
    _check_fused(got, ref.dss_topk_fused_ref(gate, w, ids, h, k, e_base), e_base, K_real)


def _quantize(w):
    scales = w.abs().amax(-1) / 127
    scales = torch.where(scales > 0, scales, 1.0)
    return torch.round(w / scales[..., None]).clamp(-127, 127).to(torch.int8), scales


def _int8_table(dev, K, v_pad, d, seed, empty=None):
    w, ids, g = _table(dev, K, v_pad, d, torch.float32, seed, empty=empty, dup=True)
    q, scales = _quantize(w)
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
    from repro_torch.kernels.dss_topk_grouped import select_body

    body = select_body(C, dtype)
    assert after[body + "_q"] == n[body + "_q"] + 1
    assert after[body] == n[body]
    _same(got, ref.dss_topk_grouped_ref(q, ids, buf, g_buf, k, scales=scales))
    if empty is not None:
        assert (got[1][empty] == -1).all() and (got[0][empty] == -1e9).all()


# The decode body (kernels/dss_topk_grouped.py::DECODE) on K 4 experts of
# v_pad 900 (no row chunk divides it): rows 2i and 2i+1 equal, rows 5 all
# zero, expert 1 all padding, expert 2 with 5 real rows, expert 3 with no
# live slot, and slot C - 1 of expert 0 empty when C > 1 (an empty slot as
# the dispatch leaves it: a zero row and g 0); rows cb - 1 and cb (cb the
# first row chunk's boundary for the experts that hold a slot) equal and
# doubled to reach the top k. Rows lie on a grid of 1/64 in [-2, 2] and
# tokens are integers in [-8, 8], so every product and every partial sum
# is exact in fp32 (bf16 holds them too): the kernel's sums equal the plain
# version's whatever their order, and equal rows tie exactly. Every slot is
# compared, empty ones too.
GROUPED_DECODE_V_PAD, GROUPED_DECODE_K = 900, 4


def _decode_inputs(dev, dtype, C, d, seed, quantized):
    from repro_torch.kernels.dss_topk_grouped import launch_plan
    from repro_torch.kernels.retrieve_stream import chunk_rows

    K, v_pad = GROUPED_DECODE_K, GROUPED_DECODE_V_PAD
    _, ids, g = _table(dev, K, v_pad, d, torch.float32, seed=seed, empty=1)
    ids[2, 5:] = -1
    w = torch.randint(-128, 129, (K, v_pad, d), generator=g, device=dev).float() / 64
    w[:, 1::2] = w[:, 0::2]
    w[ids < 0] = 0.0
    w[:, 5] = 0.0
    buf = torch.randint(-8, 9, (K, C, d), generator=g, device=dev).to(dtype)
    g_buf = torch.rand((K, C), generator=g, device=dev) * 0.5 + 0.5
    g_buf[3] = 0.0
    if C > 1:
        g_buf[0, C - 1] = 0.0
    buf[g_buf == 0] = 0.0
    cb = chunk_rows(3, v_pad, launch_plan(K, v_pad, d, dtype).grid)
    real = (ids[:, cb - 1] >= 0) & (ids[:, cb] >= 0)
    w[real, cb - 1] *= 2
    w[real, cb] = w[real, cb - 1]
    kw = {}
    if quantized:
        w, kw["scales"] = _quantize(w)
        assert (w[:, 5] == 0).all() and (kw["scales"][:, 5] == 1.0).all()
    else:
        w = w.to(dtype)
    return w, ids, buf, g_buf, kw


def _check_decode(got, want, g_buf, k):
    _same(got, want)
    assert not torch.isinf(got[0]).any()
    assert (got[1][1] == -1).all() and (got[0][1] == -1e9).all()  # all padding
    n_real = min(k, 5)  # expert 2: 5 real rows, then padding
    assert (got[1][2, :, n_real:] == -1).all() and (got[1][2, :, :n_real] >= 0).all()
    assert (got[0][3] == 0).all()  # no live slot: the first k real rows at 0


@pytest.mark.parametrize("quantized,dtype", [(False, torch.float32), (False, torch.bfloat16),
                                             (True, torch.bfloat16)])
@pytest.mark.parametrize("C", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("d", [37, 128, 200, 1536])
def test_grouped_decode_body(dev, quantized, dtype, C, k, d):
    """Both decode bodies against the plain version on every slot. d 37
    and 200 admit no 16-byte row load (f32/bf16 at 37, int8 at both)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dss_topk_grouped import DECODE, launch_body

    w, ids, buf, g_buf, kw = _decode_inputs(dev, dtype, C, d, seed=C * 7 + d + k, quantized=quantized)
    body = DECODE + ("_q" if quantized else "")
    n = ops.launch_counts()[body]
    got = launch_body(w, ids, buf, g_buf, k, kw.get("scales"), DECODE)
    assert ops.launch_counts()[body] == n + 1
    _check_decode(got, ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k, **kw), g_buf, k)


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("B,K,cf", [(8, 16, 2.0), (20, 8, 2.0), (5, 16, 1.0)])
def test_grouped_decode_body_on_a_real_dispatch(dev, quantize, B, K, cf):
    """Buffers from the serve path's own dispatch (``_group_tokens`` over
    ``gate_top1``'s choices) at qwen2-1.5b's width: experts that no token
    chose and slots left empty, compared on every slot."""
    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops, ref

    d, v_pad, k = 1536, 1000, 8
    w, ids, g = _table(dev, K, v_pad, d, torch.bfloat16, seed=B + K)
    table = ds.ServeTable(ids=ids, weights=w)
    kw = {}
    if quantize:
        table = ds.quantize_table(table)
        w, kw["scales"] = table.qweights, table.scales
    gate = (torch.randn((K, d), generator=g, device=dev) * d ** -0.5).to(torch.bfloat16)
    h = torch.randn((B, d), generator=g, device=dev).to(torch.bfloat16)
    e, gv = ops.gate_top1(gate, h)
    C = int(max(1, round(B / K * cf)))
    buf, g_buf, _, _ = ds._group_tokens(h, gv, e, K, C)
    assert not (g_buf != 0).all()
    if B < K:
        assert not (g_buf != 0).any(1).all()
    got = ops.dss_topk_grouped(w, ids, buf, g_buf, k, **kw)
    _same(got, ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k, **kw))
    assert not torch.isinf(got[0]).any()


def test_grouped_decode_body_on_an_int8_table_with_fallback_experts(dev):
    """On an int8 table the fallback experts' tokens go to the sentinel K
    before dispatch (``_serve_topk_grouped``): those experts hold no live
    slot, and the int8 decode body's output (forced at C 4, above
    TILED_ABOVE) equals the plain version's on every slot."""
    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dss_topk_grouped import DECODE, launch_body

    K, d, v_pad, B, k = 8, 128, 640, 16, 8
    w, ids, g = _table(dev, K, v_pad, d, torch.bfloat16, seed=9)
    qt = ds.quantize_table(ds.ServeTable(ids=ids, weights=w), fb_mask=torch.arange(K) % 2 == 1)
    gate = torch.randn((K, d), generator=g, device=dev).to(torch.bfloat16)
    h = torch.randn((B, d), generator=g, device=dev).to(torch.bfloat16)
    e, gv = ops.gate_top1(gate, h)
    fb_tok = qt.fb_index[e.long()] >= 0
    assert fb_tok.any()
    e_disp = torch.where(fb_tok, K, e)
    buf, g_buf, _, _ = ds._group_tokens(h, gv, e_disp, K, 4)
    assert (g_buf[1::2] == 0).all()
    n = ops.launch_counts()["dss_topk_grouped_q"]
    got = launch_body(qt.qweights, ids, buf, g_buf, k, qt.scales, DECODE)
    assert ops.launch_counts()["dss_topk_grouped_q"] == n + 1
    _same(got, ref.dss_topk_grouped_ref(qt.qweights, ids, buf, g_buf, k, scales=qt.scales))


@pytest.mark.parametrize("quantized", [False, True])
def test_grouped_decode_body_replays_in_a_cuda_graph(dev, quantized):
    """The wrapper captured once in a CUDA graph (the work list is built on
    the device, no host sync, no allocation in the kernels) and replayed
    on new slots copied into the captured buffers, with other experts
    live each time, gives the eager call's result exactly."""
    from repro_torch.kernels import ops

    C, k, d = 2, 8, 128
    w, ids, buf, g_buf, kw = _decode_inputs(dev, torch.bfloat16, C, d, seed=5, quantized=quantized)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.dss_topk_grouped(w, ids, buf, g_buf, k, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.dss_topk_grouped(w, ids, buf, g_buf, k, **kw)
    for seed, dead in ((6, 0), (7, 2)):
        gen = torch.Generator(device=dev).manual_seed(seed)
        b_new = torch.randn(buf.shape, generator=gen, device=dev).to(buf.dtype)
        g_new = torch.rand(g_buf.shape, generator=gen, device=dev) + 0.25
        g_new[dead] = 0.0
        b_new[g_new == 0] = 0.0
        buf.copy_(b_new)
        g_buf.copy_(g_new)
        graph.replay()
        torch.cuda.synchronize()
        want = ops.dss_topk_grouped(w, ids, b_new, g_new, k, **kw)
        for a, b in zip(out, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("quantized", [False, True])
def test_grouped_bodies_launch_by_capacity(dev, quantized):
    """Through the wrapper, bf16 tokens launch the decode body at every
    capacity up to TILED_ABOVE and the tensor-core body above it; fp32
    tokens the decode body up to SIMT_TILED_ABOVE and the CUDA-core tiled
    body above it. Exactly one body launches per call."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dss_topk_grouped import (DECODE, SIMT_TILED_ABOVE, TILED,
                                                      TILED_ABOVE, WGMMA)

    d, k = 128, 8
    sfx = "_q" if quantized else ""
    runs = [(torch.bfloat16, C, DECODE if C <= TILED_ABOVE else WGMMA)
            for C in list(range(1, TILED_ABOVE + 1)) + [TILED_ABOVE + 1, 33, 70, 256]]
    runs += [(torch.float32, C, DECODE if C <= SIMT_TILED_ABOVE else TILED)
             for C in (1, SIMT_TILED_ABOVE, SIMT_TILED_ABOVE + 1, 70)]
    for dtype, C, want_body in runs:
        w, ids, buf, g_buf, kw = _decode_inputs(dev, dtype, C, d, seed=C, quantized=quantized)
        ops.reset_launch_counts()
        got = ops.dss_topk_grouped(w, ids, buf, g_buf, k, **kw)
        counts = ops.launch_counts()
        assert counts[want_body + sfx] == 1 and sum(counts.values()) == 1, (dtype, C, counts)
        _same(got, ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k, **kw))


# The tensor-core body (kernels/dss_topk_grouped.py::WGMMA) on the decode
# body's exact inputs: rows on the 1/64 grid, integer tokens, so every fp32
# sum is exact in any order and the ids must be equal; equal rows tie and
# the lower packed position wins (inside a warpgroup's tile, across the two
# warpgroups, across tiles and across vocab splits); expert 1 all padding,
# expert 2 with 5 real rows, expert 3 and one slot of expert 0 empty (g 0).
# C above 256 takes more than one token tile; V_pad 900 leaves a ragged
# 128-row tile; d 144 is no multiple of the 64-element stage (16 for int8).
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("C", [1, 8, 33, 64, 200, 256, 300])
@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("d", [64, 144, 1536])
def test_grouped_wgmma_body(dev, quantized, C, k, d):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dss_topk_grouped import WGMMA, launch_body

    w, ids, buf, g_buf, kw = _decode_inputs(dev, torch.bfloat16, C, d, seed=C * 7 + d + k,
                                            quantized=quantized)
    body = WGMMA + ("_q" if quantized else "")
    n = ops.launch_counts()[body]
    got = launch_body(w, ids, buf, g_buf, k, kw.get("scales"), WGMMA)
    assert ops.launch_counts()[body] == n + 1
    _check_decode(got, ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k, **kw), g_buf, k)


@pytest.mark.parametrize("quantized,d", [(False, 37), (True, 37), (True, 200)])
def test_grouped_tiled_body_takes_bf16_that_tma_cannot_address(dev, quantized, d):
    """bf16 tokens above TILED_ABOVE whose rows TMA cannot stage (d 37: a
    row pitch of 74 bytes; d 200 with int8 rows: 200 bytes) run the
    CUDA-core tiled body through the wrapper, equal to the plain version."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dss_topk_grouped import TILED, tma_addressable

    C, k = 70, 8
    w, ids, buf, g_buf, kw = _decode_inputs(dev, torch.bfloat16, C, d, seed=d, quantized=quantized)
    assert not tma_addressable(d, w.dtype, w.data_ptr(), buf.data_ptr())
    body = TILED + ("_q" if quantized else "")
    ops.reset_launch_counts()
    got = ops.dss_topk_grouped(w, ids, buf, g_buf, k, **kw)
    assert ops.launch_counts()[body] == 1
    _check_decode(got, ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k, **kw), g_buf, k)


# The CUDA-core tiled body (kernels/dss_topk_grouped.py::TILED) with fp32
# tokens on the decode body's exact inputs (rows on the 1/64 grid, integer
# tokens: every fp32 sum is exact in any order, so the ids must be equal and
# equal rows tie to the lower packed position, inside a row tile, across
# tiles and across vocab chunks). Expert 1 is all padding, expert 2 has 5
# real rows (fewer than k at k 8 and 64; all its other row tiles are
# padding alone), expert 3 has no live slot (every token tile empty); every
# third slot of expert 0 is empty (live slots that are no prefix), and past
# the first token tile expert 2's slots are empty (a token tile with no live
# slot beside a live one). C 1 and 8 take 16-slot tiles, 33 a 64-slot tile,
# 100 to 300 128-slot tiles (300: three); V_pad 900 leaves a ragged row
# tile; d 37 and 144 are no multiple of the 32-element stage (37 loads one
# element at a time).
def _tiled_inputs(dev, C, d, seed, quantized):
    w, ids, buf, g_buf, kw = _decode_inputs(dev, torch.float32, C, d, seed, quantized)
    g_buf[0, 1::3] = 0.0
    g_buf[2, 128:] = 0.0
    buf[g_buf == 0] = 0.0
    return w, ids, buf, g_buf, kw


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("C", [1, 8, 33, 100, 200, 256, 300])
@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("d", [37, 144, 1536])
def test_grouped_tiled_body(dev, quantized, C, k, d):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dss_topk_grouped import TILED, launch_body

    w, ids, buf, g_buf, kw = _tiled_inputs(dev, C, d, seed=C * 7 + d + k, quantized=quantized)
    body = TILED + ("_q" if quantized else "")
    n = ops.launch_counts()[body]
    got = launch_body(w, ids, buf, g_buf, k, kw.get("scales"), TILED)
    assert ops.launch_counts()[body] == n + 1
    _check_decode(got, ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k, **kw), g_buf, k)


@pytest.mark.parametrize("quantized", [False, True])
def test_grouped_tiled_body_replays_in_a_cuda_graph(dev, quantized):
    """The tiled body through the wrapper (fp32 tokens, C 70 above
    SIMT_TILED_ABOVE), captured once in a CUDA graph (the work counter is
    reset by a memset in the graph, the skipped tiles are found on the
    device, nothing syncs the host or allocates in the kernels) and
    replayed on new tokens with other experts live each time, gives the
    eager call's result exactly."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dss_topk_grouped import SIMT_TILED_ABOVE, TILED

    C, k, d = 70, 8, 128
    assert C > SIMT_TILED_ABOVE
    w, ids, buf, g_buf, kw = _tiled_inputs(dev, C, d, seed=5, quantized=quantized)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.dss_topk_grouped(w, ids, buf, g_buf, k, **kw)
    torch.cuda.current_stream().wait_stream(side)
    body = TILED + ("_q" if quantized else "")
    n = ops.launch_counts()[body]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.dss_topk_grouped(w, ids, buf, g_buf, k, **kw)
    assert ops.launch_counts()[body] == n + 1
    for seed, dead in ((6, 0), (7, 2)):
        gen = torch.Generator(device=dev).manual_seed(seed)
        b_new = torch.randint(-8, 9, buf.shape, generator=gen, device=dev).to(buf.dtype)
        g_new = torch.rand(g_buf.shape, generator=gen, device=dev) + 0.25
        g_new[dead] = 0.0
        b_new[g_new == 0] = 0.0
        buf.copy_(b_new)
        g_buf.copy_(g_new)
        graph.replay()
        torch.cuda.synchronize()
        want = ops.dss_topk_grouped(w, ids, b_new, g_new, k, **kw)
        for a, b in zip(out, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_auto_picks_the_grouped_kernel_for_an_fp32_batch(dev, quantize):
    """qwen2-1.5b's head shape with fp32 tokens on an fp32 table (or its
    int8 table) at B 2048: 'auto' resolves to cuda_grouped, which launches
    the CUDA-core tiled body and gives the plain grouped path's result.
    Rows on the 1/64 grid and integer tokens keep every sum exact, so the
    ids are equal; the values differ by the gate alone (rtol 1e-5, as in
    the bf16 batch test)."""
    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops, registry

    K, d, v_pad, k, B = 16, 1536, 12032, 8, 2048
    g = torch.Generator(device=dev).manual_seed(B + 1)
    w = torch.randint(-128, 129, (K, v_pad, d), generator=g, device=dev) / 64
    ids = torch.randperm(K * v_pad, generator=g, device=dev).reshape(K, v_pad).to(torch.int32)
    table = ds.ServeTable(ids=ids, weights=w)
    if quantize:
        table = ds.quantize_table(table)
        del w
    gate = torch.randn((K, d), generator=g, device=dev) * d ** -0.5
    h = torch.randint(-8, 9, (B, d), generator=g, device=dev).float()
    assert registry.resolve_kernel("auto", ds.serve_kernel_context(table, h, k)) == "cuda_grouped"
    body = "dss_topk_grouped_tiled" + ("_q" if quantize else "")
    ops.reset_launch_counts()
    got = ds.serve_topk(gate, table, h, k, kernel="auto")
    assert ops.launch_counts()[body] == 1
    want = ds.serve_topk(gate, table, h, k, kernel="grouped")
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)


@pytest.mark.parametrize("quantized", [False, True])
def test_grouped_wgmma_body_replays_in_a_cuda_graph(dev, quantized):
    """The tensor-core body through the wrapper (C 70 > TILED_ABOVE), captured
    once in a CUDA graph (tensor maps are kernel parameters, no host sync,
    no allocation in the kernels) and replayed on new tokens copied into the
    captured buffers gives the eager call's result exactly."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dss_topk_grouped import WGMMA

    C, k, d = 70, 8, 128
    w, ids, buf, g_buf, kw = _decode_inputs(dev, torch.bfloat16, C, d, seed=5, quantized=quantized)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.dss_topk_grouped(w, ids, buf, g_buf, k, **kw)
    torch.cuda.current_stream().wait_stream(side)
    body = WGMMA + ("_q" if quantized else "")
    n = ops.launch_counts()[body]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.dss_topk_grouped(w, ids, buf, g_buf, k, **kw)
    assert ops.launch_counts()[body] == n + 1
    for seed, dead in ((6, 0), (7, 2)):
        gen = torch.Generator(device=dev).manual_seed(seed)
        b_new = torch.randint(-8, 9, buf.shape, generator=gen, device=dev).to(buf.dtype)
        g_new = torch.rand(g_buf.shape, generator=gen, device=dev) + 0.25
        g_new[dead] = 0.0
        b_new[g_new == 0] = 0.0
        buf.copy_(b_new)
        g_buf.copy_(g_new)
        graph.replay()
        torch.cuda.synchronize()
        want = ops.dss_topk_grouped(w, ids, b_new, g_new, k, **kw)
        for a, b in zip(out, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("B", [64, 2048])
def test_auto_picks_the_grouped_kernel_at_batch_sizes(dev, quantize, B):
    """qwen2-1.5b's head shape (K 16, d 1536, V_pad 12,032, k 8, bf16
    tokens) at B 64 (C 8) and 2048 (C 256), fp and int8 tables: 'auto'
    resolves to cuda_grouped, which launches the tensor-core body and gives
    the plain grouped path's result. Rows on the 1/64 grid and integer
    tokens keep every sum exact, so the ids are equal; the values differ
    by the gate alone (cuda_grouped's g comes from the gate_top1 kernel,
    held to rtol 1e-5 of the plain gate's)."""
    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops, registry

    K, d, v_pad, k = 16, 1536, 12032, 8
    g = torch.Generator(device=dev).manual_seed(B)
    w = (torch.randint(-128, 129, (K, v_pad, d), generator=g, device=dev) / 64).to(torch.bfloat16)
    ids = torch.randperm(K * v_pad, generator=g, device=dev).reshape(K, v_pad).to(torch.int32)
    table = ds.ServeTable(ids=ids, weights=w)
    if quantize:
        table = ds.quantize_table(table)
        del w
    gate = (torch.randn((K, d), generator=g, device=dev) * d ** -0.5).to(torch.bfloat16)
    h = torch.randint(-8, 9, (B, d), generator=g, device=dev).to(torch.bfloat16)
    assert registry.resolve_kernel("auto", ds.serve_kernel_context(table, h, k)) == "cuda_grouped"
    body = "dss_topk_grouped_wgmma" + ("_q" if quantize else "")
    ops.reset_launch_counts()
    got = ds.serve_topk(gate, table, h, k, kernel="auto")
    assert ops.launch_counts()[body] == 1
    want = ds.serve_topk(gate, table, h, k, kernel="grouped")
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,k,d,e_base,K_real", FUSED_CASES)
def test_fused_kernel_int8(dev, dtype, B, k, d, e_base, K_real):
    """The cases of test_fused_kernel on int8 rows; rows 5 quantize to
    zeros with scale 1.0."""
    from repro_torch.kernels import ops, ref

    gate, h, w, ids = _fused_inputs(dev, dtype, B, d, e_base, K_real, seed=B + d)
    q, scales = _quantize(w)
    assert (q[:, 5] == 0).all() and (scales[:, 5] == 1.0).all()
    n = ops.launch_counts()
    got = ops.dss_topk_fused(gate, q, ids, h, k, scales=scales, e_base=e_base)
    after = ops.launch_counts()
    assert after["dss_topk_fused_q"] == n["dss_topk_fused_q"] + 1
    assert after["dss_topk_fused"] == n["dss_topk_fused"]
    _check_fused(got, ref.dss_topk_fused_ref(gate, q, ids, h, k, e_base, scales=scales),
                 e_base, K_real)


@pytest.mark.parametrize("quantized", [False, True])
def test_fused_kernel_replays_in_a_cuda_graph(dev, quantized):
    """The wrapper captured once in a CUDA graph (no host sync, no
    allocation in the kernels) and replayed on new tokens copied into the
    captured buffers gives the eager call's result exactly."""
    from repro_torch.kernels import ops

    B, k, d = 8, 8, 128
    gate, h, w, ids = _fused_inputs(dev, torch.bfloat16, B, d, 0, 4, seed=5)
    kw = {}
    if quantized:
        w, kw["scales"] = _quantize(w)
    else:
        w = w.to(torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.dss_topk_fused(gate, w, ids, h, k, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.dss_topk_fused(gate, w, ids, h, k, **kw)
    for seed in (6, 7):
        h_new = torch.randn((B, d), generator=torch.Generator(device=dev).manual_seed(seed),
                            device=dev).to(torch.bfloat16)
        h.copy_(h_new)
        graph.replay()
        torch.cuda.synchronize()
        want = ops.dss_topk_fused(gate, w, ids, h_new, k, **kw)
        for a, b in zip(out, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("B", [1, 8])
def test_auto_picks_the_fused_kernel_on_the_head_path(dev, quantize, B):
    """qwen2-1.5b's head shape (K 16, d 1536, V_pad 12,032, k 8, bf16
    tokens), fp and int8 tables: 'auto' resolves to cuda_fused at B 1
    (prefill's last position) and B 8 (decode at 8 slots), launches its
    body and gives the jnp path's result."""
    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops, registry

    K, d, v_pad, k = 16, 1536, 12032, 8
    g = torch.Generator(device=dev).manual_seed(B)
    w = (torch.randn((K, v_pad, d), generator=g, device=dev) * d ** -0.5).to(torch.bfloat16)
    ids = torch.randperm(K * v_pad, generator=g, device=dev).reshape(K, v_pad).to(torch.int32)
    table = ds.ServeTable(ids=ids, weights=w)
    if quantize:
        table = ds.quantize_table(table)
        del w
    gate = (torch.randn((K, d), generator=g, device=dev) * d ** -0.5).to(torch.bfloat16)
    h = torch.randn((B, d), generator=g, device=dev).to(torch.bfloat16)
    ctx = ds.serve_kernel_context(table, h, k)
    assert registry.resolve_kernel("auto", ctx) == "cuda_fused"
    body = "dss_topk_fused" + ("_q" if quantize else "")
    n = ops.launch_counts()[body]
    got = ds.serve_topk(gate, table, h, k, kernel="auto")
    assert ops.launch_counts()[body] == n + 1
    _same(got, ds.serve_topk(gate, table, h, k, kernel="jnp"), atol=1e-4)


def _pertoken_inputs(dev, dtype, B, K, d, v_pad, spread, seed):
    """A table whose expert 1 holds 5 real rows (its tokens' tails are
    (-1e9, -1)) and every odd row a copy of the even one before it (ties),
    tokens h, gate values, and each token's expert: its own (``own``, K =
    B), random (``random``), or all on expert 2 but token 0 (``one``);
    token 0 is on expert 1."""
    w, ids, g = _table(dev, K, v_pad, d, dtype, seed=seed, dup=True)
    ids[1, 5:] = -1
    w[1, 5:] = 0
    h = torch.randn((B, d), generator=g, device=dev).to(dtype)
    if spread == "own":  # expert 1 first, then the others in random order
        perm = torch.randperm(K, generator=g, device=dev)
        e = torch.cat([perm[perm == 1], perm[perm != 1]])[:B]
    elif spread == "one":
        e = torch.full((B,), 2, device=dev)
    else:
        e = torch.randint(0, K, (B,), generator=g, device=dev)
    e = e.to(torch.int32)
    e[0] = 1
    gv = torch.rand((B,), generator=g, device=dev)
    return w, ids, h, e, gv


# (B, K, k, d, spread): d 37 and 36 take 4-byte or element row loads
PERTOKEN_CASES = [(1, 4, 8, 128, "random"), (8, 8, 8, 128, "own"), (64, 64, 1, 64, "own"),
                  (37, 4, 1, 37, "random"), (300, 4, 16, 128, "random"),
                  (300, 4, 64, 200, "one"), (100, 8, 64, 36, "one"), (16, 16, 8, 1536, "own")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,k,d,spread", PERTOKEN_CASES)
def test_pertoken_kernel(dev, dtype, B, K, k, d, spread):
    """The streaming retrieval over tokens grouped by expert, against the
    plain version: one token to many on an expert, every token on its own
    expert, k 1 to 64, d that no 16-byte load divides; expert 1 holds 5
    real rows, so its tokens' tails are (-1e9, -1) and no -inf is
    emitted."""
    from repro_torch.kernels import ops, ref

    w, ids, h, e, gv = _pertoken_inputs(dev, dtype, B, K, d, 900, spread, seed=B + k + d)
    n = ops.launch_counts()["dss_topk"]
    got = ops.dss_topk(w, ids, h, e, gv, k)
    assert ops.launch_counts()["dss_topk"] == n + 1
    h_scaled = (h.float() * gv[:, None]).to(dtype)
    _same(got, ref.dss_topk_ref(w, ids, h_scaled, e, k))
    assert not torch.isinf(got[0]).any()
    short = e == 1
    if k > 5:
        assert (got[1][short, 5:] == -1).all() and (got[0][short, 5:] == -1e9).all()


def test_pertoken_kernel_tokens_of_no_expert(dev):
    """An expert id of K or -1 emits (-inf, -1); the other tokens get the
    plain version's result."""
    from repro_torch.kernels import ops, ref

    B, K, k, d = 12, 4, 8, 128
    w, ids, h, e, gv = _pertoken_inputs(dev, torch.float32, B, K, d, 900, "random", seed=3)
    e[3], e[7] = K, -1
    got = ops.dss_topk(w, ids, h, e, gv, k)
    off = torch.zeros(B, dtype=torch.bool, device=dev)
    off[[3, 7]] = True
    assert (got[0][off] == float("-inf")).all() and (got[1][off] == -1).all()
    on = ~off
    want = ref.dss_topk_ref(w, ids, h[on] * gv[on, None], e[on], k)
    _same((got[0][on], got[1][on]), want)


@pytest.mark.parametrize("experts,k", [((1,), 64), ((0, 1), 8), ((1, 0, 1), 1), ((1, 1), 64)])
def test_pertoken_kernel_ties_across_chunk_boundaries(dev, experts, k):
    """Rows on both sides of every chunk boundary of the retrieval
    (``retrieve_stream.chunk_rows`` for the experts the tokens hold) are
    copies of each other and score above every other row: each pair ties
    exactly, and the merge of the chunks' lists gives the lower position
    first, as the plain version does."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dss_topk import launch_plan
    from repro_torch.kernels.retrieve_stream import chunk_rows

    K, d, v_pad = 2, 64, 12032
    B = len(experts)
    g = torch.Generator(device=dev).manual_seed(B * k)
    w = torch.randn((K, v_pad, d), generator=g, device=dev) / d ** 0.5
    ids = torch.randperm(K * v_pad, generator=g, device=dev).reshape(K, v_pad).to(torch.int32)
    h = torch.randn((B, d), generator=g, device=dev).abs()
    e = torch.tensor(experts, dtype=torch.int32, device=dev)
    rows = chunk_rows(len(set(experts)), v_pad, launch_plan(B, K, v_pad, d, torch.float32).grid)
    for c in range(1, -(-v_pad // rows)):
        w[:, c * rows - 1] = w[:, c * rows] = 1 + c / 1000
    gv = torch.rand((B,), generator=g, device=dev) + 0.5
    got = ops.dss_topk(w, ids, h, e, gv, k)
    want = ref.dss_topk_ref(w, ids, h * gv[:, None], e, k)
    _same(got, want)
    if k > 1:  # the top of every token is a tied pair
        assert torch.equal(got[0][:, 0], got[0][:, 1])


def test_pertoken_kernel_replays_in_a_cuda_graph(dev):
    """The wrapper captured once in a CUDA graph (no host sync, no
    allocation in the kernels) and replayed on new tokens and experts
    copied into the captured buffers gives the eager call's result
    exactly."""
    from repro_torch.kernels import ops

    B, K, k, d = 8, 8, 8, 128
    w, ids, h, e, gv = _pertoken_inputs(dev, torch.bfloat16, B, K, d, 900, "random", seed=5)
    hs = (h.float() * gv[:, None]).to(torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.dss_topk_kernel(w, ids, hs, e, k)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.dss_topk_kernel(w, ids, hs, e, k)
    for seed in (6, 7):
        gen = torch.Generator(device=dev).manual_seed(seed)
        h_new = torch.randn((B, d), generator=gen, device=dev).to(torch.bfloat16)
        e_new = torch.randint(0, K, (B,), generator=gen, device=dev).to(torch.int32)
        hs.copy_(h_new)
        e.copy_(e_new)
        graph.replay()
        torch.cuda.synchronize()
        want = ops.dss_topk_kernel(w, ids, h_new, e_new, k)
        for a, b in zip(out, want):
            assert torch.equal(a, b)


def test_quantized_serve_with_fallback_experts(dev):
    """An int8 table with half its experts on fp fallback: cuda_grouped
    and cuda_fused give the jnp path's ids on the card, each through its
    int8 body (the grouped one ``select_body`` names at C 8)."""
    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops
    from repro_torch.kernels.dss_topk_grouped import select_body

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
    body = select_body(64 // K, torch.bfloat16)
    assert c[body + "_q"] == 1 and c["dss_topk_fused_q"] == 1
    assert c[body] == c["dss_topk_fused"] == 0
    assert sum(c.values()) == 2 + c["gate_top1"]


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
        # every path prefills through the flash_attention kernel: its
        # tensor-core body on these bf16 weights
        assert counts.pop("flash_attention_wgmma") > 0 and counts.pop("flash_attention") == 0
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
        # every path's prefill, through the CUDA-core body (fp32)
        assert counts.pop("flash_attention") > 0 and counts.pop("flash_attention_wgmma") == 0
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


# ---------------------------------------------------------------------------
# the decode graph (ServeSession's backbone captured once, replayed per step)
# ---------------------------------------------------------------------------

_GRAPH_CASES = [(table, cache, kern) for table in ("fp", "int8") for cache in ("contiguous", "paged")
                for kern in ("jnp", "cuda_grouped", "cuda_fused", "cuda_pertoken", "auto")
                if not (table == "int8" and kern == "cuda_pertoken")]


def _graph_model(dev, dtype="bfloat16", skewed=False):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import build
    from repro_torch.testing import skew_gate

    cfg = reduce_config(get_config("qwen2-1.5b"), vocab=1024).replace(dtype=dtype)
    if skewed:
        cfg = cfg.replace(ds=cfg.ds.replace(capacity_factor=0.25))
    bundle = build(cfg)
    params, state = bundle.init(torch.Generator(device=dev).manual_seed(0))
    return cfg, bundle, (skew_gate(params) if skewed else params), state


def _graph_requests(n, seed, max_new, sampled=None):
    from repro_torch.train import Request, SamplingParams

    rng = np.random.RandomState(seed)
    return [Request(prompt=rng.randint(0, 1024, rng.randint(3, 60)).astype(np.int32),
                    sampling=SamplingParams(max_new_tokens=max_new, seed=seed + i,
                                            temperature=0.8 if i == sampled else 0.0))
            for i in range(n)]


@pytest.mark.parametrize("table,cache,kern", _GRAPH_CASES)
def test_decode_graph_streams_equal_the_eager_step(dev, table, cache, kern):
    """The graph session (the default on CUDA) against ``decode_graph=False``
    on the same requests: greedy streams and one sampled stream
    token-identical, one capture, the same head launches. The int8 table
    keeps experts 0 and 2 on int8 rows and serves 1 and 3 from fp fallback
    rows."""
    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops
    from repro_torch.train import ServeSession

    _, bundle, params, state = _graph_model(dev)
    tbl = ds.pack_experts(params["head"], state)
    if table == "int8":
        tbl = ds.quantize_table(tbl, fb_mask=torch.arange(4) % 2 == 1)
        assert 0 < tbl.n_fallback < 4
    kw = dict(paged=True, page_size=16) if cache == "paged" else {}
    streams, launches = {}, {}
    for graph in (False, None):
        ops.reset_launch_counts()
        sess = ServeSession(bundle, params, tbl, n_slots=2, max_seq_len=128, kernel=kern,
                            decode_graph=graph, **kw)
        reqs = _graph_requests(5, 4, 8, sampled=2)
        sess.run(reqs)
        streams[graph] = [r.out_tokens for r in reqs]
        launches[graph] = ops.launch_counts()
        st = sess.stats()
        assert st["decode_graphs"] == (1 if graph is None else 0)
        assert st["decode_builds"] == 1 and st["n_completed"] == 5
    assert streams[None] == streams[False]
    assert launches[None] == launches[False]


def test_decode_graph_survives_swaps_and_breaker_trips(dev):
    """One graph session on skewed traffic: a mid-stream ``swap_table``
    after the capture, then the breaker's two trips. ``decode_builds``
    counts 1 + 1 + 2, as without the graph, ``decode_graphs`` stays 1, and
    the streams equal the eager session's doing the same."""
    from repro_torch.core import dssoftmax as ds
    from repro_torch.train import ServeSession

    _, bundle, params, state = _graph_model(dev, dtype="float32", skewed=True)
    streams = {}
    for graph in (False, None):
        sess = ServeSession(bundle, params, state, n_slots=8, max_seq_len=96,
                            kernel="cuda_grouped", overflow_threshold=0.3, overflow_window=4,
                            decode_graph=graph)
        reqs = _graph_requests(8, 5, 24)
        for r in reqs:
            sess.submit(r)
        swapped = False
        while sess.step():
            if not swapped and sess.n_steps == 5:
                sess.swap_table(ds.pack_experts(params["head"], state))
                swapped = True
        st = sess.stats()
        assert swapped and st["n_swaps"] == 1 and st["breaker_trips"] == 2
        assert st["decode_builds"] == 4 and st["effective_kernel"] == "cuda_fused"
        assert st["decode_graphs"] == (1 if graph is None else 0)
        streams[graph] = [r.out_tokens for r in reqs]
    assert streams[None] == streams[False]


def test_decode_graph_capture_failure_raises(dev):
    """A backbone that cannot be captured makes the capturing step raise;
    the session does not carry on eagerly."""
    import dataclasses

    from repro_torch.core import dssoftmax as ds
    from repro_torch.train import ServeSession
    from repro_torch.train.serve import GRAPH_WARMUP_STEPS

    _, bundle, params, state = _graph_model(dev)

    def decode_hidden(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("this backbone refuses capture")
        return bundle.decode_hidden(*a, **kw)

    sess = ServeSession(dataclasses.replace(bundle, decode_hidden=decode_hidden), params,
                        ds.pack_experts(params["head"], state), n_slots=2, max_seq_len=128,
                        kernel="cuda_fused")
    for r in _graph_requests(2, 6, 16):
        sess.submit(r)
    for _ in range(GRAPH_WARMUP_STEPS):
        sess.step()
    with pytest.raises(RuntimeError, match="capturing the decode step as a CUDA graph failed"):
        sess.step()
    assert sess.stats()["decode_graphs"] == 0
    assert sess.n_steps == GRAPH_WARMUP_STEPS


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

def _attn_inputs(dev, B, H, H_kv, S, dh, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, S, h, dh), generator=g, device=dev).to(dtype)
               for h in (H, H_kv, H_kv))
    return q, k, v  # (B, S, heads, dh): the layout attention_block holds


def _assert_within_limit(o, q, k, v):
    """The kernel's output against its plain version, element by element,
    within ``repro_torch.testing.flash_attention_limit`` (fp32: repro's
    own 1e-4 / 1e-5; bf16: one bf16 rounding of p, 2^-8·(softmax(s)·|v|),
    plus the two outputs' own rounding, 2^-7·|o|)."""
    from repro_torch.kernels import ref
    from repro_torch.testing import flash_attention_limit

    want = ref.flash_attention_ref(q, k, v)
    err = (o.float() - want.float()).abs()
    limit = flash_attention_limit(q, k, v, want)
    assert (err <= limit).all(), f"{float((err / limit).max())} of the limit"


def _run_flash(q, k, v, body):
    """flash_attention(q, k, v), asserting that exactly one launch of
    ``body`` (and none of the other body) ran."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import select_body

    assert select_body(q, k, v) == body
    n = ops.launch_counts()
    o = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after[body] == n[body] + 1
    assert sum(after.values()) == sum(n.values()) + 1
    return o


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 64, 128])
@pytest.mark.parametrize("S", [1, 7, 129, 2047])
@pytest.mark.parametrize("H,H_kv", [(2, 2), (12, 2)])
def test_flash_attention_kernel(dev, dtype, dh, S, H, H_kv):
    """(B, S, H, dh) tensors passed as their (B, H, S, dh) transpose views,
    as attention_block passes them; the output comes back in that layout.
    bf16 runs the tensor-core body, fp32 the CUDA-core body."""
    q, k, v = _attn_inputs(dev, 2, H, H_kv, S, dh, dtype, seed=S * dh + H)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    body = "flash_attention_wgmma" if dtype == torch.bfloat16 else "flash_attention"
    o = _run_flash(qt, kt, vt, body)
    assert o.shape == qt.shape and o.dtype == dtype
    assert o.transpose(1, 2).is_contiguous()  # q's (B, S, H, dh) layout
    _assert_within_limit(o, qt, kt, vt)


@pytest.mark.parametrize("S", [63, 64, 65, 127, 128, 129, 255, 256, 257, 2048])
@pytest.mark.parametrize("H,H_kv", [(12, 2), (2, 2)])
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_attention_tensor_core_body_tile_edges(dev, S, H, H_kv, dh):
    """The tensor-core body at the edges of its 128-row tiles and of its
    2-stage K/V ring (S 255-257: three kv tiles), B 2, with GQA and
    without; each element within the unchanged limit."""
    q, k, v = _attn_inputs(dev, 2, H, H_kv, S, dh, torch.bfloat16, seed=S + dh + H)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o = _run_flash(qt, kt, vt, "flash_attention_wgmma")
    assert o.transpose(1, 2).is_contiguous()
    _assert_within_limit(o, qt, kt, vt)


@pytest.mark.parametrize("case", ["dh 24", "dh 8", "dh 192", "unaligned base",
                                  "unaligned stride"])
def test_flash_attention_cuda_core_body_takes_the_rest(dev, case):
    """bf16 inputs the tensor-core body does not take run the CUDA-core
    body, by the written rule, within the same limit."""
    S, H, H_kv = 129, 4, 2
    dh = {"dh 24": 24, "dh 8": 8, "dh 192": 192}.get(case, 64)
    g = torch.Generator(device=dev).manual_seed(len(case))
    if case == "unaligned base":  # every tensor starts one element past a 16-byte boundary
        flat = [torch.randn(1 + S * h * dh, generator=g, device=dev).to(torch.bfloat16)
                for h in (H, H_kv, H_kv)]
        q, k, v = (f[1:].view(1, S, h, dh) for f, h in zip(flat, (H, H_kv, H_kv)))
    elif case == "unaligned stride":  # rows 2 * dh + 4 elements apart
        bufs = [torch.randn((1, S, h, dh + 4), generator=g, device=dev).to(torch.bfloat16)
                for h in (H, H_kv, H_kv)]
        q, k, v = (b[..., :dh] for b in bufs)
    else:
        q, k, v = _attn_inputs(dev, 1, H, H_kv, S, dh, torch.bfloat16, seed=dh)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o = _run_flash(qt, kt, vt, "flash_attention")
    _assert_within_limit(o, qt, kt, vt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_strided_views(dev, dtype):
    """Views that are not dense: q, k and v sliced out of wider buffers
    along dh and every other position; the output is dense, in q's axis
    order (B, S, H, dh)."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(5)
    S, dh = 300, 128
    qb = torch.randn((1, 2 * S, 12, dh + 32), generator=g, device=dev).to(dtype)
    kvb = torch.randn((1, 2 * S, 2, 2, dh), generator=g, device=dev).to(dtype)
    q = qb[:, ::2, :, 16:16 + dh].transpose(1, 2)
    k, v = (kvb[:, ::2, :, j].transpose(1, 2) for j in (0, 1))
    body = "flash_attention_wgmma" if dtype == torch.bfloat16 else "flash_attention"
    o = _run_flash(q, k, v, body)
    assert o.transpose(1, 2).is_contiguous()
    _assert_within_limit(o, q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 129, 2048])
@pytest.mark.parametrize("dh", [64, 80, 96, 128, 256])
@pytest.mark.parametrize("H,H_kv", [(12, 2), (4, 4)])
def test_flash_attention_cuda_core_body(dev, dtype, S, dh, H, H_kv):
    """The CUDA-core body, forced for bf16 too, at the edges of its 64-row
    tiles and its two-slot K/V ring, for every head-dim class (dh 80 and 96
    in the 128 class), with GQA and without; (B, S, H, dh) tensors passed
    as their transpose views (rows copied 16 bytes at a time); each element
    within the limit."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import SIMT, launch_body

    B = 1 if S == 2048 else 2
    q, k, v = _attn_inputs(dev, B, H, H_kv, S, dh, dtype, seed=S + dh + H)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    n = ops.launch_counts()
    o = launch_body(qt, kt, vt, SIMT)
    torch.cuda.synchronize()
    assert ops.launch_counts()[SIMT] == n[SIMT] + 1
    assert o.transpose(1, 2).is_contiguous()
    _assert_within_limit(o, qt, kt, vt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["strided", "no 16-byte stride", "unaligned base"])
def test_flash_attention_cuda_core_body_views(dev, dtype, case):
    """The CUDA-core body on views that are not dense: every other position
    of wider buffers (16-byte aligned rows: the asynchronous copies), rows
    dh + 1 elements apart (no 16-byte stride: copied one element at a
    time) and a base one element past a 16-byte boundary; S 300 (five
    tiles and a ragged one), dh 128, GQA 12/2."""
    from repro_torch.kernels.flash_attention import SIMT, launch_body

    g = torch.Generator(device=dev).manual_seed(len(case))
    S, dh, H, H_kv = 300, 128, 12, 2
    if case == "strided":
        qb = torch.randn((1, 2 * S, H, dh + 32), generator=g, device=dev).to(dtype)
        kvb = torch.randn((1, 2 * S, H_kv, 2, dh), generator=g, device=dev).to(dtype)
        q = qb[:, ::2, :, 16:16 + dh]
        k, v = (kvb[:, ::2, :, j] for j in (0, 1))
    elif case == "no 16-byte stride":
        q, k, v = (torch.randn((1, S, h, dh + 1), generator=g, device=dev).to(dtype)[..., :dh]
                   for h in (H, H_kv, H_kv))
    else:
        flat = [torch.randn(1 + S * h * dh, generator=g, device=dev).to(dtype)
                for h in (H, H_kv, H_kv)]
        q, k, v = (f[1:].view(1, S, h, dh) for f, h in zip(flat, (H, H_kv, H_kv)))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o = launch_body(qt, kt, vt, SIMT)
    torch.cuda.synchronize()
    _assert_within_limit(o, qt, kt, vt)


def test_flash_attention_kernel_rejects_what_it_does_not_take(dev):
    from repro_torch.kernels import ops

    q = torch.zeros((1, 2, 8, 16), device=dev)
    n = ops.launch_counts()
    with pytest.raises(ValueError):
        ops.flash_attention(q, q[:, :, :, :8], q)          # k/v shape
    with pytest.raises(ValueError):
        ops.flash_attention(q.transpose(2, 3), q.transpose(2, 3), q.transpose(2, 3))
    with pytest.raises(TypeError):
        ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        big = torch.zeros((1, 1, 4, 320), device=dev)
        ops.flash_attention(big, big, big)
    assert ops.launch_counts() == n


def test_paged_chunked_session_preempts_on_the_card(dev):
    """A 5-page arena cannot hold both requests: admitting the
    high-priority one preempts the low one, which resumes through chunked
    re-prefill. Both streams equal uncontended runs (fp32: the re-prefill's
    other product shapes move values by ulps, far below any top-1/top-2
    gap here), no page stays mapped. Whole-prompt paged prefill goes through
    the flash_attention kernel and matches the contiguous cache's tokens."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.train import Request, SamplingParams, ServeSession

    cfg = reduce_config(get_config("qwen2-1.5b"), vocab=1024).replace(dtype="float32")
    bundle = build(cfg)
    params, state = bundle.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.RandomState(6)
    specs = [(rng.randint(1, 1000, 10).astype(np.int32), pr) for pr in (0, 5)]

    def req(p, pr):
        return Request(prompt=p, sampling=SamplingParams(max_new_tokens=20, priority=pr))

    solo = []
    for p, pr in specs:
        r = req(p, pr)
        ServeSession(bundle, params, state, n_slots=1, max_seq_len=64,
                     prefill_chunk=4).run([r])
        solo.append(r.out_tokens)
    sess = ServeSession(bundle, params, state, n_slots=2, max_seq_len=64, prefill_chunk=4,
                        paged=True, page_size=8, page_arena=5, prefix_sharing=False)
    low, high = (req(p, pr) for p, pr in specs)
    sess.submit(low)
    for _ in range(3):
        sess.step()
    sess.submit(high)
    while sess.step():
        pass
    st = sess.stats()["paged"]
    assert st["preemptions"] > 0 and st["pages_in_use"] == 0
    assert [low.out_tokens, high.out_tokens] == solo

    prompts = [rng.randint(1, 1000, n).astype(np.int32) for n in (5, 70, 129)]
    streams = {}
    for paged in (False, True):
        ops.reset_launch_counts()
        reqs = [req(p, 0) for p in prompts]
        ServeSession(bundle, params, state, n_slots=2, max_seq_len=160, paged=paged,
                     page_size=16).run(reqs)
        assert ops.launch_counts()["flash_attention"] == len(prompts) * cfg.n_layers
        streams[paged] = [r.out_tokens for r in reqs]
    assert streams[True] == streams[False]


# ---------------------------------------------------------------------------
# Training on the card
# ---------------------------------------------------------------------------


def _train_setup(dev_cpu_or_cuda, dtype="float32", **kw):
    """Reduced qwen2-1.5b seeded on the CPU, then moved to the device."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import build
    from repro_torch.optim import adam_init
    from repro_torch.train.train_step import TrainState
    from repro_torch.utils import tree_map

    cfg = reduce_config(get_config("qwen2-1.5b"), vocab=256).replace(dtype=dtype, **kw)
    cfg = cfg.replace(ds=cfg.ds.replace(lambda_lasso=1e-3, lambda_expert=1e-3, gamma=1.0))
    params, st = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    move = lambda t: t.to(dev_cpu_or_cuda)  # noqa: E731
    params, st = tree_map(move, params), st._replace(mask=move(st.mask))
    return build(cfg, device=dev_cpu_or_cuda), TrainState(params, adam_init(params), st)


def _batch(device, B=4, S=33, seed=1):
    tokens = np.random.RandomState(seed).randint(0, 256, (B, S)).astype(np.int32)
    return {"tokens": torch.from_numpy(tokens).to(device)}


def test_train_step_on_cuda_matches_cpu(dev):
    """Three fp32 steps on the card against the CPU: loss and grad norm
    rtol 1e-5; params within 2·lr per step (Adam's first steps are ≈
    lr·sign(g), and a gradient near zero may take either sign) and rtol
    1e-4 elsewhere on average; masks equal."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.train_step import make_train_step
    from repro_torch.utils import flatten_dict

    lr = 1e-3
    out = {}
    for device in ("cpu", dev):
        bundle, state = _train_setup(device)
        step = make_train_step(bundle, TrainConfig(lr=lr))
        hist = []
        for i in range(3):
            state, m = step(state, _batch(device, seed=i))
            hist.append((float(m["loss"]), float(m["grad_norm"]), float(m["ce"])))
        out[str(torch.device(device).type)] = (state, hist)
    (sc, hc), (sg, hg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(np.array(hg), np.array(hc), rtol=1e-5)
    assert torch.equal(sg.ds_state.mask.cpu(), sc.ds_state.mask)
    for k, v in flatten_dict(sc.params).items():
        g = flatten_dict(sg.params)[k].cpu()
        assert (g - v).abs().max() <= 3 * 2 * lr + 1e-6, k
        assert float((g - v).abs().mean()) <= 1e-4 * float(v.abs().mean()) + 1e-6, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", ["layer", "none"])
def test_every_param_gets_a_gradient_on_cuda(dev, dtype, remat):
    """The train path on the card: every parameter gets a finite, non-zero
    gradient (the attention is the differentiable one, not the forward-only
    kernel), and no kernel launches."""
    from repro_torch.kernels import ops
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.utils import flatten_dict

    bundle, state = _train_setup(dev, dtype=dtype, remat=remat)
    ops.reset_launch_counts()
    (loss, _), grads = value_and_grad(bundle, state.params, state.ds_state, _batch(dev))
    assert torch.isfinite(loss)
    assert sum(ops.launch_counts().values()) == 0
    for k, g in flatten_dict(grads).items():
        assert g.device.type == dev.type and g.dtype == flatten_dict(state.params)[k].dtype, k
        assert torch.isfinite(g.float()).all() and g.float().abs().sum() > 0, k


@pytest.mark.parametrize("name", ["gate_top1", "dss_topk_grouped", "dss_topk_fused",
                                  "dss_topk_kernel", "lasso_prune", "flash_attention"])
def test_kernel_wrappers_raise_on_grad_inputs_on_cuda(dev, name):
    from repro_torch.kernels import ops

    fn = getattr(ops, name)
    args = {
        "gate_top1": (torch.randn(4, 8, device=dev), torch.randn(2, 8, device=dev)),
        "dss_topk_grouped": (torch.randn(4, 16, 8, device=dev),
                             torch.zeros(4, 16, dtype=torch.int32, device=dev),
                             torch.randn(4, 2, 8, device=dev), torch.ones(4, 2, device=dev), 2),
        "dss_topk_fused": (torch.randn(4, 8, device=dev), torch.randn(4, 16, 8, device=dev),
                           torch.zeros(4, 16, dtype=torch.int32, device=dev),
                           torch.randn(2, 8, device=dev), 2),
        "dss_topk_kernel": (torch.randn(4, 16, 8, device=dev),
                            torch.zeros(4, 16, dtype=torch.int32, device=dev),
                            torch.randn(2, 8, device=dev),
                            torch.zeros(2, dtype=torch.int32, device=dev), 2),
        "lasso_prune": (torch.randn(4, 16, 8, device=dev),
                        torch.ones(4, 16, dtype=torch.bool, device=dev), 0.5),
        "flash_attention": (torch.randn(1, 4, 8, 16, device=dev),
                            torch.randn(1, 2, 8, 16, device=dev),
                            torch.randn(1, 2, 8, 16, device=dev)),
    }[name]
    req = [a.requires_grad_(True) if torch.is_tensor(a) and a.is_floating_point() else a
           for a in args]
    with pytest.raises(RuntimeError, match="forward-only"):
        fn(*req)
    with torch.no_grad():
        fn(*req)


def test_checkpoint_round_trip_on_cuda(dev, tmp_path):
    """A bf16 train state saved from the card and restored onto it: every
    tensor bit-equal, on the card, in its dtype."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.utils import flatten_dict

    _, state = _train_setup(dev, dtype="bfloat16")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(3, state, meta={"pipeline": {"step": 3, "seed": 0}})
    back, meta = mgr.restore(like=state)
    assert meta["step"] == 3 and meta["pipeline"]["step"] == 3
    for k, v in flatten_dict(state).items():
        got = flatten_dict(back)[k]
        assert got.device.type == dev.type and got.dtype == v.dtype and torch.equal(got, v), k


# ---------------------------------------------------------------------------
# speculative decoding, the wide heads, attention at MQA 48/1
# ---------------------------------------------------------------------------

def _spec_model(dev, dtype, n_layers=None, seed=0):
    """Reduced llama3.2-3b (vocab 1024) on the card, its table packed."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core import dssoftmax as ds
    from repro_torch.models import build

    cfg = reduce_config(get_config("llama3.2-3b"), vocab=1024).replace(dtype=dtype)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    bundle = build(cfg)
    params, state = bundle.init(torch.Generator(device=dev).manual_seed(seed))
    return bundle, params, ds.pack_experts(params["head"], state)


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_verify_graph_streams_equal_the_eager_verify(dev, cache):
    """A bf16 speculative session (self-draft, gamma 3) with its draft and
    verify backbones replayed from graphs, against the same session run
    eagerly (``decode_graph=False``): greedy streams and one sampled stream
    token-identical; one draft graph and one verify graph, no decode
    graph (speculation never runs the plain decode step)."""
    from repro_torch.train import ServeSession

    model = _spec_model(dev, "bfloat16")
    kw = dict(paged=True, page_size=16, prefill_chunk=16) if cache == "paged" else {}
    streams = {}
    for graph in (False, None):
        sess = ServeSession(*model, n_slots=2, max_seq_len=128, draft=model, gamma=3,
                            decode_graph=graph, **kw)
        reqs = _graph_requests(5, 8, 12, sampled=1)
        sess.run(reqs)
        streams[graph] = [r.out_tokens for r in reqs]
        st = sess.stats()
        n = 1 if graph is None else 0
        assert (st["draft_graphs"], st["verify_graphs"], st["decode_graphs"]) == (n, n, 0)
        assert st["n_completed"] == 5 and st["speculative"]["spec_steps"] > 3
        if cache == "paged":
            assert st["paged"]["pages_in_use"] == 0
    assert streams[None] == streams[False]


@pytest.mark.parametrize("draft", ["self", "shallow"])
def test_speculative_greedy_session_equals_its_baseline_on_the_card(dev, draft):
    """fp32 on the card: the speculative greedy streams (a self-draft, and
    a 1-layer draft of its own seed, whose proposals the target rejects)
    equal the non-speculative session's, through the graphs."""
    from repro_torch.train import ServeSession

    model = _spec_model(dev, "float32")
    d = model if draft == "self" else _spec_model(dev, "float32", n_layers=1, seed=5)
    streams = {}
    for spec in (False, True):
        sess = ServeSession(*model, n_slots=2, max_seq_len=128,
                            **(dict(draft=d, gamma=4) if spec else {}))
        reqs = _graph_requests(5, 9, 10)
        sess.run(reqs)
        streams[spec] = [r.out_tokens for r in reqs]
    assert streams[True] == streams[False]
    rate = sess.stats()["speculative"]["accept_rate"]
    assert rate > 0.5 if draft == "self" else rate < 0.5


WIDE_D = [3072, 6144, 8192]   # llama3.2-3b, granite-20b, deepseek-67b


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("C,body_of", [(1, "DECODE"), (2, "DECODE"), (5, "WGMMA"),
                                       (10, "WGMMA"), (10, "TILED")])
@pytest.mark.parametrize("d", WIDE_D)
def test_grouped_bodies_at_the_wide_heads(dev, quantized, C, body_of, d):
    """The grouped bodies at the new head widths and at the verify step's
    capacities (C 5 at K 16, C 10 at K 8): the decode bodies (their
    streaming plan stages one fp32 token of d 6144 or 8192, and one or two
    bf16 rows), the tensor-core bodies (bf16 tokens) and the tiled bodies
    (fp32 tokens), on the exact inputs of the decode-body tests (every fp32
    sum exact at d 8192, so ids equal)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dss_topk_grouped import DECODE, TILED, WGMMA, launch_body

    body = {"DECODE": DECODE, "WGMMA": WGMMA, "TILED": TILED}[body_of]
    dtype = torch.float32 if body == TILED else torch.bfloat16
    w, ids, buf, g_buf, kw = _decode_inputs(dev, dtype, C, d, seed=C + d, quantized=quantized)
    name = body + ("_q" if quantized else "")
    n = ops.launch_counts()[name]
    got = launch_body(w, ids, buf, g_buf, 8, kw.get("scales"), body)
    assert ops.launch_counts()[name] == n + 1
    _check_decode(got, ref.dss_topk_grouped_ref(w, ids, buf, g_buf, 8, **kw), g_buf, 8)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("B", [8, 40])
@pytest.mark.parametrize("d", WIDE_D)
def test_fused_kernel_at_the_wide_heads(dev, quantized, B, d):
    """The fused kernel (gate, streaming retrieval, merge) at the new head
    widths, at decode (B 8) and verify (B 40) batches, fp and int8 rows."""
    from repro_torch.kernels import ops, ref

    gate, h, w, ids = _fused_inputs(dev, torch.bfloat16, B, d, 0, 4, seed=B + d)
    kw = {}
    if quantized:
        w, kw["scales"] = _quantize(w)
    else:
        w = w.to(torch.bfloat16)
    name = "dss_topk_fused" + ("_q" if quantized else "")
    n = ops.launch_counts()[name]
    got = ops.dss_topk_fused(gate, w, ids, h, 8, **kw)
    assert ops.launch_counts()[name] == n + 1
    _check_fused(got, ref.dss_topk_fused_ref(gate, w, ids, h, 8, 0, **kw), 0, 4)


@pytest.mark.parametrize("B", [8, 40])
@pytest.mark.parametrize("d", WIDE_D)
def test_gate_and_pertoken_kernels_at_the_wide_heads(dev, B, d):
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(B + d)
    u = (torch.randn((8, d), generator=g, device=dev) * d ** -0.5).to(torch.bfloat16)
    hh = torch.randn((B, d), generator=g, device=dev).to(torch.bfloat16)
    i1, g1 = ops.gate_top1(u, hh)
    i2, g2 = ref.gate_top1_ref(u, hh)
    assert torch.equal(i1, i2)
    torch.testing.assert_close(g1, g2, rtol=1e-5, atol=1e-7)
    w, ids, h, e, gv = _pertoken_inputs(dev, torch.bfloat16, B, 8, d, 900, "random", seed=B + d)
    n = ops.launch_counts()["dss_topk"]
    got = ops.dss_topk(w, ids, h, e, gv, 8)
    assert ops.launch_counts()["dss_topk"] == n + 1
    h_scaled = (h.float() * gv[:, None]).to(torch.bfloat16)
    _same(got, ref.dss_topk_ref(w, ids, h_scaled, e, 8), atol=1e-4)
    assert not torch.isinf(got[0]).any()


@pytest.mark.parametrize("S", [1, 129, 1024])
def test_flash_attention_tensor_core_body_at_mqa_48(dev, S):
    """granite-20b's attention: H 48 over one kv head (G 48), dh 128, bf16,
    through the tensor-core body, every element within the limit."""
    q, k, v = _attn_inputs(dev, 1, 48, 1, S, 128, torch.bfloat16, seed=S + 48)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o = _run_flash(qt, kt, vt, "flash_attention_wgmma")
    _assert_within_limit(o, qt, kt, vt)


# ---------------------------------------------------------------------------
# The tensor-core attention body's persistent, pipelined design
# ---------------------------------------------------------------------------

# Every S class of its 128-row items (one row, a tile less one, a tile, a
# tile and one row, two tiles less one, and the 2048-token prefill, whose
# 192 items at H 12 walk more than one per block), GQA 12/2 and 24/8 and
# MQA 48/1, B 1 and 3, dh 64, 80 (zero fill past dh in the 128 class) and
# 128; each element within the limit. At B 3 each batch row is also run
# alone: an item's output does not depend on which block or which
# warpgroup turn computed it, bit for bit.
@pytest.mark.parametrize("S", [1, 127, 128, 129, 255, 2047, 2048])
@pytest.mark.parametrize("H,H_kv", [(12, 2), (24, 8), (48, 1)])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dh", [64, 80, 128])
def test_flash_attention_tensor_core_persistent_schedule(dev, S, H, H_kv, B, dh):
    from repro_torch.kernels import ops

    q, k, v = _attn_inputs(dev, B, H, H_kv, S, dh, torch.bfloat16, seed=S + H + B + dh)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o = _run_flash(qt, kt, vt, "flash_attention_wgmma")
    _assert_within_limit(o, qt, kt, vt)
    if B > 1:
        for b in range(B):
            assert torch.equal(ops.flash_attention(qt[b:b + 1], kt[b:b + 1], vt[b:b + 1]),
                               o[b:b + 1])


@pytest.mark.parametrize("S,B,H,H_kv", [(4096, 1, 12, 2), (4096, 3, 12, 2), (8192, 1, 12, 2),
                                        (8192, 1, 2, 1)])
def test_flash_attention_tensor_core_long_sequences(dev, S, B, H, H_kv):
    """Long prompts: up to 64 kv tiles per item through the two-stage K and
    V rings, and up to 2304 items over the persistent grid."""
    q, k, v = _attn_inputs(dev, B, H, H_kv, S, 128, torch.bfloat16, seed=S + B + H)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o = _run_flash(qt, kt, vt, "flash_attention_wgmma")
    _assert_within_limit(o, qt, kt, vt)


def test_flash_attention_tensor_core_body_replays_in_a_cuda_graph(dev):
    """The tensor-core body captured once in a CUDA graph (tensor maps are
    kernel parameters, the schedule a function of the shapes) and replayed
    on new q, k, v copied into the captured buffers gives the eager call's
    output bit for bit."""
    from repro_torch.kernels import ops

    B, H, H_kv, S, dh = 2, 12, 2, 1000, 128
    q, k, v = (t.transpose(1, 2)
               for t in _attn_inputs(dev, B, H, H_kv, S, dh, torch.bfloat16, seed=7))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.flash_attention(q, k, v)
    torch.cuda.current_stream().wait_stream(side)
    n = ops.launch_counts()["flash_attention_wgmma"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention_wgmma"] == n + 1
    for seed in (8, 9):
        new = [t.transpose(1, 2)
               for t in _attn_inputs(dev, B, H, H_kv, S, dh, torch.bfloat16, seed=seed)]
        for dst, src in zip((q, k, v), new):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ops.flash_attention(*new))


# ---------------------------------------------------------------------------
# The tensor-core grouped body (first-tile threshold, wide heads, overflow)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("C", [5, 10, 16, 100, 256])
@pytest.mark.parametrize("k", [1, 8, 16])
@pytest.mark.parametrize("d", [3072, 8192])
def test_grouped_wgmma_body_at_wide_heads(dev, quantized, C, k, d):
    """The decode body's exact inputs (test_grouped_wgmma_body) at the wide
    heads' widths, d 3072 and 8192, with the verify step's capacities (5,
    10) and token tiles of 16 to 256: equal to the plain version."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dss_topk_grouped import WGMMA, launch_body

    w, ids, buf, g_buf, kw = _decode_inputs(dev, torch.bfloat16, C, d, seed=C + d + k,
                                            quantized=quantized)
    body = WGMMA + ("_q" if quantized else "")
    n = ops.launch_counts()[body]
    got = launch_body(w, ids, buf, g_buf, k, kw.get("scales"), WGMMA)
    assert ops.launch_counts()[body] == n + 1
    _check_decode(got, ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k, **kw), g_buf, k)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("k", [1, 8])
def test_grouped_wgmma_first_tile_threshold_with_the_top_in_one_warp(dev, quantized, k):
    """The first row tile's threshold (each token's seed: the k-th largest
    of the 8 warps' top 2 values, or one past the tile's k-th padding row)
    when each expert's best rows all sit in one warp's 16 rows of that
    tile, and on later tiles rows tie with them exactly: equal to the plain
    version (ties to the lowest position)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dss_topk_grouped import WGMMA, launch_body

    w, ids, buf, g_buf, kw = _decode_inputs(dev, torch.bfloat16, 40, 1536, seed=41 + k,
                                            quantized=False)
    w = w.float()
    w[:, 16:32] += 1.0
    w[:, 300:316] = w[:, 16:32]
    w[ids < 0] = 0.0
    if quantized:
        w, kw["scales"] = _quantize(w)
    else:
        w = w.to(torch.bfloat16)
    got = launch_body(w, ids, buf, g_buf, k, kw.get("scales"), WGMMA)
    torch.cuda.synchronize()
    _same(got, ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k, **kw))


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_grouped_wgmma_body_on_an_overflowing_dispatch(dev, quantize):
    """Every one of 40 tokens chooses expert 3 (a verify step's batch at 16
    experts: capacity 5), so 35 overflow into the gather fixup:
    cuda_grouped launches the tensor-core body once and equals the jnp
    path (rows on the 1/64 grid, integer tokens: exact sums)."""
    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops

    K, d, v_pad, k, B = 16, 1536, 1000, 8, 40
    g = torch.Generator(device=dev).manual_seed(21)
    w = (torch.randint(-128, 129, (K, v_pad, d), generator=g, device=dev) / 64).to(torch.bfloat16)
    ids = torch.randperm(K * v_pad, generator=g, device=dev).reshape(K, v_pad).to(torch.int32)
    table = ds.ServeTable(ids=ids, weights=w)
    if quantize:
        table = ds.quantize_table(table)
    gate = torch.zeros((K, d), device=dev, dtype=torch.bfloat16)
    gate[3] = 0.01
    h = torch.randint(1, 9, (B, d), generator=g, device=dev).to(torch.bfloat16)
    body = "dss_topk_grouped_wgmma" + ("_q" if quantize else "")
    ops.reset_launch_counts()
    got = ds.serve_topk(gate, table, h, k, kernel="cuda_grouped")
    assert ops.launch_counts()[body] == 1
    want = ds.serve_topk(gate, table, h, k, kernel="jnp")
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# The tensor-core grouped body's queue: spills, capacities, fallback, graphs
# ---------------------------------------------------------------------------

def _ordered_inputs(dev, K, C, v_pad, quantized, kind):
    """Integer logits, exact in fp32: z = position (``ascending``: each row
    tile raises every token's threshold past all the earlier rows, so all
    128 rows of a tile are candidates and 112 of them spill past the
    queue) or z = 1 on every row (``equal``: all tied, the lowest positions
    win), d 64, the last 3 rows of each expert padding, g 1."""
    d = 64
    pos = torch.arange(v_pad, device=dev)
    x = torch.zeros(d, device=dev)
    if kind == "ascending":
        rows = ((pos[:, None] >> torch.arange(d, device=dev)[None, :]) & 1).float()
        rows[:, 16:] = 0
        x[:16] = 2.0 ** torch.arange(16, device=dev).float()
    else:
        rows = torch.zeros((v_pad, d), device=dev)
        rows[:, 0] = 1
        x[0] = 1
    ids = torch.arange(K * v_pad, device=dev, dtype=torch.int32).reshape(K, v_pad)
    ids[:, v_pad - 3:] = -1
    w = torch.where((ids >= 0)[..., None], rows.expand(K, v_pad, d), 0.0)
    buf = x.expand(K, C, d).to(torch.bfloat16).contiguous()
    g_buf = torch.ones((K, C), device=dev)
    if quantized:
        return w.to(torch.int8).contiguous(), ids, buf, g_buf, {"scales": torch.ones((K, v_pad),
                                                                                  device=dev)}
    return w.to(torch.bfloat16).contiguous(), ids, buf, g_buf, {}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("kind", ["ascending", "equal"])
@pytest.mark.parametrize("k", [1, 8, 16, 32])
@pytest.mark.parametrize("C,v_pad", [(37, 700), (256, 1200)])
def test_grouped_wgmma_queue_spills_and_keeps_the_exact_topk(dev, quantized, kind, k, C, v_pad):
    """Ascending logits fill every token's queue past its 16 slots on every
    row tile (the spill area takes the rest); logits all equal make every
    row tie with the threshold: the tensor-core body's values and ids equal
    the plain version's exactly."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dss_topk_grouped import WGMMA, launch_body

    w, ids, buf, g_buf, kw = _ordered_inputs(dev, 3, C, v_pad, quantized, kind)
    body = WGMMA + ("_q" if quantized else "")
    n = ops.launch_counts()[body]
    got = launch_body(w, ids, buf, g_buf, k, kw.get("scales"), WGMMA)
    assert ops.launch_counts()[body] == n + 1
    want = ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("C", [3, 4, 17, 100, 255, 257, 384, 512])
def test_grouped_wgmma_body_from_capacity_3_to_512(dev, quantized, C):
    """The decode body's exact inputs (test_grouped_wgmma_body) at every
    token tile from 16 to 256 and at two and more token tiles (C 257 to
    512): equal to the plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.dss_topk_grouped import WGMMA, launch_body

    w, ids, buf, g_buf, kw = _decode_inputs(dev, torch.bfloat16, C, 144, seed=C + 3,
                                            quantized=quantized)
    got = launch_body(w, ids, buf, g_buf, 8, kw.get("scales"), WGMMA)
    _check_decode(got, ref.dss_topk_grouped_ref(w, ids, buf, g_buf, 8, **kw), g_buf, 8)


def test_grouped_wgmma_body_on_an_int8_table_with_fallback_experts(dev):
    """On an int8 table the fallback experts' tokens go to the sentinel K
    before dispatch: those experts hold no live slot, and the int8
    tensor-core body's output (C 8 > TILED_ABOVE) equals the plain
    version's on every slot."""
    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dss_topk_grouped import WGMMA, launch_body

    K, d, v_pad, B, k = 8, 128, 640, 32, 8
    w, ids, g = _table(dev, K, v_pad, d, torch.bfloat16, seed=19)
    qt = ds.quantize_table(ds.ServeTable(ids=ids, weights=w), fb_mask=torch.arange(K) % 2 == 1)
    gate = torch.randn((K, d), generator=g, device=dev).to(torch.bfloat16)
    h = torch.randn((B, d), generator=g, device=dev).to(torch.bfloat16)
    e, gv = ops.gate_top1(gate, h)
    fb_tok = qt.fb_index[e.long()] >= 0
    assert fb_tok.any()
    buf, g_buf, _, _ = ds._group_tokens(h, gv, torch.where(fb_tok, K, e), K, 8)
    assert (g_buf[1::2] == 0).all()
    n = ops.launch_counts()["dss_topk_grouped_wgmma_q"]
    got = launch_body(qt.qweights, ids, buf, g_buf, k, qt.scales, WGMMA)
    assert ops.launch_counts()["dss_topk_grouped_wgmma_q"] == n + 1
    _same(got, ref.dss_topk_grouped_ref(qt.qweights, ids, buf, g_buf, k, scales=qt.scales))


@pytest.mark.parametrize("quantized", [False, True])
def test_grouped_wgmma_body_replays_spilling_tokens_in_a_cuda_graph(dev, quantized):
    """The tensor-core body at C 256 captured once in a CUDA graph (the
    spill area is allocated at capture) and replayed on tokens that make
    every row tile spill (ascending logits), then on the same tokens
    negated, every fifth slot random in both: each replay equals the eager
    call exactly."""
    from repro_torch.kernels import ops

    K, C, v_pad, k = 3, 256, 1200, 8
    w, ids, buf, g_buf, kw = _ordered_inputs(dev, K, C, v_pad, quantized, "ascending")
    buf = buf.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.dss_topk_grouped(w, ids, buf, g_buf, k, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.dss_topk_grouped(w, ids, buf, g_buf, k, **kw)
    gen = torch.Generator(device=dev).manual_seed(3)
    for scale in (1.0, -1.0):
        new = (buf.float() * scale).to(buf.dtype)
        new[:, ::5] = torch.randint(-8, 9, new[:, ::5].shape, generator=gen, device=dev).to(
            buf.dtype)
        buf.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        want = ops.dss_topk_grouped(w, ids, new, g_buf, k, **kw)
        for a, b in zip(out, want):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the moe and vlm families
# ---------------------------------------------------------------------------

def _moe_inputs(dtype, widths, B, S, seed=0):
    """One layer's MoE params at ``reduce_config(olmoe-1b-7b)``'s widths
    ("reduced": d 64, 4 experts, top-2, f 64) or at olmoe-1b-7b's ("olmoe":
    d 2048, 64 experts, top-8, f 1024), and x (B, S, d), seeded, on the
    CPU."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import moe

    cfg = get_config("olmoe-1b-7b")
    if widths == "reduced":
        cfg = reduce_config(cfg)
    cfg = cfg.replace(dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    params = {k: v[0] for k, v in moe.init_moe(g, cfg, 1, device="cpu").items()}
    x = torch.randn((B, S, cfg.d_model), generator=g).to(cfg.jdtype)
    return cfg, params, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("widths,B,S", [("reduced", 3, 7), ("reduced", 2, 33),
                                        ("olmoe", 8, 1), ("olmoe", 1, 96), ("olmoe", 8, 5)])
def test_moe_block_on_the_card_matches_its_cpu_run(dev, dtype, widths, B, S):
    """``moe_block`` on CUDA tensors against the same call on the CPU (its
    plain run: fp32-widened expert products): the router's ids, slots and
    drops equal (the drop fraction, 1 - a mean in another order, within
    2^-23: one fp32 ulp of the mean); fp32 outputs within max|y|·2^-16
    (sums in other orders); bf16 outputs within one bf16 ulp (2^-7) of
    max|y| (bf16 products with fp32 outputs on the card, exact fp32
    products on the CPU; the same roundings after them). B 8 × S 1 is a decode step, B 1 ×
    S 96 a prefill, B 8 × S 5 a verify block of gamma 4."""
    from repro_torch.models import moe

    cfg, params, x = _moe_inputs(dtype, widths, B, S)
    want, aux = moe.moe_block(params, cfg, x)
    route = moe.route(params, cfg, x)
    on = {k: v.to(dev) for k, v in params.items()}
    got, gaux = moe.moe_block(on, cfg, x.to(dev))
    groute = moe.route(on, cfg, x.to(dev))
    for a, b in zip(groute[2:], route[2:]):
        assert torch.equal(a.cpu(), b)
    assert got.dtype == x.dtype and got.shape == x.shape
    scale = float(want.float().abs().max())
    atol = scale * (2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -16)
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=0, atol=atol)
    torch.testing.assert_close(gaux.drop_frac.cpu(), aux.drop_frac, rtol=0, atol=2.0 ** -23)
    torch.testing.assert_close(gaux.load_loss.cpu(), aux.load_loss, rtol=1e-5, atol=0)


def test_moe_block_replays_in_a_cuda_graph(dev):
    """``moe_block`` at a decode step's shape (B 8, S 1, olmoe's widths,
    bf16) captured once in a CUDA graph (it makes no host sync) and
    replayed on new tokens: each replay equals the eager call bit for
    bit."""
    from repro_torch.models import moe

    cfg, params, x = _moe_inputs("bfloat16", "olmoe", 8, 1)
    on = {k: v.to(dev) for k, v in params.items()}
    x = x.to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe.moe_block(on, cfg, x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _ = moe.moe_block(on, cfg, x)
    gen = torch.Generator(device=dev).manual_seed(4)
    for _ in range(3):
        x.copy_(torch.randn(x.shape, generator=gen, device=dev).to(x.dtype))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, moe.moe_block(on, cfg, x)[0])


def _family_model(dev, arch, dtype="bfloat16"):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core import dssoftmax as ds
    from repro_torch.models import build

    cfg = reduce_config(get_config(arch), vocab=1024).replace(dtype=dtype)
    bundle = build(cfg)
    params, state = bundle.init(torch.Generator(device=dev).manual_seed(0))
    return bundle, params, ds.pack_experts(params["head"], state)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-moe-235b-a22b", "internvl2-26b"])
@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_family_decode_graph_streams_equal_the_eager_step(dev, arch, cache):
    """A reduced moe or vlm model in bf16 served with its decode backbone
    replayed from a CUDA graph against the eager step on the same
    requests: greedy streams and one sampled stream token-identical, one
    capture, pages all free after the paged session."""
    from repro_torch.train import ServeSession

    model = _family_model(dev, arch)
    kw = dict(paged=True, page_size=16, prefill_chunk=16) if cache == "paged" else {}
    streams = {}
    for graph in (False, None):
        sess = ServeSession(*model, n_slots=2, max_seq_len=128, decode_graph=graph, **kw)
        reqs = _graph_requests(5, 6, 10, sampled=3)
        sess.run(reqs)
        streams[graph] = [r.out_tokens for r in reqs]
        st = sess.stats()
        assert st["decode_graphs"] == (1 if graph is None else 0) and st["n_completed"] == 5
        if cache == "paged":
            assert st["paged"]["pages_in_use"] == 0
    assert streams[None] == streams[False]


def test_moe_speculative_session_repeats_through_its_graphs(dev):
    """A reduced olmoe self-draft (gamma 4, bf16) through its draft and
    verify graphs: two runs on the same requests give the same tokens, and
    the eager run (``decode_graph=False``) gives them too."""
    from repro_torch.train import ServeSession

    model = _family_model(dev, "olmoe-1b-7b")
    runs = []
    for graph in (None, None, False):
        sess = ServeSession(*model, n_slots=2, max_seq_len=128, draft=model, gamma=4,
                            decode_graph=graph)
        reqs = _graph_requests(5, 7, 10)
        sess.run(reqs)
        runs.append([r.out_tokens for r in reqs])
        n = 1 if graph is None else 0
        st = sess.stats()
        assert (st["draft_graphs"], st["verify_graphs"]) == (n, n)
    assert runs[0] == runs[1] == runs[2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_prefill_with_patches_runs_the_attention_kernel(dev, dtype):
    """A reduced internvl2-26b prefill of 8 patches + 40 tokens on the card:
    one ``flash_attention`` launch per layer (the body ``select_body``
    picks), the same top-k ids as the prefill with the plain attention
    swapped in, values within 2^-4 (bf16) or 1e-4 (fp32) of the top-1."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    bundle, params, table = _family_model(dev, "internvl2-26b", dtype)
    cfg = bundle.cfg
    g = torch.Generator(device=dev).manual_seed(2)
    batch = {"tokens": torch.randint(0, 1024, (1, 40), generator=g, device=dev),
             "patches": torch.randn((1, 8, cfg.d_model), generator=g, device=dev)}
    ops.reset_launch_counts()
    vk, ik, cache = bundle.prefill(params, table, batch)
    assert cache.k.shape[2] == 48
    assert sum(ops.launch_counts()[n] for n in ("flash_attention", "flash_attention_wgmma")) \
        == cfg.n_layers
    orig = layers.flash_attention
    layers.flash_attention = lambda q, k, v, device: layers.chunked_causal_attention(
        cfg, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
    try:
        vp, ip, _ = bundle.prefill(params, table, batch)
    finally:
        layers.flash_attention = orig
    assert torch.equal(ik, ip)
    tol = 2.0 ** -4 if dtype == "bfloat16" else 1e-4
    assert float((vk - vp).abs().max()) <= tol * float(vp[:, 0].abs().max())


# ---------------------------------------------------------------------------
# The ssm and hybrid families: the SSD block on the card, zamba2-7b's dh 112
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 129, 2048])
@pytest.mark.parametrize("B", [1, 2])
def test_flash_attention_tensor_core_body_at_dh_112(dev, S, B):
    """zamba2-7b's shared attention: MHA 32/32 at dh 112 (3584 / 32), bf16,
    through the tensor-core body (112 is a multiple of 16 and at most 128),
    every element within the limit."""
    q, k, v = _attn_inputs(dev, B, 32, 32, S, 112, torch.bfloat16, seed=S + B + 112)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o = _run_flash(qt, kt, vt, "flash_attention_wgmma")
    _assert_within_limit(o, qt, kt, vt)


def _ssd_inputs(S, H, G, N, P=64, b=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, S, H, P), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((b, S, H), generator=g))
    A = -torch.exp(torch.randn((H,), generator=g))
    B = torch.randn((b, S, G, N), generator=g)
    C = torch.randn((b, S, G, N), generator=g)
    return x, dt, A, B, C


@pytest.mark.parametrize("S,H,G,N,chunk", [(37, 8, 2, 16, 8), (512, 24, 1, 128, 256),
                                           (300, 112, 1, 64, 256)])
def test_ssd_chunked_on_the_card_matches_its_cpu_run(dev, S, H, G, N, chunk):
    """``ssd_chunked`` on CUDA tensors against the same call on the CPU, at a
    small shape and at mamba2-130m's (H 24, N 128) and zamba2-7b's (H 112,
    N 64) head shapes with S not a chunk multiple: outputs and final states
    within 2^-7 of their largest magnitude (the bf16 operands of the
    intra-chunk products round identically; a one-ulp difference of an fp32
    sum ahead of a bf16 rounding moves a term by one bf16 ulp), and with a
    relative RMS difference below 1e-5. TF32 stays off."""
    from repro_torch.models import mamba2

    args = _ssd_inputs(S, H, G, N, seed=S)
    want = mamba2.ssd_chunked(*args, chunk=chunk)
    got = mamba2.ssd_chunked(*(a.to(dev) for a in args), chunk=chunk)
    for a, b in zip(got, want):
        a = a.cpu()
        big = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0, atol=2.0 ** -7 * big)
        assert float((a - b).pow(2).mean().sqrt()) <= 1e-5 * big


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_on_the_card_matches_its_cpu_run(dev, dtype):
    """``mamba2_decode`` (B 8, mamba2-130m's widths) on the card against its
    CPU run: fp32 within 1e-5 of each tensor's largest magnitude, bf16
    within one bf16 ulp (2^-7) of it; the rows the new conv state shifts
    along from the old one bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba2

    cfg = get_config("mamba2-130m").replace(dtype=dtype)
    g = torch.Generator().manual_seed(3)
    p = {k: v[0] for k, v in mamba2.init_mamba2(g, cfg, 1, device="cpu").items()}
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    u = torch.randn((8, 1, cfg.d_model), generator=g).to(cfg.jdtype)
    cs = torch.randn((8, 3, conv_dim), generator=g).to(cfg.jdtype)
    ss = torch.randn((8, cfg.ssm_nheads, 64, cfg.ssm_state), generator=g) * 0.1
    want = mamba2.mamba2_decode(p, cfg, u, cs, ss)
    got = mamba2.mamba2_decode({k: v.to(dev) for k, v in p.items()}, cfg, u.to(dev),
                               cs.to(dev), ss.to(dev))
    rel = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu().float(), b.float(), rtol=0,
                                   atol=rel * float(b.float().abs().max()))
    assert torch.equal(got[1][:, :-1].cpu(), want[1][:, :-1])
    assert torch.equal(got[1][:, :-1].cpu(), cs[:, 1:])


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_state_family_decode_graph_streams_equal_the_eager_step(dev, arch, cache):
    """A reduced ssm or hybrid model in bf16 with its decode backbone (the
    conv/ssm state copied in place, the state page ids a static input when
    paged) replayed from a CUDA graph against the eager step: greedy
    streams and one sampled stream token-identical, one capture, every
    page and state page free after the paged session."""
    from repro_torch.train import ServeSession

    model = _family_model(dev, arch)
    kw = dict(paged=True, page_size=16, prefill_chunk=16) if cache == "paged" else {}
    streams = {}
    for graph in (False, None):
        sess = ServeSession(*model, n_slots=2, max_seq_len=128, decode_graph=graph, **kw)
        reqs = _graph_requests(5, 6, 10, sampled=3)
        sess.run(reqs)
        streams[graph] = [r.out_tokens for r in reqs]
        st = sess.stats()
        assert st["decode_graphs"] == (1 if graph is None else 0) and st["n_completed"] == 5
        if cache == "paged":
            assert st["paged"]["pages_in_use"] == 0 and st["paged"]["state_pages_in_use"] == 0
    assert streams[None] == streams[False]


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_state_family_speculative_session_repeats_through_its_graphs(dev, arch):
    """A reduced ssm or hybrid self-draft (gamma 4, bf16, paged chunked)
    through its draft and verify graphs, the commit passes eager: two runs
    give the same tokens, and so does the eager run."""
    from repro_torch.train import ServeSession

    model = _family_model(dev, arch)
    runs = []
    for graph in (None, None, False):
        sess = ServeSession(*model, n_slots=2, max_seq_len=128, draft=model, gamma=4,
                            decode_graph=graph, paged=True, page_size=16, prefill_chunk=16)
        reqs = _graph_requests(5, 7, 10)
        sess.run(reqs)
        runs.append([r.out_tokens for r in reqs])
        n = 1 if graph is None else 0
        st = sess.stats()
        assert (st["draft_graphs"], st["verify_graphs"]) == (n, n)
        assert st["paged"]["state_pages_in_use"] == 0
    assert runs[0] == runs[1] == runs[2]


# ---------------------------------------------------------------------------
# The encdec family: whisper-base and paper-envi
# ---------------------------------------------------------------------------

ENCDEC_D = [256, 512]   # paper-envi, whisper-base: narrower than any head served before


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("d", ENCDEC_D)
def test_fused_kernel_at_the_encdec_heads(dev, quantized, B, d):
    """The fused kernel at the encdec heads' widths (its streaming plan
    sizes the token group from d), at prefill's last position (B 1) and at
    decode (B 8), fp and int8 rows."""
    from repro_torch.kernels import ops, ref

    gate, h, w, ids = _fused_inputs(dev, torch.bfloat16, B, d, 0, 4, seed=B + d + 1)
    kw = {}
    if quantized:
        w, kw["scales"] = _quantize(w)
    else:
        w = w.to(torch.bfloat16)
    name = "dss_topk_fused" + ("_q" if quantized else "")
    n = ops.launch_counts()[name]
    got = ops.dss_topk_fused(gate, w, ids, h, 8, **kw)
    assert ops.launch_counts()[name] == n + 1
    _check_fused(got, ref.dss_topk_fused_ref(gate, w, ids, h, 8, 0, **kw), 0, 4)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("d", ENCDEC_D)
def test_grouped_decode_body_at_the_encdec_heads(dev, quantized, C, d):
    """The grouped decode body at the encdec heads' widths and at the
    capacities decode gives it (C 1 and 2 at K 8, B 8)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dss_topk_grouped import DECODE, launch_body

    w, ids, buf, g_buf, kw = _decode_inputs(dev, torch.bfloat16, C, d, seed=C + d + 1,
                                            quantized=quantized)
    name = DECODE + ("_q" if quantized else "")
    n = ops.launch_counts()[name]
    got = launch_body(w, ids, buf, g_buf, 8, kw.get("scales"), DECODE)
    assert ops.launch_counts()[name] == n + 1
    _check_decode(got, ref.dss_topk_grouped_ref(w, ids, buf, g_buf, 8, **kw), g_buf, 8)


@pytest.mark.parametrize("S", [1, 64, 129, 448])
@pytest.mark.parametrize("H", [8, 4])
def test_flash_attention_tensor_core_body_at_the_encdec_heads(dev, H, S):
    """The decoders' causal self-attention: whisper-base's MHA 8/8 and
    paper-envi's 4/4 at dh 64, bf16, through the tensor-core body, every
    element within the limit (S up to whisper's 448-token context)."""
    q, k, v = _attn_inputs(dev, 2, H, H, S, 64, torch.bfloat16, seed=S + H)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    o = _run_flash(qt, kt, vt, "flash_attention_wgmma")
    _assert_within_limit(o, qt, kt, vt)


def _encdec_models(dev, arch, dtype):
    """A reduced encdec model (vocab 1024) initialized on the CPU, and the
    same params and table on the card."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core import dssoftmax as ds
    from repro_torch.models import build

    cfg = reduce_config(get_config(arch), vocab=1024).replace(dtype=dtype)
    cpu = build(cfg, device="cpu")
    params, state = cpu.init(torch.Generator().manual_seed(0))
    table = ds.pack_experts(params["head"], state)
    on = lambda t: {k: on(v) for k, v in t.items()} if isinstance(t, dict) else t.to(dev)
    return ((cpu, params, table),
            (build(cfg), on(params), type(table)(*(x.to(dev) for x in table))))


@pytest.mark.parametrize("arch", ["whisper-base", "paper-envi"])
def test_encdec_prefill_and_decode_on_the_card_match_the_cpu_run(dev, arch):
    """A reduced encdec model in fp32: prefill (B 2, 8 frames, 9 target
    tokens; the decoder's causal attention through the CUDA-core
    ``flash_attention`` body, one launch a layer) and three decode steps at
    a vector, then three at a scalar ``pos`` on the self cache grown to 16
    (``encdec.pad_self_cache``), through ``kernel='auto'`` on the card and
    the plain head on the CPU: ids equal, values within 1e-4, the self
    cache within 1e-5."""
    from repro_torch.kernels import ops
    from repro_torch.models import encdec

    (cb, cp, ct), (gb, gp, gt) = _encdec_models(dev, arch, "float32")
    cfg = cb.cfg
    g = torch.Generator().manual_seed(3)
    batch = {"frames": torch.randn((2, 8, cfg.d_model), generator=g),
             "tokens": torch.randint(0, 1024, (2, 9), generator=g)}
    ops.reset_launch_counts()
    gv, gi, gc = gb.prefill(gp, gt, {k: v.to(dev) for k, v in batch.items()}, kernel="auto")
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    cv, ci, cc = cb.prefill(cp, ct, batch, kernel="jnp")
    _same((gv.cpu(), gi.cpu()), (cv, ci), atol=1e-4)
    for a, b in zip(gc, cc):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)
    gc, cc = encdec.pad_self_cache(gc, 16), encdec.pad_self_cache(cc, 16)
    tok = ci[:, 0]
    for step in range(6):
        pos = torch.tensor([9 + step, 7 + step]) if step < 3 else 9 + step
        gpos = pos.to(dev) if torch.is_tensor(pos) else pos
        gv, gi, gc = gb.decode_step(gp, gt, gc, tok.to(dev), gpos, kernel="auto")
        cv, ci, cc = cb.decode_step(cp, ct, cc, tok, pos, kernel="jnp")
        _same((gv.cpu(), gi.cpu()), (cv, ci), atol=1e-4)
        torch.testing.assert_close(gc.self_k.cpu(), cc.self_k, rtol=0, atol=1e-5)
        tok = ci[:, 0]


@pytest.mark.parametrize("arch", ["whisper-base", "paper-envi"])
def test_encdec_bf16_prefill_runs_the_tensor_core_attention(dev, arch):
    """In bf16 the decoder's prefill attention runs ``flash_attention_wgmma``
    once a layer and nothing else of the attention kernels; the top-k ids
    equal the prefill's with the plain attention swapped in, values within
    2^-4 of the top-1."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers

    _, (bundle, params, table) = _encdec_models(dev, arch, "bfloat16")
    cfg = bundle.cfg
    g = torch.Generator(device=dev).manual_seed(5)
    batch = {"frames": torch.randn((2, 8, cfg.d_model), generator=g, device=dev),
             "tokens": torch.randint(0, 1024, (2, 40), generator=g, device=dev)}
    ops.reset_launch_counts()
    vk, ik, _ = bundle.prefill(params, table, batch)
    counts = ops.launch_counts()
    assert counts["flash_attention_wgmma"] == cfg.n_layers and counts["flash_attention"] == 0
    orig = layers.flash_attention
    layers.flash_attention = lambda q, k, v, device: layers.chunked_causal_attention(
        cfg, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
    try:
        vp, ip, _ = bundle.prefill(params, table, batch)
    finally:
        layers.flash_attention = orig
    assert torch.equal(ik, ip)
    assert float((vk - vp).abs().max()) <= 2.0 ** -4 * float(vp[:, 0].abs().max())


# ---------------------------------------------------------------------------
# Serving on a mesh: the sharded head in a 1-rank NCCL group, and each
# model rank's local half at ep 2 and 4 through the CUDA bodies, merged
# ---------------------------------------------------------------------------

def _mesh_head_inputs(dev, quantized, seed=5):
    from repro_torch.core import dssoftmax as ds

    K, v_pad, d = 6, 512, 64
    w, ids, g = _table(dev, K, v_pad, d, torch.bfloat16, seed)
    table = ds.ServeTable(ids=ids, weights=w)
    if quantized:  # experts 1 and 4 on exact fallback rows, the rest int8
        table = ds.quantize_table(table, fb_mask=torch.tensor([0, 1, 0, 0, 1, 0], dtype=bool))
    gate = (torch.randn((K, d), generator=g, device=dev) * d ** -0.5).to(torch.bfloat16)
    return gate, table, g


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from repro_torch.launch import mesh as lmesh

    lmesh.init_distributed("cuda", store=str(tmp_path_factory.mktemp("nccl") / "store"),
                           rank=0, world_size=1)
    yield lmesh.parse_mesh("1x1", device="cuda")
    lmesh.destroy()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("path", ["auto", "cuda_fused", "cuda_grouped", "cuda_pertoken", "jnp"])
def test_sharded_head_in_a_one_rank_nccl_group(dev, nccl_mesh, path, quantized):
    """``serve_topk_sharded`` over NCCL at 1x1 equals ``serve_topk`` on the
    same path bit for bit, at decode, verify and batch sizes."""
    from repro_torch.core import dssoftmax as ds

    if quantized and path == "cuda_pertoken":
        pytest.skip("the per-token kernel serves fp tables only")
    gate, table, g = _mesh_head_inputs(dev, quantized)
    shard = ds.shard_table(table, nccl_mesh)
    for B in (1, 8, 40, 300):
        h = torch.randn((B, gate.shape[1]), generator=g, device=dev).to(torch.bfloat16)
        got = ds.serve_topk_sharded(gate, shard, h, 8, mesh=nccl_mesh, kernel=path,
                                    with_stats=True)
        want = ds.serve_topk(gate, table, h, 8, kernel=path, with_stats=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[2]["dispatched"], want[2]["dispatched"])
        assert torch.equal(got[2]["overflow"], want[2]["overflow"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_split_data_rows_in_turn_equal_the_whole_cache(dev, dtype):
    """A data-2 mesh's slot-split decode emulated on the card
    (``testing.mesh_rows.decode_data_rows``: each data row's 2 of 4 slots
    stepped in turn on its own block cache through the backbone and the
    ``cuda_fused`` head, the rows merged) against the whole cache on reduced
    qwen2-1.5b: the prefill's emission bit for bit; in fp32 every id equal
    and values within rtol 1e-5 / atol 1e-5 (the backbone's products at 2
    rows where the whole steps 4), in bf16 the streams equal or parting
    only where the whole cache's top-2 are within 2^-4 of each other; each
    row's cache half the whole's bytes; the fused body launched."""
    from repro_torch import configs
    from repro_torch.core import dssoftmax as ds
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.testing.mesh_rows import decode_data_rows

    cfg = configs.reduce_config(configs.get_config("qwen2-1.5b")).replace(dtype=dtype)
    bundle = build(cfg, device=dev)
    params, state = bundle.init(torch.Generator(device=dev).manual_seed(3))
    table = ds.pack_experts(params["head"], state)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 17, 9, 30)]
    kw = dict(new_tokens=12, max_seq_len=48, k=8, kernel="cuda_fused", device=dev)
    whole = decode_data_rows(bundle, params, table, prompts, n_rows=1, **kw)
    n0 = ops.launch_counts()["dss_topk_fused"]
    rows = decode_data_rows(bundle, params, table, prompts, n_rows=2, **kw)
    assert ops.launch_counts()["dss_topk_fused"] > n0
    assert [sharding.tree_shard_bytes(c) * 2 for c in rows.caches] == \
        [sharding.tree_shard_bytes(whole.caches[0])] * 2
    for i in range(len(prompts)):
        assert all(torch.equal(a, b) for a, b in zip(rows.heads[i][0], whole.heads[i][0]))
        for j, ((v, ids), (wv, wids)) in enumerate(zip(rows.heads[i], whole.heads[i])):
            if dtype == "float32":
                assert torch.equal(ids, wids), (i, j)
                torch.testing.assert_close(v, wv, rtol=1e-5, atol=1e-5)
            elif rows.tokens[i][j] != whole.tokens[i][j]:
                assert float(wv[0] - wv[1]) <= 2.0 ** -4 * abs(float(wv[0])), (i, j)
                break


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("path", ["cuda_fused", "cuda_grouped"])
def test_local_halves_through_the_kernels_merge_to_serve_topk(dev, path, ep, quantized):
    """Each model rank's half at ep 2 and 4 (K 6 pads to 8 at ep 4) on this
    one card, one after another: the fused kernel at ``e_base`` r·K_loc, the
    grouped kernel on owned tokens at the global capacity; merged, ids equal
    ``serve_topk``'s bit for bit and values within rtol 1e-6 / atol 2e-6,
    the counts concatenate to its counts, no -inf in any carry, and the
    path's bodies launch."""
    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops

    gate, table, g = _mesh_head_inputs(dev, quantized, seed=9)
    for B, cf in ((8, 2.0), (300, 2.0), (64, 0.25)):
        h = torch.randn((B, gate.shape[1]), generator=g, device=dev).to(torch.bfloat16)
        want = ds.serve_topk(gate, table, h, 8, kernel=path, capacity_factor=cf,
                             with_stats=True)
        shards = [ds.table_shard(table, ep, r) for r in range(ep)]
        before = ops.launch_counts()
        halves = [ds.serve_topk_local_half(gate, s, h, 8, path, capacity_factor=cf,
                                           with_stats=True) for s in shards]
        delta = {n: c - before[n] for n, c in ops.launch_counts().items()}
        fam = "dss_topk_fused" if path == "cuda_fused" else "dss_topk_grouped"
        assert sum(c for n, c in delta.items() if n.startswith(fam)) >= ep
        assert not any(torch.isinf(v).any() for v, _, _, _ in halves)
        K_loc = shards[0].local.ids.shape[0]
        v, i = ds.merge_carries(torch.stack([x[0] for x in halves]),
                                torch.stack([x[1] for x in halves]), halves[0][2], K_loc)
        assert torch.equal(i, want[1])
        torch.testing.assert_close(v, want[0], rtol=1e-6, atol=2e-6)
        got = {key: torch.cat([x[3][key] for x in halves])[:6] for key in want[2]}
        assert torch.equal(got["dispatched"], want[2]["dispatched"])
        if 6 % ep == 0:  # else capacity is sized by the padded K, as in repro
            assert torch.equal(got["overflow"], want[2]["overflow"])


# Training on a mesh: the mesh step in a 1-rank NCCL group against the plain
# step, and the expert-parallel FFN one shard after another
# ---------------------------------------------------------------------------

def _moe_train_setup(dev, dtype):
    """Reduced olmoe-1b-7b (d 64, E 4, top-2), seeded on the CPU, moved."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import build
    from repro_torch.optim import adam_init
    from repro_torch.train.train_step import TrainState
    from repro_torch.utils import tree_map

    cfg = reduce_config(get_config("olmoe-1b-7b"), vocab=256).replace(dtype=dtype)
    cfg = cfg.replace(ds=cfg.ds.replace(lambda_lasso=1e-3, lambda_expert=1e-3, gamma=1.0))
    params, st = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    move = lambda t: t.to(dev)  # noqa: E731
    params, st = tree_map(move, params), st._replace(mask=move(st.mask))
    return build(cfg, device=dev), TrainState(params, adam_init(params), st)


@pytest.mark.parametrize("arch,dtype,micro", [("qwen2-1.5b", "float32", 1),
                                              ("qwen2-1.5b", "bfloat16", 2),
                                              ("olmoe-1b-7b", "float32", 2),
                                              ("olmoe-1b-7b", "bfloat16", 1)])
def test_mesh_train_step_in_a_one_rank_nccl_group_equals_the_plain_step(
        dev, nccl_mesh, arch, dtype, micro):
    """Three steps of ``make_train_step(mesh=1x1)`` over NCCL against the
    plain step from the same state (olmoe through the expert-parallel FFN
    with one shard): the same code with every collective on a group of one
    left out, so params, moments, masks and metrics are equal bit for bit,
    or (where a CUDA scatter sums in another order) params within 2·lr per
    step, moments within 1e-3 of each leaf's largest, masks and metrics
    within rtol 1e-3."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.train.train_step import make_train_step
    from repro_torch.utils import flatten_dict

    lr = 1e-3
    setup = _train_setup if arch == "qwen2-1.5b" else _moe_train_setup
    bundle, state = setup(dev, dtype)
    tcfg = TrainConfig(lr=lr, microbatches=micro)
    local, specs = sharding.shard_train_state(nccl_mesh, state)
    plain, meshed = make_train_step(bundle, tcfg), make_train_step(
        bundle, tcfg, mesh=nccl_mesh, shardings=specs)
    ops.reset_launch_counts()
    for i in range(3):
        batch = _batch(dev, seed=i)
        state, pm = plain(state, batch)
        local, mm = meshed(local, batch)
        for k in pm:
            torch.testing.assert_close(mm[k], pm[k], rtol=1e-3, atol=0, msg=k)
    assert not any(ops.launch_counts().values())
    fp, fm = flatten_dict(state), flatten_dict(local)
    for k in fp:
        if torch.equal(fp[k], fm[k]):
            continue
        assert fp[k].dtype != torch.bool, k
        diff = (fp[k].float() - fm[k].float()).abs().max()
        bound = 2 * lr * 3 if k.startswith("params/") else 1e-3 * fp[k].float().abs().max()
        assert diff <= bound, (k, float(diff))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ep", [2, 4])
def test_expert_parallel_ffn_one_shard_at_a_time_matches_moe_block(dev, ep, dtype):
    """olmoe-1b-7b's MoE at full width (E 64, top-8, d 2048, f 1024), B 2 x
    S 64: the shards' parts (``moe.moe_ep_local``) run one after another on
    the card and summed in the activation dtype equal ``moe_block``: fp32
    within max|y|·2^-20 (sums in another order); bf16 within the partials'
    and running sums' half ulps plus half an ulp of the reference. The
    gradients of Σ y·dy + the aux loss for x, the router and every expert
    slice within 2^-16 (fp32) or 2^-6 (bf16) of each leaf's largest."""
    from repro_torch.models import moe

    cfg, params, x = _moe_inputs(dtype, "olmoe", 2, 64)
    params = {k: v.to(dev) for k, v in params.items()}
    x = x.to(dev)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)).to(dev)
    E = cfg.moe.num_experts

    def grads(run):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        xr = x.detach().requires_grad_(True)
        y, parts, load = run(leaves, xr)
        g = torch.autograd.grad(torch.sum(y.float() * dy) + load, [xr] + list(leaves.values()))
        return y.detach(), parts, dict(zip(["x"] + list(leaves), g))

    def whole(p, xr):
        y, aux = moe.moe_block(p, cfg, xr)
        return y, None, aux.load_loss

    def sharded(p, xr):
        probs, top_p, top_e, slot, valid = moe.route(p, cfg, xr)
        parts = [moe.moe_ep_local({k: p[k][m * (E // ep):(m + 1) * (E // ep)]
                                   for k in ("w_gate", "w_up", "w_down")},
                                  cfg, xr, top_e, top_p, slot, valid, m, ep)
                 for m in range(ep)]
        y = parts[0]
        for part in parts[1:]:
            y = y + part
        return y, [q.detach() for q in parts], moe.switch_aux(probs, top_e, valid).load_loss

    want, _, gw = grads(whole)
    got, parts, gg = grads(sharded)
    err = (got.float() - want.float()).abs()
    if dtype == "float32":
        assert float(err.max()) <= float(want.abs().max()) * 2.0 ** -20
    else:
        def half_ulp(t):
            e = torch.floor(torch.log2(torch.clamp(t.float().abs(), min=2.0 ** -126)))
            return torch.exp2(e - 8)

        bound = sum(half_ulp(q) for q in parts) + half_ulp(want)
        run = parts[0].float()
        for q in parts[1:]:
            run = (run + q.float()).to(torch.bfloat16).float()
            bound = bound + half_ulp(run)
        assert bool((err <= bound).all()), float((err - bound).max())
    tol = 2.0 ** -16 if dtype == "float32" else 2.0 ** -6
    for k, w in gw.items():
        rel = float((gg[k].float() - w.float()).abs().max() / w.float().abs().max())
        assert rel <= tol, (k, rel)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dryrun_prediction_holds_on_the_card(dev, kind):
    """A reduced qwen2-1.5b cell traced at 1x1 on meta tensors, then run on
    the card from the same shapes: the argument bytes equal the card's
    exactly, the step peak (``max_memory_allocated`` less what was
    allocated at entry, one step warmed up) within
    ``launch.dryrun.PEAK_RTOL``/``PEAK_ATOL`` of the traced one."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.core import dssoftmax as ds
    from repro_torch.distributed.sharding import tree_shard_bytes
    from repro_torch.launch import dryrun
    from repro_torch.models import build
    from repro_torch.models.model_zoo import cache_specs
    from repro_torch.optim import adam_init
    from repro_torch.train.train_step import TrainState, make_train_step

    cfg = reduce_config(get_config("qwen2-1.5b"))
    shape = ShapeConfig(name=f"tiny_{kind}", seq_len=64, global_batch=8, kind=kind)
    bundle = build(cfg, device="cuda")
    params, ds_state = bundle.init(torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    if kind == "train":
        rec = dryrun.run_cell(None, "1x1", "qwen2-1.5b", shape.name, cfg=cfg, shape=shape,
                              microbatches=2)
        state = TrainState(params, adam_init(params), ds_state)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 65), generator=g, device=dev,
                                         dtype=torch.int32)}
        step = make_train_step(bundle, TrainConfig(microbatches=2))
        args = tree_shard_bytes(state) + tree_shard_bytes(batch)
        call = lambda: step(state, batch)  # noqa: E731
    else:
        table = ds.pack_experts(params["head"], ds_state)
        params = dict(params, head={"gate": params["head"]["gate"]})
        rec = dryrun.run_cell(None, "1x1", "qwen2-1.5b", shape.name, cfg=cfg, shape=shape,
                              v_pad=table.v_pad)
        specs = cache_specs(cfg, shape)
        cache = type(specs)(*(torch.zeros(s.shape, dtype=s.dtype, device=dev) for s in specs))
        tok = torch.arange(8, dtype=torch.int32, device=dev)
        pos = torch.arange(8, dtype=torch.int32, device=dev) * 7
        args = tree_shard_bytes({"p": params, "t": table, "c": cache,
                                 "b": {"tok": tok, "pos": pos}})
        call = lambda: bundle.decode_step(params, table, cache, tok, pos,  # noqa: E731
                                          with_stats=True)
    call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    entry = torch.cuda.memory_allocated()
    out = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - entry
    del out
    m = rec["memory"]
    assert m["argument_bytes"] == args
    traced = m["step_bytes"]
    assert abs(peak - traced) <= dryrun.PEAK_RTOL * traced + dryrun.PEAK_ATOL, (peak, traced)
