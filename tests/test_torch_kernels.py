"""Port parity: the ``dss_topk_grouped`` and ``dss_topk_fused`` kernel
wrappers (their plain versions, which is what they run on CPU tensors)
against ``repro``'s Pallas kernels in interpret mode on the same seeded
inputs.

Tolerances: ids equal everywhere (ties included: duplicated rows make
them exact, and the lowest packed position must win on both sides);
values rtol 1e-6, atol 2e-6 (``tests/test_kernels.py:103``: fp32 sums of
exact products in another order)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as pallas_ops
from repro_torch.convert import to_tensor
from repro_torch.kernels import _build, ops, ref

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



# ---------------------------------------------------------------------------
# The fused kernel's launch plan (kernels/dss_topk_fused.py): the grid and
# the row chunks the kernel computes on the device, mirrored in Python.
# ---------------------------------------------------------------------------

# the package's name dss_topk_fused is the wrapper function, so the module
# comes from importlib; the chunking it shares with the grouped decode body
# is retrieve_stream's
_plan = importlib.import_module("repro_torch.kernels.dss_topk_fused")
_stream = importlib.import_module("repro_torch.kernels.retrieve_stream")


@pytest.mark.parametrize("B,K,v_pad", [(1, 16, 12032), (8, 16, 12032), (300, 16, 12032),
                                       (8, 4, 900), (37, 4, 900), (1, 64, 64), (128, 8, 12000)])
def test_fused_chunks_partition_the_rows(B, K, v_pad):
    """For every number of experts the tokens can choose, the chunks are
    multiples of ROW_STEP rows (the last one cut at v_pad), cover [0,
    v_pad) exactly once, and never outnumber the partial lists the wrapper
    allocates."""
    plan = _plan.launch_plan(B, K, v_pad, 1536, torch.bfloat16)
    for n_sel in range(1, min(B, K) + 1):
        rows = _stream.chunk_rows(n_sel, v_pad, plan.grid)
        assert rows % _stream.ROW_STEP == 0 and _stream.ROW_STEP <= rows <= _stream.MAX_CHUNK_ROWS
        nck = -(-v_pad // rows)
        bounds = [(c * rows, min(v_pad, (c + 1) * rows)) for c in range(nck)]
        assert bounds[0][0] == 0 and bounds[-1][1] == v_pad
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(bounds, bounds[1:]))
        assert nck <= plan.max_chunks


@pytest.mark.parametrize("n_sel", range(1, 9))
def test_fused_grid_fills_every_sm_at_decode(n_sel):
    """qwen2-1.5b's head at B 8 (K 16, V_pad 12,032): the grid is two
    blocks on each of the H100's 132 SMs, and whatever number of experts 8
    tokens choose, their chunks keep at least 95% of those blocks busy in
    one pass (no block takes a second chunk)."""
    plan = _plan.launch_plan(8, 16, 12032, 1536, torch.bfloat16)
    assert plan.grid == 2 * _build.SMS
    items = n_sel * -(-12032 // _stream.chunk_rows(n_sel, 12032, plan.grid))
    assert 0.95 * plan.grid <= items <= plan.grid


def test_fused_plan_depends_only_on_the_shapes():
    """The plan is a function of (B, K, v_pad, d, dtype): the same shapes
    give the same plan, and the row load width follows d and the element
    size (16 bytes where the row allows it, else 4, else one element)."""
    shapes = (8, 16, 12032, 1536)
    assert _plan.launch_plan(*shapes, torch.bfloat16) == _plan.launch_plan(*shapes, torch.bfloat16)
    assert _plan.launch_plan(*shapes, torch.int8).grid == _plan.launch_plan(*shapes,
                                                                            torch.float32).grid
    vb = {(d, dt): _plan.launch_plan(8, 4, 900, d, dt).vec_bytes
          for d in (37, 128, 200, 1536) for dt in (torch.float32, torch.bfloat16, torch.int8)}
    assert vb[(1536, torch.bfloat16)] == vb[(1536, torch.int8)] == vb[(128, torch.float32)] == 16
    assert vb[(200, torch.int8)] == 4 and vb[(200, torch.bfloat16)] == 16
    assert vb[(37, torch.float32)] == 4 and vb[(37, torch.bfloat16)] == 2
    assert vb[(37, torch.int8)] == 1
    assert _stream.row_vec_bytes(128, 2, ptr=8) == 4


@pytest.mark.parametrize("d,group", [(1536, 6), (128, 8), (200, 8), (8192, 1)])
def test_fused_token_group_fits_the_staged_tokens(d, group):
    assert _stream.token_group(d) == group
    assert group * d * 4 <= _stream.TOKEN_BYTES or group == 1


# ---------------------------------------------------------------------------
# The per-token kernel (kernels/dss_topk.py): the streaming retrieval over
# the tokens grouped by their expert, and its price in the registry.
# ---------------------------------------------------------------------------

_pertoken = importlib.import_module("repro_torch.kernels.dss_topk")


@pytest.mark.parametrize("B,K,v_pad,d,dtype", [
    (8, 16, 12032, 1536, torch.bfloat16), (1, 16, 12032, 1536, torch.float32),
    (300, 16, 12032, 1536, torch.bfloat16), (37, 4, 900, 37, torch.float32),
    (2, 64, 64, 128, torch.bfloat16), (64, 16, 12032, 200, torch.bfloat16)])
def test_pertoken_plan_is_the_streaming_retrieval_over_its_experts(B, K, v_pad, d, dtype):
    """dss_topk launches the retrieval of the decode kernels for min(B, K)
    experts that can hold a token: the grid is two blocks per SM (fewer
    where those experts' 16-row chunks cannot use them), the partial lists
    hold the chunks of any number of experts from 1 to min(B, K), and the
    row loads are 16 bytes where d allows them."""
    plan = _pertoken.launch_plan(B, K, v_pad, d, dtype)
    slots = min(B, K)
    assert plan.grid == min(2 * _build.SMS, slots * -(-v_pad // _stream.ROW_STEP))
    for n_sel in range(1, slots + 1):
        assert -(-v_pad // _stream.chunk_rows(n_sel, v_pad, plan.grid)) <= plan.max_chunks
    elem = torch.empty((), dtype=dtype).element_size()
    assert plan.vec_bytes == (16 if d * elem % 16 == 0 else 4 if d * elem % 4 == 0 else elem)


@pytest.mark.parametrize("B,reads", [(1, 1), (8, 8), (64, 16 + 48 // 6)])
def test_cost_cuda_pertoken_prices_each_expert_per_token_group(B, reads):
    """qwen2-1.5b's head (K 16, d 1536, V_pad 12,032, k 8, bf16): the
    per-token path reads the experts that hold a token once per group of 6
    (token_group(1536)) of their tokens, as the fused path does, plus the
    gate (the gate matrix and h read, ids and g written), the fold (h and g
    read, h_scaled written), h_scaled and the expert ids read by the
    retrieval, and the outputs; so it stays above the fused path."""
    from repro_torch.kernels import registry

    K, d, v_pad, k = 16, 1536, 12032, 8
    ctx = registry.KernelContext(B=B, d=d, K=K, v_pad=v_pad, k=k, backend="cuda",
                                 wbytes=2, hbytes=2)
    want = (reads * v_pad * d * 2                      # the experts' rows
            + K * d * 2 + B * d * 2 + B * 8            # gate_top1
            + 2 * B * d * 2 + B * 4                    # the fold
            + B * d * 2 + B * 4                        # h_scaled, expert ids
            + B * k * 8)                               # outputs
    assert registry.get_spec("cuda_pertoken").bytes_moved(ctx) == want
    assert want > registry.get_spec("cuda_fused").bytes_moved(ctx)


# ---------------------------------------------------------------------------
# The grouped kernel's decode body (kernels/dss_topk_grouped.py): its launch
# plan and work list, mirrored in Python, and the body rule by capacity.
# ---------------------------------------------------------------------------

_grouped = importlib.import_module("repro_torch.kernels.dss_topk_grouped")


def _work_items(live, v_pad, grid):
    """The decode body's work list as every block builds it on the device:
    the experts with a live slot in ascending id, each cut into chunks of
    ``chunk_rows(len(live))`` rows; item i is chunk i % nck of the
    (i // nck)-th. Returns [(expert, row_lo, row_hi)] in item order."""
    rows = _stream.chunk_rows(len(live), v_pad, grid)
    nck = -(-v_pad // rows)
    return [(live[i // nck], (i % nck) * rows, min(v_pad, (i % nck + 1) * rows))
            for i in range(len(live) * nck)]


@pytest.mark.parametrize("K,v_pad,live", [
    (16, 12032, list(range(16))), (16, 12032, [0, 3, 4, 9, 15]), (16, 12032, [7]),
    (4, 900, [0, 2]), (8, 1000, [1, 2, 3, 5, 6, 7]), (64, 64, [0, 63])])
def test_grouped_work_items_partition_each_live_experts_rows(K, v_pad, live):
    """Every live expert's packed rows are covered exactly once, in
    chunks of whole ROW_STEP multiples (the last cut at v_pad), no expert
    without a live slot appears, and the chunks of one expert never
    outnumber the partial lists the wrapper allocates."""
    plan = _grouped.launch_plan(K, v_pad, 1536, torch.bfloat16)
    items = _work_items(live, v_pad, plan.grid)
    assert [e for e, _, _ in items] == sorted(e for e, _, _ in items)
    assert {e for e, _, _ in items} == set(live)
    for e in live:
        spans = [(lo, hi) for x, lo, hi in items if x == e]
        assert spans[0][0] == 0 and spans[-1][1] == v_pad
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(spans, spans[1:]))
        assert all((hi - lo) % _stream.ROW_STEP == 0 for lo, hi in spans[:-1])
        assert len(spans) <= plan.max_chunks


@pytest.mark.parametrize("n_live", range(1, 17))
def test_grouped_grid_fills_every_sm_at_decode(n_live):
    """qwen2-1.5b's head (K 16, V_pad 12,032) at any decode capacity: the
    grid is two blocks on each of the H100's 132 SMs, and whatever number
    of experts hold a live slot, their chunks keep at least 95% of those
    blocks busy in one pass (no block takes a second chunk)."""
    plan = _grouped.launch_plan(16, 12032, 1536, torch.bfloat16)
    assert plan.grid == 2 * _build.SMS
    items = len(_work_items(list(range(n_live)), 12032, plan.grid))
    assert 0.95 * plan.grid <= items <= plan.grid


def test_grouped_plan_depends_only_on_the_shapes():
    """The decode body's plan is a function of (K, v_pad, d, dtype), not of
    the capacity or the data: the same shapes give the same plan, the
    shared retrieval's with every expert a possible holder of a live slot;
    the row load width follows d and the element size."""
    assert _grouped.launch_plan(16, 12032, 1536, torch.bfloat16) == \
        _grouped.launch_plan(16, 12032, 1536, torch.bfloat16) == \
        _stream.stream_plan(16, 12032, 1536, torch.bfloat16)
    assert _grouped.launch_plan(4, 900, 1536, torch.int8).grid == \
        _grouped.launch_plan(4, 900, 1536, torch.float32).grid
    vb = {(d, dt): _grouped.launch_plan(4, 900, d, dt).vec_bytes
          for d in (37, 200) for dt in (torch.float32, torch.bfloat16, torch.int8)}
    assert vb == {(37, torch.float32): 4, (37, torch.bfloat16): 2, (37, torch.int8): 1,
                  (200, torch.float32): 16, (200, torch.bfloat16): 16, (200, torch.int8): 4}


@pytest.mark.parametrize("C", [1, 2, 3, 8, 16, 17, 32, 64, 70, 256, 4096])
def test_grouped_select_body_by_capacity_alone(C):
    """For a given token dtype the body is chosen by the capacity alone:
    bf16 tokens run the decode body up to TILED_ABOVE slots per expert and
    the tensor-core body above, or the CUDA-core tiled body where TMA
    cannot address the data; fp32 tokens run the decode body up to
    SIMT_TILED_ABOVE and the tiled body above. Every body it names counts
    its launches for both row kinds."""
    import inspect

    assert list(inspect.signature(_grouped.select_body).parameters) == ["capacity", "dtype",
                                                                         "tma_ok"]
    bf16 = _grouped.DECODE if C <= _grouped.TILED_ABOVE else _grouped.WGMMA
    assert _grouped.select_body(C, torch.bfloat16) == bf16
    simt = _grouped.DECODE if C <= _grouped.SIMT_TILED_ABOVE else _grouped.TILED
    assert _grouped.select_body(C, torch.float32) == simt
    assert _grouped.select_body(C, torch.bfloat16, tma_ok=False) == simt
    assert _grouped.select_body(C, torch.float32, tma_ok=False) == simt
    for want in (bf16, simt):
        assert {name for name, _, _ in ops.BODIES} >= {want, want + "_q"}


@pytest.mark.parametrize("d,wdtype,ptr,ok", [
    (1536, torch.bfloat16, 0, True), (1536, torch.int8, 256, True), (200, torch.bfloat16, 0, True),
    (136, torch.bfloat16, 0, True), (144, torch.int8, 0, True), (136, torch.int8, 0, False),
    (37, torch.bfloat16, 0, False), (1536, torch.bfloat16, 8, False)])
def test_grouped_wgmma_takes_only_what_tma_addresses(d, wdtype, ptr, ok):
    """TMA stages 16-byte-aligned rows and tokens: bf16 tokens need d a
    multiple of 8, int8 rows a multiple of 16, every data pointer on a
    16-byte boundary; the rest runs the CUDA-core tiled body."""
    assert _grouped.tma_addressable(d, wdtype, 0, ptr) is ok
    assert _grouped.select_body(256, torch.bfloat16, ok) == (
        _grouped.WGMMA if ok else _grouped.TILED)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("C", [1, 8, 33, 64, 128, 200, 256, 300, 1000])
def test_grouped_wgmma_plan_fits_one_block_per_sm(C, k, quantized):
    """The tensor-core body's plan: a token tile N the kernel instantiates
    (a multiple of 8, at most 256: wgmma's N), the smallest that holds C
    unless the k-entry lists need a smaller one, enough tiles for every
    slot, a ring of 2 to 4 stages, and a block within the 232,448 bytes of
    shared memory an H100 block may use; the splits cover the vocab's
    128-row tiles exactly, each split with at least one."""
    v_pad = 12032
    p = _grouped.wgmma_plan(16, C, v_pad, k, quantized)
    assert p.n_tile in _grouped.WGMMA_TILES and p.n_tile % 8 == 0 and p.n_tile <= 256
    assert p.token_tiles == -(-C // p.n_tile)
    assert 2 <= p.stages <= 4
    assert p.smem == _grouped.wgmma_smem_bytes(p.n_tile, k, p.stages, quantized) <= 232448
    smallest = min(n for n in _grouped.WGMMA_TILES if n >= min(C, 256))
    if k <= 8:
        assert p.n_tile == smallest
        assert p.stages >= 3
    n_tiles = -(-v_pad // _grouped.WGMMA_ROWS)
    assert (p.nsplit - 1) * p.tiles_per_split < n_tiles <= p.nsplit * p.tiles_per_split


def test_grouped_wgmma_plan_fills_the_sms_at_the_batch_shape():
    """qwen2-1.5b's head at the batch path's capacity (K 16, C 256, V_pad
    12,032, k 8): one token tile of 256, and the experts' vocab splits fill
    at least 95% of the H100's 132 SMs in one wave of one block each, no
    block walking more than 12 of the 94 row tiles."""
    p = _grouped.wgmma_plan(16, 256, 12032, 8, False)
    assert (p.n_tile, p.token_tiles) == (256, 1)
    blocks = 16 * p.token_tiles * p.nsplit
    assert 0.95 * _build.SMS <= blocks <= _build.SMS
    assert p.tiles_per_split == 12
    assert _grouped.wgmma_plan(16, 256, 12032, 8, True)[:2] == (256, 1)


def test_grouped_wgmma_smem_matches_the_kernel_layout():
    """wgmma_smem_bytes is the kernel's wg::Layout: per stage a 128 x 64
    row tile (2 bytes an element, 1 for int8) and N x 64 bf16 tokens; 16
    bytes of barriers per stage; per token 8 bytes of threshold, 4 of bound,
    8 per list entry, 8 per queue slot (WGMMA_QUEUE of them), 4 of count and
    4 of g; 1 KB to align the base. The first tile's exchange (8 consumer
    warps x N tokens x a top-2 pair, then a 16-row padding mask per warp)
    fits in the queue it borrows. At N 256 and k 8 the ring keeps 3 stages
    of 48 KB (4 of 40 KB for int8 rows)."""
    assert _grouped.WGMMA_QUEUE == 16 and _grouped.WGMMA_SPILL == 128 - 16
    assert _grouped.wgmma_smem_bytes(256, 8, 3, False) == (
        3 * (16384 + 32768) + 48 + 8 * 256 + 4 * 256 + 8 * 256 * 8 + 8 * 256 * 16
        + 4 * 256 + 4 * 256 + 1024)
    assert _grouped.wgmma_smem_bytes(256, 8, 3, False) == 202800
    assert _grouped.wgmma_smem_bytes(256, 8, 3, True) == 202800 - 3 * 8192
    assert _grouped.wgmma_smem_bytes(256, 8, 4, False) > 232448
    assert _grouped.wgmma_smem_bytes(256, 8, 4, True) <= 232448
    p = _grouped.wgmma_plan(16, 256, 12032, 8, False)
    q = _grouped.wgmma_plan(16, 256, 12032, 8, True)
    assert (p.n_tile, p.stages, q.n_tile, q.stages) == (256, 3, 256, 4)
    for n in _grouped.WGMMA_TILES:
        assert 8 * n * 8 + 4 * 8 <= 8 * n * _grouped.WGMMA_QUEUE


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("k", [1, 8, 64])
def test_grouped_empty_slots_follow_the_rule_the_decode_body_writes(quantized, k):
    """The decode body writes an empty slot (g 0) from ids alone: (0, id) on
    the first k real packed positions, then (-1e9, -1). That is the plain
    version's output on the serve path's own dispatch (``_group_tokens``:
    zero rows, g 0) for finite inputs: every real row scores x·w·0 = 0,
    all tied, and padding -1e9. Expert 1 is all padding, expert 2 has 5
    real rows and its padding scattered between them."""
    from repro_torch.core.dssoftmax import _group_tokens

    K, d, v_pad, C = 4, 32, 300, 3
    w, ids = _table(K, d, v_pad, seed=k, empty=1)
    w = w.copy()
    ids[2] = -1
    ids[2, [3, 40, 41, 100, 299]] = [7, 8, 9, 10, 11]
    w[2][ids[2] < 0] = 0.0
    rng = np.random.RandomState(k)
    h = rng.randn(5, d).astype(np.float32)
    e = np.array([0, 0, 2, 1, 0], np.int32)
    g = rng.rand(5).astype(np.float32) * 0.5 + 0.5
    buf, g_buf, _, _ = _group_tokens(_t(h), _t(g), _t(e), K, C)
    wt, scales = _t(w), None
    if quantized:
        scales = torch.where(wt.abs().amax(-1) > 0, wt.abs().amax(-1) / 127, 1.0)
        wt = torch.round(wt / scales[..., None]).to(torch.int8)
    vals, out_ids = ref.dss_topk_grouped_ref(wt, _t(ids), buf, g_buf, k, scales=scales)
    empty = (g_buf == 0).nonzero().tolist()
    assert [2, 1] in empty and [3, 0] in empty
    for ex, c in empty:
        real = [int(i) for i in ids[ex] if i >= 0][:k]
        want_ids = real + [-1] * (k - len(real))
        want_v = [0.0] * len(real) + [-1e9] * (k - len(real))
        assert out_ids[ex, c].tolist() == want_ids
        assert vals[ex, c].tolist() == want_v


# ---------------------------------------------------------------------------
# The grouped kernel's CUDA-core tiled body (kernels/dss_topk_grouped.py::
# TILED): its plan, mirrored in Python, and the work items it walks.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("C", [1, 3, 8, 16, 17, 33, 64, 100, 128, 129, 256, 300, 1000])
@pytest.mark.parametrize("K,v_pad", [(16, 12032), (4, 900), (16, 152064)])
def test_grouped_tiled_plan_from_shapes(K, v_pad, C, k, quantized):
    """The tiled body's plan: the smallest token tile the kernel
    instantiates that holds C (128 above), enough tiles for every slot, at
    most 64 vocab chunks per expert (chunks of tiles_per_chunk row tiles up
    to big_tiles, then one tile each), and a block (its ring of 4 stages,
    k-entry lists up to k 64) within the 232,448 bytes of shared memory an
    H100 block may use."""
    p = _grouped.tiled_plan(K, C, v_pad, k, quantized)
    assert p.n_tile == min(t for t in _grouped.TILED_TOKENS if t >= min(C, 128))
    assert p.token_tiles == -(-C // p.n_tile)
    row_tiles = -(-v_pad // _grouped.TILED_ROWS)
    assert 1 <= p.nchunk <= _grouped.TILED_MAX_CHUNKS
    assert 0 <= p.big_tiles <= row_tiles
    assert p.nchunk == -(-p.big_tiles // p.tiles_per_chunk) + row_tiles - p.big_tiles
    assert p.smem == _grouped.tiled_smem_bytes(p.n_tile, k, p.tiles_per_chunk,
                                               quantized) <= 232448


def test_grouped_tiled_plan_fills_the_sms_at_the_batch_shape():
    """qwen2-1.5b's head at the batch path's capacity (K 16, C 256, V_pad
    12,032, k 8): two token tiles of 128; 22 chunks of up to 4 row tiles
    (85 tiles) take about 5 items per SM, then 9 one-tile chunks give the
    last 288 items (two waves over the H100's 132 SMs), so the SMs finish
    within one row tile of each other. Without the tail (tail_waves 0, the
    schedule chip_smoke.py times it against) the 94 row tiles make 24
    chunks of up to 4."""
    for quantized in (False, True):
        p = _grouped.tiled_plan(16, 256, 12032, 8, quantized)
        assert p[:5] == (128, 2, 4, 85, 31)
        assert 16 * p.token_tiles * (p.nchunk - 22) == 288 >= 2 * _build.SMS
        assert _grouped.tiled_plan(16, 256, 12032, 8, quantized, tail_waves=0)[:5] == (
            128, 2, 4, 94, 24)
    assert _grouped.tiled_plan(16, 8, 12032, 8)[:2] == (16, 1)


def test_grouped_tiled_smem_matches_the_kernel_layout():
    """tiled_smem_bytes is the kernel's simt::Layout: per ring stage (4)
    128 fp32 rows (int8 rows: two fp32 buffers and a ring of 3 raw blocks
    of 128 x 128 bytes with a barrier each), BN fp32 tokens of 32 floats
    each and an 8-byte barrier;
    then per token a k-entry list of (value, position) and g (and a narrow
    tile's 132 logits), an int per row tile of the chunk, 16 + 64 ints of
    scratch and 1 KB to align the base."""
    assert _grouped.tiled_smem_bytes(128, 8, 2, False) == (
        4 * (128 + 128) * 32 * 4 + 4 * 8 + 128 * 8 * 8 + 128 * 4 + 2 * 4 + (16 + 64) * 4
        + 1024) == 141160
    assert _grouped.tiled_smem_bytes(128, 8, 2, True) == (
        2 * 128 * 32 * 4 + 4 * 128 * 32 * 4 + 3 * 128 * 128 + 7 * 8 + 128 * 8 * 8 + 128 * 4
        + 2 * 4 + (16 + 64) * 4 + 1024) == 157568
    assert _grouped.tiled_smem_bytes(16, 8, 2, False) == (
        4 * (128 + 16) * 32 * 4 + 4 * 8 + 16 * 8 * 8 + 16 * 4 + 16 * 132 * 4 + 2 * 4
        + (16 + 64) * 4 + 1024)
    assert _grouped.tiled_smem_bytes(128, 64, 38, False) <= 232448


@pytest.mark.parametrize("d,wdtype,ptr,ok", [
    (1536, torch.float32, 0, True), (1536, torch.int8, 256, True), (36, torch.float32, 0, True),
    (144, torch.int8, 0, True), (200, torch.int8, 0, False), (37, torch.float32, 0, False),
    (1536, torch.float32, 8, False), (1536, torch.int8, 4, False)])
def test_grouped_tiled_stages_by_tma_only_where_aligned(d, wdtype, ptr, ok):
    """The tiled body stages fp32 tokens and fp32 or int8 rows by TMA only
    where every row pitch (d x 4 bytes, d x the row element) and data
    pointer lies on a 16-byte boundary; elsewhere it loads one element at a
    time."""
    assert _grouped.tma_addressable(d, wdtype, 0, ptr, xdtype=torch.float32) is ok


@pytest.mark.parametrize("v_pad", [129, 12032, 152064])
@pytest.mark.parametrize("B", [1, 8, 2048])
def test_split_plans_stay_within_the_merge(v_pad, B):
    """Every body that splits the vocab hands the one split merge
    (merge_splits_kernel in csrc/topk_common.cuh: a warp per row, 9 splits
    per lane) at most MAX_SPLITS partial lists per row: the tensor-core
    body's splits and the tiled body's chunks."""
    assert _build.MAX_SPLITS == 32 * 9
    for K, C in ((1, 3), (16, 256), (4, B)):
        assert _grouped.wgmma_plan(K, C, v_pad, 8, False).nsplit <= _build.MAX_SPLITS
        assert _grouped.tiled_plan(K, C, v_pad, 8).nchunk <= _build.MAX_SPLITS


def _tiled_items(K, C, v_pad, k):
    """The tiled body's work items in the order the kernel pulls them:
    item i is token tile i % T of expert (i // T) % K and vocab chunk
    i // (T K); chunks of tiles_per_chunk row tiles up to big_tiles, then
    one tile each. Returns [(expert, first slot, slots, row_lo, row_hi)]."""
    p = _grouped.tiled_plan(K, C, v_pad, k)
    T, R = p.token_tiles, _grouped.TILED_ROWS
    n_big = -(-p.big_tiles // p.tiles_per_chunk)
    out = []
    for i in range(p.nchunk * K * T):
        e, ch, t0 = (i // T) % K, i // (T * K), (i % T) * p.n_tile
        lo = ch * p.tiles_per_chunk if ch < n_big else p.big_tiles + ch - n_big
        hi = min(lo + p.tiles_per_chunk, p.big_tiles) if ch < n_big else lo + 1
        out.append((e, t0, min(p.n_tile, C - t0), lo * R, min(v_pad, hi * R)))
    return out


@pytest.mark.parametrize("K,C,v_pad", [(16, 256, 12032), (4, 70, 900), (3, 300, 1000),
                                       (16, 8, 12032), (2, 1, 129)])
def test_grouped_tiled_items_cover_every_slot_and_row_once(K, C, v_pad):
    """Every (expert, slot, packed row) lies in exactly one work item, and
    the token tiles of one (chunk, expert), which read the same rows, are
    consecutive items."""
    items = _tiled_items(K, C, v_pad, 8)
    seen = np.zeros((K, C, v_pad), np.int32)
    for e, t0, n, lo, hi in items:
        assert n >= 1 and lo < hi
        seen[e, t0:t0 + n, lo:hi] += 1
    assert (seen == 1).all()
    T = _grouped.tiled_plan(K, C, v_pad, 8).token_tiles
    for i in range(0, len(items), T):
        assert len({(e, lo) for e, _, _, lo, _ in items[i:i + T]}) == 1


def _merge_splits(lists, k):
    """The merge of the chunks' partial lists (merge_splits_kernel in
    csrc/topk_common.cuh): the lists in chunk order, each entry kept when it
    beats the k-th so far, ties to the earlier chunk."""
    out = [(-np.inf, -1)] * k
    for lst in lists:
        for v, i in lst:
            if v > out[-1][0]:
                j = next(j for j in range(k) if v > out[j][0])
                out = out[:j] + [(v, i)] + out[j:-1]
    return out


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("k", [1, 8, 64])
def test_grouped_tiled_empty_slots_follow_the_rule_in_every_chunk(quantized, k):
    """An item whose token tile has no live slot writes, for each slot, the
    chunk's first k real rows at (0, id), then (-1e9, -1) while the chunk
    has rows, then (-inf, -1); merged in chunk order that is the plain
    version's output for the empty slots of the serve path's dispatch
    (the decode body's rule): expert 1 all padding, expert 2 with 5 real
    rows in two of its three chunks (V_pad 300, 128-row chunks, the last
    of 44 rows)."""
    from repro_torch.core.dssoftmax import _group_tokens

    K, d, v_pad, C = 4, 32, 300, 3
    w, ids = _table(K, d, v_pad, seed=k, empty=1)
    w = w.copy()
    ids[2] = -1
    ids[2, [3, 40, 41, 100, 299]] = [7, 8, 9, 10, 11]
    w[2][ids[2] < 0] = 0.0
    rng = np.random.RandomState(k)
    h = rng.randn(5, d).astype(np.float32)
    e = np.array([0, 0, 2, 1, 0], np.int32)
    g = rng.rand(5).astype(np.float32) * 0.5 + 0.5
    buf, g_buf, _, _ = _group_tokens(_t(h), _t(g), _t(e), K, C)
    wt, scales = _t(w), None
    if quantized:
        scales = torch.where(wt.abs().amax(-1) > 0, wt.abs().amax(-1) / 127, 1.0)
        wt = torch.round(wt / scales[..., None]).to(torch.int8)
    vals, out_ids = ref.dss_topk_grouped_ref(wt, _t(ids), buf, g_buf, k, scales=scales)
    chunks = sorted({(lo, hi) for _, _, _, lo, hi in _tiled_items(K, C, v_pad, k)})
    assert chunks == [(0, 128), (128, 256), (256, 300)]
    empty = (g_buf == 0).nonzero().tolist()
    assert [2, 1] in empty and [3, 0] in empty
    for ex, c in empty:
        lists = []
        for lo, hi in chunks:
            real = [int(ids[ex, p]) for p in range(lo, hi) if ids[ex, p] >= 0][:k]
            lst = [(0.0, i) for i in real] + [(-1e9, -1)] * (min(k, hi - lo) - len(real))
            lists.append(lst + [(-np.inf, -1)] * (k - len(lst)))
        merged = _merge_splits(lists, k)
        assert [i for _, i in merged] == out_ids[ex, c].tolist()
        assert [v for v, _ in merged] == vals[ex, c].tolist()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("C", list(_grouped.WGMMA_TILES))
def test_grouped_wgmma_plan_fits_at_every_token_tile_and_k(C, k, quantized):
    """At every token tile the kernel instantiates and k up to 32, the
    tensor-core body's plan fits one block in the 232,448 bytes of shared
    memory an H100 block may use (the plan gives up stages, then tile width,
    before it would not), the first tile's exchange (8 consumer warps x N
    tokens x a top-2 pair, and 8 padding masks) fits in the queue it
    borrows, and the spill area holds a tile's rows past the queue for every
    token of every block."""
    p = _grouped.wgmma_plan(16, C, 12032, k, quantized)
    assert p.smem == _grouped.wgmma_smem_bytes(p.n_tile, k, p.stages, quantized)
    assert p.smem <= _grouped.SMEM_MAX
    assert p.n_tile <= C and 2 <= p.stages <= 4
    assert 8 * p.n_tile * 8 + 4 * 8 <= 8 * p.n_tile * _grouped.WGMMA_QUEUE
    assert _grouped.wgmma_spill_pairs(p, 16) == (
        p.nsplit * p.token_tiles * 16 * p.n_tile * (_grouped.WGMMA_ROWS - _grouped.WGMMA_QUEUE))


def _u_bound(tv, g):
    """The kernel's ``wg::u_bound`` in float32: a bound on u below which
    z = u x g (rounded) cannot reach tv, for g > 0; +inf for g 0 (nothing
    passes), -inf for g < 0 (everything goes to the exact compare)."""
    f = np.float32
    tv, g = f(tv), f(g)
    if not g > 0:
        return f(np.inf) if g == 0 else f(-np.inf)
    with np.errstate(invalid="ignore", over="ignore"):
        r = f(1) / g
        q = tv * r
        return q - np.abs(q) * f(2.0 ** -20) - f(2.0 ** -100) * r


def _wgmma_topk_mirror(u, pad, g, k, stale=0):
    """The tensor-core body's top-k rule for one token over one split (rows
    in packed-position order, a whole number of 128-row tiles): u the rows'
    values before x g (float32), pad the padding rows (z = -1e9), g > 0.
    One list of (value, position) (value desc, position asc), its threshold
    (value, position bound) the k-th entry, (-inf, no position) while the
    list has fewer. The first tile (k <= 16) starts from the k-th largest of
    the 8 warps' (16 rows each) top 2 of u, times g, admitting ties, or for
    padding (-1e9, one past the tile's k-th padding row). Each tile's filter
    reads the threshold published ``stale`` merges ago. Pass 1 passes a row
    pair (rows r, r + 8 of a warp, one thread's) when a real row's u reaches
    u_bound or a padding row beats the threshold; pass 2 takes each row of a
    passed pair whose z beats the threshold exactly; the queue takes 16, the
    spill area the rest of a tile's 128. Returns (values, positions) and
    asserts that pass 1 never drops a row pass 2 would take."""
    f = np.float32
    u = np.asarray(u, f)
    z = np.where(pad, f(-1e9), u * f(g)).astype(f)
    no_pos = 0x7FFFFFFF
    lst = []
    published = [(f(-np.inf), 0)]  # thresholds, oldest first
    for t0 in range(0, len(z), 128):
        rows = range(t0, t0 + 128)
        if t0 == 0 and k <= 16:
            uu = np.where(pad, f(-np.inf), u)
            tops = [x for w in range(8) for x in sorted(uu[16 * w:16 * w + 16])[-2:]]
            kth = next(x for x in tops if sum(y > x for y in tops) < k <= sum(y >= x for y in tops))
            th = (f(kth) * f(g), 0xFFFFFFFF)
            pads = [r for r in rows if pad[r]]
            if len(pads) >= k and not th[0] > f(-1e9):
                th = (f(-1e9), pads[k - 1] + 1)
            published = [th]
        tv, tb = published[max(0, len(published) - 1 - stale)]
        lo = _u_bound(tv, g)

        def beats(r):
            return z[r] > tv or (z[r] == tv and r < tb)

        cand = []
        for w in range(8):
            for lane_row in range(8):
                pair = (t0 + 16 * w + lane_row, t0 + 16 * w + lane_row + 8)
                passed = any(beats(r) if pad[r] else u[r] >= lo for r in pair)
                taken = [r for r in pair if beats(r)]
                assert passed or not taken, (pair, [z[r] for r in pair], tv, lo)
                if passed:
                    cand += taken
        assert len(cand) <= 128  # the queue's 16 slots and the spill area's 112
        lst = sorted(lst + [(z[r], r) for r in cand], key=lambda e: (-e[0], e[1]))[:k]
        published.append((lst[-1][0], lst[-1][1]) if len(lst) == k else (f(-np.inf), no_pos))
    return [v for v, _ in lst], [p for _, p in lst]


@pytest.mark.parametrize("stale", [0, 1, 2])
@pytest.mark.parametrize("kind", ["ties", "top_warp", "ascending", "equal", "padding"])
@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("k", [1, 3, 8, 16, 32])
def test_grouped_wgmma_threshold_rule_keeps_the_exact_topk(seed, k, kind, stale):
    """The tensor-core body's candidate rule (the first tile's seeded
    threshold, one list per token whose k-th entry bounds every later tile,
    a u-space bound that pre-filters row pairs, an exact compare, a queue
    that spills but never drops) loses no value of the top k, with the
    thresholds read up to two merges stale: on integer logits with many
    ties, with the first tile's top rows all in one warp, on ascending
    logits (every tile raises every threshold, so every row of a tile is a
    candidate), on logits all equal, and with padding rows (-1e9) after the
    real ones and in a tile of their own; the mirror's top k equals a plain
    stable sort's (value desc, position asc)."""
    rng = np.random.RandomState(seed)
    n = 4 * 128
    g = np.float32(rng.uniform(0.05, 1.0))
    pad = np.zeros(n, bool)
    if kind == "ties":
        u = rng.randint(-6, 7, n)
    elif kind == "top_warp":
        u = rng.randint(-6, 7, n) + np.where(np.arange(n) // 16 == 1 + 5 * seed, 20, 0)
    elif kind == "ascending":
        u = np.arange(n) - 100
    elif kind == "equal":
        u = np.full(n, 3)
    else:
        u = rng.randint(-6, 7, n)
        pad[rng.randint(2, 200) if seed else 0:] = True  # the first tile of padding alone
        pad[300:310] = False
    u = u.astype(np.float32) * np.float32(0.37)
    z = np.where(pad, np.float32(-1e9), u * g).astype(np.float32)
    want = sorted(range(n), key=lambda i: (-z[i], i))[:k]
    vals, pos = _wgmma_topk_mirror(u, pad, g, k, stale)
    assert pos == want and vals == [z[i] for i in want]


@pytest.mark.parametrize("seed", range(4))
def test_grouped_wgmma_u_bound_never_drops_a_candidate(seed):
    """``u_bound(tv, g)`` (float32, as the kernel computes it) is below
    every u whose rounded z = u x g reaches tv, near the boundary and at
    zero (underflow), for thresholds of either sign and gates from 2^-20
    to 64: the pre-filter is a superset of the exact compare."""
    rng = np.random.RandomState(seed)
    f = np.float32
    for _ in range(400):
        g = f(2.0 ** rng.uniform(-20, 6))
        tv = f(rng.choice([0.0, rng.randn() * 10.0 ** rng.randint(-30, 9)]))
        lo = _u_bound(tv, g)
        q = tv / g
        for u in [f(q), np.nextafter(f(q), f(-np.inf)), np.nextafter(f(q), f(np.inf)), lo,
                  np.nextafter(lo, f(-np.inf)), f(0.0), f(-1e-38), f(-1e-45)]:
            if f(u * g) >= tv:
                assert u >= lo, (u, g, tv, lo)
    assert _u_bound(1.0, 0.0) == np.inf and _u_bound(1.0, -0.5) == -np.inf
