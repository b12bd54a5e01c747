"""Port parity: the ``flash_attention`` wrapper (its plain version,
``ref.flash_attention_ref``, which is what it runs on CPU tensors) against
``repro``'s Pallas kernel in interpret mode and ``repro``'s oracle
``ref.flash_attention_ref``, on the same numpy-seeded inputs.

Shapes: ``repro``'s own (``tests/test_kernels.py:49``), a grouped-query
case (H 6, H_kv 2: the JAX side gets ``jnp.repeat(k, 3, axis=1)``), an odd
S, and bf16.

Tolerances. fp32: against the Pallas kernel ``repro``'s 1e-4 / 1e-5
(``tests/test_kernels.py:56``); against the oracle, which computes the
same einsums, 1e-5 / 1e-6. bf16: against the oracle one bf16 rounding of
the output (rtol 2^-7, an fp32 difference in the last bit can round to the
neighbouring bf16 value); against the Pallas kernel, which rounds p to
bf16 before p·v and the plain version does not, the per-element limit
``repro_torch.testing.flash_attention_limit``: 2^-8·(softmax(s)·|v|) for
the rounding of p, plus 2^-7·|o| for the two outputs' own rounding.
"""
import heapq
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import to_tensor
from repro_torch.kernels import _build, ops
from repro_torch.models import layers
from repro_torch.testing import flash_attention_limit

BF16_ULP = 2.0 ** -7


def _inputs(B, H, H_kv, S, dh, seed, dtype=jnp.float32):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, h, S, dh).astype(np.float32) for h in (H, H_kv, H_kv))
    return tuple(jnp.asarray(a).astype(dtype) for a in (q, k, v))


def _t(a):
    return to_tensor(np.asarray(a), "cpu")


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not torch.is_tensor(a) \
        else a.float().numpy()


@pytest.mark.parametrize("B,H,H_kv,S,dh,dtype", [
    (2, 2, 2, 64, 16, jnp.float32),      # tests/test_kernels.py:49
    (2, 2, 2, 128, 32, jnp.float32),
    (2, 2, 2, 256, 64, jnp.float32),
    (1, 6, 2, 96, 32, jnp.float32),      # grouped-query attention
    (2, 2, 1, 37, 16, jnp.float32),      # odd S
    (1, 6, 2, 128, 64, jnp.bfloat16),
    (1, 2, 2, 45, 32, jnp.bfloat16),
])
def test_flash_attention_matches_pallas_and_oracle(B, H, H_kv, S, dh, dtype):
    q, k, v = _inputs(B, H, H_kv, S, dh, seed=S + dh + H, dtype=dtype)
    G = H // H_kv
    kr, vr = jnp.repeat(k, G, axis=1), jnp.repeat(v, G, axis=1)
    n = ops.flash_attention.launches
    got = ops.flash_attention(_t(q), _t(k), _t(v), device="cpu")
    assert ops.flash_attention.launches == n  # the plain version: no launch
    assert got.shape == (B, H, S, dh) and got.dtype == _t(q).dtype
    pallas = pallas_flash(q, kr, vr, interpret=True)
    oracle = jref.flash_attention_ref(q, kr, vr)
    if dtype == jnp.float32:
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5, atol=1e-6)
    else:
        limit = flash_attention_limit(_t(q), _t(k), _t(v), got)
        err = np.abs(_f32(got) - _f32(pallas))
        assert (err <= limit.numpy()).all(), float((err / limit.numpy()).max())
        np.testing.assert_allclose(_f32(got), _f32(oracle), rtol=BF16_ULP, atol=1e-6)


def test_plain_version_equals_the_cpu_attention_path():
    """The kernel's plain version and the port's CPU prefill attention
    (``chunked_causal_attention``: three query chunks merged online) are one
    function on the same (B, S, H, dh) tensors."""
    cfg = reduce_config(get_config("qwen2-1.5b"))
    S = 3 * cfg.attn_q_chunk
    q, k, v = (torch.from_numpy(np.array(a)).permute(0, 2, 1, 3)
               for a in _inputs(1, 4, 2, S, 32, seed=3))
    flash = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                device="cpu").transpose(1, 2)
    chunked = layers.chunked_causal_attention(cfg, q, k, v)
    torch.testing.assert_close(flash, chunked, rtol=1e-5, atol=1e-6)


def test_attention_block_on_cpu_tensors_keeps_the_plain_code(monkeypatch):
    """CPU tensors never reach the kernel wrapper: the plain attention runs,
    as in ``repro``'s CPU lowering."""
    cfg = reduce_config(get_config("qwen2-1.5b")).replace(dtype="float32")
    from repro_torch.models import build

    params, _ = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    attn = {name: w[0] for name, w in params["layers"]["attn"].items()}

    def refuse(*a, **kw):
        raise AssertionError("flash_attention called on CPU tensors")

    monkeypatch.setattr(layers, "flash_attention", refuse)
    for S in (5, 2 * cfg.attn_q_chunk):
        x = torch.randn((1, S, cfg.d_model), generator=torch.Generator().manual_seed(S))
        out, (kk, vv) = layers.attention_block(attn, cfg, x, torch.arange(S)[None])
        assert out.shape == x.shape and kk.shape == (1, S, cfg.n_kv_heads, cfg.hd)


def test_wrapper_rejects_mismatched_shapes_and_dtypes():
    q = torch.zeros((1, 4, 8, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros((1, 3, 8, 16)), torch.zeros((1, 3, 8, 16)),
                            device="cpu")  # H % H_kv != 0
    with pytest.raises(ValueError):
        ops.flash_attention(q, q[:, :, :4], q[:, :, :4], device="cpu")
    with pytest.raises(TypeError):
        ops.flash_attention(q, q.bfloat16(), q.bfloat16(), device="cpu")


def _bhsd(S, H, dh, dtype=torch.bfloat16, pad=0, offset=0):
    """(B 1, H, S, dh) as attention_block passes it: the transpose view of
    a (1, S, H, dh + pad) buffer (``pad`` widens each row, ``offset``
    shifts the data pointer by that many elements)."""
    flat = torch.zeros(offset + S * H * (dh + pad), dtype=dtype)
    return flat[offset:].view(1, S, H, dh + pad)[..., :dh].transpose(1, 2)


WGMMA, SIMT = "flash_attention_wgmma", "flash_attention"


@pytest.mark.parametrize("case,want", [
    ("bf16 (B, S, H, dh) views, dh 128", WGMMA),
    ("bf16 dense (B, H, S, dh), dh 64", WGMMA),
    ("bf16 dh 16", WGMMA),
    ("a length-1 axis with a stride TMA refuses", WGMMA),
    ("fp32", SIMT),
    ("bf16 dh 8", SIMT),
    ("bf16 dh 24", SIMT),
    ("bf16 dh 192", SIMT),
    ("unaligned base", SIMT),
    ("unaligned stride", SIMT),
    ("unaligned k only", SIMT),
])
def test_body_selection_rule(case, want):
    """``select_body`` is the written rule that picks flash_attention's
    body on the card from dtypes, shapes, strides and data-pointer
    alignment alone: bf16 with dh a multiple of 16 up to 128 and
    16-byte-aligned pointers and strides runs the tensor-core body,
    everything else the CUDA-core body."""
    from repro_torch.kernels.flash_attention import SIMT as simt
    from repro_torch.kernels.flash_attention import WGMMA as wgmma
    from repro_torch.kernels.flash_attention import select_body

    assert (wgmma, simt) == (WGMMA, SIMT)
    H, H_kv, S, dh = 12, 2, 64, 128
    kw = {}
    if case == "bf16 dense (B, H, S, dh), dh 64":
        q, k, v = (torch.zeros((1, h, S, 64), dtype=torch.bfloat16) for h in (H, H_kv, H_kv))
    elif case == "a length-1 axis with a stride TMA refuses":
        q, k, v = (torch.zeros((1, h, S, dh), dtype=torch.bfloat16)
                   .as_strided((1, h, S, dh), (3, S * dh, dh, 1)) for h in (H, H_kv, H_kv))
    else:
        dh = {"bf16 dh 16": 16, "bf16 dh 8": 8, "bf16 dh 24": 24, "bf16 dh 192": 192}.get(case, dh)
        kw = {"fp32": {"dtype": torch.float32}, "unaligned base": {"offset": 1},
              "unaligned stride": {"pad": 4}}.get(case, {})
        q, k, v = (_bhsd(S, h, dh, **kw) for h in (H, H_kv, H_kv))
        if case == "unaligned k only":
            k = _bhsd(S, H_kv, dh, offset=4)
    if "unaligned" in case:
        assert any(t.data_ptr() % 16 or any(s * 2 % 16 for s in t.stride()[:3])
                   for t in (q, k, v))
    assert select_body(q, k, v) == want
    n = ops.launch_counts()
    ops.flash_attention(q, k, v, device="cpu")  # CPU tensors: the plain version, no launch
    assert ops.launch_counts() == n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,dh_class", [(1, 64), (16, 64), (64, 64), (65, 128), (80, 128),
                                         (96, 128), (128, 128), (129, 256), (192, 256),
                                         (256, 256)])
def test_cuda_core_body_tile_by_head_dim(dtype, dh, dh_class):
    """The CUDA-core body is compiled for three head-dim classes (dh rounded
    up to 64, 128 or 256): 128 threads for the first two, 256 for the last,
    and as many blocks per SM as its launch bound names fit in the H100's
    shared memory (227 KB a block, 228 KB an SM with 1 KB reserved per
    block) and registers (65,536 an SM); fp32 qwen2-1.5b attention (dh 128)
    two blocks of 112 KB: Q and two K/V tile slots of 64 rows, and P."""
    from repro_torch.kernels.flash_attention import SIMT_ROWS, simt_tile

    t = simt_tile(dh, dtype)
    elem = 4 if dtype == torch.float32 else 2
    assert t.dh_class == dh_class and dh <= t.dh_class
    assert t.threads == (128 if dh_class <= 128 else 256)
    assert t.smem_bytes <= 232448
    assert t.blocks_per_sm * (t.smem_bytes + 1024) <= 233472
    assert t.blocks_per_sm * t.threads <= 256  # up to 255 registers a thread
    assert t.smem_bytes == 3 * SIMT_ROWS * dh_class * elem + SIMT_ROWS * SIMT_ROWS * 4
    if dtype == torch.float32 and dh == 128:
        assert (t.blocks_per_sm, t.smem_bytes) == (2, 112 * 1024)
    with pytest.raises(ValueError):
        simt_tile(257, dtype)


# ---------------------------------------------------------------------------
# The tensor-core body's host-side plans (kernels/flash_attention.py mirrors
# csrc/flash_attention.cu, namespace tc): the persistent schedule and the
# shared memory of one block
# ---------------------------------------------------------------------------

_FA = importlib.import_module("repro_torch.kernels.flash_attention")


def _attn_shape(arch):
    """(H, H_kv, dh) of an architecture's attention; lm-100m is the training
    preset of examples/train_lm_dssoftmax.py (12 heads, 4 kv heads, d 768)."""
    if arch == "lm-100m":
        return 12, 4, 64
    cfg = get_config(arch)
    return cfg.n_heads, cfg.n_kv_heads, cfg.d_model // cfg.n_heads


def _lpt_makespan(weights, blocks):
    """Greedy longest-first: each item, heaviest first, to the least loaded
    block."""
    heap = [0] * blocks
    for w in sorted(weights, reverse=True):
        heapq.heappush(heap, heapq.heappop(heap) + w)
    return max(heap)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama3.2-3b", "granite-20b", "lm-100m"])
@pytest.mark.parametrize("S", [1, 127, 128, 129, 1000, 2048, 4096])
@pytest.mark.parametrize("B", [1, 3])
def test_wgmma_schedule_visits_every_item_once_heaviest_first(arch, S, B):
    """The persistent grid (``tc::item_at``) takes min(SMs, items) blocks;
    every (query tile, head, batch row) item is walked by exactly one block,
    each block walks its items heaviest first (query tile qt walks qt + 1 kv
    tiles), and the makespan in kv-tile steps is within one step of the
    greedy longest-first schedule's."""
    H, _, _ = _attn_shape(arch)
    n_q = -(-S // _FA.WGMMA_ROWS)
    blocks = _FA.wgmma_schedule(B, H, S)
    assert len(blocks) == min(_build.SMS, n_q * H * B)
    items = [it for blk in blocks for it in blk]
    assert sorted(items) == [(qt, h, b) for qt in range(n_q) for h in range(H) for b in range(B)]
    for blk in blocks:
        tiles = [qt for qt, _, _ in blk]
        assert tiles == sorted(tiles, reverse=True)
    makespan = max(sum(qt + 1 for qt, _, _ in blk) for blk in blocks)
    assert makespan <= _lpt_makespan([qt + 1 for qt, _, _ in items], len(blocks)) + 1


def test_wgmma_schedule_at_the_main_case_is_the_heaviest_item():
    """qwen2-1.5b's 2048-token prefill: 192 items on 132 SMs, and no block
    walks more kv tiles than the heaviest item's 16."""
    blocks = _FA.wgmma_schedule(1, 12, 2048)
    assert sum(len(blk) for blk in blocks) == 192 and len(blocks) == 132
    assert max(sum(qt + 1 for qt, _, _ in blk) for blk in blocks) == 16


@pytest.mark.parametrize("dh", [16, 64, 80, 128])
def test_wgmma_shared_memory_fits_one_block_per_sm(dh):
    """Q, the K and V rings and the O staging tile (each slot a 128-row
    tile of dh rounded up to 64-column regions), 4 mbarriers per ring stage
    and 2 for Q, 1 KB of alignment: within the 232,448 bytes an H100 block
    may use, 2 stages at dh 128 and 4 at dh 64."""
    nc, st = -(-dh // 64), _FA.wgmma_stages(dh)
    assert st == (4 if dh <= 64 else 2)
    assert _FA.wgmma_smem_bytes(dh) == (2 + 2 * st) * nc * 128 * 128 + 8 * (4 * st + 2) + 1024
    assert _FA.wgmma_smem_bytes(dh) <= _build.SMEM_MAX
    if dh > 64:  # one more stage would not fit
        assert (2 + 2 * (st + 1)) * nc * 128 * 128 > _build.SMEM_MAX


def test_wgmma_shared_memory_of_the_two_head_dim_classes():
    assert _FA.wgmma_smem_bytes(128) == 197712
    assert _FA.wgmma_smem_bytes(64) == 165008
