"""Expert-grouped DS-Softmax retrieval (weight-stationary).

Wrapper over ``csrc/dss_topk_grouped.cu`` (replaces both bodies of the
Pallas kernel ``repro/kernels/dss_topk_grouped.py``: ``_kernel`` for
f32/bf16 rows and ``_kernel_q`` for int8 rows with per-row scales).
Tokens arrive already grouped by their top-1 expert into ``(K, C, d)``
capacity buffers; only the ``(K, C, k)`` values/ids are written. For CPU
tensors it runs the plain version, ``ref.dss_topk_grouped_ref``.

On CUDA tensors one of three kernel bodies runs, chosen by the capacity C
and the token dtype (:func:`select_body`):

- ``DECODE`` (C up to ``TILED_ABOVE``, or ``SIMT_TILED_ABOVE`` for fp32
  tokens): the streaming retrieval shared with the fused kernel
  (``csrc/retrieve_stream.cuh``). It reads only the experts with a live
  slot (``g_buf != 0``), each once per group of
  ``retrieve_stream.token_group(d)`` live slots, over a grid fixed by the
  shapes (:func:`launch_plan`) whose work list the kernel builds on the
  device; an empty slot's output comes from ``ids`` alone.
- ``WGMMA`` (bf16 tokens above ``TILED_ABOVE``, where TMA can address the
  rows and tokens): tensor cores, vocab rows as wgmma's M operand and a
  token tile of up to 256 slots as its N operand, both staged by TMA; the
  top-k runs on the accumulator registers (:func:`wgmma_plan`). Each
  expert's rows are read once per token tile.
- ``TILED`` (fp32 tokens above ``SIMT_TILED_ABOVE``, and bf16 that TMA
  cannot address): 16- or 64-slot token tiles on CUDA cores, each expert's
  rows streamed once per tile through shared memory (:func:`tiled_plan`).

No body makes a host sync or allocates in its kernels: a CUDA graph can
capture the call. Each body counts its launches on this function
(``COUNTERS``): ``launches`` (decode, f32/bf16 rows), ``launches_q``
(decode, int8 rows), ``launches_wgmma``, ``launches_wgmma_q``,
``launches_tiled`` and ``launches_tiled_q``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import _build, ref
from repro_torch.kernels.retrieve_stream import StreamPlan, row_vec_bytes, stream_plan

DECODE, WGMMA, TILED = "dss_topk_grouped", "dss_topk_grouped_wgmma", "dss_topk_grouped_tiled"
# the counter attribute of each body (int8 rows: the same with "_q")
COUNTERS = {DECODE: "launches", WGMMA: "launches_wgmma", TILED: "launches_tiled"}
# bf16 tokens: capacities above this run the tensor-core body. Set from
# chip_smoke.py's capacity sweep on an H100 (PERF.md section 6).
TILED_ABOVE = 2
# fp32 tokens (and bf16 that TMA cannot address): capacities above this run
# the CUDA-core tiled body; from an earlier capacity sweep of that body
# against the decode body on an H100 (the decode body was the faster at C
# 32 and below).
SIMT_TILED_ABOVE = 32

# The tensor-core body's constants (csrc/dss_topk_grouped.cu, namespace wg)
WGMMA_ROWS = 128          # vocab rows per tile (kRows)
WGMMA_SLICE = 64          # d elements per ring stage (kSlice)
WGMMA_TILES = (16, 32, 64, 128, 256)  # token tiles N the kernel instantiates
WGMMA_CAND = 8            # candidate slots per token and warpgroup (kCand)
WGMMA_STAGES = (4, 3, 2)  # ring depths, deepest first
SMEM_MAX = 232448         # shared memory a block may use (kSmemMax)


def tma_addressable(d: int, wdtype: torch.dtype, *ptrs: int) -> bool:
    """Whether TMA can stage bf16 tokens of width d and rows of ``wdtype``
    (bf16, or int8): row pitches and data pointers on 16-byte boundaries."""
    elem = torch.empty((), dtype=wdtype).element_size()
    return d % 8 == 0 and (d * elem) % 16 == 0 and all(p % 16 == 0 for p in ptrs)


def select_body(capacity: int, dtype: torch.dtype, tma_ok: bool = True) -> str:
    """The kernel body that serves ``capacity`` slots per expert for tokens
    of ``dtype``: bf16 tokens run ``DECODE`` up to ``TILED_ABOVE`` and
    ``WGMMA`` above (``TILED`` where TMA cannot address the data,
    ``tma_ok`` False); fp32 tokens run ``DECODE`` up to
    ``SIMT_TILED_ABOVE`` and ``TILED`` above (tensor cores would need TF32,
    which changes the function)."""
    if dtype == torch.bfloat16 and tma_ok:
        return DECODE if capacity <= TILED_ABOVE else WGMMA
    return DECODE if capacity <= SIMT_TILED_ABOVE else TILED


def launch_plan(K: int, v_pad: int, d: int, wdtype: torch.dtype) -> StreamPlan:
    """The decode body's launch from the shapes alone, whatever the
    capacity: any of the K experts may hold a live slot
    (``retrieve_stream.stream_plan``)."""
    return stream_plan(K, v_pad, d, wdtype)


def _token_tile(capacity: int) -> int:
    """Tokens per block of the tiled body: 16 up to 16 slots, 64 above."""
    return 16 if capacity <= 16 else 64


def tiled_plan(K: int, C: int, v_pad: int):
    """The tiled body's launch: (token tile, vocab splits, 64-row tiles per
    split), the splits enough that about two blocks per SM have work."""
    tb = _token_tile(C)
    return (tb, *_build.vocab_split(v_pad, K * -(-C // tb)))


class WgmmaPlan(NamedTuple):
    """The tensor-core body's launch: token tiles of ``n_tile`` slots
    (``token_tiles`` of them), a ring of ``stages``, each expert's vocab in
    ``nsplit`` splits of ``tiles_per_split`` 128-row tiles; ``smem`` bytes
    of shared memory per block."""

    n_tile: int
    token_tiles: int
    stages: int
    nsplit: int
    tiles_per_split: int
    smem: int


def wgmma_smem_bytes(n_tile: int, k: int, stages: int, quantized: bool) -> int:
    """Shared memory of one block (the kernel's ``wg::Layout``): the ring
    (a 128-row tile of 64 d, then n_tile tokens of 64 d, per stage), its
    barriers and the seed barrier, g per token, and per warpgroup and token
    the k-th value, a slot count, WGMMA_CAND candidates and the k-entry
    list; 1 KB to align."""
    row = WGMMA_ROWS * WGMMA_SLICE * (1 if quantized else 2)
    return (stages * (row + n_tile * WGMMA_SLICE * 2) + 16 * stages + 16 + 4 * n_tile
            + 16 * n_tile + 16 * n_tile * WGMMA_CAND + 16 * n_tile * k + 1024)


def wgmma_split(v_pad: int, blocks_per_split: int):
    """(nsplit, tiles_per_split): the vocab's 128-row tiles over splits,
    ``blocks_per_split`` blocks per split and one block per SM at a time.
    The makespan is the waves of blocks times the tiles a block walks; the
    fewest splits within 10% of the shortest makespan win (each split adds
    a partial list per token for the merge to read)."""
    n_tiles = -(-v_pad // WGMMA_ROWS)
    options = []
    for ns in range(1, n_tiles + 1):
        tps = -(-n_tiles // ns)
        ns = -(-n_tiles // tps)
        options.append((-(-blocks_per_split * ns // _build.SMS) * tps, ns, tps))
    best = min(span for span, _, _ in options)
    return min((ns, tps) for span, ns, tps in options if span <= 1.1 * best)


def wgmma_plan(K: int, C: int, v_pad: int, k: int, quantized: bool) -> WgmmaPlan:
    """The tensor-core body's launch from the shapes: the smallest token
    tile that holds C (at most 256), the deepest ring that fits the shared
    memory, a smaller tile where even two stages do not (large k), and
    vocab splits from :func:`wgmma_split`."""
    fits = [n for n in WGMMA_TILES if n >= C]
    top = WGMMA_TILES.index(fits[0] if fits else WGMMA_TILES[-1])
    for n in reversed(WGMMA_TILES[:top + 1]):
        for stages in WGMMA_STAGES:
            smem = wgmma_smem_bytes(n, k, stages, quantized)
            if smem <= SMEM_MAX:
                tiles = -(-C // n)
                return WgmmaPlan(n, tiles, stages, *wgmma_split(v_pad, K * tiles), smem)
    raise ValueError(f"no token tile fits k={k} in {SMEM_MAX} bytes of shared memory")


def dss_topk_grouped(weights, ids, buf, g_buf, k: int = 8, *, scales=None, device="cuda"):
    """weights (K, V_pad, d) of buf's dtype (float32 or bfloat16), or int8
    with ``scales`` (K, V_pad) fp32; buf (K, C, d); ids (K, V_pad) int32
    with -1 as padding; g_buf (K, C) fp32, 0 on an empty slot → (vals
    (K, C, k) fp32, ids (K, C, k) int32)."""
    dev = resolve_device(device)
    check_on(dev, weights=weights, ids=ids, buf=buf, g_buf=g_buf)
    ref.check_scales(weights, scales)
    quantized = scales is not None
    if quantized:
        check_on(dev, scales=scales)
    if dev.type == "cpu":
        return ref.dss_topk_grouped_ref(weights, ids, buf, g_buf, k, scales=scales)
    K, v_pad, d = weights.shape
    C = buf.shape[1]
    if buf.shape != (K, C, d) or ids.shape != (K, v_pad) or g_buf.shape != (K, C) \
            or (quantized and scales.shape != (K, v_pad)):
        raise ValueError(
            f"shapes disagree: weights {tuple(weights.shape)}, ids "
            f"{tuple(ids.shape)}, buf {tuple(buf.shape)}, g_buf {tuple(g_buf.shape)}"
            + (f", scales {tuple(scales.shape)}" if quantized else ""))
    if (not quantized and buf.dtype != weights.dtype) or ids.dtype != torch.int32 \
            or g_buf.dtype != torch.float32 or (quantized and scales.dtype != torch.float32):
        raise TypeError("buf must share weights' dtype (or weights be int8 with "
                        "float32 scales), ids must be int32 and g_buf float32")
    if not 1 <= k <= min(_build.MAX_K, v_pad):
        raise ValueError(f"k={k} must be in [1, min(64, v_pad={v_pad})]")
    weights, ids, buf, g_buf = (t.contiguous() for t in (weights, ids, buf, g_buf))
    if quantized:
        scales = scales.contiguous()
    tma_ok = tma_addressable(d, weights.dtype, weights.data_ptr(), buf.data_ptr())
    return launch_body(weights, ids, buf, g_buf, k, scales, select_body(C, buf.dtype, tma_ok))


def launch_body(weights, ids, buf, g_buf, k: int, scales, body: str):
    """Launch ``body`` (``DECODE``, ``WGMMA`` or ``TILED``) on contiguous
    CUDA tensors that :func:`dss_topk_grouped` has checked, and count the
    launch. The wrapper passes ``select_body``'s choice; ``chip_smoke.py``'s
    capacity sweep runs the decode and the tensor-core body at every
    capacity. ``WGMMA`` takes bf16 tokens only (the kernel raises on data
    TMA cannot address)."""
    K, v_pad, d = weights.shape
    C = buf.shape[1]
    out_v = torch.empty((K, C, k), dtype=torch.float32, device=buf.device)
    out_i = torch.empty((K, C, k), dtype=torch.int32, device=buf.device)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    lib = _build.load("dss_topk_grouped")
    if body == DECODE:
        plan = launch_plan(K, v_pad, d, weights.dtype)
        part_v = torch.empty((plan.max_chunks, K, C, k), dtype=torch.float32, device=buf.device)
        part_p = torch.empty((plan.max_chunks, K, C, k), dtype=torch.int32, device=buf.device)
        n_sel = torch.empty((1,), dtype=torch.int32, device=buf.device)
        err = lib.dss_topk_grouped(
            buf.data_ptr(), g_buf.data_ptr(), weights.data_ptr(), ids.data_ptr(),
            _build.ptr(scales), out_v.data_ptr(), out_i.data_ptr(), part_v.data_ptr(),
            part_p.data_ptr(), n_sel.data_ptr(), K, C, v_pad, d, k, plan.grid,
            row_vec_bytes(d, weights.element_size(), weights.data_ptr()),
            _build.dtype_code(buf), _build.weight_code(weights), stream)
    elif body == TILED:
        tb, nsplit, tps = tiled_plan(K, C, v_pad)
        part_v = part_i = None
        if nsplit > 1:
            part_v = torch.empty((nsplit, K, C, k), dtype=torch.float32, device=buf.device)
            part_i = torch.empty((nsplit, K, C, k), dtype=torch.int32, device=buf.device)
        err = lib.dss_topk_grouped_tiled(
            buf.data_ptr(), g_buf.data_ptr(), weights.data_ptr(), ids.data_ptr(),
            _build.ptr(scales), out_v.data_ptr(), out_i.data_ptr(),
            _build.ptr(part_v), _build.ptr(part_i),
            K, C, v_pad, d, k, tb, nsplit, tps, _build.dtype_code(buf),
            _build.weight_code(weights), stream)
    elif body == WGMMA:
        if buf.dtype != torch.bfloat16:
            raise TypeError(f"{WGMMA} takes bfloat16 tokens, got {buf.dtype}")
        plan = wgmma_plan(K, C, v_pad, k, scales is not None)
        part_v = part_i = None
        if plan.nsplit > 1:
            part_v = torch.empty((plan.nsplit, K, C, k), dtype=torch.float32, device=buf.device)
            part_i = torch.empty((plan.nsplit, K, C, k), dtype=torch.int32, device=buf.device)
        err = lib.dss_topk_grouped_wgmma(
            buf.data_ptr(), g_buf.data_ptr(), weights.data_ptr(), ids.data_ptr(),
            _build.ptr(scales), out_v.data_ptr(), out_i.data_ptr(),
            _build.ptr(part_v), _build.ptr(part_i), K, C, v_pad, d, k, plan.n_tile,
            plan.nsplit, plan.tiles_per_split, plan.stages, _build.weight_code(weights), stream)
    else:
        raise ValueError(f"unknown body {body!r}: expected one of {tuple(COUNTERS)}")
    _build.check(lib, err, body)
    attr = COUNTERS[body] + ("_q" if scales is not None else "")
    setattr(dss_topk_grouped, attr, getattr(dss_topk_grouped, attr) + 1)
    return out_v, out_i


for _attr in COUNTERS.values():
    setattr(dss_topk_grouped, _attr, 0)
    setattr(dss_topk_grouped, _attr + "_q", 0)
