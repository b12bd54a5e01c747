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
  token tile of up to 256 slots as its N operand, both staged by TMA; per
  row tile the accumulators are filtered against each token's threshold
  (a bound on the value before x g, then an exact compare), the few
  candidates queued (a spill area in device memory takes a queue's
  overflow, :func:`wgmma_spill_pairs`) and merged into one list per token
  (:func:`wgmma_plan`). Each expert's rows are read once per token tile.
- ``TILED`` (fp32 tokens above ``SIMT_TILED_ABOVE``, and bf16 that TMA
  cannot address): CUDA cores, a register-tiled fp32 product of 128 vocab
  rows by a token tile of 16 to 128 slots, staged by TMA through a ring of
  4 stages, with the top-k on the accumulators, over work items (vocab
  chunk, expert, token tile) that persistent blocks pull from a counter; a
  tile without a live slot, and a row tile of padding alone, do no product
  (:func:`tiled_plan`). Each expert's rows are read once per token tile.

No body makes a host sync or allocates in its kernels: a CUDA graph can
capture the call. Each body counts its launches on this function
(``COUNTERS``): ``launches`` (decode, f32/bf16 rows), ``launches_q``
(decode, int8 rows), ``launches_wgmma``, ``launches_wgmma_q``,
``launches_tiled`` and ``launches_tiled_q``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.device import check_forward_only, check_on, resolve_device
from repro_torch.kernels import _build, ref
from repro_torch.kernels.retrieve_stream import StreamPlan, row_vec_bytes, stream_plan

DECODE, WGMMA, TILED = "dss_topk_grouped", "dss_topk_grouped_wgmma", "dss_topk_grouped_tiled"
# the counter attribute of each body (int8 rows: the same with "_q")
COUNTERS = {DECODE: "launches", WGMMA: "launches_wgmma", TILED: "launches_tiled"}
# bf16 tokens: capacities above this run the tensor-core body. Set from
# chip_smoke.py's capacity sweep on an H100 (PERF.md section 6).
TILED_ABOVE = 2
# fp32 tokens (and bf16 that TMA cannot address): capacities above this run
# the CUDA-core tiled body. Set from chip_smoke.py's fp32 capacity sweep on
# an H100 (PERF.md section 6).
SIMT_TILED_ABOVE = 4

# The tensor-core body's constants (csrc/dss_topk_grouped.cu, namespace wg)
WGMMA_ROWS = 128          # vocab rows per tile (kRows)
WGMMA_SLICE = 64          # d elements per ring stage (kSlice)
WGMMA_TILES = (16, 32, 64, 128, 256)  # token tiles N the kernel instantiates
WGMMA_QUEUE = 16          # queue slots per token in shared memory (kQueue)
WGMMA_CONSUMER_REGS = 232  # registers a consumer thread holds after setmaxnreg (kConsumerRegs)
WGMMA_PRODUCER_REGS = 40   # and a producer thread (kProducerRegs)
WGMMA_SPILL = WGMMA_ROWS - WGMMA_QUEUE  # a token's further candidates in a tile (kSpill)
WGMMA_STAGES = (4, 3, 2)  # ring depths, deepest first
SMEM_MAX = _build.SMEM_MAX

# The CUDA-core tiled body's constants (csrc/dss_topk_grouped.cu, namespace simt)
TILED_ROWS = 128          # vocab rows per tile (kRows)
TILED_SLICE = 32          # d elements per ring stage (kSlice): 128-byte fp32 rows
TILED_TOKENS = (16, 32, 64, 128)  # token tiles BN the kernel instantiates
TILED_STAGES = 4          # ring stages (kStages)
TILED_RAW_SLOTS = 3       # int8 rows: raw blocks of 4 slices in the ring (kRawSlots)
TILED_MAX_CHUNKS = 64     # vocab chunks per expert (kMaxChunks)
TILED_MISC = 16           # ints of scratch (kMisc), then MAX_K real rows
TILED_NARROW = 32         # token tiles up to this take the narrow product (kNarrow)
TILED_Z_PITCH = 132       # fp32 per token of a narrow tile's logits (kZPitch)
# work items per SM the chunks aim at: enough that the last ones to finish
# leave little of the card idle
TILED_ITEMS_PER_SM = 6
TILED_TAIL_WAVES = 2      # waves of one-tile items that end the schedule


def tma_addressable(d: int, wdtype: torch.dtype, *ptrs: int,
                    xdtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether TMA can stage tokens of ``xdtype`` (bf16 for the tensor-core
    body, fp32 for the tiled body) and width d and rows of ``wdtype``: row
    pitches and data pointers on 16-byte boundaries."""
    pitch_ok = all(d * torch.empty((), dtype=t).element_size() % 16 == 0 for t in (xdtype, wdtype))
    return pitch_ok and all(p % 16 == 0 for p in ptrs)


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


class TiledPlan(NamedTuple):
    """The CUDA-core tiled body's launch: token tiles of ``n_tile`` slots
    (``token_tiles`` of them), each expert's vocab in ``nchunk`` chunks:
    its first ``big_tiles`` 128-row tiles in chunks of ``tiles_per_chunk``,
    then one tile a chunk; ``smem`` bytes of shared memory per block. The
    kernel runs one persistent block per SM, or as many as fit, over the
    ``nchunk * K * token_tiles`` work items, chunk by chunk."""

    n_tile: int
    token_tiles: int
    tiles_per_chunk: int
    big_tiles: int
    nchunk: int
    smem: int


def tiled_smem_bytes(n_tile: int, k: int, tiles_per_chunk: int, quantized: bool) -> int:
    """Shared memory of one block (the kernel's ``simt::Layout``): the ring
    of TILED_STAGES stages of 128 fp32 rows (int8 rows: TILED_RAW_SLOTS raw
    blocks of 128 x 128 bytes, with their barriers, and two fp32 buffers)
    and n_tile fp32 tokens, 32 d each,
    with a barrier per stage; per token the k-entry list (8 bytes an entry)
    and g, and for token tiles up to TILED_NARROW the tile's logits (132
    floats a token); a flag per row tile of the chunk; the scratch ints;
    1 KB to align the base for TMA's swizzle."""
    stages, row_bufs = TILED_STAGES, 2 if quantized else TILED_STAGES
    return (4 * TILED_SLICE * (row_bufs * TILED_ROWS + stages * n_tile)
            + (TILED_RAW_SLOTS * TILED_ROWS * 4 * TILED_SLICE if quantized else 0)
            + 8 * (stages + (TILED_RAW_SLOTS if quantized else 0))
            + 8 * n_tile * k + 4 * n_tile
            + (4 * n_tile * TILED_Z_PITCH if n_tile <= TILED_NARROW else 0)
            + 4 * tiles_per_chunk + 4 * (TILED_MISC + _build.MAX_K) + 1024)


def tiled_plan(K: int, C: int, v_pad: int, k: int, quantized: bool = False,
               tail_waves: int = TILED_TAIL_WAVES) -> TiledPlan:
    """The tiled body's launch from the shapes: the smallest token tile that
    holds C (at most 128); chunks of the vocab's 128-row tiles that give
    about TILED_ITEMS_PER_SM work items per SM. With 128-slot tiles, whose
    items are long, chunks of one tile follow for the last ``tail_waves``
    waves of items, so the SMs finish together (the big chunks then take
    at most half of the TILED_MAX_CHUNKS an expert may have); 0 gives
    chunks of one size (``chip_smoke.py`` times both)."""
    n = next((t for t in TILED_TOKENS if t >= C), TILED_TOKENS[-1])
    tiles = -(-C // n)
    row_tiles = -(-v_pad // TILED_ROWS)
    tail = n == TILED_TOKENS[-1] and tail_waves > 0
    per_chunk = round(K * tiles * row_tiles / (TILED_ITEMS_PER_SM * _build.SMS))
    per_chunk = min(row_tiles, max(1, -(-row_tiles // (TILED_MAX_CHUNKS // (2 if tail else 1))),
                                   per_chunk))
    small = min(row_tiles, -(-tail_waves * _build.SMS // (K * tiles)),
                TILED_MAX_CHUNKS // 2) if tail else 0
    big_tiles = row_tiles - small
    nchunk = -(-big_tiles // per_chunk) + small
    smem = tiled_smem_bytes(n, k, per_chunk, quantized)
    if smem > SMEM_MAX:
        raise ValueError(f"k={k} and {per_chunk} row tiles a chunk need {smem} bytes of "
                         f"shared memory, above {SMEM_MAX}")
    return TiledPlan(n, tiles, per_chunk, big_tiles, nchunk, smem)


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
    (a 128-row tile of 64 d, then n_tile tokens of 64 d, per stage) and its
    barriers; per token one list of k 8-byte keys, its threshold (8 bytes)
    and bound (4), a queue of WGMMA_QUEUE 8-byte candidates, their count
    and g; 1 KB to align."""
    row = WGMMA_ROWS * WGMMA_SLICE * (1 if quantized else 2)
    return (stages * (row + n_tile * WGMMA_SLICE * 2) + 16 * stages
            + 8 * n_tile * (1 + k + WGMMA_QUEUE) + 12 * n_tile + 1024)


def wgmma_spill_pairs(plan: "WgmmaPlan", K: int) -> int:
    """(value, position) pairs of the spill area the tensor-core body takes:
    per block (nsplit x token tiles x K), WGMMA_SPILL per token of the tile,
    a token's candidates in one row tile past its WGMMA_QUEUE slots in
    shared memory (a tile has 128 rows, so none is ever dropped). Written
    only when a token has more than WGMMA_QUEUE candidates in a tile."""
    return plan.nsplit * plan.token_tiles * K * plan.n_tile * WGMMA_SPILL


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
    memory beside the lists and queues (:func:`wgmma_smem_bytes`: 3 stages
    at N 256, k 8 for bf16 rows, 4 for int8), a smaller tile where even two
    stages do not (large k), and vocab splits from :func:`wgmma_split`. The
    ring feeds products that run at the rate rows and token slices arrive;
    the per-tile filter and merge after them are a few microseconds a row
    tile at C 256 (PERF.md section 6)."""
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
    dev = resolve_device(device, meta=True)
    check_forward_only("dss_topk_grouped", weights=weights, buf=buf, g_buf=g_buf, scales=scales)
    check_on(dev, weights=weights, ids=ids, buf=buf, g_buf=g_buf)
    ref.check_scales(weights, scales)
    quantized = scales is not None
    if quantized:
        check_on(dev, scales=scales)
    if dev.type != "cuda":
        return ref.plain("dss_topk_grouped", ref.dss_topk_grouped_ref, weights, ids, buf,
                         g_buf, k, scales=scales)
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


def launch_body(weights, ids, buf, g_buf, k: int, scales, body: str,
                plan: Optional[TiledPlan] = None):
    """Launch ``body`` (``DECODE``, ``WGMMA`` or ``TILED``) on contiguous
    CUDA tensors that :func:`dss_topk_grouped` has checked, and count the
    launch. The wrapper passes ``select_body``'s choice; ``chip_smoke.py``'s
    capacity sweeps run the decode body beside the tensor-core body (bf16
    tokens) or the tiled body (fp32 tokens) at every capacity. ``WGMMA``
    takes bf16 tokens only (the kernel raises on data TMA cannot
    address). ``plan`` replaces ``TILED``'s plan from the shapes (the
    schedule comparison in ``chip_smoke.py``)."""
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
        plan = plan or tiled_plan(K, C, v_pad, k, scales is not None)
        # bf16 tokens come here only where TMA cannot stage them
        tma = buf.dtype == torch.float32 and tma_addressable(
            d, weights.dtype, weights.data_ptr(), buf.data_ptr(), xdtype=torch.float32)
        part_v = part_i = None
        if plan.nchunk > 1:
            part_v = torch.empty((plan.nchunk, K, C, k), dtype=torch.float32, device=buf.device)
            part_i = torch.empty((plan.nchunk, K, C, k), dtype=torch.int32, device=buf.device)
        next_item = torch.empty((1,), dtype=torch.int32, device=buf.device)
        lows = torch.empty((K, C), dtype=torch.int32, device=buf.device)
        err = lib.dss_topk_grouped_tiled(
            buf.data_ptr(), g_buf.data_ptr(), weights.data_ptr(), ids.data_ptr(),
            _build.ptr(scales), out_v.data_ptr(), out_i.data_ptr(),
            _build.ptr(part_v), _build.ptr(part_i), next_item.data_ptr(), lows.data_ptr(),
            K, C, v_pad, d, k, plan.n_tile, plan.tiles_per_chunk, plan.big_tiles, plan.nchunk,
            int(tma),
            _build.dtype_code(buf), _build.weight_code(weights), stream)
    elif body == WGMMA:
        if buf.dtype != torch.bfloat16:
            raise TypeError(f"{WGMMA} takes bfloat16 tokens, got {buf.dtype}")
        plan = wgmma_plan(K, C, v_pad, k, scales is not None)
        part_v = part_i = None
        if plan.nsplit > 1:
            part_v = torch.empty((plan.nsplit, K, C, k), dtype=torch.float32, device=buf.device)
            part_i = torch.empty((plan.nsplit, K, C, k), dtype=torch.int32, device=buf.device)
        spill = torch.empty((wgmma_spill_pairs(plan, K), 2), dtype=torch.float32,
                            device=buf.device)
        err = lib.dss_topk_grouped_wgmma(
            buf.data_ptr(), g_buf.data_ptr(), weights.data_ptr(), ids.data_ptr(),
            _build.ptr(scales), out_v.data_ptr(), out_i.data_ptr(),
            _build.ptr(part_v), _build.ptr(part_i), spill.data_ptr(), K, C, v_pad, d, k,
            plan.n_tile, plan.nsplit, plan.tiles_per_split, plan.stages,
            _build.weight_code(weights), stream)
    else:
        raise ValueError(f"unknown body {body!r}: expected one of {tuple(COUNTERS)}")
    _build.check(lib, err, body)
    attr = COUNTERS[body] + ("_q" if scales is not None else "")
    setattr(dss_topk_grouped, attr, getattr(dss_topk_grouped, attr) + 1)
    return out_v, out_i


for _attr in COUNTERS.values():
    setattr(dss_topk_grouped, _attr, 0)
    setattr(dss_topk_grouped, _attr + "_q", 0)
