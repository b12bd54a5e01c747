"""Expert-grouped DS-Softmax retrieval (weight-stationary).

Wrapper over ``csrc/dss_topk_grouped.cu`` (replaces both bodies of the
Pallas kernel ``repro/kernels/dss_topk_grouped.py``: ``_kernel`` for
f32/bf16 rows and ``_kernel_q`` for int8 rows with per-row scales).
Tokens arrive already grouped by their top-1 expert into ``(K, C, d)``
capacity buffers; only the ``(K, C, k)`` values/ids are written. For CPU
tensors it runs the plain version, ``ref.dss_topk_grouped_ref``.

On CUDA tensors one of two kernel bodies runs, chosen by the capacity C
alone (:func:`select_body`):

- ``DECODE`` (C up to ``TILED_ABOVE``): the streaming retrieval shared with
  the fused kernel (``csrc/retrieve_stream.cuh``). It reads only the
  experts with a live slot (``g_buf != 0``), each once per group of
  ``retrieve_stream.token_group(d)`` live slots, over a grid fixed by the
  shapes (:func:`launch_plan`) whose work list the kernel builds on the
  device; an empty slot's output comes from ``ids`` alone. No host sync,
  no allocation in the kernels: a CUDA graph can capture the call.
- ``TILED`` (larger C): 16- or 64-slot token tiles, each expert's rows
  streamed once per tile through shared memory, vocab splits merged by a
  second kernel (:func:`tiled_plan`).

Each body counts its launches on this function: ``launches`` (decode,
f32/bf16 rows), ``launches_q`` (decode, int8 rows), ``launches_tiled`` and
``launches_tiled_q``.
"""
from __future__ import annotations

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import _build, ref
from repro_torch.kernels.retrieve_stream import StreamPlan, row_vec_bytes, stream_plan

DECODE, TILED = "dss_topk_grouped", "dss_topk_grouped_tiled"
# Capacities above this run the tiled body: the decode body reads an
# expert's rows once per token group (6 slots at d 1536), the tiled body
# once per 64 slots. Set from chip_smoke.py's capacity sweep on an H100
# (PERF.md section 6): the decode body was the faster at C 32 and below on
# bf16 and int8 rows, the tiled body at C 64 and above.
TILED_ABOVE = 32


def select_body(capacity: int) -> str:
    """The kernel body that serves a capacity of ``capacity`` slots per
    expert: ``DECODE`` up to ``TILED_ABOVE``, ``TILED`` above."""
    return DECODE if capacity <= TILED_ABOVE else TILED


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
    return launch_body(weights, ids, buf, g_buf, k, scales, select_body(C))


def launch_body(weights, ids, buf, g_buf, k: int, scales, body: str):
    """Launch ``body`` (``DECODE`` or ``TILED``) on contiguous CUDA tensors
    that :func:`dss_topk_grouped` has checked, and count the launch. The
    wrapper passes ``select_body``'s choice; ``chip_smoke.py``'s capacity
    sweep runs both bodies at every capacity."""
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
    else:
        raise ValueError(f"unknown body {body!r}: expected {DECODE!r} or {TILED!r}")
    _build.check(lib, err, body)
    attr = ("launches" if body == DECODE else "launches_tiled") + ("_q" if scales is not None else "")
    setattr(dss_topk_grouped, attr, getattr(dss_topk_grouped, attr) + 1)
    return out_v, out_i


dss_topk_grouped.launches = 0
dss_topk_grouped.launches_q = 0
dss_topk_grouped.launches_tiled = 0
dss_topk_grouped.launches_tiled_q = 0
