#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero before the result line):

1. Device and build: the card's name and power limit, TF32 off, the
   five CUDA libraries built from ``src/repro_torch/csrc`` (one ``nvcc``
   each, all at once).
2. Every kernel body against its plain PyTorch version at full width
   (d 1536, K 16, k 8; bf16 and fp32; int8 rows for the ``_q`` bodies):
   ids equal, values within the stated tolerance, kernel / plain /
   library-call times (CUDA events, median of 25 after warm-up).
   ``lasso_prune``: fp32 at N 16,384 and, once the model exists, bf16 on
   its seeded (16, 152,064, 1536) head with the stand-in mask (the shape
   the repack gives it) and with every row alive; masks equal, norms
   within rtol 1e-5, the threshold at the midpoint of two adjacent sorted
   norms at least 8 fp32 ulps apart (relative; the kernel and its plain
   version differ by at most one) so no row ties it, nearest to the 25th
   percentile of the alive rows' norms (within 0.01 of it for the stand-in
   mask, whose threshold the adapt phase prunes at).
3. The slice: qwen2-1.5b at full width (28 layers, seeded weights, a
   seeded stand-in for a trained expert mask) served by ``ServeSession``
   through 8 slots, 12 requests (one prompt of 2048 tokens, so chunked
   attention merges two query chunks).
   Every session here keeps the overflow breaker off and must end on the
   kernel it names.
   (fp) For each ``kernel=`` of cuda_fused, cuda_grouped, auto and jnp:
   once as a user calls ``run()`` (tokens/s), once with every prefill and
   decode step synchronized and timed; greedy streams token-identical.
   (int8) ``quantize='int8'`` sessions, each run once, instrumented:
   (a) flip threshold 1.0, every expert on int8 rows, through
   cuda_fused, cuda_grouped, auto and jnp; (b) a ``quantize_table`` table
   with half the experts on fp fallback rows, through cuda_fused,
   cuda_grouped and jnp; each group token-identical; (c) the default
   threshold 0.0, its exactness report printed.
   (per-token) One ``cuda_pertoken`` session on the fp table, held
   against the fp jnp session (its g fold rounds h to bf16, so a stream
   may leave only at a top-1/top-2 gap below 2^-7 relative).
   Each group resets the launch counters before it and reads them after:
   every kernel body of its path must have launched, the plain sessions'
   counts stay 0.
4. Decode-step profile: 8 residents at prompt length 512, for cuda_fused
   and jnp on the fp table and cuda_fused on the int8 table: step ms
   (median of 20), then ``torch.profiler`` over 5 steps for device-busy
   time, the device's idle share, device ops and host syncs per step, and
   the ten device ops that take the most time.
5. Adapt: qwen2-1.5b at full width on ``skew_gate`` params (every token
   to expert 0: at capacity factor 2.0, K 16 and 8 slots, 7 of 8 tokens
   overflow), 8 requests. (i) One ``repack_for_traffic`` (re-prune at the
   25th percentile of alive-row norms, mitosis of expert 0) swapped into
   ``cuda_grouped``, ``cuda_fused`` and ``jnp`` sessions at the same
   decode step: streams agree (or leave at a near-tie), v_pad shrinks.
   (ii) The online loop (``AdaptPolicy``, breaker off) on
   ``cuda_grouped``: one swap, the window's overflow rate falls, rows
   pruned, v_pad shrinks, ``lasso_prune`` launched and its plain version
   never called, ``decode_builds == 1 + n_swaps``.
   (iii) The breaker trips twice (capacity x2, then the ``cuda_fused``
   kernel, which must launch after trip 2), streams equal an unswapped
   ``jnp`` session's. (iv) An int8 session (flip threshold
   1.0) adapted once stays quantized, with a fresh gate report, and its
   int8 grouped body launches after the swap. Every kernel body of the
   path (both grouped bodies, ``gate_top1``, the fused body,
   ``lasso_prune``) must have launched. Repack, swap and lasso times are
   printed.
6. Report: one ``{"kernels": [...]}`` line (seven kernel bodies), the card
   line, and as the last line ``{"ok": true, "device": {...}}``.

Without CUDA it exits with code 2 and prints no result. It imports only
torch, numpy and the port.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of bytes / memory rate and operations / the rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Value tolerance, kernel vs plain version on the same inputs: both sum
# the same exact fp32 products (bf16 operands are widened) over d = 1536
# in different orders, so they differ by fp32 rounding only.
VAL_ATOL, VAL_RTOL = 1e-3, 1e-5
# A greedy stream may leave the plain session's only at a near-tie: the
# reference's top-1 and top-2 values closer than this (relative), i.e.
# within the accumulation-order differences above.
TIE_RTOL = 1e-5
# cuda_pertoken rounds g·h to bf16 before the product (as the reference's
# per-token path does), so its stream may leave the plain one where the
# reference's top-1 and top-2 are closer than one bf16 step (2^-7 relative).
FOLD_RTOL = 2.0 ** -7

SEED = 0
N_SLOTS, K_TOP, NEW_TOKENS = 8, 8, 32
# 2048 = 2 x attn_q_chunk: the one prompt whose prefill takes the multi-chunk
# branch of chunked_causal_attention (the others are not chunk multiples).
PROMPT_LENS = (16, 1536, 40, 300, 1100, 64, 700, 24, 512, 90, 2048, 200)
MAX_SEQ = max(PROMPT_LENS) + NEW_TOKENS - 1
SAMPLED = 5                  # this request samples at temperature 0.8
SESSION_KERNELS = ("cuda_fused", "cuda_grouped", "auto", "jnp")
INT8_ALL_KERNELS = ("cuda_fused", "cuda_grouped", "auto", "jnp")      # (a)
INT8_FB_KERNELS = ("cuda_fused", "cuda_grouped", "jnp")               # (b)
# kernel bodies each serve path must launch (dispatch by table kind)
NEEDS = {("cuda_fused", False): ("dss_topk_fused",),
         ("cuda_grouped", False): ("gate_top1", "dss_topk_grouped"),
         ("auto", False): ("dss_topk_fused",),
         ("cuda_fused", True): ("dss_topk_fused_q",),
         ("cuda_grouped", True): ("gate_top1", "dss_topk_grouped_q"),
         ("auto", True): ("dss_topk_fused_q",),
         ("cuda_pertoken", False): ("gate_top1", "dss_topk"),
         ("jnp", False): (), ("jnp", True): ()}
PROFILE_PROMPT, PROFILE_STEPS, PROFILE_TRACED = 512, 20, 5
# lasso_prune: the kernel sums its fp32 squares in another order than the
# plain version (one fp32 ulp apart at most, at d 1536 on the H100); each
# threshold is the midpoint of a gap of 8 ulps (FP32_SAFE_GAP) between two
# adjacent alive norms; the main path's must land within PRUNE_SLACK of the
# quantile.
LASSO_RTOL, LASSO_ATOL = 1e-5, 1e-6
PRUNE_QUANTILE, PRUNE_SLACK = 0.25, 0.01
# adapt phase: 8 requests fill the 8 slots; 24 new tokens give the breaker
# (window 8) room for both trips
ADAPT_PROMPT_LENS = (16, 40, 24, 64, 90, 32, 48, 200)
ADAPT_NEW, SWAP_AT = 24, 6
ADAPT_SEQ = max(ADAPT_PROMPT_LENS) + ADAPT_NEW - 1
ADAPT_KERNELS = ("cuda_grouped", "cuda_fused", "jnp")
BREAKER_OFF = 1.1            # overflow_threshold above any rate
# kernel bodies the adapt path must launch: the grouped and fused decode
# paths, the int8 grouped body of (iv), and the repack's re-prune
ADAPT_NEEDS = ("gate_top1", "dss_topk_grouped", "dss_topk_fused", "dss_topk_grouped_q",
               "lasso_prune")
SYNC_OPS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
            "cudaMemcpyAsync", "cudaEventSynchronize")


class SmokeFailure(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _table(gen, K, v_pad, d, dtype, empty_expert=None):
    """A packed-table stand-in: expert e holds a random number of real
    rows (ids >= 0) followed by padding (-1); ``empty_expert`` is all
    padding."""
    import torch

    dev = "cuda"
    w = torch.randn((K, v_pad, d), generator=gen, device=dev).mul_(d ** -0.5).to(dtype)
    sizes = torch.randint(v_pad * 3 // 4, v_pad + 1, (K,), generator=gen, device=dev)
    if empty_expert is not None:
        sizes[empty_expert] = 0
    pos = torch.arange(v_pad, device=dev)
    ids = torch.randperm(K * v_pad, generator=gen, device=dev).reshape(K, v_pad)
    ids = torch.where(pos[None, :] < sizes[:, None], ids, -1).to(torch.int32)
    w = torch.where((ids >= 0)[..., None], w, torch.zeros((), dtype=dtype, device=dev))
    return w.contiguous(), ids


def _compare(name, case, got, want, rtol=VAL_RTOL, atol=VAL_ATOL):
    """Max |value difference| over entries both report finite; raise
    unless ids (and sentinels) agree and values are within tolerance."""
    import torch

    (gv, gi), (wv, wi) = got, want
    ids_equal = bool(torch.equal(gi, wi))
    fin = torch.isfinite(wv)
    if not torch.equal(fin, torch.isfinite(gv)):
        raise SmokeFailure(f"{name} {case}: non-finite entries differ from the plain version")
    diff = (gv[fin] - wv[fin]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if not ids_equal:
        bad = int((gi != wi).sum())
        raise SmokeFailure(f"{name} {case}: {bad} ids differ from the plain version")
    if not torch.allclose(gv[fin], wv[fin], rtol=rtol, atol=atol):
        raise SmokeFailure(f"{name} {case}: values differ by up to {err}")
    return err, ids_equal


def report_case(results, name, case, got, want, t_kernel, t_plain, t_lib, nbytes, flops,
                dtype, main=False, rtol=VAL_RTOL, atol=VAL_ATOL):
    """Check one kernel case against its plain version and record its
    times and bound (``main``: the shape the main path gives the body)."""
    from repro_torch.kernels import ops

    err, ids_equal = _compare(name, case, got, want, rtol, atol)
    b_ms, b_by = bound_ms(nbytes, flops, dtype)
    row = {"name": name, "case": case, "ms": t_kernel, "plain_ms": t_plain,
           "library_ms": t_lib, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": err, "ids_equal": ids_equal, "main_path_shape": main}
    results.setdefault("cases", []).append(row)
    print(f"[kernel] {name:17s} {case:38s} kernel {t_kernel:9.4f} ms  plain "
          f"{t_plain:9.4f} ms  library {t_lib:9.4f} ms  bound {b_ms:.4f} ms "
          f"({b_by})  max|dv| {err:.3g}  ids equal {ids_equal}  launches "
          f"{ops.launch_counts()[name]}", flush=True)
    if main:
        results.setdefault("main", {})[name] = row


def kernel_phase(results: dict) -> None:
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    K, d, k = 16, 1536, 8
    bf16, f32 = torch.bfloat16, torch.float32
    report = functools.partial(report_case, results)

    # -- gate_top1 --------------------------------------------------------
    for dtype, B, main in ((bf16, 8, True), (bf16, 2048, False), (f32, 8, False)):
        gw = torch.randn((K, d), generator=gen, device="cuda").mul_(d ** -0.5).to(dtype)
        h = torch.randn((B, d), generator=gen, device="cuda").to(dtype)
        got = ops.gate_top1(gw, h)
        want = ref.gate_top1_ref(gw, h)
        eb = h.element_size()
        report("gate_top1", f"{str(dtype)[6:]} B={B} K={K} d={d}",
               (got[1], got[0]), (want[1], want[0]),
               time_ms(lambda: ops.gate_top1(gw, h)),
               time_ms(lambda: ref.gate_top1_ref(gw, h)),
               time_ms(lambda: torch.softmax(h.float() @ gw.float().T, -1).max(-1)),
               (B * d + K * d) * eb + B * 8, 2 * B * K * d, dtype, main)

    # -- dss_topk_grouped -------------------------------------------------
    cases = (
        # decode: B = 8 slots, capacity round(8/16*2) = 1
        (bf16, 1, 12032, None, True),
        # prefill-sized batch B = 2048 at cf 2.0 → C = 256; one expert all
        # padding and a v_pad that no 64-row tile divides
        (bf16, 256, 12000, 3, False),
        (f32, 256, 12032, None, False),
    )
    for dtype, C, v_pad, empty, main in cases:
        w, ids = _table(gen, K, v_pad, d, dtype, empty)
        buf = torch.randn((K, C, d), generator=gen, device="cuda").to(dtype)
        g_buf = torch.rand((K, C), generator=gen, device="cuda")
        got = ops.dss_topk_grouped(w, ids, buf, g_buf, k)
        want = ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k)
        if empty is not None:
            pad = got[1][empty]
            if not (bool((pad == -1).all()) and bool((got[0][empty] == -1e9).all())):
                raise SmokeFailure("dss_topk_grouped: the all-padding expert must emit (-1e9, -1)")
        eb = w.element_size()
        real_rows = int((ids >= 0).sum())
        case = f"{str(dtype)[6:]} C={C} v_pad={v_pad}" + (f" empty e{empty}" if empty is not None else "")
        report("dss_topk_grouped", case, got, want,
               time_ms(lambda: ops.dss_topk_grouped(w, ids, buf, g_buf, k)),
               time_ms(lambda: ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k)),
               time_ms(lambda: torch.topk(torch.bmm(buf, w.transpose(1, 2)), k)),
               real_rows * (d * eb + 4) + K * C * (d * eb + 4) + K * C * k * 8,
               2 * C * real_rows * d, dtype, main)

    # -- dss_topk_fused ---------------------------------------------------
    cases = ((bf16, 8, 0, K, True), (bf16, 128, 0, K, False), (f32, 8, 0, K, False),
             # the local half of a 16-expert gate: e_base 8, K 8
             (bf16, 128, 8, K // 2, False))
    for dtype, B, e_base, K_loc, main in cases:
        v_pad = 12032
        gw = torch.randn((K, d), generator=gen, device="cuda").mul_(d ** -0.5).to(dtype)
        w, ids = _table(gen, K_loc, v_pad, d, dtype)
        h = torch.randn((B, d), generator=gen, device="cuda").to(dtype)
        got = ops.dss_topk_fused(gw, w, ids, h, k, e_base=e_base)
        want = ref.dss_topk_fused_ref(gw, w, ids, h, k, e_base)
        if not torch.equal(got[2], want[2]):
            raise SmokeFailure("dss_topk_fused: expert ids differ from the plain version")
        local = want[2].long() - e_base
        mine = (local >= 0) & (local < K_loc)
        if e_base and not (bool((got[1][~mine] == -1).all()) and bool(mine.any())):
            raise SmokeFailure("dss_topk_fused: foreign tokens must emit id -1")
        if bool(torch.isinf(got[0][mine]).any()):
            raise SmokeFailure("dss_topk_fused: an internal -inf reached a served token")
        eb = w.element_size()
        sel = torch.unique(local[mine])
        rows_read = int((ids[sel] >= 0).sum()) if sel.numel() else 0
        flops = 2 * B * K * d + 2 * sum(int((ids[e] >= 0).sum()) for e in local[mine].tolist()) * d
        e0 = int(sel[0]) if sel.numel() else 0
        report("dss_topk_fused", f"{str(dtype)[6:]} B={B} e_base={e_base} K={K_loc}",
               got[:2], want[:2],
               time_ms(lambda: ops.dss_topk_fused(gw, w, ids, h, k, e_base=e_base)),
               time_ms(lambda: ref.dss_topk_fused_ref(gw, w, ids, h, k, e_base)),
               time_ms(lambda: torch.topk(h @ w[e0].T, k)),
               rows_read * (d * eb + 4) + (B + K) * d * eb + B * (k * 8 + 4),
               flops, dtype, main)

    # -- dss_topk_grouped_q: int8 rows, bf16 tokens ----------------------
    from repro_torch.core.dssoftmax import ServeTable, quantize_table

    for C, v_pad, empty, main in ((1, 12032, None, True), (256, 12000, 3, False)):
        w, ids = _table(gen, K, v_pad, d, bf16, empty)
        qt = quantize_table(ServeTable(ids=ids, weights=w))
        q, sc = qt.qweights, qt.scales
        del w, qt
        qb = q.to(bf16)  # the yardstick reads the rows as bf16
        buf = torch.randn((K, C, d), generator=gen, device="cuda").to(bf16)
        g_buf = torch.rand((K, C), generator=gen, device="cuda")
        got = ops.dss_topk_grouped(q, ids, buf, g_buf, k, scales=sc)
        want = ref.dss_topk_grouped_ref(q, ids, buf, g_buf, k, scales=sc)
        if empty is not None and not (bool((got[1][empty] == -1).all())
                                      and bool((got[0][empty] == -1e9).all())):
            raise SmokeFailure("dss_topk_grouped_q: the all-padding expert must emit (-1e9, -1)")
        real_rows = int((ids >= 0).sum())
        report("dss_topk_grouped_q",
               f"int8 rows, bf16 C={C} v_pad={v_pad}"
               + (f" empty e{empty}" if empty is not None else ""),
               got, want,
               time_ms(lambda: ops.dss_topk_grouped(q, ids, buf, g_buf, k, scales=sc)),
               time_ms(lambda: ref.dss_topk_grouped_ref(q, ids, buf, g_buf, k, scales=sc)),
               time_ms(lambda: torch.topk(torch.bmm(buf, qb.transpose(1, 2)), k)),
               real_rows * (d + 4 + 4) + K * C * (d * 2 + 4) + K * C * k * 8,
               2 * C * real_rows * d, bf16, main)
        del q, qb, buf

    # -- dss_topk_fused_q: int8 rows, bf16 gate and tokens ---------------
    for B, main in ((8, True), (128, False)):
        v_pad = 12032
        gw = torch.randn((K, d), generator=gen, device="cuda").mul_(d ** -0.5).to(bf16)
        w, ids = _table(gen, K, v_pad, d, bf16)
        qt = quantize_table(ServeTable(ids=ids, weights=w))
        q, sc = qt.qweights, qt.scales
        del w, qt
        h = torch.randn((B, d), generator=gen, device="cuda").to(bf16)
        got = ops.dss_topk_fused(gw, q, ids, h, k, scales=sc)
        want = ref.dss_topk_fused_ref(gw, q, ids, h, k, scales=sc)
        if not torch.equal(got[2], want[2]):
            raise SmokeFailure("dss_topk_fused_q: expert ids differ from the plain version")
        sel = want[2].long()
        e0 = int(sel[0])
        qb0 = q[e0].to(bf16)
        uniq = torch.unique(sel)
        rows_read = int((ids[uniq] >= 0).sum())
        flops = 2 * B * K * d + 2 * sum(int((ids[e] >= 0).sum()) for e in sel.tolist()) * d
        report("dss_topk_fused_q", f"int8 rows, bf16 B={B} K={K}", got[:2], want[:2],
               time_ms(lambda: ops.dss_topk_fused(gw, q, ids, h, k, scales=sc)),
               time_ms(lambda: ref.dss_topk_fused_ref(gw, q, ids, h, k, scales=sc)),
               time_ms(lambda: torch.topk(h @ qb0.T, k)),
               rows_read * (d + 4 + 4) + (B + K) * d * 2 + B * (k * 8 + 4),
               flops, bf16, main)
        del q, qb0

    # -- dss_topk: per token, fp rows, one expert with 5 real rows --------
    for dtype, main in ((bf16, True), (f32, False)):
        B, v_pad = 8, 12032
        w, ids = _table(gen, K, v_pad, d, dtype)
        ids[5, 5:] = -1
        w[5, 5:] = 0
        e = torch.randperm(K, generator=gen, device="cuda")[:B].to(torch.int32)
        e[0] = 5
        g = torch.rand((B,), generator=gen, device="cuda") * 0.5 + 0.5
        h = torch.randn((B, d), generator=gen, device="cuda").to(dtype)
        hs = (h.float() * g[:, None]).to(dtype)
        got = ops.dss_topk(w, ids, h, e, g, k)
        want = ref.dss_topk_ref(w, ids, hs, e, k)
        if not (bool((got[1][0, 5:] == -1).all()) and bool((got[0][0, 5:] == -1e9).all())):
            raise SmokeFailure("dss_topk: the tail of an expert with 5 real rows "
                               "must be (-1e9, -1)")
        el = e.long()
        eb = w.element_size()
        uniq = torch.unique(el)
        rows_read = int((ids[uniq] >= 0).sum())
        flops = 2 * sum(int((ids[x] >= 0).sum()) for x in el.tolist()) * d
        report("dss_topk", f"{str(dtype)[6:]} B={B} K={K} (expert 5: 5 rows)", got, want,
               time_ms(lambda: ops.dss_topk_kernel(w, ids, hs, e, k)),
               time_ms(lambda: ref.dss_topk_ref(w, ids, hs, e, k)),
               time_ms(lambda: torch.topk(torch.bmm(w[el], hs[:, :, None])[:, :, 0], k)),
               rows_read * (d * eb + 4) + B * (d * eb + 4) + B * k * 8,
               flops, dtype, main)

    # -- lasso_prune: fp32 rows, half of them alive; the full-width bf16
    # head comes in lasso_phase, once the model exists
    w = torch.randn((K, 16384, d), generator=gen, device="cuda").mul_(d ** -0.5)
    mask = torch.rand((K, 16384), generator=gen, device="cuda") < 0.5
    lasso_case(results, "N=16384, half alive", w, mask, main=False)


def lasso_case(results, case, w, mask, main, q=PRUNE_QUANTILE) -> float:
    """``lasso_prune`` against its plain version on (w, mask) at a threshold
    near the q-quantile of the alive rows' norms; returns the threshold.
    Bound: the alive rows' bytes (a masked row is never read), the mask
    read, the norms and new mask written; one fp32 multiply-add per alive
    element."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.testing import FP32_SAFE_GAP, gamma_between

    K, N, d = w.shape
    norms = ref.lasso_prune_ref(w, mask, 0.0)[0]
    gamma = gamma_between(norms, mask, q, rel_gap=FP32_SAFE_GAP)
    quantile = float((norms[mask] < gamma).double().mean())
    del norms
    # the main path's threshold is the one the adapt phase prunes at; with
    # every row alive (2.4M norms) ties leave no safe gap near q
    if main and abs(quantile - q) > PRUNE_SLACK:
        raise SmokeFailure(f"lasso_prune {case}: the nearest safe gap lies at the "
                           f"{quantile:.5f} quantile, not near {q}")
    got = ops.lasso_prune(w, mask, gamma)
    want = ref.lasso_prune_ref(w, mask, gamma)
    if bool((got[0][~mask] != 0).any()):
        raise SmokeFailure(f"lasso_prune {case}: a masked row's norm is not 0")
    if not 0 < int(want[1].sum()) < int(mask.sum()):
        raise SmokeFailure(f"lasso_prune {case}: the threshold prunes no row or every row")
    alive = int(mask.sum())
    report_case(results, "lasso_prune", f"{str(w.dtype)[6:]} {case}", got, want,
                time_ms(lambda: ops.lasso_prune(w, mask, gamma)),
                time_ms(lambda: ref.lasso_prune_ref(w, mask, gamma)),
                time_ms(lambda: torch.linalg.vector_norm(w, dim=-1, dtype=torch.float32) * mask),
                alive * d * w.element_size() + K * N * (1 + 4 + 1), 2 * alive * d,
                torch.float32, main, LASSO_RTOL, LASSO_ATOL)
    results["cases"][-1].update(gamma=gamma, gamma_quantile=quantile,
                                rows_pruned=alive - int(want[1].sum()))
    print(f"[kernel] lasso_prune       threshold {gamma:.7g}: the nearest 8-ulp gap to the "
          f"{q:.2f} quantile lies at the {quantile:.5f} quantile of the {alive} alive "
          f"rows' norms; {alive - int(want[1].sum())} rows fall below it", flush=True)
    return gamma


def lasso_phase(results, head_w, mask) -> float:
    """Phase 2's full-width lasso_prune cases, on the model's seeded head:
    the stand-in mask (the main path's input), then every row alive.
    Returns the stand-in case's threshold (the adapt phase prunes at it)."""
    import torch

    shape = "(" + ", ".join(map(str, head_w.shape)) + ")"
    gamma = lasso_case(results, f"{shape} stand-in mask", head_w, mask, main=True)
    lasso_case(results, f"{shape} every row alive", head_w, torch.ones_like(mask), main=False)
    torch.cuda.empty_cache()
    return gamma


# ---------------------------------------------------------------------------
# Phase 3: the slice
# ---------------------------------------------------------------------------

def stand_in_mask(cfg, device):
    """A seeded stand-in for a trained DS mask: each class keeps its home
    expert (a seeded permutation mod K) and, with probability 0.25, one
    more random expert; vocab-padding classes stay masked."""
    import numpy as np
    import torch

    K, V, N = cfg.ds.num_experts, cfg.vocab_size, cfg.padded_vocab
    rng = np.random.RandomState(SEED)
    home = rng.permutation(V) % K
    extra = rng.rand(V) < 0.25
    other = (home + rng.randint(1, K, V)) % K
    mask = np.zeros((K, N), bool)
    mask[home, np.arange(V)] = True
    mask[other[extra], np.arange(V)[extra]] = True
    return torch.from_numpy(mask).to(device)


class Recorder:
    """Wraps a bundle's prefill/decode_step: synchronized wall times, and
    each request's per-emission (values, ids) for divergence reports."""

    def __init__(self, bundle, session, reqs):
        self.inner, self.sess = bundle, session
        self.by_prompt = {r.prompt.tobytes(): i for i, r in enumerate(reqs)}
        self.index = {id(r): i for i, r in enumerate(reqs)}
        self.heads = {i: [] for i in range(len(reqs))}
        self.prefill_s, self.decode_s = {}, []

    def prefill(self, p, t, batch, **kw):
        import torch

        t0 = time.perf_counter()
        vals, ids, cache = self.inner.prefill(p, t, batch, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        i = self.by_prompt[batch["tokens"][0].cpu().numpy().astype("int32").tobytes()]
        self.prefill_s[i] = dt
        self.heads[i].append((vals[0].cpu(), ids[0].cpu()))
        return vals, ids, cache

    def decode_step(self, p, t, cache, tok, pos, **kw):
        import torch

        owners = [s.req if s is not None else None for s in self.sess.scheduler.slots]
        t0 = time.perf_counter()
        out = self.inner.decode_step(p, t, cache, tok, pos, **kw)
        torch.cuda.synchronize()
        self.decode_s.append(time.perf_counter() - t0)
        vals, ids = out[0].cpu(), out[1].cpu()
        for i, r in enumerate(owners):
            if r is not None:
                self.heads[self.index[id(r)]].append((vals[i], ids[i]))
        return out


def _diverge_check(label, streams, heads, kerns, ref_kern, rtol, greedy_only=False,
                   sampled=SAMPLED):
    """Each stream of ``kerns`` must equal ``ref_kern``'s, or leave it only
    at a near-tie of the reference (top-1/top-2 gap below ``rtol``
    relative); the ``sampled`` request (None: none samples) must match
    exactly unless ``greedy_only``. Prints every divergence; returns their
    count."""
    n = 0
    for kern in kerns:
        for i, (a, b) in enumerate(zip(streams[kern], streams[ref_kern])):
            if a == b or (greedy_only and i == sampled):
                continue
            n += 1
            j = next(m for m, (x, y) in enumerate(zip(a, b)) if x != y)
            rv, ri = heads[ref_kern][i][j]
            kv, ki = heads[kern][i][j]
            gap = float(rv[0] - rv[1])
            print(f"[slice] {label}: request {i} diverges at emission {j}: {ref_kern} top-2 "
                  f"{rv[:2].tolist()} ids {ri[:2].tolist()}; {kern} top-2 "
                  f"{kv[:2].tolist()} ids {ki[:2].tolist()}; gap {gap:.3g}")
            if i == sampled or gap > rtol * max(1.0, abs(float(rv[0]))):
                raise SmokeFailure(f"{label} {kern}: stream {i} diverges from {ref_kern} "
                                   f"at emission {j} without a near-tie (gap {gap})")
    return n


def slice_phase(results: dict, card: str):
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession

    cfg = get_config("qwen2-1.5b")
    t0 = time.perf_counter()
    bundle = build(cfg, device="cuda")
    params, _ = bundle.init(torch.Generator(device="cuda").manual_seed(SEED))
    table = ds.pack_experts(params["head"], ds.DSState(mask=stand_in_mask(cfg, "cuda")))
    torch.cuda.synchronize()
    n_rows = (table.ids >= 0).sum(dim=1).tolist()
    print(f"[slice] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.padded_vocab}, K {cfg.ds.num_experts}; table v_pad {table.v_pad}, rows "
          f"per expert {min(n_rows)}..{max(n_rows)}, {table.weights.nbytes / 2**30:.3f} GiB; "
          f"init + pack {time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)

    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in PROMPT_LENS]
    if not any(n % cfg.attn_q_chunk == 0 and n % cfg.attn_kv_chunk == 0
               and n // cfg.attn_q_chunk >= 2 for n in PROMPT_LENS):
        raise SmokeFailure("no prompt takes the multi-chunk branch of chunked attention")

    def serve(label, kern, record, tbl, **session_kw):
        t0 = time.perf_counter()
        # the breaker stays off: each session serves through the kernel it names
        sess = ServeSession(bundle, params, tbl, n_slots=N_SLOTS, max_seq_len=MAX_SEQ,
                            k=K_TOP, kernel=kern, device="cuda",
                            overflow_threshold=BREAKER_OFF, **session_kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        reqs = [Request(prompt=p, sampling=SamplingParams(
            max_new_tokens=NEW_TOKENS, temperature=0.8 if i == SAMPLED else 0.0,
            seed=SEED + i)) for i, p in enumerate(prompts)]
        rec = None
        if record:
            rec = Recorder(bundle, sess, reqs)
            sess.bundle = dataclasses.replace(bundle, prefill=rec.prefill,
                                              decode_step=rec.decode_step)
        t0 = time.perf_counter()
        sess.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = sess.stats()
        for r in reqs:
            if r.status is not RequestStatus.COMPLETED or len(r.out_tokens) != NEW_TOKENS:
                raise SmokeFailure(f"{label} {kern}: request ended {r.status} ({r.error}) "
                                   f"with {len(r.out_tokens)} tokens")
            if not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
                raise SmokeFailure(f"{label} {kern}: token outside the vocabulary")
        if st["n_admitted"] != len(prompts) or st["n_admitted"] <= N_SLOTS:
            raise SmokeFailure(f"{label} {kern}: slots were not reused ({st})")
        if st["effective_kernel"] != kern or st["breaker_trips"] != 0:
            raise SmokeFailure(f"{label} {kern}: served through {st['effective_kernel']!r} "
                               f"after {st['breaker_trips']} breaker trips")
        return [list(r.out_tokens) for r in reqs], wall, rec, st, setup_s, sess.table

    def row_of(label, kern, streams, wall, rec, delta, **extra):
        n_tok = sum(len(t) for t in streams)
        row = {"group": label, "kernel": kern, "tokens": n_tok, "wall_s": wall,
               "tokens_per_s": n_tok / wall,
               "decode_steps": len(rec.decode_s),
               "decode_step_ms_median": 1e3 * statistics.median(rec.decode_s),
               "prefill_ms_median": 1e3 * statistics.median(rec.prefill_s.values()),
               "prefill_ms_total": 1e3 * sum(rec.prefill_s.values()),
               "prefill_ms_longest": 1e3 * rec.prefill_s[PROMPT_LENS.index(max(PROMPT_LENS))],
               "launches": delta,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, **extra}
        results.setdefault("sessions", []).append(row)
        return row

    def need_launches(label, kern, quantized, delta):
        for n in NEEDS[(kern, quantized)]:
            if delta[n] < 1:
                raise SmokeFailure(f"{label} {kern}: kernel {n} never launched ({delta})")
        if kern == "jnp" and any(delta.values()):
            raise SmokeFailure(f"{label} jnp launched kernels ({delta})")

    # -- (fp) the slice-1 path: four serve paths on the bf16 table --------
    streams, heads = {}, {}
    ops.reset_launch_counts()  # the fp path starts here
    for kern in SESSION_KERNELS:
        before = ops.launch_counts()
        # tokens/s from run() as a user calls it; step times and the heads
        # for divergence reports from a second, instrumented run (a sync and
        # a read-back around every prefill and decode step).
        timed, wall, _, _, _, _ = serve("fp", kern, False, table)
        streams[kern], wall_rec, rec, _, _, _ = serve("fp", kern, True, table)
        if timed != streams[kern]:
            raise SmokeFailure(f"session {kern}: two runs on the same requests gave other tokens")
        delta = {n: c - before[n] for n, c in ops.launch_counts().items()}
        need_launches("fp", kern, False, delta)
        row = row_of("fp", kern, timed, wall, rec, delta,
                     tokens_per_s_instrumented=sum(map(len, timed)) / wall_rec)
        print(f"[slice] fp kernel={kern:12s} {row['tokens']} tokens in {wall:.3f} s = "
              f"{row['tokens_per_s']:.2f} tokens/s (uninstrumented run); instrumented run: "
              f"decode step median {row['decode_step_ms_median']:.2f} ms over "
              f"{row['decode_steps']} steps, prefill median {row['prefill_ms_median']:.2f} ms "
              f"(total {row['prefill_ms_total']:.1f} ms, {max(PROMPT_LENS)}-token prompt "
              f"{row['prefill_ms_longest']:.1f} ms); launches over both runs {delta}; "
              f"card {card}", flush=True)
        heads[kern] = rec.heads
    results["main_path_launches"] = {"fp": ops.launch_counts()}
    _diverge_check("fp", streams, heads, SESSION_KERNELS[:-1], "jnp", TIE_RTOL)
    print(f"[slice] fp: greedy and sampled streams agree across {', '.join(SESSION_KERNELS)}")

    # -- (int8) quantize='int8' sessions, each run once, instrumented ------
    K = cfg.ds.num_experts
    fb_half = torch.arange(K) % 2 == 1
    fb_table = ds.quantize_table(table, fb_mask=fb_half)
    groups = (("int8 (a) all rows int8", INT8_ALL_KERNELS, table,
               dict(quantize="int8", quantize_flip_threshold=1.0)),
              ("int8 (b) half fp fallback", INT8_FB_KERNELS, fb_table, {}))
    ops.reset_launch_counts()  # the int8 path starts here
    int8_table = None
    for label, kerns, tbl, kw in groups:
        g_streams, g_heads = {}, {}
        for kern in kerns:
            before = ops.launch_counts()
            g_streams[kern], wall, rec, st, setup_s, served = serve(label, kern, True, tbl, **kw)
            if not isinstance(served, ds.QuantizedServeTable):
                raise SmokeFailure(f"{label} {kern}: the session did not serve an int8 table")
            delta = {n: c - before[n] for n, c in ops.launch_counts().items()}
            need_launches(label, kern, True, delta)
            g_heads[kern] = rec.heads
            report_ = st["quantize_report"]
            row = row_of(label, kern, g_streams[kern], wall, rec, delta,
                         setup_s=setup_s, n_fallback=served.n_fallback,
                         quantize_report=report_)
            print(f"[slice] {label} kernel={kern:12s} {row['tokens']} tokens in {wall:.3f} s = "
                  f"{row['tokens_per_s']:.2f} tokens/s (instrumented run); decode step median "
                  f"{row['decode_step_ms_median']:.2f} ms over {row['decode_steps']} steps, "
                  f"prefill median {row['prefill_ms_median']:.2f} ms; session set-up "
                  f"(calibration included) {setup_s:.2f} s; {served.n_fallback} fallback "
                  f"experts; launches {delta}; card {card}", flush=True)
            if kern == "cuda_fused" and int8_table is None:
                int8_table = served
        n_div = _diverge_check(label, g_streams, g_heads, kerns[:-1], "jnp", TIE_RTOL)
        print(f"[slice] {label}: streams agree across {', '.join(kerns)} "
              f"({n_div} near-tie divergences)", flush=True)
    results["main_path_launches"]["int8"] = ops.launch_counts()

    # (c) the default exactness gate at full width
    before = ops.launch_counts()
    c_streams, wall, rec, st, setup_s, served = serve("int8 (c) gate 0.0", "auto", True,
                                                      table, quantize="int8")
    rep = st["quantize_report"]
    row_of("int8 (c) gate 0.0", "auto", c_streams, wall, rec,
           {n: c - before[n] for n, c in ops.launch_counts().items()},
           setup_s=setup_s, n_fallback=served.n_fallback, quantize_report=rep)
    print(f"[slice] int8 (c) default gate at full width: quantize_report "
          f"n_flips_raw {rep['n_flips_raw']} of {rep['n_tokens']}, n_fallback "
          f"{rep['n_fallback']} {rep['fallback_experts']}, passed {rep['passed']}; "
          f"per-expert flip rate {[round(r, 4) for r in rep['per_expert_flip_rate']]}; "
          f"set-up {setup_s:.2f} s", flush=True)
    results["quantize_report_default"] = rep
    if not rep["passed"]:
        raise SmokeFailure(f"int8 (c): the default exactness gate did not pass ({rep})")

    # -- (per-token) cuda_pertoken on the fp table -------------------------
    ops.reset_launch_counts()  # the per-token path starts here
    p_streams, wall, rec, _, _, _ = serve("per-token", "cuda_pertoken", True, table)
    delta = ops.launch_counts()
    need_launches("per-token", "cuda_pertoken", False, delta)
    results["main_path_launches"]["pertoken"] = delta
    row = row_of("per-token", "cuda_pertoken", p_streams, wall, rec, delta)
    print(f"[slice] per-token kernel=cuda_pertoken {row['tokens']} tokens in {wall:.3f} s = "
          f"{row['tokens_per_s']:.2f} tokens/s (instrumented run); decode step median "
          f"{row['decode_step_ms_median']:.2f} ms; launches {delta}; card {card}", flush=True)
    n_div = _diverge_check("per-token", {"cuda_pertoken": p_streams, "jnp": streams["jnp"]},
                           {"cuda_pertoken": rec.heads, "jnp": heads["jnp"]},
                           ("cuda_pertoken",), "jnp", FOLD_RTOL, greedy_only=True)
    print(f"[slice] per-token: stream agrees with the fp jnp session ({n_div} divergences, "
          f"each at a gap below 2^-7 relative)", flush=True)
    return cfg, bundle, params, (("cuda_fused", table), ("jnp", table),
                                 ("cuda_fused int8", int8_table))


# ---------------------------------------------------------------------------
# Phase 4: where a decode step's time goes
# ---------------------------------------------------------------------------

def _dev_time(e) -> float:
    """Self device time (µs) of a profiler event average, across versions."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


def profile_phase(results: dict, card: str, cfg, bundle, params, cases) -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train import Request, SamplingParams, ServeSession

    rng = np.random.RandomState(SEED + 2)
    for label, table in cases:
        kern = label.split()[0]
        sess = ServeSession(bundle, params, table, n_slots=N_SLOTS, max_seq_len=MAX_SEQ,
                            k=K_TOP, kernel=kern, device="cuda")
        for _ in range(N_SLOTS):
            sess.submit(Request(
                prompt=rng.randint(0, cfg.vocab_size, PROFILE_PROMPT).astype(np.int32),
                sampling=SamplingParams(max_new_tokens=PROFILE_STEPS + PROFILE_TRACED + 4)))
        sess.step()  # admits (prefills) all slots and runs the first decode step
        times = []
        for _ in range(PROFILE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_TRACED):
                sess.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        dev = [e for e in events if _dev_time(e) > 0 and "cuda" in str(e.device_type).lower()]
        busy_us = sum(_dev_time(e) for e in dev)
        row = {
            "kernel": label, "card": card,
            "step_ms_median": 1e3 * statistics.median(times),
            "traced_step_ms": 1e3 * wall / PROFILE_TRACED,
            "device_busy_ms_per_step": busy_us / 1e3 / PROFILE_TRACED,
            "device_idle_share": (1.0 - busy_us / 1e6 / wall) if busy_us else None,
            "device_ops_per_step": sum(e.count for e in dev) / PROFILE_TRACED,
            "host_syncs_and_copies_per_step":
                sum(e.count for e in events if e.key in SYNC_OPS) / PROFILE_TRACED,
            "top_device_ops_ms_per_step": [
                (e.key[:80], _dev_time(e) / 1e3 / PROFILE_TRACED)
                for e in sorted(dev, key=_dev_time, reverse=True)[:10]],
        }
        results.setdefault("profile", []).append(row)
        print(f"[profile] {json.dumps(row)}", flush=True)


# ---------------------------------------------------------------------------
# Phase 5: the adaptation path (repack, swap, the online loop, the breaker)
# ---------------------------------------------------------------------------

def _count_calls(module, name):
    """Wrap ``module.name`` so each call is counted; returns the counter
    (a list holding one int) and a function that restores the original."""
    orig, calls = getattr(module, name), [0]

    def counted(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)

    setattr(module, name, counted)
    return calls, lambda: setattr(module, name, orig)


def adapt_phase(results: dict, card: str, cfg, bundle, params, mask, gamma: float) -> None:
    import numpy as np
    import torch

    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import AdaptPolicy, repack_for_traffic
    from repro_torch.testing import skew_gate
    from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession

    skewed = skew_gate(params)
    state = ds.DSState(mask=mask)
    K = cfg.ds.num_experts
    rng = np.random.RandomState(SEED + 3)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in ADAPT_PROMPT_LENS]
    out = results.setdefault("adapt", {"card": card, "gamma": gamma})

    def session(kern, record=False, **kw):
        sess = ServeSession(bundle, skewed, state, n_slots=N_SLOTS,
                            max_seq_len=ADAPT_SEQ, k=K_TOP, kernel=kern, device="cuda", **kw)
        reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=ADAPT_NEW))
                for p in prompts]
        rec = None
        if record:
            rec = Recorder(bundle, sess, reqs)
            sess.bundle = dataclasses.replace(bundle, prefill=rec.prefill,
                                              decode_step=rec.decode_step)
        for r in reqs:
            sess.submit(r)
        return sess, reqs, rec

    def drained(label, sess, reqs):
        while sess.step():
            pass
        torch.cuda.synchronize()
        for r in reqs:
            if r.status is not RequestStatus.COMPLETED or len(r.out_tokens) != ADAPT_NEW:
                raise SmokeFailure(f"adapt {label}: request ended {r.status} ({r.error})")
        return [list(r.out_tokens) for r in reqs], sess.stats()

    def sync_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    plain_calls, restore = _count_calls(ref, "lasso_prune_ref")
    try:
        ops.reset_launch_counts()  # the adapt path starts here
        # -- (i) one repack swapped into three sessions at the same step ----
        sessions = {}
        for kern in ADAPT_KERNELS:
            sess, reqs, rec = session(kern, record=True, overflow_threshold=BREAKER_OFF)
            for _ in range(SWAP_AT):
                sess.step()
            sessions[kern] = (sess, reqs, rec)
        prof = sessions["cuda_grouped"][0].traffic_profile()
        if not prof.overflow_rate > 0.5:
            raise SmokeFailure(f"adapt (i): the skewed window did not overflow ({prof})")
        n_lasso = ops.launch_counts()["lasso_prune"]
        res, repack_s = sync_s(lambda: repack_for_traffic(
            skewed["head"], state, prof, prune_gamma=gamma, mitosis_overflow_threshold=0.1,
            generator=torch.Generator(device="cuda").manual_seed(SEED)))
        if res.cloned != (0,) or res.rows_pruned <= 0 \
                or ops.launch_counts()["lasso_prune"] != n_lasso + 1:
            raise SmokeFailure(f"adapt (i): repack cloned {res.cloned}, pruned "
                               f"{res.rows_pruned} rows, lasso launches "
                               f"{ops.launch_counts()['lasso_prune'] - n_lasso}")
        streams, heads, swap_s = {}, {}, {}
        v_pad_before = int(sessions["jnp"][0].table.v_pad)
        if not res.table.v_pad < v_pad_before:
            raise SmokeFailure(f"adapt (i): the re-pruned table's v_pad {res.table.v_pad} "
                               f"is not below {v_pad_before}")
        for kern, (sess, reqs, rec) in sessions.items():
            _, swap_s[kern] = sync_s(lambda: sess.swap_table(
                res.table, new_gate=res.head_params["gate"],
                capacity_factor=res.capacity_factor))
            streams[kern], st = drained(f"(i) {kern}", sess, reqs)
            heads[kern] = rec.heads
            if st["n_swaps"] != 1 or st["decode_builds"] != 2 or sess.table_version != 1:
                raise SmokeFailure(f"adapt (i) {kern}: swap accounting {st}")
        n_div = _diverge_check("adapt (i)", streams, heads, ADAPT_KERNELS[:-1], "jnp",
                               TIE_RTOL, sampled=None)
        lasso_ms = results["main"]["lasso_prune"]["ms"]
        out["explicit_swap"] = {
            "rows_pruned": res.rows_pruned, "cloned": list(res.cloned),
            "K": int(res.table.ids.shape[0]), "v_pad": int(res.table.v_pad),
            "v_pad_before": v_pad_before,
            "capacity_factor": res.capacity_factor, "window_overflow_rate": prof.overflow_rate,
            "repack_s": repack_s, "swap_s": swap_s, "lasso_ms": lasso_ms,
            "lasso_share_of_repack": lasso_ms / 1e3 / repack_s, "near_tie_divergences": n_div}
        print(f"[adapt] (i) repack of the skewed window (overflow {prof.overflow_rate:.3f}): "
              f"{res.rows_pruned} rows pruned at gamma {gamma:.6g}, cloned {res.cloned}, K "
              f"{K} -> {res.table.ids.shape[0]}, v_pad {v_pad_before} "
              f"-> {res.table.v_pad}, capacity factor {res.capacity_factor:.3g}; repack "
              f"{repack_s * 1e3:.1f} ms wall, lasso_prune kernel {lasso_ms:.4f} ms "
              f"({100 * lasso_ms / 1e3 / repack_s:.2f}% of it); swap wall ms "
              f"{ {k: round(v * 1e3, 3) for k, v in swap_s.items()} }; streams agree across "
              f"{', '.join(ADAPT_KERNELS)} ({n_div} near-tie divergences); card {card}",
              flush=True)
        del sessions, res

        # -- (ii) the online loop on cuda_grouped, breaker off --------------
        policy = AdaptPolicy(interval=SWAP_AT, min_window_steps=4, overflow_threshold=0.05,
                             mitosis_overflow_threshold=0.1, max_swaps=1, prune_gamma=gamma,
                             seed=SEED)
        n_lasso = ops.launch_counts()["lasso_prune"]
        sess, reqs, _ = session("cuda_grouped", overflow_threshold=BREAKER_OFF,
                                adapt_policy=policy)
        v_pad_first = int(sess.table.v_pad)
        before = None
        while True:
            more = sess.step()
            st = sess.stats()
            if st["n_swaps"] == 0:
                before = st["overflow_rate_window"]
            if not more:
                break
        _, st = drained("(ii)", sess, reqs)
        after = st["overflow_rate_window"]
        fails = [msg for ok, msg in (
            (st["n_swaps"] >= 1, "no swap"),
            (before is not None and after < before, f"window overflow {before} -> {after}"),
            (st["rows_pruned"] > 0, "no row pruned"),
            (ops.launch_counts()["lasso_prune"] - n_lasso >= 1, "lasso_prune never launched"),
            (st["decode_builds"] == 1 + st["n_swaps"], f"decode_builds {st['decode_builds']}"),
            (sess.table.v_pad < v_pad_first, f"v_pad {v_pad_first} -> {sess.table.v_pad}"),
        ) if not ok]
        if fails:
            raise SmokeFailure(f"adapt (ii): {'; '.join(fails)}")
        out["online_loop"] = {k: st[k] for k in (
            "n_swaps", "decode_builds", "rows_pruned", "effective_capacity_factor",
            "overflow_rate_window", "breaker_trips")}
        out["online_loop"].update(overflow_rate_window_before=before, v_pad_before=v_pad_first,
                                  v_pad=int(sess.table.v_pad))
        print(f"[adapt] (ii) AdaptPolicy on cuda_grouped: {st['n_swaps']} swap(s), window "
              f"overflow {before:.3f} -> {after:.3f}, {st['rows_pruned']} rows pruned, "
              f"v_pad {v_pad_first} -> {sess.table.v_pad}, "
              f"capacity factor -> {st['effective_capacity_factor']:.3g}, decode_builds "
              f"{st['decode_builds']}", flush=True)
        del sess

        # -- (iii) the breaker: trip 1, then trip 2 to the fused kernel ------
        sess, reqs, rec = session("cuda_grouped", record=True)
        fused_first, fused_at_trip2 = ops.launch_counts()["dss_topk_fused"], None
        while sess.step():
            if fused_at_trip2 is None and sess.stats()["breaker_trips"] == 2:
                fused_at_trip2 = ops.launch_counts()["dss_topk_fused"]
        b_streams, st = drained("(iii)", sess, reqs)
        fused_after = ops.launch_counts()["dss_topk_fused"] - (fused_at_trip2 or 0)
        if st["breaker_trips"] != 2 or st["effective_kernel"] != "cuda_fused" \
                or st["effective_capacity_factor"] != 2 * cfg.ds.capacity_factor \
                or st["decode_builds"] != 3 or fused_at_trip2 != fused_first \
                or fused_after < 1:
            raise SmokeFailure(f"adapt (iii): breaker state {st}; dss_topk_fused launches "
                               f"before trip 2 {(fused_at_trip2 or fused_first) - fused_first}, "
                               f"after it {fused_after}")
        plain, plain_reqs, plain_rec = session("jnp", record=True)
        p_streams, _ = drained("(iii) plain", plain, plain_reqs)
        n_div = _diverge_check("adapt (iii)", {"breaker": b_streams, "jnp": p_streams},
                               {"breaker": rec.heads, "jnp": plain_rec.heads}, ("breaker",),
                               "jnp", TIE_RTOL, sampled=None)
        out["breaker"] = {k: st[k] for k in ("breaker_trips", "effective_kernel",
                                              "effective_capacity_factor", "decode_builds",
                                              "overflow_rate")}
        out["breaker"]["fused_launches_after_trip_2"] = fused_after
        print(f"[adapt] (iii) breaker: {st['breaker_trips']} trips, capacity factor "
              f"{st['effective_capacity_factor']}, then kernel {st['effective_kernel']!r} "
              f"(dss_topk_fused launched {fused_after} times after trip 2); streams agree "
              f"with an unswapped jnp session ({n_div} near-tie divergences)", flush=True)
        del sess, plain

        # -- (iv) an int8 session stays quantized across a swap -------------
        sess, reqs, _ = session("cuda_grouped", overflow_threshold=BREAKER_OFF,
                                quantize="int8", quantize_flip_threshold=1.0,
                                adapt_policy=dataclasses.replace(policy, interval=10**9))
        for _ in range(SWAP_AT):
            sess.step()
        rep_before = sess.stats()["quantize_report"]
        _, swap_q_s = sync_s(sess.adapt_now)
        n_q = ops.launch_counts()["dss_topk_grouped_q"]
        _, st = drained("(iv)", sess, reqs)
        rep_after = st["quantize_report"]
        n_q = ops.launch_counts()["dss_topk_grouped_q"] - n_q
        if not isinstance(sess.table, ds.QuantizedServeTable) or st["n_swaps"] != 1 \
                or len(rep_after["per_expert_flip_rate"]) != K + 1 \
                or len(rep_before["per_expert_flip_rate"]) != K or n_q < 1:
            raise SmokeFailure(f"adapt (iv): after the swap the table is "
                               f"{type(sess.table).__name__}, report {rep_after}, "
                               f"int8 launches since {n_q}")
        out["int8"] = {"adapt_now_s": swap_q_s, "n_fallback_after": rep_after["n_fallback"],
                       "int8_launches_after_swap": n_q}
        print(f"[adapt] (iv) int8 session: adapt_now (repack + gate + swap) "
              f"{swap_q_s * 1e3:.1f} ms wall; still int8 after the swap (K {K + 1}, "
              f"{rep_after['n_fallback']} fallback experts, report refreshed); "
              f"dss_topk_grouped_q launched {out['int8']['int8_launches_after_swap']} times "
              f"after it", flush=True)
        del sess
    finally:
        restore()
    if plain_calls[0]:
        raise SmokeFailure(f"adapt: lasso_prune's plain version ran {plain_calls[0]} times")
    counts = ops.launch_counts()
    results["main_path_launches"]["adapt"] = counts
    missing = [n for n in ADAPT_NEEDS if counts[n] < 1]
    if missing:
        raise SmokeFailure(f"adapt: kernels {missing} never launched ({counts})")
    print(f"[adapt] launches over the adapt path: {counts}", flush=True)
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    per_lib = _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(per_lib) or 'nothing (cached)'}; "
          f"per library {json.dumps({n: round(s, 2) for n, s in per_lib.items()})}")
    for n in _build.SOURCES:
        for line in _build.build_log(n).splitlines():
            if "Used" in line:
                print(f"[build] {n}: {line.strip()}")

    results: dict = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    kernel_phase(results)
    cfg, bundle, params, cases = slice_phase(results, card)
    mask = stand_in_mask(cfg, "cuda")
    gamma = lasso_phase(results, params["head"]["experts"], mask)
    profile_phase(results, card, cfg, bundle, params, cases)
    adapt_phase(results, card, cfg, bundle, params, mask, gamma)

    from repro_torch.kernels import ops

    csrc = "src/repro_torch/csrc/"
    # body -> (source, the TPU kernel it replaces, the path whose run counts it)
    bodies = {
        "gate_top1": ("gate_top1.cu", "src/repro/kernels/gate_top1.py:43", "fp"),
        "dss_topk_grouped": ("dss_topk_grouped.cu", "src/repro/kernels/dss_topk_grouped.py:221",
                             "fp"),
        "dss_topk_grouped_q": ("dss_topk_grouped.cu",
                               "src/repro/kernels/dss_topk_grouped.py:148", "int8"),
        "dss_topk_fused": ("dss_topk_fused.cu", "src/repro/kernels/dss_topk_fused.py:197", "fp"),
        "dss_topk_fused_q": ("dss_topk_fused.cu", "src/repro/kernels/dss_topk_fused.py:120",
                             "int8"),
        "dss_topk": ("dss_topk.cu", "src/repro/kernels/dss_topk.py:110", "pertoken"),
        "lasso_prune": ("lasso_prune.cu", "src/repro/kernels/lasso_prune.py:41", "adapt"),
    }
    if set(bodies) != {name for name, _, _ in ops.BODIES}:
        raise SmokeFailure("the report does not list every kernel body")
    kernels = []
    for name, (src, replaces, path) in bodies.items():
        m = results["main"][name]
        launches = results["main_path_launches"][path][name]
        if launches < 1:
            raise SmokeFailure(f"{name} never launched on its main path ({path})")
        kernels.append({"name": name, "route": "cuda", "source": csrc + src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                        "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
