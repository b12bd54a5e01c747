#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero before the result line):

1. Device and build: the card's name and power limit, TF32 off, the
   four CUDA libraries built from ``src/repro_torch/csrc`` (one ``nvcc``
   each, all at once).
2. Every kernel body against its plain PyTorch version at full width
   (d 1536, K 16, k 8; bf16 and fp32; int8 rows for the ``_q`` bodies):
   ids equal, values within the stated tolerance, kernel / plain /
   library-call times (CUDA events, median of 25 after warm-up).
3. The slice: qwen2-1.5b at full width (28 layers, seeded weights, a
   seeded stand-in for a trained expert mask) served by ``ServeSession``
   through 8 slots, 12 requests (one prompt of 2048 tokens, so chunked
   attention merges two query chunks).
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
5. Report: one ``{"kernels": [...]}`` line (six kernel bodies), the card
   line, and as the last line ``{"ok": true, "device": {...}}``.

Without CUDA it exits with code 2 and prints no result. It imports only
torch, numpy and the port.
"""
from __future__ import annotations

import dataclasses
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


def _compare(name, case, got, want):
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
    if not torch.allclose(gv[fin], wv[fin], rtol=VAL_RTOL, atol=VAL_ATOL):
        raise SmokeFailure(f"{name} {case}: values differ by up to {err}")
    return err, ids_equal


def kernel_phase(results: dict) -> None:
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    K, d, k = 16, 1536, 8
    bf16, f32 = torch.bfloat16, torch.float32

    def report(name, case, got, want, t_kernel, t_plain, t_lib, nbytes, flops, dtype,
               main=False):
        err, ids_equal = _compare(name, case, got, want)
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


def _diverge_check(label, streams, heads, kerns, ref_kern, rtol, greedy_only=False):
    """Each stream of ``kerns`` must equal ``ref_kern``'s, or leave it only
    at a near-tie of the reference (top-1/top-2 gap below ``rtol``
    relative); the sampled request must match exactly unless
    ``greedy_only``. Prints every divergence; returns their count."""
    n = 0
    for kern in kerns:
        for i, (a, b) in enumerate(zip(streams[kern], streams[ref_kern])):
            if a == b or (greedy_only and i == SAMPLED):
                continue
            n += 1
            j = next(m for m, (x, y) in enumerate(zip(a, b)) if x != y)
            rv, ri = heads[ref_kern][i][j]
            kv, ki = heads[kern][i][j]
            gap = float(rv[0] - rv[1])
            print(f"[slice] {label}: request {i} diverges at emission {j}: {ref_kern} top-2 "
                  f"{rv[:2].tolist()} ids {ri[:2].tolist()}; {kern} top-2 "
                  f"{kv[:2].tolist()} ids {ki[:2].tolist()}; gap {gap:.3g}")
            if i == SAMPLED or gap > rtol * max(1.0, abs(float(rv[0]))):
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
        sess = ServeSession(bundle, params, tbl, n_slots=N_SLOTS, max_seq_len=MAX_SEQ,
                            k=K_TOP, kernel=kern, device="cuda", **session_kw)
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
    profile_phase(results, card, *slice_phase(results, card))

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
