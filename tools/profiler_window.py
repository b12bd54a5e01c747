"""Which device records ``torch.profiler`` keeps as a process ages.

The same work is profiled every ``--every`` seconds for ``--minutes``
minutes, the card kept busy with matmuls in between. Each profile holds
its host-side launches (the runtime's launch calls) against its device
records by correlation id: how many launches found no record, and how
far each kept record starts after its launch (a kernel cannot start
before it was launched, so a negative gap is the device clock read
against the host's). Four windows each time: ``tight`` (the calls, one
synchronize), ``padded`` (``--pad-ms`` of host sleep on each side),
``tail`` (the calls, then TAIL one-element adds, then a synchronize) and
``tail+pad`` (both). Only the launches of the calls themselves are
counted.

    python3 tools/profiler_window.py [--minutes 6] [--every 20] [--pad-ms 50]

Prints one JSON line per profile and writes them all to
``chiprun_out/profiler_window.json``.
"""
import argparse
import json
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
CALLS, TAIL = 5, 64


def _one(fn, pad_s: float, tail) -> dict:
    fn()
    torch.cuda.synchronize()
    t_in = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(CALLS):
            fn()
        t_tail = time.time_ns()
        if tail is not None:
            for _ in range(TAIL):
                tail.add_(1)
        torch.cuda.synchronize()
        time.sleep(pad_s)
    t_out = time.time_ns()
    host, dev = {}, {}
    for e in prof.profiler.kineto_results.events():
        if "cuda" in str(e.device_type()).lower():
            if not e.is_user_annotation():
                dev[e.correlation_id()] = (e.start_ns(), e.end_ns())
        elif e.name() in LAUNCHES and e.start_ns() < t_tail:
            host[e.correlation_id()] = (e.start_ns(), e.end_ns())
    gaps = [(dev[c][0] - host[c][0]) / 1e3 for c in host if c in dev]
    lost = sorted(host[c][0] for c in host if c not in dev)
    kept_end = max((dev[c][1] for c in host if c in dev), default=None)
    return {"launches": len(host), "records": len(dev), "lost": len(lost),
            "gap_us_min": min(gaps, default=None), "gap_us_max": max(gaps, default=None),
            "window_ms": (t_out - t_in) / 1e6,
            # where the lost launches sat in the host's window, in ms from its start
            "lost_at_ms": [round((t - t_in) / 1e6, 3) for t in lost[:8]],
            "last_kept_end_ms": None if kept_end is None else round((kept_end - t_in) / 1e6, 3)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=6.0)
    ap.add_argument("--every", type=float, default=20.0)
    ap.add_argument("--pad-ms", type=float, default=50.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_window: needs a CUDA card")
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    # a decode head's product (8 tokens against 128,256 bf16 rows of 3072)
    # and a long one (512 tokens), both issued without a host sync
    w = torch.randn((128256, 3072), generator=gen, device="cuda").to(torch.bfloat16)
    h8 = torch.randn((8, 3072), generator=gen, device="cuda").to(torch.bfloat16)
    h512 = torch.randn((512, 3072), generator=gen, device="cuda").to(torch.bfloat16)
    work = {"head_b8": lambda: torch.topk(h8 @ w.T, 8),
            "head_b512": lambda: torch.topk(h512 @ w.T, 8)}
    one = torch.zeros(1, device="cuda")
    windows = {"tight": (0.0, None), "padded": (args.pad_ms / 1e3, None),
               "tail": (0.0, one), "tail+pad": (args.pad_ms / 1e3, one)}
    rows, t0 = [], time.perf_counter()
    while True:
        age = time.perf_counter() - t0
        for name, fn in work.items():
            for pad, (pad_s, tail) in windows.items():
                row = {"age_s": round(age, 1), "work": name, "window": pad,
                       **_one(fn, pad_s, tail)}
                rows.append(row)
                print(json.dumps(row), flush=True)
        if age > 60 * args.minutes:
            break
        t = time.perf_counter()
        while time.perf_counter() - t < args.every:  # keep the card busy meanwhile
            for _ in range(50):
                h512 @ w.T
            torch.cuda.synchronize()
    out = Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profiler_window.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
