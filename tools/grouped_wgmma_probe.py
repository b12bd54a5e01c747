"""Probe the tensor-core grouped bodies (``dss_topk_grouped_wgmma`` / ``_q``)
on the card: where a row tile's time goes, and what a variant of the
source costs, beside the parent commit's body in one process.

- ``--stamps``: a copy of this tree's ``csrc/`` with ``clock64`` stamps at
  each phase of a row tile (thread 0 of each consumer warpgroup, into a
  ``__device__`` array read back by an ``extern "C"`` getter), run once at
  phase 2's C 256 and at qwen2-1.5b's verify head; prints the mean µs a
  tile of each phase, first tile and later tiles apart. With ``--parent``
  the parent's source gets the stamps of its own epilogue (slot rounds).
- ``--variant NAME`` (repeatable): a copy of this tree's source with the
  text substitutions of ``VARIANTS[NAME]``; its outputs must equal this
  tree's (``torch.equal``). ``--parent-variant NAME`` likewise patches the
  parent's source (``PARENT_VARIANTS``), timed as ``parent_NAME``.
- Every body is timed device-only (``chip_smoke.device_ms``: 20 calls in a
  CUDA graph) at C 256 and at ``chip_smoke.VERIFY_HEADS``, bf16 and int8
  rows, in the order parent, this, variants, then backwards.

Patched sources and their libraries go to ``build/probe/`` (ignored by
git); the shipped source is never changed.

    python3 tools/grouped_wgmma_probe.py [--parent build/parent
        [--parent-variant wait0]] [--stamps] [--variant int8_serial ...]

on a host with one NVIDIA GPU and ``nvcc``.

Prints the card, each build's ptxas registers and spills, one ``[time]``
line per case and one ``[stamps]`` line per stamped run; writes all of it
to ``chiprun_out/grouped_wgmma_probe.json``.
"""
import argparse
import ctypes
import importlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.core.dssoftmax import ServeTable, quantize_table  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

G = importlib.import_module("repro_torch.kernels.dss_topk_grouped")
OUT = ROOT / "build" / "probe"
SLOTS = 2048 * 2 * 192  # stamps: blocks x consumer warpgroups x (16 tiles x 12)

# Text substitutions on this tree's csrc/dss_topk_grouped.cu, each a
# (old, new) pair that must occur once.
VARIANTS = {
    # int8 rows widened in series at every token tile
    "int8_serial": [("constexpr bool kPipe = Q && N >= 128;", "constexpr bool kPipe = false;")],
    # int8 rows widened under the products at every token tile
    "int8_pipe_all": [("constexpr bool kPipe = Q && N >= 128;", "constexpr bool kPipe = Q;")],
    # barrier waits spin instead of sleeping in the barrier
    "spin": [("__device__ __forceinline__ void mbar_sleep(uint32_t bar, uint32_t parity) {\n",
              "__device__ __forceinline__ void mbar_sleep(uint32_t bar, uint32_t parity) {\n"
              "  repro::mbar_wait(bar, parity);\n  return;\n")],
}

# Text substitutions on the parent's source (a checkout of the commit
# before the redesign), for ``--parent-variant``.
PARENT_VARIANTS = {
    # the tile's last wgmma wait made unconditional (bf16 rows)
    "wait0": [("""      if (prev >= 0) {
        repro::wgmma_wait<0>();
        repro::fence_regs(acc);
        repro::mbar_arrive(empty(prev));
      }
""", """      repro::wgmma_wait<0>();
      repro::fence_regs(acc);
      if (prev >= 0) repro::mbar_arrive(empty(prev));
""")],
}

_GETTER = """
extern "C" int probe_get_stamps(void* host, long long bytes) {
  return cudaMemcpyFromSymbol(host, wg::g_stamps, bytes);
}
"""
_HEAD = ("namespace wg {\n__device__ long long g_stamps[2048 * 2 * 192];\n"
         "#define STAMP(t, s) do { if (ct_ == 0) st_[min(t, 14) * 12 + (s)] = clock64(); } while (0)\n"
         "#define STAMPV(t, s, v) do { if (ct_ == 0) st_[min(t, 14) * 12 + (s)] = (v); } while (0)\n")
_BLOCK = ("  const int blk_ = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;\n"
          "  long long* st_ = g_stamps + (static_cast<size_t>(min(blk_, 2047)) * 2 + wgi) * 192;\n"
          "  const int ct_ = threadIdx.x % 128;\n"
          "  if (ct_ == 0) {\n"
          "    unsigned long long gt;\n"
          "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt));\n"
          "    st_[15 * 12 + 0] = gt; st_[15 * 12 + 1] = clock64(); st_[15 * 12 + 4] = n_tiles;\n"
          "  }\n")
_END = ("  if (ct_ == 0) {\n"
        "    unsigned long long gt;\n"
        "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt));\n"
        "    st_[15 * 12 + 2] = gt; st_[15 * 12 + 3] = clock64();\n"
        "  }\n")

# Stamp slots of this tree's body: 0 tile start, 1 products done, 2 first
# tile's seed done, 3 barrier before the filter passed, 4 filter and queue
# done, 5 barrier before the merge passed, 6 merge done; values: 8 the
# thread's candidates, 9 cycles waiting on `full`.
THIS_PHASES = ["products", "seed", "barrier", "filter", "barrier2", "merge"]
THIS_STAMPS = [
    ("namespace wg {\n", _HEAD),
    ("  const int row0 = 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8\n",
     "  const int row0 = 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8\n" + _BLOCK),
    ("  for (int tile = 0; tile < n_tiles; ++tile) {\n    int pos[2];",
     "  for (int tile = 0; tile < n_tiles; ++tile) {\n    STAMP(tile, 0);\n    long long wsum_ = 0;\n"
     "    int ncand_ = 0;\n    int pos[2];"),
    ("        mbar_sleep(full(s), (st / stages) & 1);\n",
     "        const long long w0_ = clock64();\n        mbar_sleep(full(s), (st / stages) & 1);\n"
     "        wsum_ += clock64() - w0_;\n"),
    ("    // a row's value before x g: x scale[row]",
     "    STAMP(tile, 1);\n    // a row's value before x g: x scale[row]"),
    ("    if (tile > 0) bar_sync(1, kConsumers);\n",
     "    STAMP(tile, 2);\n    if (tile > 0) bar_sync(1, kConsumers);\n    STAMP(tile, 3);\n"),
    ("        const int slot = atomicAdd(&cnt[col], 1);\n",
     "        const int slot = atomicAdd(&cnt[col], 1);\n        ++ncand_;\n"),
    ("    bar_sync(1, kConsumers);\n    const int t = threadIdx.x;\n",
     "    STAMP(tile, 4);\n    bar_sync(1, kConsumers);\n    STAMP(tile, 5);\n"
     "    const int t = threadIdx.x;\n"),
    ("      lob[t] = u_bound(key_value(kth), gs[t]);\n    }\n  }\n",
     "      lob[t] = u_bound(key_value(kth), gs[t]);\n    }\n    STAMP(tile, 6);\n"
     "    STAMPV(tile, 8, ncand_);\n    STAMPV(tile, 9, wsum_);\n  }\n" + _END),
]

# Stamp slots of the parent's body (slot rounds on the consumers): 0 tile
# start, 1 products done, 2 z pass, 3 first tile's seed, 4 slot atomics, 5
# bar_any, 6 insert round, 7 named barrier, 8 further rounds done; values:
# 9 cycles waiting on `full`, 10 further rounds.
PARENT_PHASES = ["products", "z pass", "seed", "take_slots", "bar_any", "insert", "barrier",
                 "further rounds"]
PARENT_STAMPS = [
    ("namespace wg {\n", _HEAD),
    ("  const int ct = threadIdx.x % 128;\n  const int bar_id = 1 + wgi;\n",
     "  const int ct = threadIdx.x % 128;\n  const int bar_id = 1 + wgi;\n" + _BLOCK),
    ("  for (int tile = 0; tile < n_tiles; ++tile) {\n    int pos[2];",
     "  for (int tile = 0; tile < n_tiles; ++tile) {\n    STAMP(tile, 0);\n    long long wsum_ = 0;\n"
     "    int rounds_ = 0;\n    int pos[2];"),
    ("      repro::mbar_wait(full(s), (st / stages) & 1);\n      const uint32_t rows",
     "      const long long w0_ = clock64();\n      repro::mbar_wait(full(s), (st / stages) & 1);\n"
     "      wsum_ += clock64() - w0_;\n      const uint32_t rows"),
    ("    // z on the accumulators, in place", "    STAMP(tile, 1);\n    // z on the accumulators, in place"),
    ("    if (tile == 0) {\n      // The first tile", "    STAMP(tile, 2);\n    if (tile == 0) {\n      // The first tile"),
    ("    take_slots(pend, false);\n    bool any_pend = false;",
     "    STAMP(tile, 3);\n    take_slots(pend, false);\n    STAMP(tile, 4);\n    bool any_pend = false;"),
    ("    bool more = bar_any(bar_id, 128, any_pend);\n    insert_round();\n    bar_sync(bar_id, 128);\n",
     "    bool more = bar_any(bar_id, 128, any_pend);\n    STAMP(tile, 5);\n    insert_round();\n"
     "    STAMP(tile, 6);\n    bar_sync(bar_id, 128);\n    STAMP(tile, 7);\n"),
    ("      insert_round();\n      bar_sync(bar_id, 128);\n    }\n  }\n",
     "      insert_round();\n      bar_sync(bar_id, 128);\n      ++rounds_;\n    }\n    STAMP(tile, 8);\n"
     "    STAMPV(tile, 9, wsum_);\n    STAMPV(tile, 10, rounds_);\n  }\n" + _END),
]


def patched(name: str, csrc: Path, subs) -> Path:
    """A copy of ``csrc`` under build/probe/<name>/ with ``subs`` applied
    to dss_topk_grouped.cu (each must occur once)."""
    dst = OUT / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    f = dst / "dss_topk_grouped.cu"
    src = f.read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the source has {src.count(old)} of {old[:60]!r}")
        src = src.replace(old, new)
    f.write_text(src + (_GETTER if "g_stamps" in src else ""))
    return dst


def build(named_dirs: dict, signature) -> dict:
    """nvcc each directory's dss_topk_grouped.cu (all at once) and load it."""
    procs = {n: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
                                  str(OUT / f"{n}.so"), str(d / "dss_topk_grouped.cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n, d in named_dirs.items()}
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{n} did not build:\n{log[-4000:]}")
        lines = log.splitlines()
        wg = [lines[i + 2].strip() + " | " + lines[i + 3].split(":", 1)[1].strip()
              for i, ln in enumerate(lines) if "Compiling entry" in ln and "wgmma_kernel" in ln]
        serial = sum("(C75" in ln and "wgmma_kernel" in ln for ln in lines)
        print(f"[build] {n}: tensor-core bodies, the most spilling: "
              f"{max(wg, key=lambda x: int(x.split()[4]))}; C75xx lines {serial}", flush=True)
        lib = ctypes.CDLL(str(OUT / f"{n}.so"))
        lib.dss_topk_grouped_wgmma.argtypes = signature(n)
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        libs[n] = lib
    return libs


def this_call(lib, w, ids, buf, g_buf, k, sc):
    """This tree's wrapper's launch of WGMMA through ``lib``."""
    K, v_pad, d = w.shape
    C = buf.shape[1]
    plan = G.wgmma_plan(K, C, v_pad, k, sc is not None)
    out_v = torch.empty((K, C, k), dtype=torch.float32, device="cuda")
    out_i = torch.empty((K, C, k), dtype=torch.int32, device="cuda")
    part = [torch.empty((plan.nsplit, K, C, k), dtype=t, device="cuda") if plan.nsplit > 1
            else None for t in (torch.float32, torch.int32)]
    spill = torch.empty((G.wgmma_spill_pairs(plan, K), 2), dtype=torch.float32, device="cuda")
    err = lib.dss_topk_grouped_wgmma(
        buf.data_ptr(), g_buf.data_ptr(), w.data_ptr(), ids.data_ptr(), _build.ptr(sc),
        out_v.data_ptr(), out_i.data_ptr(), _build.ptr(part[0]), _build.ptr(part[1]),
        spill.data_ptr(), K, C, v_pad, d, k, plan.n_tile, plan.nsplit, plan.tiles_per_split,
        plan.stages, _build.weight_code(w), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "probe")
    return out_v, out_i


def stamped(lib, call, nblk, phases, value_slots):
    """Run ``call`` once and read the stamps: mean µs a tile per phase and
    the mean of each value slot, first tile and later tiles apart."""
    host = np.zeros(SLOTS, dtype=np.int64)
    call()
    torch.cuda.synchronize()
    lib.probe_get_stamps.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    assert lib.probe_get_stamps(host.ctypes.data, host.nbytes) == 0
    st = host[:nblk * 2 * 192].reshape(nblk, 2, 16, 12).astype(np.float64)
    c = st[:, :, 15]
    per_ns = np.median((c[..., 3] - c[..., 1]) / (c[..., 2] - c[..., 0]))
    nt = int(c[0, 0, 4])
    out = {"cycles_per_ns": float(per_ns),
           "block_us": float(np.median((c[..., 2] - c[..., 0]) / 1e3)),
           "block_us_max": float(((c[..., 2] - c[..., 0]) / 1e3).max())}
    for key, sel in (("first", slice(0, 1)), ("later", slice(1, nt))):
        x = st[:, :, sel, :]
        d = {n: float(np.mean(x[..., i + 1] - x[..., i]) / per_ns / 1e3)
             for i, n in enumerate(phases)}
        for name, slot, cycles in value_slots:
            v = float(np.mean(x[..., slot]))
            d[name] = v / per_ns / 1e3 if cycles else v
        out[key] = d
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="a checkout of the parent commit")
    ap.add_argument("--stamps", action="store_true", help="per-phase stamps of a row tile")
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS))
    ap.add_argument("--parent-variant", action="append", default=[],
                    choices=sorted(PARENT_VARIANTS))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grouped_wgmma_probe: needs a GPU", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    card = cs.card_line()
    print(card, flush=True)
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    dirs = {n: patched(n, csrc, VARIANTS[n]) for n in a.variant}
    if a.stamps:
        dirs["this_stamps"] = patched("this_stamps", csrc, THIS_STAMPS)
    parent_sig = None
    if a.parent:
        cs.PARENT = Path(a.parent).resolve()
        parent_sig = cs._parent_module("_build").SIGNATURES["dss_topk_grouped_wgmma"]
        pcsrc = cs.PARENT / "src" / "repro_torch" / "csrc"
        if a.stamps:
            dirs["parent_stamps"] = patched("parent_stamps", pcsrc, PARENT_STAMPS)
        for n in a.parent_variant:
            dirs[f"parent_{n}"] = patched(f"parent_{n}", pcsrc, PARENT_VARIANTS[n])
    libs = {"this": _build.load("dss_topk_grouped")}
    libs.update(build(dirs, lambda n: parent_sig if n.startswith("parent")
                      else _build.SIGNATURES["dss_topk_grouped_wgmma"]))
    if a.parent:
        cs.build_parent()

    def runner(name):
        if name == "parent":
            return lambda *x: cs.parent_grouped_wgmma(*x)
        if name.startswith("parent_"):
            return lambda *x: with_lib(cs._PARENT_LIBS, "dss_topk_grouped", libs[name],
                                       lambda: cs.parent_grouped_wgmma(*x))
        return lambda *x: this_call(libs[name], *x)

    timed = (["parent"] + [f"parent_{n}" for n in a.parent_variant] if a.parent else []) + \
        ["this"] + list(a.variant)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 7)
    results = {"card": card, "timings": {}, "stamps": {}}
    for K, C, d, v_pad in [(16, 256, 1536, 12032)] + [v[1:] for v in cs.VERIFY_HEADS]:
        for q in (False, True):
            label = f"C{C} d{d} v_pad{v_pad} {'int8' if q else 'bf16'} rows"
            w, ids = cs._table(gen, K, v_pad, d, torch.bfloat16)
            buf = torch.randn((K, C, d), generator=gen, device="cuda").to(torch.bfloat16)
            g_buf = torch.rand((K, C), generator=gen, device="cuda")
            sc = None
            if q:
                qt = quantize_table(ServeTable(ids=ids, weights=w))
                w, sc = qt.qweights, qt.scales
            args = (w, ids, buf, g_buf, 8, sc)
            want = this_call(libs["this"], *args)
            for n in list(a.variant) + [f"parent_{v}" for v in a.parent_variant]:
                got = runner(n)(*args)
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise SystemExit(f"{n} {label}: the output differs from this tree's")
            t = {n: [] for n in timed}
            for n in timed + timed[::-1]:
                t[n].append(cs.device_ms(lambda: runner(n)(*args)))
            results["timings"][label] = t
            print(f"[time] {label}: "
                  + "  ".join(f"{n} {v[0]:.4f}/{v[1]:.4f}" for n, v in t.items()), flush=True)
            if not a.stamps or C not in (256, 5) or d != 1536:
                continue
            plan = G.wgmma_plan(K, C, v_pad, 8, q)
            nblk = plan.nsplit * plan.token_tiles * K
            r = stamped(libs["this_stamps"], lambda: this_call(libs["this_stamps"], *args), nblk,
                        THIS_PHASES, [("candidates", 8, False), ("full_wait", 9, True)])
            results["stamps"][f"this {label}"] = r
            print(f"[stamps] this {label}: {json.dumps(r)}", flush=True)
            if a.parent:
                pplan = cs._parent_module("dss_topk_grouped").wgmma_plan(K, C, v_pad, 8, q)
                r = stamped(libs["parent_stamps"], lambda: runner("parent_stamps")(*args),
                            pplan.nsplit * pplan.token_tiles * K, PARENT_PHASES,
                            [("full_wait", 9, True), ("further_rounds", 10, False)])
                results["stamps"][f"parent {label}"] = r
                print(f"[stamps] parent {label}: {json.dumps(r)}", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "grouped_wgmma_probe.json").write_text(json.dumps(results, indent=1))
    return 0


def with_lib(table, key, lib, fn):
    """Call ``fn`` with ``table[key]`` swapped for ``lib``."""
    old = table[key]
    table[key] = lib
    try:
        return fn()
    finally:
        table[key] = old


if __name__ == "__main__":
    sys.exit(main())
