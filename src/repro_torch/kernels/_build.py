"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, into ``build/repro_torch/`` at the root of the
checkout (listed in ``.gitignore``), and is keyed by a hash of the
sources and flags, so a changed source rebuilds. :func:`build_all`
starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("gate_top1", "dss_topk_grouped", "dss_topk_fused", "dss_topk", "lasso_prune",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signature of each entry point (all return cudaError_t as int). An entry
# point lives in the library of its own name, or in ENTRY_LIBRARY's.
SIGNATURES = {
    # gate_w, h, idx, g, B, K, d, dtype, stream
    "gate_top1": [_P] * 4 + [_I] * 4 + [_P],
    # buf, g_buf, w, ids, scales, out_v, out_i, part_v, part_p, n_sel,
    # K, C, v_pad, d, k, grid, vec_bytes, dtype, wdtype, stream
    "dss_topk_grouped": [_P] * 10 + [_I] * 9 + [_P],
    # buf, g_buf, w, ids, scales, out_v, out_i, part_v, part_i, next_item,
    # lows, K, C, v_pad, d, k, n_tile, tiles_per_chunk, big_tiles, nchunk,
    # tma, dtype, wdtype, stream
    "dss_topk_grouped_tiled": [_P] * 11 + [_I] * 12 + [_P],
    # buf, g_buf, w, ids, scales, out_v, out_i, part_v, part_i, spill,
    # K, C, v_pad, d, k, n_tile, nsplit, tiles_per_split, stages, wdtype, stream
    "dss_topk_grouped_wgmma": [_P] * 10 + [_I] * 10 + [_P],
    # gate_w, w, ids, scales, h, out_v, out_i, out_e, g, part_v, part_p,
    # n_sel, K_real, K, B, v_pad, d, k, e_base, grid, vec_bytes, dtype,
    # wdtype, stream
    "dss_topk_fused": [_P] * 12 + [_I] * 11 + [_P],
    # w, ids, h_scaled, expert_idx, out_v, out_i, part_v, part_p, n_sel,
    # K, B, v_pad, d, k, grid, vec_bytes, dtype, stream
    "dss_topk": [_P] * 9 + [_I] * 8 + [_P],
    # w, mask, norms, new_mask, rows, d, gamma, dtype, blocks, stream
    "lasso_prune": [_P] * 4 + [_L, _I, _F, _I, _I, _P],
    # q, k, v, o, (batch, head, sequence) element strides of q, k, v, o,
    # B, H, H_kv, S, dh, dtype, body (0 CUDA cores, 1 wgmma), stream
    "flash_attention": [_P] * 4 + [_L] * 12 + [_I] * 7 + [_P],
}
ENTRY_LIBRARY = {"dss_topk_grouped_tiled": "dss_topk_grouped",
                 "dss_topk_grouped_wgmma": "dss_topk_grouped"}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin; the CUDA kernels cannot build")
    return str(path)


def _source_files(name: str):
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    """Where ``name``'s library lives for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _source_files(name):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every library that is missing, one ``nvcc`` per source, all
    started together. Returns seconds per library built (empty when all
    were built already). Raises with the compiler's output on failure."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    seconds, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        seconds[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {p.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) for ``name``'s current library, or '' if not built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if missing, with every
    entry point it holds typed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for entry, argtypes in SIGNATURES.items():
            if ENTRY_LIBRARY.get(entry, entry) == name:
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


# ---------------------------------------------------------------------------
# Launch glue shared by the wrappers
# ---------------------------------------------------------------------------

MAX_K = 64         # largest top-k width (kMaxK)
MAX_SPLITS = 288   # partial lists per row the split merge takes (kMaxSplits)
SMS = 132          # streaming multiprocessors of an H100 SXM
SMEM_MAX = 232448  # shared memory a block may use on an H100 (kSmemMax)
DTYPE_CODES = {"float32": 0, "bfloat16": 1}
INT8_CODE = 2      # kDtypeI8: int8 table rows (with per-row fp32 scales)


def dtype_code(t) -> int:
    """The C-side dtype code of a token-side tensor; raises for
    unsupported dtypes."""
    name = str(t.dtype).removeprefix("torch.")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16 tensors, got {t.dtype}")
    return DTYPE_CODES[name]


def weight_code(w) -> int:
    """The C-side dtype code of table rows: the token codes, or int8."""
    return INT8_CODE if str(w.dtype) == "torch.int8" else dtype_code(w)


def ptr(t) -> Optional[int]:
    """A tensor's device pointer, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()
