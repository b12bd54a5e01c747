"""Local SPMD worlds for the multi-rank tests: one process per rank on this host, joined
through a file store (``launch.mesh.init_distributed(store=...)``), so a
world needs no network and no port number, and worlds started side by side
never collide (each has its own store file)."""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Callable, List, Optional, Sequence

SRC = str(Path(__file__).resolve().parents[1] / "src")


def start_world(argv: Callable[[int, str], Sequence[str]], world: int, *,
                store_dir: Optional[str] = None, env: Optional[dict] = None) -> List:
    """Start ``world`` processes, rank r running ``argv(r, store)``, with
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` set, one
    intra-op thread, and ``src/`` on ``PYTHONPATH``. ``store`` is a fresh
    file in ``store_dir`` (a new temporary directory by default). Returns
    the ``Popen`` handles; :func:`wait_world` collects them."""
    store = os.path.join(store_dir or tempfile.mkdtemp(prefix="repro_torch_world_"), "store")
    procs = []
    for r in range(world):
        e = dict(os.environ, **(env or {}))
        e.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
                 PYTHONPATH=os.pathsep.join(p for p in (SRC, e.get("PYTHONPATH")) if p))
        procs.append(subprocess.Popen(list(argv(r, store)), env=e, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    return procs


def wait_world(procs: List, timeout: float = 300.0) -> List[str]:
    """Wait for every rank; return their standard outputs. If one fails or
    the time runs out, the others are killed and ``RuntimeError`` carries
    the failing rank's error output."""
    outs = [None] * len(procs)
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n{err[-6000:]}")
            outs[r] = out
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"the world did not finish in {timeout} s") from e
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def python_argv(*args: str) -> Callable[[int, str], List[str]]:
    """``argv`` for :func:`start_world`: this interpreter running ``args``
    followed by the store path."""
    return lambda rank, store: [sys.executable, *args, store]
