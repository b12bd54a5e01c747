"""Wall-clock timing helpers: a context-manager timer and a median-of-N
benchmark that waits for its results' CUDA devices."""
from __future__ import annotations

import time
from typing import Callable

import torch


class Timer:
    """Context manager: ``elapsed`` holds the seconds its block took."""

    def __init__(self, name: str = ""):
        self.name = name
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of every tensor in ``out`` (nested tuples, lists
    and dicts)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _cuda_devices(v, found)
    return found


def _wait(out) -> None:
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)


def bench(fn: Callable, *args, warmup: int = 2, iters: int = 10) -> float:
    """Median seconds per call of ``fn(*args)``, each call timed until the
    CUDA devices of its outputs finish (CPU outputs are done on return)."""
    for _ in range(warmup):
        _wait(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _wait(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
