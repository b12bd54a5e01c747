"""Sharded, checkpointable input pipeline.

Every batch is a pure function of ``(seed, step)``; each process takes
only its slice (``host_slice``), and restoring after preemption is just
"resume at step N" — no pipeline state files. Batches are numpy arrays;
the Trainer moves them to the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterator

import numpy as np


@dataclass
class PipelineState:
    step: int = 0
    seed: int = 0


class DataPipeline:
    """Wraps a ``batch_at(step) -> dict`` function with process sharding and
    exact-resume semantics. ``process_index``/``process_count`` default to
    0/1 (one process)."""

    def __init__(self, batch_fn: Callable[[int], Dict[str, np.ndarray]], *, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self.batch_fn = batch_fn
        self.state = PipelineState(step=0, seed=seed)
        self.process_index = process_index
        self.process_count = process_count

    def host_slice(self, arr: np.ndarray) -> np.ndarray:
        """This process's rows of a globally-defined batch."""
        n = arr.shape[0]
        per = n // self.process_count
        lo = self.process_index * per
        return arr[lo: lo + per]

    def next(self) -> Dict[str, np.ndarray]:
        batch = self.batch_fn(self.state.step)
        self.state.step += 1
        return {k: self.host_slice(v) for k, v in batch.items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()

    # --- exact-restart checkpoint interface ---
    def snapshot(self) -> dict:
        return {"step": self.state.step, "seed": self.state.seed}

    def restore(self, snap: dict) -> None:
        self.state = PipelineState(step=int(snap["step"]), seed=int(snap["seed"]))
