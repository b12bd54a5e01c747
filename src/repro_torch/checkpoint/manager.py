"""Checkpoint lifecycle: rotation, latest-discovery, auto-resume, preemption.

Directory layout: ``<root>/step_<N>/{arrays.npz, dtypes.json, meta.json}``.
``latest()`` is derived from directory names (no pointer file to corrupt).
Rotation keeps the newest ``keep`` checkpoints. ``save`` returns once the
tensors are on the host; the write and the rotation after it run on a
background thread, and ``all_steps``/``latest`` see a checkpoint once its
write is done (``wait`` joins it; ``restore`` and the next ``save`` do
so first). A SIGTERM handler arms a save-on-preemption flag the trainer
polls between steps.
"""
from __future__ import annotations

import os
import re
import shutil
import signal
from typing import Any, Optional

from repro_torch.checkpoint import checkpointer
from repro_torch.utils import get_logger

log = get_logger("ckpt.mgr")

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._saver = checkpointer.AsyncSaver()
        self.preempted = False

    # --- preemption protocol ---
    def install_preemption_handler(self) -> None:
        def handler(signum, frame):  # noqa: ARG001
            log.warning("preemption signal received — will checkpoint at step end")
            self.preempted = True

        signal.signal(signal.SIGTERM, handler)

    # --- save / restore ---
    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.root, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, meta: Optional[dict] = None) -> None:
        meta = dict(meta or {})
        meta["step"] = step
        self._saver.submit(self.step_dir(step), tree, meta, then=self._rotate)

    def restore(self, like: Any, step: Optional[int] = None):
        self.wait()
        step = step if step is not None else self.latest()
        if step is None:
            return None, None
        tree, meta = checkpointer.load(self.step_dir(step), like=like)
        log.info("restored checkpoint step %d from %s", step, self.root)
        return tree, meta

    def wait(self) -> None:
        self._saver.wait()

    def _rotate(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
