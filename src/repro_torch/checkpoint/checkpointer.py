"""Atomic checkpointing of trees of tensors.

Format: one directory per checkpoint holding ``arrays.npz`` (the tree
flattened to ``"a/b/c" → array``, NamedTuple fields by name) and
``meta.json`` (step, pipeline snapshot, user metadata). bfloat16 tensors
are stored bit for bit as uint16 arrays; ``dtypes.json`` names the
tensors to view back as bfloat16. Writes go to ``<dir>.tmp``, then
``os.replace`` — a crash mid-save never corrupts the latest checkpoint.

Tensors are saved from the host: :func:`save` moves each one off the
device before it writes, and :class:`AsyncSaver` copies them all before
it returns and writes on a background thread, so the step after a save
may change them freely.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.utils import get_logger
from repro_torch.utils.tree import flatten_dict, unflatten_dict

log = get_logger("ckpt")

_BF16 = "bfloat16"


def host_copy(tree: Any) -> dict:
    """The tree flattened to ``path → CPU tensor``, each a fresh copy."""
    return {k: v.detach().to("cpu", copy=True) for k, v in flatten_dict(tree).items()}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save(path: str, tree: Any, *, meta: Optional[dict] = None) -> None:
    """Atomic save of a tree of tensors (params / opt state / masks)."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = {k: v.detach().cpu() for k, v in flatten_dict(tree).items()}
    arrays = {k: _to_numpy(t) for k, t in flat.items()}
    dtypes = {k: _BF16 for k, t in flat.items() if t.dtype == torch.bfloat16}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "dtypes.json"), "w") as f:
        json.dump(dtypes, f)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta or {}, f)
    # fsync the npz for durability before the atomic rename
    with open(os.path.join(tmp, "arrays.npz"), "rb+") as f:
        os.fsync(f.fileno())
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    log.info("saved checkpoint %s (%d arrays)", path, len(arrays))


def _load_flat(path: str) -> dict:
    with open(os.path.join(path, "dtypes.json")) as f:
        dtypes = json.load(f)
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for k in z.files:
            t = torch.from_numpy(np.array(z[k]))
            out[k] = t.view(torch.bfloat16) if dtypes.get(k) == _BF16 else t
    return out


def _rebuild(like: Any, flat: dict, prefix: str):
    """A tree of ``like``'s structure from ``flat``; each leaf takes its
    like's dtype and device, and the checkpoint's shape (a checkpoint
    taken after mitosis holds twice the experts of a fresh init)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, flat, f"{prefix}{f}/")
                            for f, v in zip(like._fields, like)))
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint has no array {key!r}")
    return flat[key].to(dtype=like.dtype, device=like.device)


def load(path: str, like: Any = None):
    """Load a checkpoint → ``(tree, meta)``. With ``like`` (an example tree
    of tensors) the arrays are put in its structure, dtypes and devices;
    without, a nested dict of CPU tensors comes back."""
    flat = _load_flat(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if like is None:
        return unflatten_dict(flat), meta
    return _rebuild(like, flat, ""), meta


class AsyncSaver:
    """Checkpoint writes on a background thread. ``submit`` copies every
    tensor to the host (the only part the caller waits for), starts the
    write and returns, so the file system work overlaps the next steps;
    ``then`` runs on that thread after a successful write. One write is
    in flight at a time: the next ``submit`` or ``wait`` joins it."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, path: str, tree: Any, meta: Optional[dict] = None,
               then: Optional[Callable[[], None]] = None) -> None:
        self.wait()
        host_tree = host_copy(tree)

        def run():
            try:
                save(path, host_tree, meta=meta)
                if then is not None:
                    then()
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
