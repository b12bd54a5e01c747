"""Convert a JAX parameter pytree, DS head or serve table (as numpy
arrays) into the port's.

``repro`` and the port share the parameter layout — ``(d_in, d_out)``
weights, per-layer params stacked on a leading ``(L, …)`` axis, the same
dict keys — and the serve tables' fields, so conversion is a copy, never
a transpose.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dssoftmax import DSState, QuantizedServeTable, ServeTable
from repro_torch.device import resolve_device

MASK_KEY = "ds_state/mask"


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy → torch on ``device``. A bf16 array (``dtype.name ==
    'bfloat16'``, e.g. from ml_dtypes) is reinterpreted bit for bit."""
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def flatten_paths(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays → ``{"a/b/c": np.ndarray}``, the form
    :func:`params_from_jax` takes."""
    out: Dict[str, np.ndarray] = {}
    for key, v in tree.items():
        path = f"{prefix}{key}"
        if isinstance(v, dict):
            out.update(flatten_paths(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def _expected_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    shapes = {
        "embed/table": (cfg.padded_vocab, d),
        "layers/attn/wq": (L, d, H * dh),
        "layers/attn/wk": (L, d, KV * dh),
        "layers/attn/wv": (L, d, KV * dh),
        "layers/attn/wo": (L, H * dh, d),
        "layers/mlp/w_up": (L, d, ff),
        "layers/mlp/w_down": (L, ff, d),
        "final_norm/scale": (d,),
    }
    if cfg.head == "ds":
        K = cfg.ds.num_experts
        shapes.update({"head/gate": (K, d), "head/experts": (K, cfg.padded_vocab, d),
                       MASK_KEY: (K, cfg.padded_vocab)})
    return shapes


def params_from_jax(np_tree: Dict[str, np.ndarray], cfg: ModelConfig,
                    device="cuda") -> Tuple[dict, DSState]:
    """``np_tree`` maps "/"-joined pytree paths of ``repro``'s params
    (``"layers/attn/wq"``, ``"head/gate"``, …) to numpy arrays, plus
    ``"ds_state/mask"`` for a DS head. Returns (params, DSState or None)
    on ``device``. Raises if a leaf the config needs is missing or has
    the wrong shape."""
    dev = resolve_device(device)
    for path, shape in _expected_shapes(cfg).items():
        if path not in np_tree:
            raise KeyError(f"missing parameter {path!r}")
        if tuple(np_tree[path].shape) != shape:
            raise ValueError(f"{path}: shape {tuple(np_tree[path].shape)}, "
                             f"expected {shape} for {cfg.name}")
    params: dict = {}
    state = None
    for path, a in np_tree.items():
        t = to_tensor(np.asarray(a), dev)
        if path == MASK_KEY:
            state = DSState(mask=t.to(torch.bool))
            continue
        node = params
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t
    params.setdefault("head", {})
    return params, state


def head_from_jax(np_head: Dict[str, np.ndarray], mask: np.ndarray,
                  device="cuda") -> Tuple[dict, DSState]:
    """A ``repro`` DS head ``{"gate": (K, d), "experts": (K, N, d)}`` and
    its ``DSState.mask`` (K, N) bool, as numpy arrays → the port's
    ``(head params, DSState)`` on ``device``, the pair that
    ``pack_experts`` and ``serve.repack_for_traffic`` take. bf16 is copied
    bit for bit. Raises on a missing field or shapes that disagree."""
    dev = resolve_device(device)
    for f in ("gate", "experts"):
        if f not in np_head:
            raise KeyError(f"DS head field {f!r} is missing")
    gate, experts, mask = (np.asarray(a) for a in (np_head["gate"], np_head["experts"], mask))
    K, N, d = experts.shape
    if gate.shape != (K, d) or mask.shape != (K, N) or mask.dtype != np.bool_:
        raise ValueError(f"head fields disagree: gate {gate.shape}, experts {experts.shape}, "
                         f"mask {mask.shape} {mask.dtype} (want (K, d), (K, N, d), (K, N) bool)")
    head = {"gate": to_tensor(gate, dev), "experts": to_tensor(experts, dev)}
    return head, DSState(mask=to_tensor(mask, dev))


_TABLE_DTYPES = {"ids": ("int32",), "qweights": ("int8",), "scales": ("float32",),
                 "fb_index": ("int32",)}


def table_from_jax(np_fields: Dict[str, np.ndarray], device="cuda"):
    """A ``repro`` ``ServeTable`` (fields ``ids``, ``weights``) or
    ``QuantizedServeTable`` (``ids``, ``qweights``, ``scales``,
    ``fb_index``, ``fb_weights``), its fields as numpy arrays (e.g.
    ``{f: np.asarray(v) for f, v in table._asdict().items()}``), → the
    port's table of the same kind on ``device``. bf16 rows are copied bit
    for bit; int8 stays int8. Raises on a missing field, a wrong dtype or
    shapes that disagree."""
    dev = resolve_device(device)
    kind = QuantizedServeTable if "qweights" in np_fields else ServeTable
    for f in kind._fields:
        if f not in np_fields:
            raise KeyError(f"{kind.__name__} field {f!r} is missing")
        dt = np.asarray(np_fields[f]).dtype.name
        if f in _TABLE_DTYPES and dt not in _TABLE_DTYPES[f]:
            raise TypeError(f"{f}: dtype {dt}, expected {_TABLE_DTYPES[f][0]}")
    t = {f: to_tensor(np.asarray(np_fields[f]), dev) for f in kind._fields}
    K, v_pad = t["ids"].shape
    rows = t["qweights" if kind is QuantizedServeTable else "weights"]
    if rows.shape[:2] != (K, v_pad) or (kind is QuantizedServeTable and (
            t["scales"].shape != (K, v_pad) or t["fb_index"].shape != (K,)
            or t["fb_weights"].shape[1:] != rows.shape[1:])):
        raise ValueError("table fields disagree in shape: "
                         + ", ".join(f"{f} {tuple(v.shape)}" for f, v in t.items()))
    return kind(**t)
