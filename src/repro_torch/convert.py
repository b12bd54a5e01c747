"""Convert a JAX parameter pytree, DS head, serve table or train state (as
numpy arrays) into the port's.

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
from repro_torch.utils.tree import unflatten_dict

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


def _state_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The ssm and hybrid families' leaves: each layer's norm and Mamba2
    block, stacked ``(L, …)``, and the hybrid's one shared attention+MLP
    block."""
    L, d, di = cfg.n_layers, cfg.d_model, cfg.d_inner
    H, GN = cfg.ssm_nheads, cfg.ssm_ngroups * cfg.ssm_state
    m = "layers/mamba/"
    shapes = {
        "layers/ln/scale": (L, d),
        m + "in_zx": (L, d, 2 * di), m + "in_bc": (L, d, 2 * GN), m + "in_dt": (L, d, H),
        m + "conv_w": (L, cfg.ssm_conv_width, di + 2 * GN), m + "conv_b": (L, di + 2 * GN),
        m + "A_log": (L, H), m + "dt_bias": (L, H), m + "D": (L, H),
        m + "norm_scale": (L, di), m + "out_proj": (L, di, d),
    }
    if cfg.family == "hybrid":
        Hq, KV, dh, ff = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
        sa = "shared_attn/"
        shapes.update({sa + "ln1/scale": (d,), sa + "ln2/scale": (d,),
                       sa + "attn/wq": (d, Hq * dh), sa + "attn/wk": (d, KV * dh),
                       sa + "attn/wv": (d, KV * dh), sa + "attn/wo": (Hq * dh, d),
                       sa + "mlp/w_up": (d, ff), sa + "mlp/w_down": (ff, d)})
        if cfg.act == "swiglu":
            shapes[sa + "mlp/w_gate"] = (d, ff)
    return shapes


def _attn_shapes(prefix: str, L: int, cfg: ModelConfig) -> Dict[str, tuple]:
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {prefix + "wq": (L, d, H * dh), prefix + "wk": (L, d, KV * dh),
            prefix + "wv": (L, d, KV * dh), prefix + "wo": (L, H * dh, d)}


def _mlp_shapes(prefix: str, L: int, cfg: ModelConfig) -> Dict[str, tuple]:
    d, ff = cfg.d_model, cfg.d_ff
    shapes = {prefix + "w_up": (L, d, ff), prefix + "w_down": (L, ff, d)}
    if cfg.act == "swiglu":
        shapes[prefix + "w_gate"] = (L, d, ff)
    return shapes


def _encdec_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The encdec family's leaves: the learned decoder positions, each
    encoder layer's (ln1, attn, ln2, mlp) and each decoder layer's (ln1,
    self_attn, ln_x, cross_attn, ln2, mlp), stacked ``(L, …)``, and the two
    final layer norms (scale and bias each)."""
    from repro_torch.models.model_zoo import MAX_TARGET_LEN

    d = cfg.d_model
    shapes = {"pos_embed": (MAX_TARGET_LEN, d)}
    for stack, L, attns, norms in (
            ("enc_layers/", cfg.n_encoder_layers, ("attn",), ("ln1", "ln2")),
            ("dec_layers/", cfg.n_layers, ("self_attn", "cross_attn"), ("ln1", "ln_x", "ln2"))):
        for a in attns:
            shapes.update(_attn_shapes(f"{stack}{a}/", L, cfg))
        shapes.update(_mlp_shapes(f"{stack}mlp/", L, cfg))
        for n in norms:
            shapes.update({f"{stack}{n}/scale": (L, d), f"{stack}{n}/bias": (L, d)})
    for n in ("enc_norm", "dec_norm"):
        shapes.update({f"{n}/scale": (d,), f"{n}/bias": (d,)})
    return shapes


def _expected_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    L, d = cfg.n_layers, cfg.d_model
    shapes = {"embed/table": (cfg.padded_vocab, d)}
    if cfg.family == "encdec":
        shapes.update(_encdec_shapes(cfg))
    else:
        shapes["final_norm/scale"] = (d,)
    if cfg.family in ("ssm", "hybrid"):
        shapes.update(_state_shapes(cfg))
    elif cfg.family != "encdec":
        shapes.update(_attn_shapes("layers/attn/", L, cfg))
    if cfg.moe is not None:
        E, f = cfg.moe.num_experts, cfg.moe.d_ff_expert
        shapes.update({"layers/moe/router": (L, d, E), "layers/moe/w_gate": (L, E, d, f),
                       "layers/moe/w_up": (L, E, d, f), "layers/moe/w_down": (L, E, f, d)})
    elif cfg.family not in ("ssm", "hybrid", "encdec"):
        shapes.update(_mlp_shapes("layers/mlp/", L, cfg))
    if cfg.head == "ds":
        K = cfg.ds.num_experts
        shapes.update({"head/gate": (K, d), "head/experts": (K, cfg.padded_vocab, d),
                       MASK_KEY: (K, cfg.padded_vocab)})
    return shapes


# each backbone's own leaves, by path prefix: a leaf under another
# family's prefix is refused
_ENCDEC_LEAVES = ("enc_layers/", "dec_layers/", "enc_norm/", "dec_norm/", "pos_embed")


def check_shapes(np_tree: Dict[str, np.ndarray], cfg: ModelConfig) -> None:
    """Raise unless ``np_tree`` (the form :func:`params_from_jax` takes) has
    every leaf the config needs at its shape: ``KeyError`` for a missing
    leaf, ``ValueError`` for a wrong shape, for an MLP gate
    (``layers/mlp/w_gate``, ``shared_attn/mlp/w_gate``,
    ``enc_layers/mlp/w_gate``, ``dec_layers/mlp/w_gate``) where ``cfg.act``
    is not 'swiglu', for an MLP in a moe config or an MoE block in another,
    or for a leaf of another family's backbone (``layers/attn/…`` in an
    ssm or hybrid tree, ``layers/mamba/…`` or ``shared_attn/…`` in
    another, ``enc_layers/…`` or ``pos_embed`` outside an encdec tree,
    ``layers/…`` or ``final_norm/…`` in one)."""
    expected = _expected_shapes(cfg)
    for path, shape in expected.items():
        if path not in np_tree:
            raise KeyError(f"missing parameter {path!r}")
        if tuple(np_tree[path].shape) != shape:
            raise ValueError(f"{path}: shape {tuple(np_tree[path].shape)}, "
                             f"expected {shape} for {cfg.name}")
    for gate in ("layers/mlp/w_gate", "shared_attn/mlp/w_gate", "enc_layers/mlp/w_gate",
                 "dec_layers/mlp/w_gate"):
        if cfg.act != "swiglu" and cfg.moe is None and gate in np_tree:
            raise ValueError(f"{gate} given, but {cfg.name}'s MLP is {cfg.act!r} (no gate)")
    if cfg.family == "encdec":
        foreign = ("layers/", "shared_attn/", "final_norm/")
    elif cfg.family in ("ssm", "hybrid"):
        foreign = ("layers/attn/", "layers/mlp/", "layers/moe/", "layers/ln1/", "layers/ln2/",
                   *_ENCDEC_LEAVES)
        if cfg.family == "ssm":
            foreign += ("shared_attn/",)
    else:
        foreign = ("layers/mamba/", "shared_attn/", *_ENCDEC_LEAVES)
    extra = sorted(p for p in np_tree if p.startswith(foreign) and p not in expected)
    if extra:
        raise ValueError(f"{extra[0]} given, but {cfg.name} is a {cfg.family} model")
    if cfg.family in ("ssm", "hybrid", "encdec"):
        return
    other = "layers/mlp/" if cfg.moe is not None else "layers/moe/"
    extra = sorted(p for p in np_tree if p.startswith(other))
    if extra:
        raise ValueError(f"{extra[0]} given, but {cfg.name}'s FFN is "
                         f"{'an MoE block' if cfg.moe is not None else 'an MLP'}")


def params_from_jax(np_tree: Dict[str, np.ndarray], cfg: ModelConfig,
                    device="cuda") -> Tuple[dict, DSState]:
    """``np_tree`` maps "/"-joined pytree paths of ``repro``'s params
    (``"layers/attn/wq"``, ``"head/gate"``, …) to numpy arrays, plus
    ``"ds_state/mask"`` for a DS head. Returns (params, DSState or None)
    on ``device``. Raises if a leaf the config needs is missing or has
    the wrong shape."""
    dev = resolve_device(device)
    check_shapes(np_tree, cfg)
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


def _subtree(np_state: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in np_state.items() if k.startswith(prefix)}


def train_state_from_jax(np_state: Dict[str, np.ndarray], cfg: ModelConfig, device="cuda"):
    """A ``repro`` ``TrainState`` flattened to numpy arrays (e.g.
    ``flatten_paths({"params": params, "opt": opt._asdict(), "ds_state":
    ds_state._asdict()})`` after ``jax.tree.map(np.asarray, ...)``: keys
    ``"params/…"``, ``"opt/step"``, ``"opt/m/…"``, ``"opt/v/…"`` and
    ``"ds_state/mask"`` for a DS head) → the port's
    :class:`~repro_torch.train.train_step.TrainState` on ``device``: the
    params (checked as :func:`params_from_jax` checks them), the DS mask,
    the fp32 Adam moments (one per param, same shape) and the step count
    as a 0-d int32 tensor. bf16 is copied bit for bit."""
    from repro_torch.optim import OptState
    from repro_torch.train.train_step import TrainState

    dev = resolve_device(device)
    tree = _subtree(np_state, "params/")
    if cfg.head == "ds":
        if "ds_state/mask" not in np_state:
            raise KeyError("missing 'ds_state/mask' for a DS head")
        tree[MASK_KEY] = np_state["ds_state/mask"]
    params, ds_state = params_from_jax(tree, cfg, device=dev)
    moments = []
    for name in ("m", "v"):
        flat = _subtree(np_state, f"opt/{name}/")
        want = {k for k in tree if k != MASK_KEY}
        if set(flat) != want:
            raise KeyError(f"opt/{name} paths differ from the params': "
                           f"{sorted(set(flat) ^ want)[:8]}")
        for path, a in flat.items():
            a = np.asarray(a)
            if a.dtype != np.float32 or a.shape != np.asarray(tree[path]).shape:
                raise ValueError(f"opt/{name}/{path}: {a.dtype} {a.shape}, expected fp32 "
                                 f"{np.asarray(tree[path]).shape}")
        moment = unflatten_dict({path: to_tensor(np.asarray(a), dev) for path, a in flat.items()})
        moment.setdefault("head", {})
        moments.append(moment)
    if "opt/step" not in np_state:
        raise KeyError("missing 'opt/step'")
    step = torch.tensor(int(np.asarray(np_state["opt/step"])), dtype=torch.int32, device=dev)
    return TrainState(params=params, opt=OptState(step=step, m=moments[0], v=moments[1]),
                      ds_state=ds_state)
