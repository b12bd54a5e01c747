"""Sharding rules over a ``torch.distributed`` mesh (``repro.distributed.
sharding``): the serving rules, and the training rules with the collectives
of the mesh train step.

A placement is plain data: per dimension of a leaf, the mesh axis (or tuple
of axes) it splits over, or ``None`` — the entries of ``repro``'s
``PartitionSpec``, kept as a tuple. Rules match a leaf's slash path by
regex (``_RULES``, ``repro``'s table), so every model family is placed the
same way:

* vocab-carrying tables (embed, unembed, DS expert rows) → ``model``,
  second dim → ``data``;
* attention/MLP weights → (d_model → ``data``, heads/ff → ``model``);
* MoE expert stacks → (experts → ``model``, d_model → ``data``);
* per-head vectors, norm scales, small biases → replicated.

``repro`` applies a placement with ``jax.device_put``; here each rank keeps
its slice (:func:`shard_tree`) and a gather rebuilds the whole leaf with
one ``all_gather`` over the named axis' process group. Every collective of
the serving path (the DS head's merge and stats, :class:`ServeParamGather`)
runs through :func:`collective`, which records the shapes it moves when a
:func:`record_collectives` block is open.

A mesh is a ``DeviceMesh`` (``launch.mesh``), or, for the pure placement
rules, any object with ``shape`` (axis name → size) and ``axis_names``, as
``repro``'s tests stand a mesh in, or that ``{axis name: size}`` dict.
"""
from __future__ import annotations

import contextlib
import copy
import re
import warnings
import weakref
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.utils.tree import map_with_path, tree_leaves, tree_paths

# torch >= 2.13 renames all_gather_into_tensor and reduce_scatter_tensor;
# both names do the same
warnings.filterwarnings("ignore", message=".*(all_gather_into_tensor|reduce_scatter_tensor).*",
                        category=FutureWarning)


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

def mesh_sizes(mesh) -> dict:
    """Axis name → size of a DeviceMesh, of a stand-in whose ``shape``
    already maps names to sizes, or of such a dict itself (a mesh's shape
    alone, which the placement rules need)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 on an axis the mesh lacks)."""
    if axis not in mesh_sizes(mesh):
        return 0
    return int(mesh.get_local_rank(axis))


def mesh_coords(mesh) -> dict:
    """Axis name → this rank's coordinate on it."""
    return {a: axis_index(mesh, a) for a in mesh_sizes(mesh)}


def axis_group(mesh, axes):
    """The process group over one mesh axis, or over several together (the
    (pod, data) token axes: the mesh flattened over them, made on the
    first call, which every rank makes in step, and kept by the mesh)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def batch_axes(mesh) -> tuple:
    names = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def batch_size_on(mesh) -> int:
    sizes = mesh_sizes(mesh)
    n = 1
    for a in batch_axes(mesh):
        n *= sizes[a]
    return n


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

_RECORD: Optional[list] = None


class CollectiveRecord(tuple):
    """``(op, shape, dtype, group size)`` of one collective, which unpacks
    as that 4-tuple, with the process group it ran on as ``group``."""

    def __new__(cls, op, shape, dtype, n, group):
        rec = super().__new__(cls, (op, shape, dtype, n))
        rec.group = group
        return rec


@contextlib.contextmanager
def record_collectives():
    """Collect a :class:`CollectiveRecord` ``(op, shape, dtype, group
    size)`` of every :func:`collective` run inside the block (``shape`` is
    this rank's contribution)."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def collective(x: torch.Tensor, group, op: str = "all_gather") -> torch.Tensor:
    """The one collective of the port. ``'all_gather'`` → the ranks'
    tensors stacked, ``(n, *x.shape)`` in group-rank order; ``'all_reduce'``
    → their sum, ``x.shape`` (a new tensor); ``'all_reduce_max'`` → their
    elementwise maximum; ``'reduce_scatter'`` → this rank's block of dim 0
    of their sum, ``(x.shape[0] // n, …)``."""
    n = dist.get_world_size(group)
    if _RECORD is not None:
        _RECORD.append(CollectiveRecord(op, tuple(x.shape), x.dtype, n, group))
    x = x.contiguous()
    if op in ("all_reduce", "all_reduce_max"):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "all_reduce_max"
                        else dist.ReduceOp.SUM, group=group)
        return out
    if op == "reduce_scatter":
        out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x, group=group)
        return out
    if op != "all_gather":
        raise ValueError(f"unknown collective {op!r}")
    flat = x.reshape(1, -1)
    out = torch.empty((n, flat.shape[1]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view((n,) + tuple(x.shape))


def _gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The whole leaf from this rank's slice along ``dim`` (tiled)."""
    stacked = collective(x, group)
    return torch.cat(tuple(stacked.unbind(0)), dim=dim)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

_RULES: list = [
    # --- DS-Softmax head (the paper): experts (K, N, d) vocab-TP + FSDP ---
    (r"head/experts$", (None, "model", "data")),
    (r"head/gate$", (None, "data")),
    # --- embeddings: (V, d) ---
    (r"embed/table$", ("model", "data")),
    (r"head/unembed$", ("model", "data")),
    (r"pos_embed$", (None, "data")),
    # --- attention (leading L axis handled generically below) ---
    (r"attn/wq$", ("data", "model")),
    (r"attn/wk$", ("data", "model")),
    (r"attn/wv$", ("data", "model")),
    (r"attn/wo$", ("model", "data")),
    (r"attn/b[qkv]$", ("model",)),
    # --- dense MLP ---
    (r"mlp/w_gate$", ("data", "model")),
    (r"mlp/w_up$", ("data", "model")),
    (r"mlp/w_down$", ("model", "data")),
    # --- MoE (E, d, ff): EP over model, FSDP over data ---
    (r"moe/router$", ("data", None)),
    (r"moe/w_gate$", ("model", "data", None)),
    (r"moe/w_up$", ("model", "data", None)),
    (r"moe/w_down$", ("model", None, "data")),
    # --- mamba2 ---
    (r"mamba/in_zx$", ("data", "model")),
    (r"mamba/in_bc$", ("data", "model")),
    (r"mamba/in_dt$", ("data", None)),
    (r"mamba/out_proj$", ("model", "data")),
    (r"mamba/conv_w$", (None, "model")),
    (r"mamba/conv_b$", ("model",)),
    # small per-head vectors & norms: replicated
    (r"mamba/(A_log|dt_bias|D)$", ()),
    (r"(ln\d?|ln_x|norm|final_norm|enc_norm|dec_norm)/(scale|bias)$", ()),
    (r"norm_scale$", ()),
]

_STACKED_RE = re.compile(r"(^|/)(layers|enc_layers|dec_layers)/")


def param_pspec(path: str, ndim: int) -> tuple:
    """Placement of one parameter leaf from its slash path: the first
    matching rule, with a leading ``None`` for a stacked (L, …) leaf,
    padded or cut to ``ndim``; replicated when no rule matches."""
    stacked = bool(_STACKED_RE.search(path))
    for pat, axes in _RULES:
        if re.search(pat, path):
            spec = tuple(axes)
            if stacked:
                spec = (None,) + spec
            return spec[:ndim] + (None,) * max(0, ndim - len(spec))
    return (None,) * ndim


def _fitted_pspec(path: str, shape: tuple, mesh, keep_axes: Optional[tuple] = None) -> tuple:
    """:func:`param_pspec` held to the leaf's shape: per dim, a rule axis
    survives only if the mesh has it, it is wider than 1, it is in
    ``keep_axes`` (when given) and it divides the dim; else that dim is
    replicated. So the placement is always valid."""
    return _fit(param_pspec(path, len(shape)), shape, mesh, keep_axes)


def _fit(spec: tuple, shape: tuple, mesh, keep_axes: Optional[tuple] = None) -> tuple:
    """``spec`` held to ``shape`` on ``mesh`` (the rule of
    :func:`_fitted_pspec`)."""
    sizes = mesh_sizes(mesh)
    out = []
    for dim, ax in zip(shape, spec):
        axes = ax if isinstance(ax, tuple) else (ax,)
        axes = tuple(a for a in axes
                     if a is not None and a in sizes
                     and (keep_axes is None or a in keep_axes) and sizes[a] > 1)
        n = 1
        for a in axes:
            n *= sizes[a]
        if not axes or dim % n != 0:
            out.append(None)
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    return tuple(out)


def batch_pspec(mesh, global_batch: int, extra_dims: int = 1) -> tuple:
    """Shard the leading batch dim over (pod, data) when divisible."""
    ba = batch_axes(mesh)
    nb = max(1, batch_size_on(mesh))
    if global_batch % nb != 0 or global_batch < nb:
        ba = ()
    return (ba if ba else None,) + (None,) * extra_dims


def input_shardings(mesh, cfg, specs: dict, shape) -> dict:
    """The batch's placement as ``repro``'s dry-run places a cell's inputs:
    each leaf's leading batch dim over (pod, data) when divisible."""
    return {k: batch_pspec(mesh, shape.global_batch, len(v.shape) - 1)
            for k, v in specs.items()}


def cache_shardings(mesh, cfg, cache: Any, shape) -> Any:
    """``repro``'s decode-cache placement (its dry-run's): attention K/V
    (L, B, S, KV, dh) → B over (pod, data), S over ``model`` (split-KV; a
    batch the batch axes do not divide puts S over every axis); SSM states
    (L, B, H, P, N) → H over ``model``; conv states (L, B, W-1, C) → C over
    ``model``; each where it divides."""
    ba = batch_axes(mesh)
    nb = batch_size_on(mesh)
    b_ok = shape.global_batch % nb == 0
    b_ax = ba if (ba and b_ok) else None
    m = mesh_sizes(mesh).get("model", 1)

    def leaf(path, x):
        nd = len(x.shape)
        if nd == 5 and ("attn" in path or "self_k" in path or "self_v" in path
                        or "cross" in path or path.endswith("k") or path.endswith("v")):
            s_ax = "model" if x.shape[2] % m == 0 else None
            if not b_ok and x.shape[2] % (nb * m) == 0:
                s_ax = tuple(ba) + ("model",)
            return (None, b_ax, s_ax, None, None)
        if nd == 5:
            return (None, b_ax, "model" if x.shape[2] % m == 0 else None, None, None)
        if nd == 4:
            return (None, b_ax, None, "model" if x.shape[3] % m == 0 else None)
        return (None,) * nd

    return map_with_path(leaf, cache)


def serve_table_shardings(mesh, table) -> Any:
    """``repro``'s vocab-parallel placement of a serve table (its dry-run's
    memory estimate): V_pad over ``model``, d over ``data``; a quantized
    table's fallback rows replicated. The expert-parallel layout the
    sessions serve from is :func:`serve_table_ep_shardings`."""
    if hasattr(table, "qweights"):
        return type(table)(ids=(None, "model"), qweights=(None, "model", "data"),
                           scales=(None, "model"), fb_index=(None,),
                           fb_weights=(None, None, None))
    return type(table)(ids=(None, "model"), weights=(None, "model", "data"))


def topk_out_shardings(mesh, global_batch: int) -> tuple:
    """The placement of a head's (B, k) values and ids: B over (pod, data)
    when divisible."""
    return batch_pspec(mesh, global_batch, 1)


def shard_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """One rank's block shape of a ``shape`` leaf placed by ``spec``: each
    dim divided by the sizes of the axes it splits over (rounded up where
    they do not divide it, as GSPMD pads)."""
    sizes = mesh_sizes(mesh)
    out = []
    for i, dim in enumerate(shape):
        n = 1
        for a in _spec_axes(spec[i]) if i < len(spec) else ():
            n *= sizes.get(a, 1)
        out.append(-(-dim // n))
    return tuple(out)


def placed_bytes(tree: Any, specs: Any, mesh) -> int:
    """One rank's bytes of ``tree`` (tensors, meta tensors or specs with
    ``shape`` and ``dtype``) placed by ``specs`` on ``mesh``."""
    spec = _spec_of(specs)
    total = 0
    for p, x in zip(tree_paths(tree), tree_leaves(tree)):
        n = 1
        for d in shard_shape(tuple(x.shape), spec[p], mesh):
            n *= d
        total += n * torch.empty((), dtype=x.dtype).element_size()
    return total


def serve_table_ep_shardings(mesh, table) -> Any:
    """Expert-parallel serving layout of a serve table: experts K → model
    (each rank holds K/ep experts' packed rows), replicated over the batch
    axes. A quantized table's scales and ``fb_index`` follow the experts;
    ``fb_weights`` is replicated (``fb_index`` holds global rows into it)."""
    if hasattr(table, "qweights"):
        return type(table)(ids=("model", None), qweights=("model", None, None),
                           scales=("model", None), fb_index=("model",),
                           fb_weights=(None, None, None))
    return type(table)(ids=("model", None), weights=("model", None, None))


def _canonical_batch_axis(mesh):
    ba = tuple(a for a in batch_axes(mesh) if mesh_sizes(mesh)[a] > 1)
    return ba, batch_size_on(mesh)


def serve_cache_shardings(mesh, cfg, cache: Any, n_slots: int) -> Any:
    """Serving decode caches: only the slot axis (position 1) splits, over
    the (pod, data) axes wider than 1, when they divide ``n_slots``; the
    sequence stays whole. Replicated (``()``) otherwise."""
    ba, nb = _canonical_batch_axis(mesh)
    b_ok = ba and nb > 1 and n_slots % nb == 0
    b_ax = (ba[0] if len(ba) == 1 else ba) if b_ok else None

    def leaf(path, x):
        if b_ax is None or len(x.shape) < 2:
            return ()
        return (None, b_ax)

    return map_with_path(leaf, cache)


def serve_paged_cache_shardings(mesh, cfg, cache: Any) -> Any:
    """Paged serving arenas: the page axis (position 1) splits over the
    (pod, data) axes wider than 1 where they divide it; replicated else."""
    ba, nb = _canonical_batch_axis(mesh)

    def leaf(path, x):
        if not ba or nb <= 1 or len(x.shape) < 2 or x.shape[1] % nb != 0 or x.shape[1] == 0:
            return ()
        return (None, ba[0] if len(ba) == 1 else ba)

    return map_with_path(leaf, cache)


class CacheBlock(NamedTuple):
    """One rank's block ``[offset, offset + count)`` of a serving cache's
    slot (or arena page) axis of length ``total``. ``splits`` is False where
    the rule keeps the axis whole (``offset`` 0, ``count == total``)."""

    offset: int
    count: int
    total: int
    splits: bool

    @property
    def index(self) -> int:
        """The block's place among the batch ranks (0 when whole)."""
        return self.offset // self.count if self.count else 0

    def local(self, i: int) -> Optional[int]:
        """Global index ``i`` → its index in this block, or None when
        another rank holds it."""
        i = int(i) - self.offset
        return i if 0 <= i < self.count else None

    def owner(self, i: int) -> int:
        """The block (batch rank) that holds global index ``i``."""
        return int(i) // self.count if self.splits else 0


def serve_cache_block(mesh, n: int, paged: bool = False) -> CacheBlock:
    """This rank's block of ``n`` cache slots (``paged``: of an arena of
    ``n`` pages) where :func:`serve_cache_shardings` (or
    :func:`serve_paged_cache_shardings`) places them: the block of batch
    rank ``batch_index(mesh)`` of ``batch_size_on(mesh)`` when the rule
    splits the axis, the whole axis where it returns ``()`` (no mesh, no
    batch axis wider than 1, or ``n`` not divisible)."""
    if mesh is None:
        return CacheBlock(0, n, n, False)
    leaf = {"x": torch.empty((1, n), device="meta")}
    spec = (serve_paged_cache_shardings(mesh, None, leaf) if paged
            else serve_cache_shardings(mesh, None, leaf, n))["x"]
    if not spec:
        return CacheBlock(0, n, n, False)
    w = n // batch_size_on(mesh)
    return CacheBlock(batch_index(mesh) * w, w, n, True)


# ---------------------------------------------------------------------------
# Serving-side FSDP parameter storage + per-layer just-in-time gather
# ---------------------------------------------------------------------------

def serve_param_pspec(path: str, shape: tuple, mesh) -> tuple:
    """FSDP storage placement of a serving weight: the ``data`` entries of
    its rule only (``model`` belongs to the expert-parallel table), dims
    the data axis does not divide replicated."""
    return _fitted_pspec(path, tuple(shape), mesh, keep_axes=("data",))


def serve_param_shardings(mesh, params: Any) -> Any:
    """The placement tree of FSDP-stored serving weights, keyed by path
    (``head/gate`` is ``(None, 'data')`` whatever K is, so a swapped gate
    keeps its placement)."""
    return map_with_path(lambda p, x: serve_param_pspec(p, tuple(x.shape), mesh), params)


def slice_leaf(x: torch.Tensor, spec: tuple, sizes: dict, coords: dict) -> torch.Tensor:
    """The block of ``x`` under ``spec`` at mesh coordinates ``coords``
    (axis name → coordinate; ``sizes``: axis name → size): a copy, so the
    whole leaf can be freed, or ``x`` itself when nothing splits."""
    split = False
    for dim, ax in enumerate(spec):
        n, c = 1, 0
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is None or sizes.get(a, 1) == 1:
                continue
            # row-major over the axes, as the mesh lays ranks out
            n *= sizes[a]
            c = c * sizes[a] + coords[a]
        if n > 1:
            w = x.shape[dim] // n
            x = x.narrow(dim, c * w, w)
            split = True
    return x.contiguous().clone() if split else x


def shard_tree(mesh, tree: Any, specs: Any) -> Any:
    """This rank's shard of every leaf of ``tree`` under the matching
    placement in ``specs`` (what ``jax.device_put`` with a sharding tree
    does, for one rank). A placement is a plain tuple, so a tree walk keeps
    it whole as a leaf."""
    paths = dict(zip(tree_paths(specs), tree_leaves(specs)))
    sizes, coords = mesh_sizes(mesh), mesh_coords(mesh)
    return map_with_path(lambda p, x: slice_leaf(x, paths[p], sizes, coords), tree)


class ServeParamGather:
    """Per-layer just-in-time all-gather of FSDP-stored serving weights.

    Params live sharded over the mesh's ``data`` axis
    (:func:`serve_param_shardings`, this rank's slice from
    :func:`shard_tree`); model code calls back into this object for exactly
    the weights it is about to consume:

    * ``layer(key, lp)`` — one layer's slice of the stacked ``params[key]``
      (leading layer axis already taken), gathered where the layer runs, so
      a whole layer exists only while it runs;
    * ``full(key, sub)`` — a non-stacked subtree (the DS gate, hybrid's
      shared attention block), gathered at its use;
    * ``rows(key, table, ids)`` — rows of a d-sharded ``(N, d)`` table
      (embeddings, learned positions): each rank takes its d-slice of the
      rows and only the O(ids·d) activation rows cross ranks.

    Every gather concatenates the ranks' slices along the stored dim, so
    gathered weights equal the replicated ones bit for bit. ``params`` is
    the whole (unsharded) tree: the placements come from its shapes."""

    def __init__(self, mesh, params: Any):
        self.mesh = mesh
        specs = serve_param_shardings(mesh, params)
        self._spec = dict(zip(tree_paths(specs), tree_leaves(specs)))
        # a data axis of 1 (or leaves it never divides) splits nothing
        self._splits = any(ax is not None for s in self._spec.values() for ax in s)
        self._local_ids = False

    def for_local_rows(self) -> "ServeParamGather":
        """This gather for a step whose token rows differ by batch rank (a
        slot-split session's decode and verify steps): :meth:`rows` first
        gathers the ids of the ranks it gathers rows from, so that every
        rank takes the d-slices of the same rows, and keeps its own
        block of the result."""
        out = copy.copy(self)
        out._local_ids = True
        return out

    def _gather(self, prefix: str, tree: Any, drop_leading: bool) -> Any:
        if not self._splits:
            return tree

        def leaf(p, x):
            s = self._spec[f"{prefix}/{p}" if p else prefix]
            if drop_leading:
                s = s[1:]
            for dim in reversed(range(len(s))):
                ax = s[dim]
                if ax is None:
                    continue
                # the last axis of a multi-axis dim varies fastest: gather it first
                for a in reversed(ax if isinstance(ax, tuple) else (ax,)):
                    x = _gather_dim(x, axis_group(self.mesh, a), dim)
            return x

        return map_with_path(leaf, tree)

    def layer(self, key: str, layer_params: Any) -> Any:
        """Gather ONE layer's slice of the stacked ``params[key]``."""
        return self._gather(key, layer_params, drop_leading=True)

    def full(self, key: str, sub: Any) -> Any:
        """Gather a non-stacked subtree or leaf ``params[key]`` whole."""
        return self._gather(key, sub, drop_leading=False)

    def rows(self, key: str, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """``table[ids]`` from an ``(N, d)`` table stored d-sharded: a local
        take, then one O(ids·d) all-gather of the activation rows."""
        if not self._splits:
            return table[ids.long()]
        path = key if key in self._spec else f"{key}/table"
        spec = self._spec[path]
        if any(ax is not None for ax in spec[:-1]):
            # the row axis split (no serving rule does this): gather it whole
            return self._gather(path, table, False)[ids.long()]
        d_ax = spec[-1]
        if d_ax is None:
            return table[ids.long()]
        axes = d_ax if isinstance(d_ax, tuple) else (d_ax,)
        if self._local_ids:
            if len(axes) != 1:
                raise ValueError(f"local-row gathers take one axis, {key} splits over {axes}")
            # this rank's ids differ from its peers': take every peer's rows
            n, c = mesh_sizes(self.mesh)[axes[0]], axis_index(self.mesh, axes[0])
            rows = table[_gather_dim(ids, axis_group(self.mesh, axes[0]), 0).long()]
            rows = _gather_dim(rows, axis_group(self.mesh, axes[0]), rows.dim() - 1)
            return rows.reshape((n,) + tuple(ids.shape) + rows.shape[-1:])[c]
        rows = table[ids.long()]
        for a in reversed(axes):
            rows = _gather_dim(rows, axis_group(self.mesh, a), rows.dim() - 1)
        return rows


def tree_shard_bytes(tree: Any) -> int:
    """This rank's resident bytes of a tree of (local) tensors (other
    leaves, such as a ``TableShard``'s expert counts, hold none)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


# ---------------------------------------------------------------------------
# Training: the train state's placement, its gather, the step's collectives
# ---------------------------------------------------------------------------
#
# The mesh train step (``train.train_step.make_train_step(mesh=)``) is data
# parallel compute over a sharded train state. How it counts the loss
# across ranks: every rank computes the loss of the WHOLE batch. A rank runs
# its (pod, data) share of the rows; a batch statistic that enters the loss
# (the CE's sum and token count, the DS gate's per-expert sums, the Switch
# aux's f and P) is summed over the batch ranks in the forward
# (:func:`batch_sum`), and that sum's adjoint is the same sum over the
# cotangents. Each rank's gradient is then n_b times its rows' share plus
# the terms that read the params alone (the lassos), and the step's gradient
# is the mean of the ranks' over the batch group (:func:`block_grad`, run
# in the backward of each of the step's gathers, :class:`TrainParamGather`).
# For a power-of-two n_b the scaling by n_b and the division by it are
# exact.


def param_shardings(mesh, params) -> Any:
    """The training placement of every leaf of ``params``: its rule over
    both axes, fitted to its shape (:func:`_fitted_pspec`), as plain
    tuples where ``repro`` builds ``NamedSharding`` s."""
    return map_with_path(lambda p, x: _fitted_pspec(p, tuple(x.shape), mesh), params)


def replicated(mesh) -> tuple:
    """The placement that splits nothing."""
    return ()


def train_state_shardings(mesh, state) -> Any:
    """The placement of a whole ``TrainState`` as ``repro``'s dry-run places
    a train cell (``launch/dryrun.py:98-110``): the params and both Adam
    moments by :func:`param_shardings`, the step count replicated, the DS
    mask ``(None, 'model')`` fitted to its shape (its class axis splits as
    the expert rows' does)."""
    opt, ds_state = state.opt, state.ds_state
    return type(state)(
        params=param_shardings(mesh, state.params),
        opt=type(opt)(step=replicated(mesh), m=param_shardings(mesh, opt.m),
                      v=param_shardings(mesh, opt.v)),
        ds_state=None if ds_state is None else type(ds_state)(
            mask=_fit((None, "model"), tuple(ds_state.mask.shape), mesh)))


def shard_train_state(mesh, state) -> tuple:
    """A whole ``TrainState`` (on every rank) → (this rank's shard of it,
    the placement :func:`train_state_shardings` gives)."""
    specs = train_state_shardings(mesh, state)
    return shard_tree(mesh, state, specs), specs


def _spec_axes(ax) -> tuple:
    return tuple(a for a in (ax if isinstance(ax, tuple) else (ax,)) if a is not None)


def gather_leaf(x: torch.Tensor, spec: tuple, mesh, keep: tuple = ()) -> torch.Tensor:
    """The whole leaf from this rank's block under ``spec`` (the inverse of
    :func:`slice_leaf`): one ``all_gather`` per split axis, the last axis of
    a multi-axis dim first. Axes in ``keep`` stay split. ``x`` itself
    without a mesh."""
    if mesh is None:
        return x
    sizes = mesh_sizes(mesh)
    for dim in reversed(range(len(spec))):
        for a in reversed(_spec_axes(spec[dim])):
            if a not in keep and sizes.get(a, 1) > 1:
                x = _gather_dim(x, axis_group(mesh, a), dim)
    return x


def _spec_of(specs) -> dict:
    return dict(zip(tree_paths(specs), tree_leaves(specs)))


def gather_tree(mesh, tree: Any, specs: Any) -> Any:
    """Every leaf of a tree of this rank's blocks made whole, on every rank
    (the inverse of :func:`shard_tree`)."""
    spec = _spec_of(specs)
    return map_with_path(lambda p, x: gather_leaf(x, spec[p], mesh), tree)


# the expert stacks the expert-parallel MoE FFN reads shard-locally
# (``models.moe``): a rank keeps its block of their ``model`` axis
_MODEL_LOCAL_RE = re.compile(r"moe/w_(gate|up|down)$")


def model_local(path: str) -> bool:
    """Whether the train step reads the leaf at ``path`` as this rank's
    ``model`` block (the MoE expert stacks) rather than whole."""
    return bool(_MODEL_LOCAL_RE.search(path))


def gather_params(mesh, params: Any, specs: Any) -> Any:
    """A subtree of this rank's blocks made what the train step computes on:
    every leaf whole, except the MoE expert stacks, which keep their
    ``model`` block (not differentiable: :class:`TrainParamGather` is the
    step's gather). ``params`` itself without a mesh."""
    if mesh is None:
        return params
    spec = _spec_of(specs)
    return map_with_path(lambda p, x: gather_leaf(
        x, spec[p], mesh, keep=("model",) if model_local(p) else ()), params)


def block_grad(g: torch.Tensor, spec: tuple, mesh, keep: tuple = (),
               path: str = "") -> torch.Tensor:
    """One leaf's gradient as this rank computed it (the whole leaf, or its
    block along the axes in ``keep``: the MoE expert stacks keep ``model``)
    → this rank's block, under the leaf's placement ``spec``, of the batch
    group's mean gradient.

    Along ``model`` a rank takes its block locally: every rank of a
    ``model`` group computed the same gradient. Over the batch ranks the sum
    is a reduce-scatter along the leaf's ``data`` dim where it is split, and
    an all-reduce over the batch axes that split no dim of it, in fp32; then
    the division by the batch group's size (the loss convention above).
    Where one rank holds the whole batch the gradient keeps its dtype.
    Every collective goes through :func:`collective`, so
    :func:`record_collectives` sees its bytes."""
    sizes, coords = mesh_sizes(mesh), mesh_coords(mesh)
    batch = tuple(a for a in batch_axes(mesh) if sizes[a] > 1)
    nb = batch_size_on(mesh)
    split = []
    for dim, ax in enumerate(spec):
        axes = tuple(a for a in _spec_axes(ax) if sizes.get(a, 1) > 1)
        if len(axes) > 1:
            raise ValueError(f"{path}: dim {dim} splits over {axes}; no rule does that")
        if axes:
            split.append((dim, axes[0]))
    sliced = False
    for dim, a in split:  # model (and any non-batch axis) first: less to reduce
        if a not in batch and a not in keep:
            w = g.shape[dim] // sizes[a]
            g, sliced = g.narrow(dim, coords[a] * w, w), True
    if batch:
        g = g.float()
    left = list(batch)
    for dim, a in split:
        if a in batch:
            g = collective(g.movedim(dim, 0), axis_group(mesh, a),
                           "reduce_scatter").movedim(0, dim)
            left.remove(a)
    if left:
        g = collective(g, axis_group(mesh, tuple(left)), "all_reduce")
    elif sliced and not any(a in batch for _, a in split):
        g = g.clone()  # not a view that keeps the whole gradient alive
    return g / nb if nb > 1 else g


def constrain_like_params(grads: Any, mesh, specs: Any = None) -> Any:
    """Each rank's gradients of the leaves it computed on (whole leaves, and
    the MoE expert stacks' ``model`` blocks) → this rank's block of the
    batch group's mean, leaf by leaf (:func:`block_grad`), in fp32 where
    ranks sum. ``specs`` defaults to :func:`param_shardings` of ``grads``,
    which must then be whole leaves. ``grads`` themselves without a mesh."""
    if mesh is None:
        return grads
    spec = _spec_of(param_shardings(mesh, grads) if specs is None else specs)
    return map_with_path(lambda p, g: block_grad(
        g, spec[p], mesh, ("model",) if model_local(p) else (), p), grads)


class _GatherBlock(torch.autograd.Function):
    """:func:`gather_leaf` of a block, in the param's ``dtype``, forward;
    backward the gradient of what it gathered reduced into the block
    (:func:`block_grad`), in the block's own dtype."""

    @staticmethod
    def forward(ctx, x, spec, mesh, keep, path, dtype):
        ctx.spec, ctx.mesh, ctx.keep, ctx.path, ctx.dtype = spec, mesh, keep, path, x.dtype
        out = gather_leaf(x.to(dtype), spec, mesh, keep)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, g):
        g = block_grad(g, ctx.spec, ctx.mesh, ctx.keep, ctx.path)
        return g.to(ctx.dtype), None, None, None, None, None


class TrainParamGather:
    """The mesh train step's just-in-time gather of its params' blocks.

    The step keeps every leaf as this rank's block (placed by the state's
    ``shardings.params``) and hands the loss the blocks (:meth:`grad_leaves`)
    and this object; the model code calls back into it, with
    :class:`ServeParamGather`'s call shape, for what it is about to run:

    * ``layer(key, lp)`` — one layer's slice of the stacked ``params[key]``,
      called inside that layer's ``remat`` region, so the backward's
      recompute gathers it again and nothing gathered is saved for the
      backward;
    * ``full(key, sub)`` — a non-stacked subtree or leaf (the embedding, the
      DS gate, norms, a full-softmax ``unembed``, hybrid's shared block);
    * ``expert(key, w)`` — one DS expert's ``(N, d)`` rows of the stacked
      ``(K, N, d)`` ``params[key]`` (the head's CE, an expert at a time);
    * ``rows(key, table, ids)`` — rows of a table gathered whole.

    Each gather is differentiable (:class:`_GatherBlock`): its backward
    reduces the gradient of what it gathered into this rank's block of the
    batch group's mean, so ``torch.autograd.grad`` with respect to the
    blocks returns block gradients. Where ranks sum, the blocks autograd
    differentiates are fp32 copies of the params' (each gather casts back
    to the param's dtype), so a gradient reduced in fp32 stays fp32 (the
    step accumulates microbatches in fp32); where one rank holds the whole
    batch they are the blocks themselves. The MoE expert stacks keep their
    ``model`` block (``model_local``). On a mesh that splits nothing (1x1)
    every call returns the block itself.

    ``gathered`` collects the paths gathered since :meth:`grad_leaves` (the
    step checks that the loss read every leaf through this object);
    ``peak_bytes`` is the most the gathers' results held at once."""

    def __init__(self, mesh, specs: Any):
        self.mesh = mesh
        self._spec = _spec_of(specs)
        self._sizes = mesh_sizes(mesh)
        self._nb = batch_size_on(mesh)
        self._dtype: dict = {}
        self.gathered: set = set()
        self.live = self.peak_bytes = 0

    def grad_leaves(self, params: Any) -> list:
        """The leaves of ``params`` (this rank's blocks) for autograd to
        differentiate, in ``tree_leaves`` order, each requiring grad: fp32
        copies of floating leaves where the batch ranks sum, else the
        blocks detached."""
        self.gathered.clear()
        out = []
        for p, x in zip(tree_paths(params), tree_leaves(params)):
            self._dtype[p] = x.dtype
            x = x.detach()
            if self._nb > 1 and x.is_floating_point():
                x = x.float()
            out.append(x.requires_grad_(True))
        return out

    def _leaf(self, path: str, x: torch.Tensor, spec: tuple) -> torch.Tensor:
        self.gathered.add(path)
        keep = ("model",) if model_local(path) else ()
        splits = any(a not in keep and self._sizes.get(a, 1) > 1
                     for ax in spec for a in _spec_axes(ax))
        if not splits and self._nb == 1:
            return x
        out = _GatherBlock.apply(x, spec, self.mesh, keep, path, self._dtype.get(path, x.dtype))
        if splits:
            self._count(out)
        return out

    def _count(self, t: torch.Tensor) -> None:
        n = t.untyped_storage().nbytes()
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)

        def freed(_, n=n):
            self.live -= n

        weakref.finalize(t.untyped_storage(), freed, None)

    def _tree(self, key: str, sub: Any, drop_leading: bool) -> Any:
        def leaf(p, x):
            path = f"{key}/{p}" if p else key
            s = self._spec[path]
            return self._leaf(path, x, s[1:] if drop_leading else s)

        return map_with_path(leaf, sub)

    def layer(self, key: str, layer_params: Any) -> Any:
        """ONE layer's slice of the stacked ``params[key]``, gathered."""
        return self._tree(key, layer_params, drop_leading=True)

    def full(self, key: str, sub: Any) -> Any:
        """A non-stacked subtree or leaf ``params[key]``, gathered whole."""
        return self._tree(key, sub, drop_leading=False)

    def expert(self, key: str, w: torch.Tensor) -> torch.Tensor:
        """One expert's block of the stacked ``(K, N, d)`` ``params[key]``
        → its whole ``(N, d)`` rows."""
        return self._tree(key, w, drop_leading=True)

    def rows(self, key: str, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """``table[ids]``, the table gathered whole (its gradient is a
        scatter into the whole table, reduced into the block)."""
        return self.full(key, table)[ids.long()]


def global_norm(tree: Any, mesh, specs: Any) -> torch.Tensor:
    """The fp32 l2 norm of a tree of blocks placed by ``specs``: each leaf's
    local sum of squares is added over the axes its placement splits, and
    only those, so a leaf replicated over an axis counts once. Leaves that
    split over the same axes share one all-reduce; without a split this is
    ``utils.tree.tree_global_norm``'s sum, in its order."""
    spec = _spec_of(specs)
    sizes = mesh_sizes(mesh)
    groups: dict = {}
    for p, x in zip(tree_paths(tree), tree_leaves(tree)):
        used = {a for ax in spec[p] for a in _spec_axes(ax)}
        axes = tuple(a for a in sizes if a in used and sizes[a] > 1)
        groups.setdefault(axes, []).append(x)
    total = None
    for axes in sorted(groups):  # the same order on every rank
        sq = sum(torch.sum(torch.square(x.float())) for x in groups[axes])
        if axes:
            sq = collective(sq, axis_group(mesh, axes), "all_reduce")
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def batch_group(mesh):
    """The process group over the (pod, data) axes wider than 1, ranks in
    :func:`batch_index` order."""
    sizes = mesh_sizes(mesh)
    return axis_group(mesh, tuple(a for a in batch_axes(mesh) if sizes[a] > 1))


def batch_ranks(mesh) -> int:
    """How many ranks split the batch: the (pod, data) size, 1 without a
    mesh."""
    return 1 if mesh is None else batch_size_on(mesh)


def batch_index(mesh) -> int:
    """This rank's place among the batch ranks, row-major over (pod, data)
    as :func:`slice_leaf` lays blocks out; 0 without a mesh."""
    if mesh is None:
        return 0
    sizes, c = mesh_sizes(mesh), 0
    for a in batch_axes(mesh):
        c = c * sizes[a] + axis_index(mesh, a)
    return c


class _SumOverRanks(torch.autograd.Function):
    """Σ over a process group forward, and Σ over it backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collective(x, group, "all_reduce")

    @staticmethod
    def backward(ctx, g):
        return collective(g, ctx.group, "all_reduce"), None


def batch_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the batch ranks, the same on every rank; its
    gradient is the sum of the ranks' cotangents (the loss convention
    above). ``x`` itself without a mesh or where one rank holds the whole
    batch."""
    if batch_ranks(mesh) == 1:
        return x
    return _SumOverRanks.apply(x, batch_group(mesh))


def batch_mean(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """The mean of ``x`` along ``dim`` over every batch rank's rows (each
    rank holds as many), the same on every rank; ``torch.mean(x, dim)``
    where the batch is not split."""
    nb = batch_ranks(mesh)
    if nb == 1:
        return torch.mean(x, dim=dim)
    return batch_sum(torch.sum(x, dim=dim), mesh) / (x.shape[dim] * nb)


class _EnterModel(torch.autograd.Function):
    """Identity forward, Σ over the ``model`` group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collective(g, ctx.group, "all_reduce"), None


class _ExitModel(torch.autograd.Function):
    """Σ over the ``model`` group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return collective(x, group, "all_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


def _model_size(mesh) -> int:
    return mesh_sizes(mesh).get("model", 1)


def model_enter(x: torch.Tensor, mesh) -> torch.Tensor:
    """Where a region split over ``model`` starts: ``x`` forward; backward
    the sum of the model ranks' cotangents (each rank's region saw only its
    share of the work that reads ``x``)."""
    if _model_size(mesh) == 1:
        return x
    return _EnterModel.apply(x, axis_group(mesh, "model"))


def model_exit(x: torch.Tensor, mesh) -> torch.Tensor:
    """Where a region split over ``model`` ends: the sum of the model
    ranks' partials forward; backward the cotangent as it is (every model
    rank carries the same one downstream)."""
    if _model_size(mesh) == 1:
        return x
    return _ExitModel.apply(x, axis_group(mesh, "model"))
