"""Multi-node dry-run: trace every (arch × shape × mesh) cell on meta tensors
(``repro.launch.dryrun``'s counterpart).

``repro`` AOT-compiles its real step against abstract inputs on 256 or 512
fake CPU devices and reads XLA's memory and cost analyses. PyTorch has no
ahead-of-time compile with a memory analysis, so for each cell the port
runs its REAL step on meta tensors (shapes, no memory), as rank 0 of a
fake world of the production mesh's size (``launch.mesh.fake_world``),
under ``distributed.hlo_analysis.analyze``:

* train cells: ``make_train_step(bundle, TrainConfig(microbatches=…),
  mesh=, shardings=)`` on this rank's block of the train state
  (``sharding.shard_train_state``), the whole global batch given, as on
  every rank of a real world;
* serving cells: what a mesh ``ServeSession`` runs (its FSDP layout,
  ``param_mode='fsdp'``): the weights stored ``data``-sharded and gathered
  a layer at a time (``ServeParamGather``), the serve table
  expert-parallel over ``model`` (``shard_table``), and this rank's block
  of the ``global_batch`` slots' decode cache where
  ``serve_cache_shardings`` splits the slots over (pod, data), the whole
  cache where it does not (``sharding.serve_cache_block``). A prefill
  cell is ``global_batch`` whole-prompt prefills, one request a call on
  every rank (``ServeSession._prefill_into_slot``): one call is traced and
  its costs are counted ``global_batch`` times; a decode cell is one
  decode step of this rank's slots against its ``seq_len`` cache, then
  the head with its stats over every rank's rows merged, as
  ``ServeSession._decode``.

Every collective runs on the fake group and is recorded; nothing is
allocated on any device. The DS head's exact overflow fixup has a
data-dependent shape, which meta tensors cannot follow: the trace counts
it as zero tokens (``core.dssoftmax._overflow_fixup``).

Each cell's JSON holds, per rank: ``memory`` (``argument_bytes``: the
rank's resident state, or its params, table and cache, and its inputs;
``gathered_bytes``: the most the step holds gathered at once — a train
step's ``TrainParamGather`` measures it over the trace (one layer, one DS
expert's rows, the small leaves), a serving step's is its largest FSDP
gather less the rank's block; ``peak_bytes``: the most alive at once over
the trace, autograd's saved tensors included; ``peak_top``: the largest
tensors alive at that peak, by op, shape, dtype and the port's source
line, and ``largest_tensor`` the largest made at any time; ``fits``
against the card's memory), ``repro_placement_argument_bytes``
(the same arguments placed by ``repro``'s rules: ``param_shardings``,
``cache_shardings``, ``serve_table_shardings``, ``input_shardings``),
``cost`` (``hlo_analysis``) and ``roofline`` (``distributed.roofline``).
``repro``'s ``--hlo-dir`` has no counterpart (there is no HLO; ``cost``
holds the op and kernel-call counts).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \
      --shape decode_32k --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out runs/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.configs import SHAPES, arch_shapes, dryrun_cells, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core import dssoftmax as ds
from repro_torch.distributed import roofline
from repro_torch.distributed import sharding as shard
from repro_torch.distributed.hlo_analysis import analyze
from repro_torch.launch.mesh import fake_world, make_production_mesh, production_mesh_shape
from repro_torch.models import heads, model_zoo
from repro_torch.models.model_zoo import build, cache_specs, input_specs, serve_table_spec
from repro_torch.optim import adam_init
from repro_torch.train.train_step import TrainState, make_train_step
from repro_torch.utils.tree import tree_leaves, tree_paths

_STACKS = ("layers", "enc_layers", "dec_layers")

# How far a card's step peak (``max_memory_allocated`` less
# ``memory_allocated`` at entry, a step warmed up first) may stand from the
# traced one (``step_bytes``): |card - traced| <= PEAK_RTOL * traced +
# PEAK_ATOL. The caching allocator rounds every block up to a multiple of
# 512 bytes (on an H100: +7,112 bytes at lm-100m's 9.98 GiB train step,
# +2,312 at qwen2-1.5b's decode step, 0 at its prefill); the margin also
# leaves room for scratch no op returns (kernel workspaces), none seen.
PEAK_RTOL, PEAK_ATOL = 1e-3, 1 << 20


def _meta_cache(specs):
    """A cache NamedTuple of ``model_zoo.TensorSpec`` s → the same of meta
    tensors."""
    return type(specs)(*(torch.empty(tuple(s.shape), dtype=s.dtype, device="meta")
                         for s in specs))


def _model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train / 2·N·D inference (N = active params)."""
    n_active = model_zoo.count_params_analytic(cfg, active_only=True)
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per request


def train_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """``repro``'s rule (8 above 4 B params, 4 above 1.5 B, else 1), held to
    at least one row a batch rank per microbatch (the 2x32x8 mesh has 64
    batch ranks for 256 rows)."""
    n_params = model_zoo.count_params_analytic(cfg)
    micro = 8 if n_params > 4e9 else (4 if n_params > 1.5e9 else 1)
    return max(1, min(micro, shape.global_batch // shard.batch_ranks(mesh)))


def build_cell(arch: str, shape_name: str, head: Optional[str] = None,
               overrides: Optional[dict] = None):
    """→ (cfg, shape, meta bundle, params, ds_state, input specs): the
    arch's config with ``--head`` and ``--set`` applied (``ds.x`` keys set
    the DS head's config), everything on meta tensors."""
    cfg = get_config(arch)
    if head:
        cfg = cfg.replace(head=head)
    for k, v in (overrides or {}).items():
        if k.startswith("ds."):
            cfg = cfg.replace(ds=cfg.ds.replace(**{k[3:]: v}))
        else:
            cfg = cfg.replace(**{k: v})
    shape = SHAPES[shape_name]
    return (cfg, shape) + _abstract(cfg, shape)


def _abstract(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    bundle = build(cfg, device="meta")
    params, ds_state = bundle.abstract_params()
    return bundle, params, ds_state, input_specs(cfg, shape)


@dataclass
class Cell:
    """One traced call and what a rank holds for it."""

    cfg: ModelConfig
    shape: ShapeConfig
    fn: Any                # the traced call, fn() → its output
    arguments: dict        # name → tree of this rank's meta tensors alive at entry
    calls: int             # times the call runs per cell step (prefill: one per request)
    gathered: Any          # () → the bytes the step holds gathered at once, after the trace
    repro_placement: int   # the arguments' bytes a rank holds under repro's rules
    microbatches: Optional[int] = None


def train_state_bytes(mesh, state) -> int:
    """One rank's bytes of a ``TrainState`` placed on ``mesh`` (a
    DeviceMesh, or ``{axis name: size}``) by ``train_state_shardings``."""
    return shard.placed_bytes(state, shard.train_state_shardings(mesh, state), mesh)


def _gathered_serve_bytes(params, mesh) -> int:
    """The largest FSDP gather of a serving step (``ServeParamGather``:
    one layer of a stack, or a non-stacked leaf gathered whole), less what
    the rank holds of it. The embedding moves rows, not its table."""
    if mesh is None:
        return 0
    specs = shard.serve_param_shardings(mesh, params)
    sizes = shard.mesh_sizes(mesh)
    per: dict = {}
    for p, x, s in zip(tree_paths(params), tree_leaves(params), tree_leaves(specs)):
        split = 1
        for ax in s:
            for a in shard._spec_axes(ax):
                split *= sizes.get(a, 1)
        top = p.split("/")[0]
        if top == "embed" or split == 1:
            continue
        nbytes = x.numel() * x.element_size()
        if top in _STACKS:
            nbytes //= x.shape[0]
            key = top
        else:
            key = p
        per[key] = per.get(key, 0) + nbytes - nbytes // split
    return max(per.values(), default=0)


def _serve_table(cfg: ModelConfig, v_pad: Optional[int]):
    """The packed fp serve table's meta tensors (``serve_table_spec``, or
    ``v_pad`` rows an expert where given); None for a full-softmax head."""
    spec = serve_table_spec(cfg)
    if spec is None:
        return None
    K, vp = spec.ids.shape[0], v_pad or spec.ids.shape[1]
    return ds.ServeTable(ids=torch.empty((K, vp), dtype=torch.int32, device="meta"),
                         weights=torch.empty((K, vp, cfg.d_model), dtype=cfg.jdtype,
                                             device="meta"))


def repro_arguments(cfg: ModelConfig, shape: ShapeConfig, v_pad: Optional[int] = None) -> dict:
    """The arguments ``repro``'s dry-run compiles a cell's step for, as
    meta tensors (``repro/launch/dryrun.py:84-139``): the train state and
    the batch; or the params, the serve table and the batch (prefill),
    with the cache, the token and the position (decode)."""
    _, params, ds_state, specs = _abstract(cfg, shape)
    if shape.kind == "train":
        return {"state": TrainState(params=params, opt=adam_init(params), ds_state=ds_state),
                "batch": specs}
    out = {"params": params, "table": _serve_table(cfg, v_pad), "batch": specs}
    if shape.kind == "decode":
        out["cache"] = _meta_cache(cache_specs(cfg, shape))
        out["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    return out


def repro_placement_bytes(mesh, cfg: ModelConfig, shape: ShapeConfig,
                          v_pad: Optional[int] = None) -> int:
    """One rank's bytes of :func:`repro_arguments` placed by ``repro``'s
    rules on ``mesh`` (a DeviceMesh, or any object with ``shape`` mapping
    axis names to sizes): ``train_state_shardings`` (``param_shardings``
    for the params and moments), ``serve_table_shardings``,
    ``cache_shardings``, ``input_shardings``; the position replicated. The
    whole arguments with ``mesh=None``."""
    args = repro_arguments(cfg, shape, v_pad)
    if mesh is None:
        return shard.tree_shard_bytes(args)
    total = 4 if "pos" in args else 0
    place = {"state": lambda t: shard.train_state_shardings(mesh, t),
             "params": lambda t: shard.param_shardings(mesh, t),
             "table": lambda t: shard.serve_table_shardings(mesh, t),
             "cache": lambda t: shard.cache_shardings(mesh, cfg, t, shape),
             "batch": lambda t: shard.input_shardings(mesh, cfg, t, shape)}
    for name, tree in args.items():
        if name != "pos" and tree is not None:
            total += shard.placed_bytes(tree, place[name](tree), mesh)
    return total


def trace_cell(mesh, cfg: ModelConfig, shape: ShapeConfig, *,
               microbatches: Optional[int] = None, v_pad: Optional[int] = None) -> Cell:
    """The call a rank of ``mesh`` runs for one step of a (cfg × shape)
    cell, on meta tensors (``lower_cell``'s counterpart: nothing is
    compiled, the call is traced when counted). ``mesh=None``: one card, no
    world (the plain train step, a session without a mesh).
    ``microbatches``: the train step's, else :func:`train_microbatches`;
    ``v_pad``: the serve table's rows an expert, else
    ``serve_table_spec``'s. The head takes the config's serve path."""
    bundle, params, ds_state, specs = _abstract(cfg, shape)
    repro = repro_placement_bytes(mesh, cfg, shape, v_pad)
    if shape.kind == "train":
        micro = microbatches or train_microbatches(cfg, shape, mesh)
        state = TrainState(params=params, opt=adam_init(params), ds_state=ds_state)
        local, st_specs = (shard.shard_train_state(mesh, state) if mesh is not None
                           else (state, None))
        step = make_train_step(bundle, TrainConfig(microbatches=micro), mesh=mesh,
                               shardings=st_specs)

        def fn():  # the caller keeps its state until the step returns, as a trainer does
            return step(local, specs)

        gathered = (lambda: step.gather.peak_bytes) if mesh is not None else (lambda: 0)
        return Cell(cfg, shape, fn, {"state": local, "batch": specs}, 1, gathered, repro, micro)

    table = _serve_table(cfg, v_pad)
    if table is not None:  # the serve table holds the head's rows; the session needs the gate
        params = dict(params, head={"gate": params["head"]["gate"]})
    gather = None
    stored = params
    if mesh is not None:
        gather = shard.ServeParamGather(mesh, params)
        stored = shard.shard_tree(mesh, params, shard.serve_param_shardings(mesh, params))
    head_table = ds_state if table is None else (
        ds.shard_table(table, mesh) if mesh is not None else table)
    # the session's cache: this rank's block of the global_batch slots of
    # seq_len positions (all of them where the rule keeps the slots whole)
    slots = shard.serve_cache_block(mesh, shape.global_batch)
    cache = _meta_cache(cache_specs(cfg, dataclasses.replace(shape, global_batch=slots.count)))
    args = {"params": stored, "table": head_table, "cache": cache}
    if shape.kind == "prefill":
        one = {k: torch.empty((1,) + tuple(v.shape[1:]), dtype=v.dtype, device="meta")
               for k, v in specs.items()}
        args["batch"] = one

        def fn():
            return bundle.prefill(stored, head_table, one, mesh=mesh, gather=gather)

        calls = shape.global_batch
    else:
        tok = torch.empty((slots.count,), dtype=torch.int32, device="meta")
        pos = torch.empty((slots.count,), dtype=torch.int32, device="meta")
        args["batch"] = {"token": tok, "pos": pos}
        step_gather = gather.for_local_rows() if gather is not None and slots.splits else gather

        def fn():
            h = bundle.decode_hidden(stored, cache, tok, pos, gather=step_gather)
            return heads.head_topk(stored["head"], head_table, cfg, h, 8,
                                   embed_table=stored["embed"]["table"], mesh=mesh,
                                   gather=gather, with_stats=True, local_rows=slots.splits)

        calls = 1
    served = _gathered_serve_bytes(params, mesh)
    return Cell(cfg, shape, fn, args, calls, lambda: served, repro)


def card_memory() -> tuple:
    """(bytes, source) of one card's memory: the card's own where CUDA is
    up, else the H100 80GB specification."""
    if torch.cuda.is_available():
        return (int(torch.cuda.get_device_properties(0).total_memory),
                torch.cuda.get_device_name(0))
    return int(roofline.HBM_BYTES), "NVIDIA H100 80GB (specification)"


def count_cell(cell: Cell, n_devices: int) -> dict:
    """Trace ``cell`` under ``hlo_analysis.analyze`` → its record's memory,
    cost and roofline (per rank)."""
    arg_bytes = {k: shard.tree_shard_bytes(v) for k, v in cell.arguments.items()}
    t0 = time.perf_counter()
    _, cost = analyze(cell.fn, resident=cell.arguments)
    trace_s = time.perf_counter() - t0
    peak = cost.pop("peak_bytes")
    peak_top = cost.pop("peak_top")
    largest = cost.pop("largest_tensor")
    read_once = cost.pop("read_once_bytes_by_kind")
    if cell.calls > 1:  # the same call once per request
        for key in ("flops", "bytes", "coll_operand_bytes", "coll_wire_bytes",
                    "coll_wire_bytes_nvlink", "coll_wire_bytes_network", "ops"):
            cost[key] *= cell.calls
        for key in ("flops_by_dtype", "coll_counts", "coll_bytes_by_kind", "kernel_calls"):
            cost[key] = {k: v * cell.calls for k, v in cost[key].items()}
    card_bytes, card = card_memory()
    dtype = str(cell.cfg.jdtype).replace("torch.", "")
    rf = roofline.roofline_from_cost(cost, n_devices=n_devices,
                                     model_flops=_model_flops(cell.cfg, cell.shape),
                                     model_dtype=dtype)
    argument = sum(arg_bytes.values())
    return {
        "memory": {
            "argument_bytes": argument,
            "argument_bytes_by_kind": arg_bytes,
            # the bytes of each kind of argument the step reads, each once
            "read_once_bytes_by_kind": read_once,
            "gathered_bytes": cell.gathered(),
            "peak_bytes": peak,
            "peak_top": peak_top,
            "largest_tensor": largest,
            "step_bytes": peak - argument,
            "card_bytes": card_bytes,
            "card": card,
            "fits": peak <= card_bytes,
        },
        "repro_placement_argument_bytes": cell.repro_placement,
        "cost": cost,
        "roofline": rf.to_dict(),
        "trace_s": trace_s,
    }


def run_cell(mesh, mesh_name: str, arch: str, shape_name: str, head=None,
             overrides: Optional[dict] = None, tag: str = "",
             cfg: Optional[ModelConfig] = None, shape: Optional[ShapeConfig] = None, **trace):
    """Trace and count one (arch × shape) cell on ``mesh`` → its record.
    ``cfg``/``shape`` stand in for the registry's (a reduced config, a
    cell one card runs); ``trace``: :func:`trace_cell`'s options."""
    t0 = time.time()
    if cfg is None:
        cfg, shape = build_cell(arch, shape_name, head, overrides)[:2]
    cell = trace_cell(mesh, cfg, shape, **trace)
    n_dev = shard.batch_size_on(mesh) * shard.mesh_sizes(mesh).get("model", 1) \
        if mesh is not None else 1
    counted = count_cell(cell, n_dev)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "head": head or cfg.head,
        "tag": tag,
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
        "n_devices": int(n_dev),
        "ok": True,
        "microbatches": cell.microbatches,
        "calls": cell.calls,
        "trace_s": round(counted["trace_s"], 2),
        "wall_s": round(time.time() - t0, 2),
        "memory": counted["memory"],
        "repro_placement_argument_bytes": counted["repro_placement_argument_bytes"],
        "cost": counted["cost"],
        "roofline": counted["roofline"],
        "param_bytes_global": shard.tree_shard_bytes(build(cfg, device="meta")
                                                     .abstract_params()[0]),
    }
    m, c, rf = rec["memory"], rec["cost"], rec["roofline"]
    print(f"[dryrun] {arch:>22s} x {shape_name:<12s} x {mesh_name:<6s} OK  "
          f"trace={rec['trace_s']:6.1f}s  flops/dev={c['flops']:.3e}  hbm/dev={c['bytes']:.3e}B  "
          f"coll/dev={c['coll_wire_bytes']:.3e}B  bottleneck={rf['bottleneck']}  "
          f"args={m['argument_bytes'] / 2**30:.2f}GiB  peak={m['peak_bytes'] / 2**30:.2f}GiB  "
          f"fits={m['fits']}", flush=True)
    return rec


def _parse_overrides(pairs) -> dict:
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        else:
            for cast in (int, float):
                try:
                    v = cast(v)
                    break
                except ValueError:
                    pass
        out[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--head", choices=["ds", "full"], default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="runs/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. remat=dots, ds.serve_kernel=cuda_fused)")
    ap.add_argument("--tag", type=str, default="")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.set)

    if args.all:
        cells = dryrun_cells()
    else:
        if not args.arch:
            ap.error("--arch is required unless --all")
        shapes = [SHAPES[args.shape]] if args.shape else arch_shapes(args.arch)
        cells = [(args.arch, s) for s in shapes]
    meshes = [m for m in ("single", "multi") if args.mesh in (m, "both")]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    t0 = time.time()
    for mesh_name in meshes:
        shape, _ = production_mesh_shape(multi_pod=mesh_name == "multi")
        n = 1
        for s in shape:
            n *= s
        with fake_world(n):
            mesh = make_production_mesh(multi_pod=mesh_name == "multi")
            for arch, sh in cells:
                tag = (f"{arch}__{sh.name}__{mesh_name}" + (f"__{args.head}" if args.head else "")
                       + (f"__{args.tag}" if args.tag else ""))
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    continue
                try:
                    rec = run_cell(mesh, mesh_name, arch, sh.name, args.head, overrides,
                                   args.tag)
                except Exception as e:  # noqa: BLE001 — record per-cell failure
                    failures += 1
                    rec = {"arch": arch, "shape": sh.name, "mesh": mesh_name, "ok": False,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"[dryrun] {arch} x {sh.name} x {mesh_name} FAILED: {e}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    print(f"[dryrun] done in {time.time() - t0:.1f} s, {failures} failures", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
