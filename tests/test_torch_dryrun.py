"""The dry-run (``repro_torch.launch.dryrun``) and what it rests on, held
against ``repro``: the placement rules ``input_shardings``,
``cache_shardings``, ``serve_table_shardings`` and ``topk_out_shardings``
as plain data on production and small meshes (``repro``'s on a
``jax.sharding.AbstractMesh``); ``abstract_params``' paths, shapes and
dtypes for every arch at full width; a rank's bytes under ``repro``'s
placement for every (arch × shape) cell; the cost counter against
analytic counts and against ``repro``'s ``analyze_hlo``; the H100
roofline; reduced cells traced in a fake world of 4 ranks; and the seeded
``init_params`` draws, unchanged."""
import functools
import hashlib
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.distributed import sharding as jshard
from repro.distributed.hlo_analysis import analyze_hlo
from repro.launch.dryrun import _abstract_opt_state
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtransformer
from repro_torch.configs import ARCHS, SHAPES, dryrun_cells, get_config, reduce_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import dssoftmax as ds
from repro_torch.distributed import hlo_analysis, roofline
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, production_mesh_shape
from repro_torch.models import build
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttransformer
from repro_torch.utils.tree import tree_leaves, tree_paths

torch.set_num_threads(1)

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((32, 8), ("data", "model")), ((2, 32, 8), ("pod", "data", "model")),
          ((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model")), ((4, 1), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]


def _meshes(shape, axes):
    """(repro's AbstractMesh, the port's stand-in) of one mesh shape."""
    return (AbstractMesh(tuple(shape), tuple(axes)),
            SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=tuple(axes)))


def _norm(entry):
    """One dim's placement, a single-axis tuple written as its name."""
    if isinstance(entry, tuple):
        return entry[0] if len(entry) == 1 else tuple(entry)
    return entry


def _spec(ns_or_tuple, ndim):
    entries = tuple(ns_or_tuple.spec) if isinstance(ns_or_tuple, NamedSharding) else ns_or_tuple
    entries = tuple(_norm(e) for e in entries)
    return entries + (None,) * (ndim - len(entries))


def _jax_paths(tree, is_leaf):
    return {jax.tree_util.keystr(k, simple=True, separator="/"): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _torch_paths(tree):
    return dict(zip(tree_paths(tree), tree_leaves(tree)))


@pytest.mark.parametrize("mesh_shape,axes", MESHES, ids=MESH_IDS)
def test_placement_rules_match_repro(mesh_shape, axes):
    jm, tm = _meshes(mesh_shape, axes)
    bad = []
    is_ns = lambda x: isinstance(x, NamedSharding)  # noqa: E731
    for arch, shape in dryrun_cells():
        jcfg, tcfg = jget_config(arch), get_config(arch)
        jspecs, tspecs = jzoo.input_specs(jcfg, shape), tzoo.input_specs(tcfg, shape)
        jin = jshard.input_shardings(jm, jcfg, jspecs, shape)
        tin = sharding.input_shardings(tm, tcfg, tspecs, shape)
        assert set(jin) == set(tin)
        for k in jin:
            nd = len(tspecs[k].shape)
            if _spec(jin[k], nd) != _spec(tin[k], nd):
                bad.append((arch, shape.name, "input", k, jin[k].spec, tin[k]))
        if shape.kind == "decode":
            jc = jzoo.cache_specs(jcfg, shape)
            tc = dryrun._meta_cache(tzoo.cache_specs(tcfg, shape))
            js = _jax_paths(jshard.cache_shardings(jm, jcfg, jc, shape), is_ns)
            ts = _torch_paths(sharding.cache_shardings(tm, tcfg, tc, shape))
            tl = _torch_paths(tc)
            assert set(js) == set(ts), (arch, sorted(js), sorted(ts))
            for p in js:
                nd = len(tl[p].shape)
                if _spec(js[p], nd) != _spec(ts[p], nd):
                    bad.append((arch, shape.name, "cache", p, js[p].spec, ts[p]))
        if shape.kind != "train" and jcfg.head == "ds":
            jt = jzoo.serve_table_spec(jcfg)
            tt = dryrun._serve_table(tcfg, None)
            js = jshard.serve_table_shardings(jm, jt)
            ts = sharding.serve_table_shardings(tm, tt)
            for f in ("ids", "weights"):
                nd = getattr(tt, f).dim()
                if _spec(getattr(js, f), nd) != _spec(getattr(ts, f), nd):
                    bad.append((arch, "table", f))
    # a quantized table's placement, field by field
    from repro.core.dssoftmax import QuantizedServeTable as JQ

    jq = jshard.serve_table_shardings(jm, JQ(*(None,) * 5))
    tq = sharding.serve_table_shardings(tm, ds.QuantizedServeTable(*(None,) * 5))
    for f, nd in zip(ds.QuantizedServeTable._fields, (2, 3, 2, 1, 3)):
        if _spec(getattr(jq, f), nd) != _spec(getattr(tq, f), nd):
            bad.append(("quantized table", f))
    for B in (1, 3, 8, 32, 128, 256, 512):
        if _spec(jshard.topk_out_shardings(jm, B), 2) != _spec(
                sharding.topk_out_shardings(tm, B), 2):
            bad.append(("topk", B))
    assert not bad, bad[:8]


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_repro(arch):
    jp, js = jzoo.build(jget_config(arch)).abstract_params()
    tb = build(get_config(arch), device="meta")
    tp, ts = tb.abstract_params()
    want = _jax_paths({"params": jp, "state": js}, None)
    got = _torch_paths({"params": tp, "state": ts})
    assert set(want) == set(got), sorted(set(want) ^ set(got))
    jdt = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32, jnp.bool_: torch.bool,
           jnp.int32: torch.int32}
    bad = [(p, want[p].shape, want[p].dtype, tuple(got[p].shape), got[p].dtype) for p in want
           if tuple(want[p].shape) != tuple(got[p].shape)
           or jdt[want[p].dtype.type] != got[p].dtype or not got[p].is_meta]
    assert not bad, bad


def test_ds_abstract_params_match_repro():
    from repro.core import dssoftmax as jds

    jcfg = jget_config("qwen2-1.5b")
    jp, js = jds.abstract_params(1536, 151936, jcfg.ds)
    tp, ts = ds.abstract_params(1536, 151936, get_config("qwen2-1.5b").ds)
    for k in ("gate", "experts"):
        assert tuple(jp[k].shape) == tuple(tp[k].shape) and tp[k].dtype == torch.bfloat16
        assert tp[k].is_meta
    assert tuple(js.mask.shape) == tuple(ts.mask.shape) and ts.mask.dtype == torch.bool


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch):
    return jzoo.build(jget_config(arch)).abstract_params()


def _repro_placement(jm, arch, shape):
    """Σ over ``repro``'s dry-run arguments of one rank's block bytes
    (``NamedSharding(AbstractMesh, spec).shard_shape`` × itemsize)."""
    from repro.core.dssoftmax import DSState

    cfg = jget_config(arch)
    params, ds_state = _jax_abstract(arch)
    specs = jzoo.input_specs(cfg, shape)
    p_shard = jshard.param_shardings(jm, params)
    args, shards = [params, specs], [p_shard, jshard.input_shardings(jm, cfg, specs, shape)]
    repl = NamedSharding(jm, jax.sharding.PartitionSpec())
    if shape.kind == "train":
        opt = _abstract_opt_state(params)
        args += [opt, ds_state]
        shards += [type(opt)(step=repl, m=jshard.param_shardings(jm, opt.m),
                             v=jshard.param_shardings(jm, opt.v)),
                   None if ds_state is None else DSState(
                       mask=NamedSharding(jm, jax.sharding.PartitionSpec(None, "model")))]
    else:
        table = jzoo.serve_table_spec(cfg)
        if table is not None:
            args.append(table)
            shards.append(jshard.serve_table_shardings(jm, table))
        if shape.kind == "decode":
            cache = jzoo.cache_specs(cfg, shape)
            args += [cache, jax.ShapeDtypeStruct((), jnp.int32)]
            shards += [jshard.cache_shardings(jm, cfg, cache, shape), repl]
    total = 0
    for a, s in zip(args, shards):
        if a is None:
            continue
        leaves = jax.tree_util.tree_leaves(a)
        nss = jax.tree_util.tree_leaves(s, is_leaf=lambda x: isinstance(x, NamedSharding))
        assert len(leaves) == len(nss)
        for leaf, ns in zip(leaves, nss):
            total += math.prod(ns.shard_shape(tuple(leaf.shape))) * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh_shape,axes", MESHES[:4], ids=MESH_IDS[:4])
def test_repro_placement_argument_bytes_match_repro(mesh_shape, axes):
    jm, tm = _meshes(mesh_shape, axes)
    bad = []
    for arch, shape in dryrun_cells():
        want = _repro_placement(jm, arch, shape)
        got = dryrun.repro_placement_bytes(tm, get_config(arch), shape)
        if got != want:
            bad.append((arch, shape.name, want, got))
    assert not bad, bad


# --- the cost counter -------------------------------------------------------


def test_counter_counts_a_stacked_matmul_and_its_grad():
    L, B, D = 12, 8, 16
    x = torch.randn(B, D)
    ws = torch.randn(L, D, D)

    def f(ws, x):
        for i in range(L):
            x = torch.tanh(x @ ws[i])
        return torch.sum(x)

    _, cost = hlo_analysis.analyze(f, ws, x)
    assert cost["flops"] == L * 2 * B * D * D
    a, b = torch.randn(32, 64, requires_grad=True), torch.randn(64, 48, requires_grad=True)
    _, cost = hlo_analysis.analyze(
        lambda: torch.autograd.grad(torch.sum(torch.tanh(a @ b)), (a, b)))
    assert cost["flops"] == 3 * 2 * 32 * 64 * 48  # the forward and two backward products
    assert cost["flops_by_dtype"] == {"float32": cost["flops"]}


def test_counter_counts_kernels_and_views_as_the_card_runs_them():
    q = torch.empty(1, 4, 256, 64, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(1, 2, 256, 64, dtype=torch.bfloat16, device="meta")
    from repro_torch.kernels import ops

    before = ops.flash_attention.launches
    out, cost = hlo_analysis.analyze(lambda: ops.flash_attention(q, kv, kv, device="meta"))
    assert out.shape == q.shape and out.is_meta and ops.flash_attention.launches == before
    assert cost["kernel_calls"] == {"flash_attention": 1} and cost["ops"] == 1
    assert cost["bytes"] == (q.numel() + 2 * kv.numel() + q.numel()) * 2  # q, k, v in; o out
    assert cost["flops"] == 2 * 1 * 4 * 64 * 256 * 257
    assert cost["peak_bytes"] == q.numel() * 2  # the output alone: no (S, S) scores resident
    x = torch.empty(64, 64, device="meta")
    _, cost = hlo_analysis.analyze(lambda: x.view(16, 256).transpose(0, 1)[3])
    assert cost["bytes"] == 0 and cost["ops"] == 0


def test_counter_matches_analyze_hlo_on_a_dense_forward():
    """The flops of one reduced dense forward (the stacked layers and the
    final norm), against ``repro``'s HLO count: exact up to the XLA
    rewrites the tolerance allows (0.5%)."""
    jcfg = jreduce_config(jget_config("qwen2-1.5b")).replace(dtype="float32")
    tcfg = reduce_config(get_config("qwen2-1.5b")).replace(dtype="float32")
    B, S = 2, 64
    jp, _ = jzoo.build(jcfg).abstract_params()
    x = jax.ShapeDtypeStruct((B, S, jcfg.d_model), jnp.float32)
    pos = jax.ShapeDtypeStruct((B, S), jnp.int32)
    txt = jax.jit(lambda p, x, pos: jtransformer.forward_hidden(p, jcfg, x, pos)).lower(
        jp, x, pos).compile().as_text()
    want = analyze_hlo(txt)["flops"]
    tp, _ = build(tcfg, device="meta").abstract_params()
    tx = torch.empty(B, S, tcfg.d_model, device="meta")
    tpos = torch.empty(B, S, dtype=torch.int32, device="meta")
    _, cost = hlo_analysis.analyze(lambda: ttransformer.forward_hidden(tp, tcfg, tx, tpos))
    assert abs(cost["flops"] - want) <= 5e-3 * want, (cost["flops"], want)


def test_roofline_terms_on_h100_constants():
    cost = {"flops": 989e12 + 67e12, "flops_by_dtype": {"bfloat16": 989e12, "float32": 67e12},
            "bytes": 3.35e12 * 3, "coll_operand_bytes": 1.0, "coll_wire_bytes": 450e9 + 50e9,
            "coll_wire_bytes_nvlink": 450e9, "coll_wire_bytes_network": 50e9,
            "coll_counts": {"all-gather": 2}}
    rf = roofline.roofline_from_cost(cost, n_devices=256, model_flops=989e12 * 256 * 0.5)
    assert math.isclose(rf.compute_s, 2.0) and math.isclose(rf.memory_s, 3.0)
    assert math.isclose(rf.nvlink_s, 1.0) and math.isclose(rf.network_s, 1.0)
    assert rf.bottleneck == "memory" and rf.step_time_s == rf.memory_s
    assert math.isclose(rf.achievable_frac, 0.5 / 3.0)
    assert math.isclose(rf.useful_ratio, 989e12 * 0.5 / (989e12 + 67e12))
    assert (roofline.HBM_BW, roofline.NVLINK_BW, roofline.NETWORK_BW) == (3.35e12, 450e9, 50e9)


# --- reduced cells in a fake world -------------------------------------------


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_run_cell_in_a_fake_world_leaves_no_group(kind):
    from torch.distributed.device_mesh import init_device_mesh

    cfg = reduce_config(get_config("qwen2-1.5b"))
    shape = ShapeConfig(name=f"tiny_{kind}", seq_len=64, global_batch=8, kind=kind)
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        rec = dryrun.run_cell(mesh, "2x2", "qwen2-1.5b", shape.name, cfg=cfg, shape=shape)
        with pytest.raises(RuntimeError, match="already running"):
            with fake_world(4):
                pass
    assert not dist.is_initialized()
    m, c = rec["memory"], rec["cost"]
    assert rec["ok"] and rec["n_devices"] == 4 and m["fits"]
    assert m["peak_bytes"] > m["argument_bytes"] > 0
    assert c["flops"] > 0 and c["bytes"] > 0 and c["coll_wire_bytes"] > 0
    assert c["coll_wire_bytes"] == c["coll_wire_bytes_nvlink"]  # 4 ranks: one node
    assert rec["roofline"]["step_time_s"] > 0
    want = dryrun.repro_placement_bytes(SimpleNamespace(shape={"data": 2, "model": 2}), cfg,
                                        shape)
    assert rec["repro_placement_argument_bytes"] == want
    if kind == "train":
        whole = sharding.tree_shard_bytes(dryrun.repro_arguments(cfg, shape)["state"])
        assert m["argument_bytes_by_kind"]["state"] < whole
        assert c["coll_counts"].get("reduce-scatter", 0) > 0
    else:
        assert c["kernel_calls"]  # the head's kernel, counted as one op
        # the session's cache as serve_cache_shardings places it: 8 slots
        # over the 2 data ranks
        cache = dryrun._meta_cache(tzoo.cache_specs(cfg, shape))
        mesh2 = {"data": 2, "model": 2}
        assert m["argument_bytes_by_kind"]["cache"] == sharding.placed_bytes(
            cache, sharding.serve_cache_shardings(mesh2, cfg, cache, shape.global_batch), mesh2)


def test_decode_cell_traces_the_slot_split_cache():
    """A reduced decode cell (8 slots) in a fake world of 4 (2x2): the traced
    cache argument is ``placed_bytes`` under ``serve_cache_shardings``, half
    the single card's, whose step steps all 8 slots; the head's (B, k) rows
    come back whole over the data ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = reduce_config(get_config("qwen2-1.5b"))
    shape = ShapeConfig(name="tiny_decode", seq_len=64, global_batch=8, kind="decode")
    one = dryrun.run_cell(None, "1x1", "qwen2-1.5b", shape.name, cfg=cfg, shape=shape)
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        rec = dryrun.run_cell(mesh, "2x2", "qwen2-1.5b", shape.name, cfg=cfg, shape=shape)
        out = dryrun.trace_cell(mesh, cfg, shape).fn()
    cache = dryrun._meta_cache(tzoo.cache_specs(cfg, shape))
    mesh2 = {"data": 2, "model": 2}
    placed = sharding.placed_bytes(cache, sharding.serve_cache_shardings(mesh2, cfg, cache, 8),
                                   mesh2)
    got = rec["memory"]["argument_bytes_by_kind"]["cache"]
    assert got == placed == one["memory"]["argument_bytes_by_kind"]["cache"] // 2
    assert rec["memory"]["argument_bytes_by_kind"]["batch"] * 2 == \
        one["memory"]["argument_bytes_by_kind"]["batch"]
    assert out[0].shape == out[1].shape == (8, 8)


def test_train_cell_gathers_a_layer_at_a_time():
    """A reduced DS train cell (8 layers, d 256, layer remat) traced as rank 0
    of a fake world of 8 (4x2): the mesh step keeps the params as blocks
    and gathers one layer, one expert or one small leaf at a time, so its
    step peak (peak less arguments) stays below the whole params' bytes,
    and what it holds gathered at once (``gathered_bytes``) below a
    quarter of them."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = reduce_config(get_config("qwen2-1.5b")).replace(remat="layer", n_layers=8,
                                                          d_model=256, d_ff=512)
    shape = ShapeConfig(name="tiny_train", seq_len=16, global_batch=8, kind="train")
    with fake_world(8):
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
        rec = dryrun.run_cell(mesh, "4x2", "qwen2-1.5b", shape.name, cfg=cfg, shape=shape,
                              microbatches=1)
    m, whole = rec["memory"], rec["param_bytes_global"]
    assert cfg.head == "ds" and 0 < m["step_bytes"] < whole
    assert 0 < m["gathered_bytes"] < whole // 4


def test_loss_rows_widens_one_expert_at_a_time(monkeypatch):
    """``loss_rows`` with bf16 experts (K 4, N 256, d 32; capacity 80, two
    chunks an expert), forward and backward, traced by ``CostCounter``: no
    tensor of the whole experts' K·N·d fp32 elements is ever made (each
    expert's (N, d) rows are widened on their own, inside its checkpoint)."""
    K, N, d, B, S = 4, 256, 32, 2, 256
    g = torch.Generator().manual_seed(3)
    params, st = ds.init(g, d, N, ds.DSSoftmaxConfig(num_experts=K), dtype=torch.bfloat16,
                         device="cpu")
    gate, experts = (params[k].detach().requires_grad_(True) for k in ("gate", "experts"))
    h = torch.randn(B, S, d, generator=g).to(torch.bfloat16).requires_grad_(True)
    labels = torch.randint(0, N, (B, S), generator=g)
    counter = hlo_analysis.CostCounter()
    with counter:
        ce, aux = ds.loss_rows({"gate": gate, "experts": experts}, st, h, labels,
                               ds.DSSoftmaxConfig(num_experts=K))
        total = ce + aux.lasso + aux.expert_lasso + aux.load
        grads = torch.autograd.grad(total, (gate, experts, h))
    assert all(torch.isfinite(x.float()).all() for x in grads)
    assert counter.largest["bytes"] < K * N * d * 4, counter.largest
    # the same trace listing every storage alive at the peak, largest
    # first, each by its op and the line that made it (the port's, or "?"
    # for a backward op this test asked for)
    monkeypatch.setattr(hlo_analysis, "TOP_MIN_BYTES", 0)
    monkeypatch.setattr(hlo_analysis, "TOP_N", 1000)
    counter = hlo_analysis.CostCounter()
    with counter:
        ce, aux = ds.loss_rows({"gate": gate, "experts": experts}, st, h, labels,
                               ds.DSSoftmaxConfig(num_experts=K))
        torch.autograd.grad(ce + aux.lasso + aux.expert_lasso + aux.load, (gate, experts, h))
    top = counter.totals()["peak_top"]
    assert sum(r["bytes"] for r in top) == counter.peak
    assert [r["bytes"] for r in top] == sorted((r["bytes"] for r in top), reverse=True)
    assert all(r["op"].startswith("aten.") for r in top)
    assert {r["where"] for r in top} >= {"?"} and any(
        r["where"].startswith("repro_torch/core/dssoftmax.py:") for r in top)


def test_production_mesh_groups_split_nvlink_from_network():
    from repro_torch.launch.mesh import make_production_mesh

    for multi in (False, True):
        shape, axes = production_mesh_shape(multi)
        with fake_world(math.prod(shape)):
            mesh = make_production_mesh(multi_pod=multi)
            assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == dict(zip(axes, shape))
            assert hlo_analysis.intra_node(sharding.axis_group(mesh, "model"))
            assert not hlo_analysis.intra_node(sharding.axis_group(mesh, "data"))
            assert not hlo_analysis.intra_node(
                sharding.axis_group(mesh, sharding.batch_axes(mesh)))
        assert not dist.is_initialized()


# --- the seeded draws ---------------------------------------------------------

# sha256 (first 16 hex digits) of every leaf's path and bytes of
# ``build(reduce_config(arch), 'cpu').init(Generator().manual_seed(0))``,
# taken before the init functions moved into ``layers``/``transformer``
INIT_DIGESTS = {
    "mamba2-130m": "995cc68ab15b64b2", "granite-20b": "1082e4039f44be1d",
    "qwen2-1.5b": "c9503de81550a784", "llama3.2-3b": "76eb83d7b01f0874",
    "deepseek-67b": "76eb83d7b01f0874", "whisper-base": "890a4ee5aef90703",
    "zamba2-7b": "81e4d21787c0de75", "internvl2-26b": "76eb83d7b01f0874",
    "olmoe-1b-7b": "be750f6fdaff4920", "qwen3-moe-235b-a22b": "be750f6fdaff4920",
    "paper-envi": "3cfe67e1606e59a1",
}


@pytest.mark.parametrize("arch", sorted(INIT_DIGESTS))
def test_seeded_init_params_draw_as_before(arch):
    p, s = build(reduce_config(get_config(arch)), device="cpu").init(
        torch.Generator().manual_seed(0))
    tree = {"p": p, "s": s}
    h = hashlib.sha256()
    for path, x in zip(tree_paths(tree), tree_leaves(tree)):
        h.update(path.encode())
        h.update(x.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest()[:16] == INIT_DIGESTS[arch]


def test_cli_writes_a_cell_json(tmp_path, monkeypatch):
    """``main`` over one small production cell (mamba2-130m decode_32k) on
    the single mesh: one ``ok`` JSON, exit 0, the fake world torn down."""
    import json

    rc = dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k", "--mesh", "single",
                      "--out", str(tmp_path)])
    assert rc == 0 and not dist.is_initialized()
    rec = json.loads((tmp_path / "mamba2-130m__long_500k__single.json").read_text())
    assert rec["ok"] and rec["n_devices"] == 256 and rec["memory"]["fits"]
    assert rec["cost"]["coll_wire_bytes_network"] > 0
    assert SHAPES["long_500k"].kind == "decode"
