"""Expert-parallel serving in ``gloo`` worlds of 2 and 4 ranks (the port's
``tests/test_serve_sharded.py``): ``core.dssoftmax.serve_topk_sharded``
and ``ServeSession(mesh=...)`` on meshes 1x2, 1x4 and 2x2, held against
``repro``'s single-device ``serve_topk`` and ``ServeSession`` on the same
inputs (``repro``'s multi-device tests need 8 JAX devices; here the
contract says the sharded results equal the single-device ones).

At 2x2 the two data rows split the sessions' 2 slots (one slot a data
row, ``repro``'s ``serve_cache_shardings``): each rank holds and steps only
its slot's cache row (its block of the paged arena), and further
variants run there: a paged whole-prompt prefill, shared prompt prefixes,
speculation and the fault injectors.

Each world runs once per module: ``python tests/test_torch_sharded.py
<out_dir> <store>`` per rank (``tests/_spmd.py``), every case in
one go, each rank writing its results to ``<out_dir>/rank<r>.npz`` and
``.json``; every case below reads them and stays a test of its own. While
the worlds run, this process computes ``repro``'s references, and one
subprocess with 8 host devices runs ``repro``'s own ``serve_topk_sharded``
(with stats) at 1x2, 1x4 and 2x2.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
K, D, N, KEEP, TOPK = 6, 32, 500, 0.5, 8
BS = (1, 8, 64)
KERNELS = ("auto", "jnp", "grouped")
TABLES = ("fp", "int8")
CFS = (1.0, 0.25)
STEER_B = 32
WORLDS = {2: ("1x2",), 4: ("1x4", "2x2", "2x2x1")}
MESHES = ("1x2", "1x4", "2x2")
# the head also runs on a (pod, data, model) mesh made by init_device_mesh
# itself, whose tokens split over pod and data together
HEAD_MESHES = MESHES + ("2x2x1",)
VARIANTS = ("whole", "chunk", "paged", "int8")
# run where the slots split (2x2): paged whole-prompt prefill, 4 requests
# behind a shared 8-token prompt prefix (chunks of 4), a self-draft, and
# 4 slots on a 6-page arena where 2 late high-priority requests preempt
SPLIT_VARIANTS = ("paged_whole", "prefix", "spec", "pressure")
SPLIT_MESH = "2x2"
GAMMA = 2
MAX_NEWS = [2, 5, 3, 7, 4, 6]
SAMPLED = 3
RTOL, ATOL = 1e-6, 2e-6


# ---------------------------------------------------------------------------
# Inputs shared by both packages (numpy, seeded)
# ---------------------------------------------------------------------------

def head_fixture(seed=0):
    """K = 6 experts (not a multiple of 4: ep 4 pads two dummy experts),
    d 32, 500 classes, each kept by an expert with probability 0.5: the
    gate, the packed table's ids and rows, and the int8 table's fallback
    mask (expert 1 on exact rows)."""
    rng = np.random.RandomState(seed)
    gate = (rng.randn(K, D) / np.sqrt(D)).astype(np.float32)
    w = (rng.randn(K, N, D) / np.sqrt(D)).astype(np.float32)
    mask = rng.rand(K, N) < KEEP
    v_pad = -(-int(mask.sum(1).max()) // 128) * 128
    ids = np.full((K, v_pad), -1, np.int32)
    rows = np.zeros((K, v_pad, D), np.float32)
    for e in range(K):
        idx = np.nonzero(mask[e])[0]
        ids[e, :len(idx)] = idx
        rows[e, :len(idx)] = w[e, idx]
    fb_mask = np.arange(K) == 1
    return gate, ids, rows, fb_mask


def steer_gate():
    """Every token to expert 0 (h > 0 below), so its capacity overflows."""
    g = np.zeros((K, D), np.float32)
    g[0] = 1.0
    return g


def head_inputs(B, steer):
    rng = np.random.RandomState(100 + B)
    h = rng.randn(B, D).astype(np.float32)
    return np.abs(h) + 0.1 if steer else h


def save_tree(path, tree):
    """npz of a flat tree; bf16 leaves are stored as their uint16 bits."""
    np.savez(path, **{(k + "@bf16" if a.dtype.name == "bfloat16" else k):
                      (a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
                      for k, a in tree.items()})


def load_tree(path):
    import ml_dtypes

    return {k.removesuffix("@bf16"): (a.view(ml_dtypes.bfloat16) if k.endswith("@bf16") else a)
            for k, a in np.load(path).items()}


def prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 128, rng.randint(3, 10)).astype(np.int32) for _ in range(6)]


def prefix_prompts():
    """4 prompts behind one 8-token system prefix (two chunks of 4)."""
    rng = np.random.RandomState(5)
    sysp = rng.randint(0, 128, 8)
    return [np.concatenate([sysp, rng.randint(0, 128, rng.randint(2, 6))]).astype(np.int32)
            for _ in range(4)]


def variant_kw(variant):
    """ServeSession keywords of a session variant (both packages)."""
    return {"chunk": dict(prefill_chunk=4),
            "paged": dict(prefill_chunk=4, paged=True, page_size=8),
            "paged_whole": dict(paged=True, page_size=8),
            "prefix": dict(prefill_chunk=4, paged=True, page_size=8),
            "spec": dict(prefill_chunk=4),
            "pressure": dict(prefill_chunk=4, paged=True, page_size=8, page_arena=6,
                             n_slots=4)}.get(variant, {})


def variant_requests(variant, Request, SamplingParams):
    if variant == "prefix":
        return [Request(prompt=p, sampling=SamplingParams(max_new_tokens=m))
                for p, m in zip(prefix_prompts(), MAX_NEWS)]
    return [Request(prompt=p, sampling=SamplingParams(
        max_new_tokens=m, temperature=0.8 if j == SAMPLED else 0.0, seed=11,
        priority=5 if variant == "pressure" and j >= 4 else 0))
        for j, (p, m) in enumerate(zip(prompts(), MAX_NEWS))]


# ---------------------------------------------------------------------------
# The rank processes
# ---------------------------------------------------------------------------

def _port_tables():
    from repro_torch.core import dssoftmax as ds

    gate, ids, rows, fb_mask = head_fixture()
    fp = ds.ServeTable(ids=torch.from_numpy(ids), weights=torch.from_numpy(rows))
    return torch.from_numpy(gate), {"fp": fp, "int8": ds.quantize_table(
        fp, torch.from_numpy(fb_mask))}


def _head_cases(mesh, spec, out, checks):
    from repro_torch.core import dssoftmax as ds
    from repro_torch.distributed import sharding

    gate, tables = _port_tables()
    ep, ndata = ds._mesh_degrees(mesh)
    cases = [(t, "normal", kern, 2.0, B) for t in TABLES for kern in KERNELS for B in BS]
    cases += [(t, "steer", kern, cf, STEER_B) for t in TABLES for kern in ("grouped", "auto")
              for cf in CFS]
    bad_payload = []
    for tname, gname, kern, cf, B in cases:
        g = gate if gname == "normal" else torch.from_numpy(steer_gate())
        shard = tables[tname].shard(mesh)
        h = torch.from_numpy(head_inputs(B, gname == "steer"))
        with sharding.record_collectives() as rec:
            v, i, st = ds.serve_topk_sharded(g, shard, h, TOPK, mesh=mesh, kernel=kern,
                                             capacity_factor=cf, with_stats=True)
        key = f"head/{spec}/{tname}/{gname}/{kern}/{cf}/{B}"
        out[key + "/vals"] = v.numpy()
        out[key + "/ids"] = i.numpy()
        out[key + "/dispatched"] = st["dispatched"].numpy()
        out[key + "/overflow"] = st["overflow"].numpy()
        b_loc = B // ndata if (ndata > 1 and B % ndata == 0) else B
        k_loc = shard.local.ids.shape[0]
        for op, shape, dtype, n in rec:
            ok = ((op == "all_gather" and shape == (b_loc, TOPK) and n in (ep, ndata))
                  or (shape == (k_loc,) and dtype == torch.int32))
            if not ok or int(np.prod(shape)) >= b_loc * shard.v_pad:
                bad_payload.append((key, op, shape, n))
    checks[f"payload/{spec}"] = bad_payload


def _session_cases(mesh, spec, out, checks, weights):
    from repro_torch.convert import params_from_jax
    from repro_torch.core import dssoftmax as ds
    from repro_torch.distributed import sharding
    from repro_torch.kernels.registry import AutoPolicy
    from repro_torch.models import build
    from repro_torch.train import Request, SamplingParams, ServeSession

    cfg = _tiny_cfg()
    params, state = params_from_jax(load_tree(weights), cfg, device="cpu")
    bundle = build(cfg, device="cpu")
    fp = ds.pack_experts(params["head"], state)
    int8 = ds.quantize_table(fp, torch.arange(4) == 1)

    def run(mesh_, variant, kernel, table=fp, swap_at=None):
        kw = dict(variant_kw(variant))
        if variant == "spec":
            kw.update(draft=(bundle, params, table), gamma=GAMMA)
        kw.setdefault("n_slots", 2)
        sess = ServeSession(bundle, params, int8 if variant == "int8" else table,
                            max_seq_len=32, kernel=kernel, mesh=mesh_, device="cpu", **kw)
        sess._draft_backfill = False  # repro's draft schedule
        reqs = variant_requests(variant, Request, SamplingParams)
        late = reqs[4:] if variant == "pressure" else []
        for r in reqs:
            if r not in late:
                sess.submit(r)
        while sess.step():
            if late and sess.n_steps == 3:
                for r in late:
                    sess.submit(r)
                late = []
            if swap_at is not None and sess.n_steps == swap_at[0]:
                sess.swap_table(swap_at[1], new_gate=swap_at[2])
                swap_at = None
        return sess, [list(map(int, r.out_tokens)) for r in reqs]

    kernels = {"whole": None, "chunk": "grouped", "paged": "cuda_fused", "int8": "cuda_grouped"}
    for variant in VARIANTS:
        hist = []
        kern = AutoPolicy(history=hist) if variant == "whole" else kernels[variant]
        sess, toks = run(mesh, variant, kern)
        st = sess.stats()
        out[f"session/{spec}/{variant}"] = {
            # a policy object prints by type: its address differs per process
            "tokens": toks, "stats": json.loads(json.dumps(st, default=lambda o: type(o).__name__)),
            "policy": [name for _, name in hist],
            "table_rows": int(sess.table.local.ids.shape[0]), "k_pad": sess.table.n_experts,
            "cache_bytes": sharding.tree_shard_bytes(sess._cache)}
    if spec == SPLIT_MESH:
        for variant in SPLIT_VARIANTS:
            sess, toks = run(mesh, variant, "grouped")
            out[f"split/{variant}"] = {
                "tokens": toks, "cache_bytes": sharding.tree_shard_bytes(sess._cache),
                "stats": json.loads(json.dumps(sess.stats(), default=lambda o: type(o).__name__))}
        # the port's single-device runs: their paged counters beside the mesh's
        for variant in ("prefix", "pressure"):
            out[f"split/{variant}/unsharded"] = run(None, variant, "grouped")[0].stats()["paged"]
        _fault_cases(mesh, out, bundle, params, fp)
        _local_row_heads(mesh, out, params, fp)
    if "unsharded_stats" not in checks:  # it needs no mesh: once a world
        base, _ = run(None, "whole", "jnp")
        checks["unsharded_stats"] = json.loads(json.dumps(base.stats(), default=str))
    out[f"session/{spec}/unsharded_stats"] = checks["unsharded_stats"]
    if spec == "1x2":
        # a swap between steps to a table of 5 experts (ep 2 pads a sixth)
        g5 = torch.cat([params["head"]["gate"], params["head"]["gate"][:1] * 0.5])
        e5 = torch.cat([params["head"]["experts"], params["head"]["experts"][:1]])
        m5 = torch.cat([state.mask, state.mask[:1]])
        t5 = ds.pack_experts({"gate": g5, "experts": e5}, ds.DSState(mask=m5))
        sess, toks = run(mesh, "whole", "grouped", swap_at=(3, t5, g5))
        _, want = run(None, "whole", "grouped", swap_at=(3, t5, g5))
        out["swap/1x2"] = {"tokens": toks, "want": want, "k_pad": sess.table.n_experts,
                           "local_rows": int(sess.table.local.ids.shape[0]),
                           "version": sess.table_version}


def _local_row_heads(mesh, out, params, fp):
    """Each rank's block of 8 hidden rows through ``heads.head_topk(...,
    local_rows=True)``, the DS head (``serve_topk_sharded(h_local=True)``,
    with stats) and a full softmax over the tied embedding, against the
    whole 8 rows without a mesh."""
    from repro_torch.core import dssoftmax as ds
    from repro_torch.distributed import sharding
    from repro_torch.models import heads

    cfg = _tiny_cfg()
    h = torch.from_numpy(np.random.RandomState(9).randn(8, cfg.d_model).astype(np.float32))
    r, nb = sharding.batch_index(mesh), sharding.batch_ranks(mesh)
    mine = h[r * 8 // nb:(r + 1) * 8 // nb]
    res = {}
    for head in ("ds", "full"):
        c = cfg.replace(head=head, tie_embeddings=head == "full")
        table = ds.shard_table(fp, mesh) if head == "ds" else None
        got = heads.head_topk(params["head"], table, c, mine, TOPK,
                              embed_table=params["embed"]["table"], kernel="grouped",
                              mesh=mesh, with_stats=True, local_rows=True)
        want = heads.head_topk(params["head"], fp if head == "ds" else None, c, h, TOPK,
                               embed_table=params["embed"]["table"], kernel="grouped",
                               with_stats=True)
        res[head] = {"ids": torch.equal(got[1], want[1]),
                     "vals": bool(torch.allclose(got[0], want[0], rtol=RTOL, atol=ATOL)),
                     # overflow depends on the split: capacity is sized by
                     # each rank's rows
                     "stats": head == "full" or torch.equal(got[2]["dispatched"][:4],
                                                            want[2]["dispatched"]),
                     "shape": list(got[0].shape)}
    out["local_row_heads"] = res


def _fault_cases(mesh, out, bundle, params, fp):
    """``poison_cache_slot`` and ``poison_page`` on slot 1 of a slot-split
    session (contiguous, and paged with whole-prompt prefill) after 2
    decode steps: which rank wrote NaN, and every request's outcome."""
    from repro_torch.distributed import sharding
    from repro_torch.testing import faults
    from repro_torch.train import Request, SamplingParams, ServeSession

    for name, kw in (("slot", {}), ("page", dict(paged=True, page_size=8))):
        sess = ServeSession(bundle, params, fp, n_slots=2, max_seq_len=32, kernel="grouped",
                            mesh=mesh, device="cpu", **kw)
        reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=6))
                for p in prompts()[:2]]
        for r in reqs:
            sess.submit(r)
        sess.step()
        sess.step()
        victim = sess.scheduler.slots[1].req
        if name == "slot":
            faults.poison_cache_slot(sess, 1)
        else:
            faults.poison_page(sess, int(sess._mgr.tables[1, 0]))
        poisoned = any(bool(torch.isnan(leaf).any()) for leaf in sess._cache)
        while sess.step():
            pass
        out[f"fault/{name}"] = {
            "batch_index": sharding.batch_index(mesh), "wrote_nan": poisoned,
            "victim": reqs.index(victim), "status": [r.status.value for r in reqs],
            "tokens": [list(map(int, r.out_tokens)) for r in reqs],
            "nan_left": any(bool(torch.isnan(leaf).any()) for leaf in sess._cache)}


def _worker(out_dir, weights, store):
    import torch.distributed as dist

    from repro_torch.launch.mesh import destroy, init_distributed, parse_mesh

    torch.set_num_threads(1)
    init_distributed("cpu", store=store)
    rank, world = dist.get_rank(), dist.get_world_size()
    arrays, sessions, checks = {}, {}, {}
    for spec in WORLDS[world]:
        if spec in MESHES:
            mesh = parse_mesh(spec, device="cpu")
        else:
            from torch.distributed.device_mesh import init_device_mesh

            mesh = init_device_mesh("cpu", tuple(int(x) for x in spec.split("x")),
                                    mesh_dim_names=("pod", "data", "model"))
        _head_cases(mesh, spec, arrays, checks)
        if spec in MESHES:
            _session_cases(mesh, spec, sessions, checks, weights)
    destroy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"sessions": sessions, "checks": checks}, f, default=str)


# ---------------------------------------------------------------------------
# repro's references (this process, and one 8-device subprocess)
# ---------------------------------------------------------------------------

_XLA_STATS = r"""
import sys, json
import numpy as np
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
import jax, jax.numpy as jnp
from repro.core import dssoftmax as ds
from repro.launch.mesh import parse_mesh
import test_torch_sharded as t
gate, ids, rows, fb = t.head_fixture()
fp = ds.ServeTable(ids=jnp.asarray(ids), weights=jnp.asarray(rows))
tables = {"fp": fp, "int8": ds.quantize_table(fp, fb)}
out = {}
for spec in ("1x2", "1x4", "2x2"):
    mesh = parse_mesh(spec)
    for tname, tbl in tables.items():
        for gname, kern, cf, B in (("normal", "grouped", 2.0, 64), ("steer", "grouped", 0.25, 32)):
            g = gate if gname == "normal" else t.steer_gate()
            h = jnp.asarray(t.head_inputs(B, gname == "steer"))
            stab = tbl.shard(mesh)
            v, i, st = jax.jit(lambda gg, hh: ds.serve_topk_sharded(
                gg, stab, hh, t.TOPK, mesh=mesh, kernel=kern, capacity_factor=cf,
                with_stats=True))(jnp.asarray(g), h)
            out[f"{spec}/{tname}/{gname}"] = {
                "ids": np.asarray(i).tolist(),
                "dispatched": np.asarray(st["dispatched"]).tolist(),
                "overflow": np.asarray(st["overflow"]).tolist()}
print(json.dumps(out))
"""


def port_weights(cfg, path):
    """The port's seeded init of ``cfg`` on the CPU, its DS mask pruned so
    that each class survives in about half the experts (and in at least
    one), saved to ``path`` for the ranks (``save_tree``); returns the flat
    numpy tree (bf16 leaves as ``ml_dtypes`` arrays), which both packages
    load: the port through ``convert.params_from_jax``, ``repro`` by path
    (the two trees name their leaves alike)."""
    import ml_dtypes

    from repro_torch.models import build
    from repro_torch.utils.tree import flatten_dict

    params, state = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tree = {k: (v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
                if v.dtype == torch.bfloat16 else v.numpy())
            for k, v in flatten_dict(params).items()}
    rng = np.random.RandomState(3)
    mask = state.mask.numpy() & (rng.rand(*state.mask.shape) < 0.5)
    mask[rng.randint(0, mask.shape[0], mask.shape[1]), np.arange(mask.shape[1])] = True
    tree["ds_state/mask"] = mask
    save_tree(path, tree)
    return tree


def repro_model(cfg, tree):
    """``repro``'s bundle, params and DS state on the flat numpy ``tree``."""
    import jax.numpy as jnp

    from repro.core import dssoftmax as jds
    from repro.models import build as jbuild
    from repro.utils.tree import unflatten_dict

    params = unflatten_dict({k: jnp.asarray(v) for k, v in tree.items()
                             if k != "ds_state/mask"})
    return jbuild(cfg), params, jds.DSState(mask=jnp.asarray(tree["ds_state/mask"]))


def _tiny_cfgs():
    """qwen2-1.5b at vocab 128 with K 4 (``repro``'s tiny of
    tests/test_serve_sharded.py) in fp32, in both packages (in bf16
    ``repro``'s CPU XLA keeps fp32 between fused ops, which moves
    near-ties)."""
    from repro.configs import get_config, reduce_config

    jcfg = reduce_config(get_config("qwen2-1.5b"), vocab=128).replace(
        ds=get_config("qwen2-1.5b").ds.replace(num_experts=4), dtype="float32")
    return jcfg, _tiny_cfg()


def _tiny_cfg():
    from repro_torch import configs

    return configs.reduce_config(configs.get_config("qwen2-1.5b"), vocab=128).replace(
        ds=configs.get_config("qwen2-1.5b").ds.replace(num_experts=4), dtype="float32")


def _repro_streams(jb, params, state):
    """repro's unsharded session (``jnp``, chunks of 4: token-identical to
    its whole prefill and one compile for every length) on the fp table and
    on the int8 table with expert 1 on exact rows; on the shared-prefix
    prompts; and its speculative session (a self-draft, gamma 2)."""
    import jax.numpy as jnp

    from repro.core import dssoftmax as jds
    from repro.train import Request, SamplingParams, ServeSession

    fp = jds.pack_experts(params["head"], state)
    out = {}
    runs = (("fp", fp, "whole", {}), ("int8", jds.quantize_table(fp, jnp.arange(4) == 1),
                                      "whole", {}),
            ("prefix", fp, "prefix", {}),
            ("spec", fp, "spec", dict(draft=(jb, params, fp), gamma=GAMMA)))
    for name, table, variant, kw in runs:
        sess = ServeSession(jb, params, table, n_slots=2, max_seq_len=32, kernel="jnp",
                            prefill_chunk=4, **kw)
        reqs = variant_requests(variant, Request, SamplingParams)
        sess.run(reqs)
        out[name] = [list(map(int, r.out_tokens)) for r in reqs]
    return out


def _repro_heads():
    import jax.numpy as jnp

    from repro.core import dssoftmax as jds

    gate, ids, rows, fb = head_fixture()
    fp = jds.ServeTable(ids=jnp.asarray(ids), weights=jnp.asarray(rows))
    tables = {"fp": fp, "int8": jds.quantize_table(fp, fb)}
    out = {}
    for tname, tbl in tables.items():
        for B in BS:
            out[(tname, "normal", 2.0, B)] = jds.serve_topk(
                jnp.asarray(gate), tbl, jnp.asarray(head_inputs(B, False)), TOPK, kernel="jnp")
        for cf in CFS:
            out[(tname, "steer", cf, STEER_B)] = jds.serve_topk(
                jnp.asarray(steer_gate()), tbl, jnp.asarray(head_inputs(STEER_B, True)), TOPK,
                kernel="jnp")
    return {key: (np.asarray(v), np.asarray(i)) for key, (v, i) in out.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from _spmd import python_argv, start_world, wait_world

    tmp = tmp_path_factory.mktemp("sharded")
    weights = str(tmp / "weights.npz")
    jcfg, tcfg = _tiny_cfgs()
    tree = port_weights(tcfg, weights)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    xla = subprocess.Popen([sys.executable, "-c", _XLA_STATS, str(ROOT / "src"),
                            str(ROOT / "tests")], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    worlds = {}
    for world in WORLDS:
        d = tmp / f"world{world}"
        d.mkdir()
        worlds[world] = (d, start_world(python_argv(__file__, str(d), weights), world,
                                        store_dir=str(d)))
    heads = _repro_heads()
    streams = _repro_streams(*repro_model(jcfg, tree))
    ranks = {}
    for world, (d, procs) in worlds.items():
        wait_world(procs, timeout=600)
        for r in range(world):
            ranks.setdefault(world, []).append(
                (dict(np.load(d / f"rank{r}.npz")), json.loads((d / f"rank{r}.json").read_text())))
    out, err = xla.communicate(timeout=600)
    assert xla.returncode == 0, err[-4000:]
    return {"ranks": ranks, "heads": heads, "streams": streams,
            "xla": json.loads(out.strip().splitlines()[-1])}


def _world_of(spec):
    return next(w for w, specs in WORLDS.items() if spec in specs)


# ---------------------------------------------------------------------------
# The head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("kern", KERNELS)
@pytest.mark.parametrize("spec", HEAD_MESHES)
def test_sharded_head_matches_repro_serve_topk(results, spec, kern, table):
    """Every rank's (B, k) ids equal repro's single-device ``jnp`` oracle's,
    values within rtol 1e-6 / atol 2e-6, at B 1, 8 and 64 (K 6 padded to a
    multiple of ep; at 2x2 B 8 and 64 split over the data ranks, at 2x2x1
    over pod and data together)."""
    for arrays, _ in results["ranks"][_world_of(spec)]:
        for B in BS:
            v_ref, i_ref = results["heads"][(table, "normal", 2.0, B)]
            key = f"head/{spec}/{table}/normal/{kern}/2.0/{B}"
            np.testing.assert_array_equal(arrays[key + "/ids"], i_ref, err_msg=key)
            np.testing.assert_allclose(arrays[key + "/vals"], v_ref, rtol=RTOL, atol=ATOL,
                                       err_msg=key)
            assert np.isfinite(arrays[key + "/vals"]).all(), key


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("spec", HEAD_MESHES)
def test_sharded_capacity_overflow_exact(results, spec, cf, table):
    """Every token steered to expert 0: its owner's grouped buffers overflow
    at cf 1.0 and 0.25 and its fixup repairs exactly those tokens (and no
    token another rank owns), on ``grouped`` and ``auto``."""
    v_ref, i_ref = results["heads"][(table, "steer", cf, STEER_B)]
    for arrays, _ in results["ranks"][_world_of(spec)]:
        for kern in ("grouped", "auto"):
            key = f"head/{spec}/{table}/steer/{kern}/{cf}/{STEER_B}"
            np.testing.assert_array_equal(arrays[key + "/ids"], i_ref, err_msg=key)
            np.testing.assert_allclose(arrays[key + "/vals"], v_ref, rtol=RTOL, atol=ATOL)
        over = arrays[f"head/{spec}/{table}/steer/grouped/{cf}/{STEER_B}/overflow"]
        disp = arrays[f"head/{spec}/{table}/steer/grouped/{cf}/{STEER_B}/dispatched"]
        assert disp[0] == STEER_B and disp[1:].sum() == 0
        assert over[0] > 0 and over[1:].sum() == 0


@pytest.mark.parametrize("spec", MESHES)
def test_sharded_stats_match_repro_sharded(results, spec):
    """``with_stats``: (K_pad,) global counts, summed over the data ranks
    and concatenated over ``model``, equal to repro's ``serve_topk_sharded``
    on the same mesh of 8 host devices, on the fp and int8 tables, also
    under overflow (whose counts depend on the data split: capacity is
    sized by each data rank's token rows)."""
    for arrays, _ in results["ranks"][_world_of(spec)]:
        for table in TABLES:
            for gname, kern, cf, B in (("normal", "grouped", 2.0, 64),
                                       ("steer", "grouped", 0.25, STEER_B)):
                key = f"head/{spec}/{table}/{gname}/{kern}/{cf}/{B}"
                want = results["xla"][f"{spec}/{table}/{gname}"]
                assert arrays[key + "/dispatched"].tolist() == want["dispatched"], key
                assert arrays[key + "/overflow"].tolist() == want["overflow"], key
                np.testing.assert_array_equal(arrays[key + "/ids"], want["ids"])


@pytest.mark.parametrize("spec", HEAD_MESHES)
def test_sharded_collectives_move_only_topk_carries(results, spec):
    """Every collective of the head moves this rank's (B_loc, k) carries
    (over ``model`` or the data ranks) or its (K_loc,) int32 counts:
    nothing of size V_pad crosses ranks."""
    for _, js in results["ranks"][_world_of(spec)]:
        assert js["checks"][f"payload/{spec}"] == []


# ---------------------------------------------------------------------------
# ServeSession(mesh=...)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("spec", MESHES)
def test_session_mesh_matches_repro_session(results, spec, variant):
    """6 requests (one sampled) through 2 slots: whole prefill (``auto``),
    chunks of 4 (``grouped``), paged (``cuda_fused``'s plain version) and an
    int8 table with expert 1 on exact rows (``cuda_grouped``): every rank
    emits repro's unsharded session's streams."""
    want = results["streams"]["int8" if variant == "int8" else "fp"]
    for _, js in results["ranks"][_world_of(spec)]:
        got = js["sessions"][f"session/{spec}/{variant}"]
        assert got["tokens"] == want
        ep = int(spec.split("x")[1])
        assert got["k_pad"] % ep == 0 and got["table_rows"] == got["k_pad"] // ep


@pytest.mark.parametrize("spec", MESHES)
def test_session_mesh_stats_equal_on_every_rank(results, spec):
    """Every host decision reads gathered values, so every rank's
    ``stats()`` is the same dict; captures and rebinds are as unsharded."""
    ranks = results["ranks"][_world_of(spec)]
    for variant in VARIANTS:
        first = ranks[0][1]["sessions"][f"session/{spec}/{variant}"]["stats"]
        for _, js in ranks[1:]:
            assert js["sessions"][f"session/{spec}/{variant}"]["stats"] == first
        base = ranks[0][1]["sessions"][f"session/{spec}/unsharded_stats"]
        for key in ("decode_graphs", "decode_builds", "n_admitted", "n_completed"):
            assert first[key] == base[key], (variant, key)


@pytest.mark.parametrize("spec", MESHES)
def test_session_mesh_auto_policy_picks_sharded_specs(results, spec):
    """At ep > 1 every ``AutoPolicy`` resolution is a ``*_ep`` spec."""
    for _, js in results["ranks"][_world_of(spec)]:
        hist = js["sessions"][f"session/{spec}/whole"]["policy"]
        assert hist and all(name.endswith("_ep") for name in hist), hist


def _whole_cache_specs(variant):
    from repro_torch.models.model_zoo import cache_specs, paged_cache_specs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.serve.paged_cache import N_RESERVED

    cfg = _tiny_cfg()
    kw = variant_kw(variant)
    paged, n_slots = bool(kw.get("paged")), kw.get("n_slots", 2)
    specs = (paged_cache_specs(cfg, N_RESERVED + kw.get("page_arena", n_slots * 32 // 8), 8)
             if paged else cache_specs(cfg, ShapeConfig(name="serve", seq_len=32,
                                                        global_batch=n_slots, kind="decode")))
    return type(specs)(*(torch.empty(s.shape, dtype=s.dtype, device="meta")
                         for s in specs)), paged


@pytest.mark.parametrize("spec", MESHES)
def test_session_mesh_cache_bytes_are_placed_bytes(results, spec):
    """Each rank's resident cache is ``placed_bytes`` of the whole cache
    under ``serve_cache_shardings`` (paged: ``serve_paged_cache_shardings``,
    plus the rank's own two reserved pages a leaf where the arena splits):
    half the whole cache at 2x2, whose 2 data ranks split the 2 slots (and
    the 10-page arena); the whole cache at 1x2 and 1x4."""
    from repro_torch.distributed import sharding
    from repro_torch.serve.paged_cache import N_RESERVED

    d, m = (int(x) for x in spec.split("x"))
    mesh = {"data": d, "model": m}
    variants = VARIANTS + (SPLIT_VARIANTS if spec == SPLIT_MESH else ())
    for _, js in results["ranks"][_world_of(spec)]:
        for variant in variants:
            got = js["sessions"][f"session/{spec}/{variant}" if variant in VARIANTS
                                 else f"split/{variant}"]["cache_bytes"]
            whole, paged = _whole_cache_specs(variant)
            if paged:
                rule = sharding.serve_paged_cache_shardings(mesh, None, whole)
            else:
                rule = sharding.serve_cache_shardings(mesh, None, whole,
                                                      variant_kw(variant).get("n_slots", 2))
            want = sharding.placed_bytes(whole, rule, mesh)
            full = sum(int(np.prod(s.shape)) * 4 for s in whole)
            if paged and d > 1:
                # one page of every layer, for each reserved page
                want += N_RESERVED * sum(int(np.prod(s.shape)) // s.shape[1] * 4 for s in whole)
            assert got == want, (variant, got, want)
            assert (got < full) == (d > 1), (variant, got, full)


@pytest.mark.parametrize("variant", SPLIT_VARIANTS)
def test_session_split_slots_match_repro_session(results, variant):
    """Where the data ranks split the slots (2x2, one slot a rank): a paged
    whole-prompt prefill, 4 requests behind a shared 8-token prefix (paged,
    chunks of 4, prefix sharing) and a speculative self-draft (gamma 2,
    repro's draft schedule, one sampled request) emit repro's unsharded
    streams on every rank, and every rank's ``stats()`` is the same."""
    want = results["streams"][{"paged_whole": "fp", "pressure": "fp"}.get(variant, variant)]
    ranks = results["ranks"][_world_of(SPLIT_MESH)]
    first = ranks[0][1]["sessions"][f"split/{variant}"]["stats"]
    for _, js in ranks:
        got = js["sessions"][f"split/{variant}"]
        assert got["tokens"] == want
        assert got["stats"] == first
    if variant == "spec":
        assert first["speculative"]["spec_steps"] > 0


def test_session_split_prefix_hits_only_within_a_data_row(results):
    """A prefix is adopted only by a slot of the data row that holds its
    pages (Queue 3). With one slot a row, a row's prefix pages die with the
    request that wrote them (an entry holds no reference), so the mesh
    session hits none of the 3 prefixes the single-device one hits, while
    its streams stay repro's (the test above); the arena's size and its
    release are as on one device. ``tests/test_torch_fsdp.py`` shows hits
    within a row of two slots."""
    js = results["ranks"][_world_of(SPLIT_MESH)][0][1]["sessions"]
    mesh_paged = js["split/prefix"]["stats"]["paged"]
    single = js["split/prefix/unsharded"]
    assert single["prefix_hits"] == 3 and mesh_paged["prefix_hits"] == 0
    assert mesh_paged["prefix_queries"] == single["prefix_queries"] == 4
    assert mesh_paged["pages_in_use"] == 0 and mesh_paged["pages_total"] == single["pages_total"]


def test_session_split_preempts_within_a_data_row(results):
    """4 slots (two a data row) on a 6-page arena, blocks of 4 pages (data
    row 0 can map 2 of them, beside the reserved ids): a slot draws only
    from its row's free list, so the mesh session preempts once where one
    device, with all 6 pages on one list, never does (Queue 3); the
    streams stay repro's (the test above) and every page is free at the
    end."""
    js = results["ranks"][_world_of(SPLIT_MESH)][0][1]["sessions"]
    mesh_paged = js["split/pressure"]["stats"]["paged"]
    single = js["split/pressure/unsharded"]
    assert (mesh_paged["preemptions"], single["preemptions"]) == (1, 0)
    assert mesh_paged["pages_in_use"] == 0 and mesh_paged["pages_total"] == 6


@pytest.mark.parametrize("head", ["ds", "full"])
def test_head_local_rows_merge_to_the_whole_batch(results, head):
    """At 2x2 each rank passes only its data row's 4 of 8 hidden rows
    (``head_topk(local_rows=True)``): every rank gets the whole (8, k) in
    row order, ids equal and values within rtol 1e-6 / atol 2e-6 of the
    head on all 8 rows without a mesh, the DS head's per-expert dispatch
    counts summed over the rows."""
    for _, js in results["ranks"][_world_of(SPLIT_MESH)]:
        got = js["sessions"]["local_row_heads"][head]
        assert got == {"ids": True, "vals": True, "stats": True, "shape": [8, TOPK]}


@pytest.mark.parametrize("fault", ["slot", "page"])
def test_session_split_fault_injectors_hit_the_owner(results, fault):
    """``poison_cache_slot`` / ``poison_page`` on slot 1 at 2x2 write NaN
    only on the ranks of data row 1, which hold the slot; the request there
    fails, the other completes with its unpoisoned stream, and no NaN is
    left in any rank's cache."""
    want = results["streams"]["fp"]
    for _, js in results["ranks"][_world_of(SPLIT_MESH)]:
        got = js["sessions"][f"fault/{fault}"]
        assert got["wrote_nan"] == (got["batch_index"] == 1)
        v = got["victim"]
        assert got["status"][v] == "failed" and got["status"][1 - v] == "completed"
        assert got["tokens"][1 - v][:len(want[1 - v])] == want[1 - v]
        assert not got["nan_left"]


def test_session_mesh_swap_table_reshards(results):
    """A swap between steps to a 5-expert table: placed on the 1x2 mesh
    before it is visible (padded to 6, 3 experts a rank), streams equal
    the unsharded session's with the same swap."""
    for _, js in results["ranks"][2]:
        got = js["sessions"]["swap/1x2"]
        assert got["tokens"] == got["want"]
        assert (got["k_pad"], got["local_rows"], got["version"]) == (6, 3, 1)


if __name__ == "__main__":
    _worker(*sys.argv[1:4])
