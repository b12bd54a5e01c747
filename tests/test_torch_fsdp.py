"""FSDP-stored serving weights in ``gloo`` worlds (the port's
``tests/test_serve_fsdp.py``): ``ServeSession(mesh=..., param_mode='fsdp')``
at 2x1, 4x1 and 2x2 for the dense, moe, ssm and hybrid families, and the
encdec bundle's prefill and decode with a ``ServeParamGather``, held
against ``repro``'s unsharded session and bundle on the same weights, and
against the port's replicated session bit for bit; each rank's resident
leaf shapes against ``repro``'s ``serve_param_pspec``. At 2x1 and 2x2 the
two data rows split the sessions' slots (``serve_cache_shardings``): each
rank's resident cache is its block, the whole cache at 4x1, whose 4 data
ranks do not divide 2 slots; a paged hybrid session of 4 slots shares
prompt prefixes within each data row.

Each world runs once per module (``python tests/test_torch_fsdp.py
<out_dir> <weights_dir> <store>`` per rank, every case in one go); this
process computes ``repro``'s references meanwhile.
"""
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

VOCAB = 96
FAMILIES = {"dense": "qwen2-1.5b", "moe": "olmoe-1b-7b", "ssm": "mamba2-130m",
            "hybrid": "zamba2-7b"}
WORLDS = {2: ("2x1",), 4: ("4x1", "2x2")}
MESHES = ("2x1", "4x1", "2x2")
MAX_NEWS = [2, 6, 3, 5, 4]
FRAMES, ENC_B, ENC_S, ENC_STEPS, ENC_SMAX = 6, 2, 5, 4, 12
HEAD_TOL = dict(rtol=1e-6, atol=2e-6)


def prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(1, VOCAB, rng.randint(3, 12)).astype(np.int32) for _ in range(5)]


def prefix_prompts():
    """6 prompts behind one 8-token system prefix (two chunks of 4)."""
    rng = np.random.RandomState(5)
    sysp = rng.randint(1, VOCAB, 8)
    return [np.concatenate([sysp, rng.randint(1, VOCAB, rng.randint(2, 6))]).astype(np.int32)
            for _ in range(6)]


PREFIX_NEWS = [2, 5, 3, 6, 4, 2]
PREFIX_SLOTS, PREFIX_ARENA = 4, 16


def enc_batch(d):
    rng = np.random.RandomState(7)
    return (rng.normal(size=(ENC_B, FRAMES, d)).astype(np.float32),
            rng.randint(0, VOCAB, (ENC_B, ENC_S)).astype(np.int32))


def _tcfg(arch):
    from repro_torch import configs

    return configs.reduce_config(configs.get_config(arch), vocab=VOCAB).replace(dtype="float32")


# ---------------------------------------------------------------------------
# The rank processes
# ---------------------------------------------------------------------------

def _port_model(arch, weights_dir):
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build

    cfg = _tcfg(arch)
    params, state = params_from_jax(dict(np.load(os.path.join(weights_dir, f"{arch}.npz"))),
                                    cfg, device="cpu")
    return build(cfg, device="cpu"), params, state


def _session_cases(mesh, spec, out, weights_dir, replicated):
    from repro_torch.core import dssoftmax as ds
    from repro_torch.distributed import sharding
    from repro_torch.models import build
    from repro_torch.train import Request, SamplingParams, ServeSession
    from repro_torch.utils.tree import map_with_path

    def run(bundle, params, state, mesh_, mode, **kw):
        sess = ServeSession(bundle, params, state, n_slots=2, max_seq_len=32, kernel="jnp",
                            mesh=mesh_, param_mode=mode, prefill_chunk=4, device="cpu", **kw)
        reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=m))
                for p, m in zip(prompts(), MAX_NEWS)]
        sess.run(reqs)
        return sess, [list(map(int, r.out_tokens)) for r in reqs]

    for fam, arch in FAMILIES.items():
        bundle, params, state = _port_model(arch, weights_dir)
        sess, toks = run(bundle, params, state, mesh, "fsdp")
        if fam not in replicated:  # once a world: it needs no mesh
            replicated[fam] = run(bundle, params, state, None, "replicated")[1]
        rep = replicated[fam]
        shapes = {}
        map_with_path(lambda p, x: shapes.__setitem__(p, list(x.shape)), sess.params)
        out[f"{spec}/{fam}"] = {
            "tokens": toks, "replicated": rep, "shapes": shapes,
            "bytes": sharding.tree_shard_bytes(sess.params),
            "cache_bytes": sharding.tree_shard_bytes(sess._cache),
            "stats": json.loads(json.dumps(sess.stats(), default=lambda o: type(o).__name__))}
        if fam == "hybrid":
            # paged, chunks of 4, 6 requests behind a shared prefix through
            # 4 slots: at 2x1 and 2x2 two slots a data row, which adopt
            # their row's prefixes
            s4 = ServeSession(bundle, params, state, n_slots=PREFIX_SLOTS, max_seq_len=32,
                              kernel="jnp", mesh=mesh, param_mode="fsdp", prefill_chunk=4,
                              paged=True, page_size=8, page_arena=PREFIX_ARENA, device="cpu")
            reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=m))
                    for p, m in zip(prefix_prompts(), PREFIX_NEWS)]
            s4.run(reqs)
            out[f"{spec}/prefix"] = {
                "tokens": [list(map(int, r.out_tokens)) for r in reqs],
                "cache_bytes": sharding.tree_shard_bytes(s4._cache),
                "stats": json.loads(json.dumps(s4.stats(), default=lambda o: type(o).__name__))}
        if fam == "dense":
            # every token to expert 0 at capacity factor 0.25: the grouped
            # path's fixup stays exact with the gate gathered from storage
            head = dict(params["head"], gate=torch.zeros_like(params["head"]["gate"]))
            head["gate"][0] = 1.0
            p2 = dict(params, head=head)
            b2 = build(bundle.cfg.replace(ds=bundle.cfg.ds.replace(capacity_factor=0.25)),
                       device="cpu")
            t2 = ds.pack_experts(head, state)
            # 8 slots: each data rank's share of the decode batch still
            # overflows expert 0's capacity (sized by its own token rows)
            modes = (("fsdp", mesh),) + ((("replicated", None),)
                                         if "overflow" not in replicated else ())
            for m, ms in modes:
                s = ServeSession(b2, p2, t2, n_slots=8, max_seq_len=32, kernel="grouped",
                                 mesh=ms, param_mode=m, prefill_chunk=4, device="cpu")
                reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=n))
                        for p, n in zip(prompts(), MAX_NEWS)]
                s.run(reqs)
                got = ([list(map(int, r.out_tokens)) for r in reqs],
                       sum(s.stats()["expert_overflow"]))
                if m == "replicated":
                    replicated["overflow"] = got
                else:
                    out[f"{spec}/overflow/fsdp"], out[f"{spec}/overflow/fsdp/count"] = got
            out[f"{spec}/overflow/replicated"] = replicated["overflow"][0]
            out[f"{spec}/gather"] = _gather_checks(mesh, params)


def _gather_checks(mesh, params):
    """ServeParamGather.layer / .full / .rows against the replicated leaves,
    bit for bit, and what .rows moves."""
    from repro_torch.distributed import sharding
    from repro_torch.utils.tree import tree_leaves

    specs = sharding.serve_param_shardings(mesh, params)
    sp = sharding.shard_tree(mesh, params, specs)
    g = sharding.ServeParamGather(mesh, params)
    lp = {k: v for k, v in sp["layers"].items()}
    got = g.layer("layers", {k: _take(v, 1) for k, v in lp.items()})
    want = {k: _take(v, 1) for k, v in params["layers"].items()}
    layer_ok = all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
    gate_ok = torch.equal(g.full("head/gate", sp["head"]["gate"]), params["head"]["gate"])
    tok = torch.tensor([1, 7, 42])
    with sharding.record_collectives() as rec:
        rows = g.rows("embed/table", sp["embed"]["table"], tok)
    rows_ok = torch.equal(rows, params["embed"]["table"][tok])
    return {"layer": layer_ok, "gate": gate_ok, "rows": rows_ok,
            "rows_moved": [list(shape) for _, shape, _, _ in rec]}


def _take(tree, i):
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def _encdec_cases(mesh, spec, out, weights_dir, replicated):
    from repro_torch.core import dssoftmax as ds
    from repro_torch.distributed import sharding
    from repro_torch.models import encdec

    bundle, params, state = _port_model("whisper-base", weights_dir)
    table = ds.pack_experts(params["head"], state)
    g = sharding.ServeParamGather(mesh, params)
    sp = sharding.shard_tree(mesh, params, sharding.serve_param_shardings(mesh, params))
    frames, tokens = enc_batch(bundle.cfg.d_model)
    batch = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens).long()}
    res = {"replicated": replicated.get("encdec")}
    for mode, p, gather in (("fsdp", sp, g), ("replicated", params, None)):
        if res.get(mode) is not None:  # the replicated run needs no mesh: once a world
            continue
        v, i, cache = bundle.prefill(p, table, batch, kernel="jnp", gather=gather)
        cache = encdec.pad_self_cache(cache, ENC_SMAX)
        steps = [(v.numpy().tolist(), i.numpy().tolist())]
        tok = i[:, 0].long()
        for s in range(ENC_STEPS):
            pos = ENC_S + s if s % 2 else torch.tensor([ENC_S + s, ENC_S + s - 1])
            v, i, cache = bundle.decode_step(p, table, cache, tok, pos, kernel="jnp",
                                             gather=gather)
            steps.append((v.numpy().tolist(), i.numpy().tolist()))
            tok = i[:, 0].long()
        res[mode] = steps
    replicated["encdec"] = res["replicated"]
    out[f"{spec}/encdec"] = res


def _worker(out_dir, weights_dir, store):
    import torch.distributed as dist

    from repro_torch.launch.mesh import destroy, init_distributed, parse_mesh

    torch.set_num_threads(1)
    init_distributed("cpu", store=store)
    rank, world = dist.get_rank(), dist.get_world_size()
    out, replicated = {}, {}
    for spec in WORLDS[world]:
        mesh = parse_mesh(spec, device="cpu")
        _session_cases(mesh, spec, out, weights_dir, replicated)
        _encdec_cases(mesh, spec, out, weights_dir, replicated)
    destroy()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


# ---------------------------------------------------------------------------
# repro's references
# ---------------------------------------------------------------------------

def _repro_models(weights_dir):
    """Each arch's seeded weights (the port's init, fp32, pruned mask),
    saved for the ranks, and ``repro``'s bundle, params and DS state on
    them."""
    from repro.configs import get_config, reduce_config
    from test_torch_sharded import port_weights, repro_model

    models = {}
    for arch in list(FAMILIES.values()) + ["whisper-base"]:
        tree = port_weights(_tcfg(arch), os.path.join(weights_dir, f"{arch}.npz"))
        jcfg = reduce_config(get_config(arch), vocab=VOCAB).replace(dtype="float32")
        models[arch] = (*repro_model(jcfg, tree), tree)
    return models


def _repro_streams(models):
    from repro.train import Request, SamplingParams, ServeSession

    out = {}
    for fam, arch in FAMILIES.items():
        jb, params, state, _ = models[arch]
        sess = ServeSession(jb, params, state, n_slots=2, max_seq_len=32, kernel="jnp",
                            prefill_chunk=4)
        reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=m))
                for p, m in zip(prompts(), MAX_NEWS)]
        sess.run(reqs)
        out[fam] = [list(map(int, r.out_tokens)) for r in reqs]
    # the hybrid prefix prompts, single-device and unpaged
    jb, params, state, _ = models[FAMILIES["hybrid"]]
    sess = ServeSession(jb, params, state, n_slots=PREFIX_SLOTS, max_seq_len=32, kernel="jnp",
                        prefill_chunk=4)
    reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=m))
            for p, m in zip(prefix_prompts(), PREFIX_NEWS)]
    sess.run(reqs)
    out["prefix"] = [list(map(int, r.out_tokens)) for r in reqs]
    return out


def _repro_encdec(models):
    import jax
    import jax.numpy as jnp

    from repro.core import dssoftmax as jds

    jb, params, state, _ = models["whisper-base"]
    table = jds.pack_experts(params["head"], state)
    frames, tokens = enc_batch(jb.cfg.d_model)
    v, i, c = jax.jit(lambda p: jb.prefill(p, table, {"frames": jnp.asarray(frames),
                                                      "tokens": jnp.asarray(tokens)},
                                           kernel="jnp"))(params)
    pad = lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, ENC_SMAX - ENC_S), (0, 0), (0, 0)))
    c = c._replace(self_k=pad(c.self_k), self_v=pad(c.self_v))
    steps = [(np.asarray(v), np.asarray(i))]
    dec = jax.jit(lambda p, cc, tok, pos: jb.decode_step(p, table, cc, tok, pos, kernel="jnp"))
    tok = i[:, 0]
    for s in range(ENC_STEPS):
        pos = jnp.int32(ENC_S + s) if s % 2 else jnp.asarray([ENC_S + s, ENC_S + s - 1],
                                                            jnp.int32)
        v, i, c = dec(params, c, tok, pos)
        steps.append((np.asarray(v), np.asarray(i)))
        tok = i[:, 0]
    return steps


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from _spmd import python_argv, start_world, wait_world

    tmp = tmp_path_factory.mktemp("fsdp")
    models = _repro_models(str(tmp))
    worlds = {}
    for world in WORLDS:
        d = tmp / f"world{world}"
        d.mkdir()
        worlds[world] = (d, start_world(python_argv(__file__, str(d), str(tmp)), world,
                                        store_dir=str(d)))
    streams = _repro_streams(models)
    enc = _repro_encdec(models)
    ranks = {}
    for world, (d, procs) in worlds.items():
        wait_world(procs, timeout=600)
        ranks[world] = [json.loads((d / f"rank{r}.json").read_text()) for r in range(world)]
    shapes = {arch: {k: a.shape for k, a in m[3].items() if k != "ds_state/mask"}
              for arch, m in models.items()}
    return {"ranks": ranks, "streams": streams, "encdec": enc, "shapes": shapes}


def _world_of(spec):
    return next(w for w, specs in WORLDS.items() if spec in specs)


def _stand_in(spec):
    d, m = (int(x) for x in spec.split("x"))
    return types.SimpleNamespace(shape={"data": d, "model": m}, axis_names=("data", "model"))


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("spec", MESHES)
def test_fsdp_session_matches_repro_session(results, spec, family):
    """5 requests through 2 slots in chunks of 4: every rank's FSDP streams
    equal repro's unsharded session's and the port's replicated session's."""
    for js in results["ranks"][_world_of(spec)]:
        got = js[f"{spec}/{family}"]
        assert got["tokens"] == results["streams"][family]
        assert got["tokens"] == got["replicated"]


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("spec", MESHES)
def test_fsdp_resident_shapes_match_repro_serve_param_pspec(results, spec, family):
    """Each rank keeps, of every leaf, the block ``repro``'s
    ``serve_param_pspec`` leaves a device at this mesh shape (the data axis
    only), and its resident bytes are their sum."""
    from repro.distributed.sharding import serve_param_pspec

    mesh = _stand_in(spec)
    sizes = mesh.shape
    want_bytes = 0
    expected = {}
    for path, shape in results["shapes"][FAMILIES[family]].items():
        spec_ = serve_param_pspec(path, shape, mesh)
        local = []
        for dim, ax in zip(shape, tuple(spec_)):
            n = 1
            for a in (() if ax is None else (ax if isinstance(ax, tuple) else (ax,))):
                n *= sizes[a]
            local.append(dim // n)
        expected[path] = local
        want_bytes += int(np.prod(local)) * 4
    for js in results["ranks"][_world_of(spec)]:
        got = js[f"{spec}/{family}"]
        assert got["shapes"] == expected
        assert got["bytes"] == want_bytes
        if sizes["data"] > 1:
            full = sum(int(np.prod(s)) * 4 for s in results["shapes"][FAMILIES[family]].values())
            assert got["bytes"] < full


def _placed_cache_bytes(arch, spec, paged):
    """(what a rank holds under repro's serving cache rules, the whole
    cache): ``serve_cache_shardings`` over the 2-slot contiguous cache, or
    ``serve_paged_cache_shardings`` over the paged hybrid's arenas plus the
    rank's two reserved pages a leaf where an arena splits."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding
    from repro_torch.models.model_zoo import cache_specs, paged_cache_specs
    from repro_torch.serve.paged_cache import N_RESERVED

    cfg = _tcfg(arch)
    d, m = (int(x) for x in spec.split("x"))
    mesh = {"data": d, "model": m}
    if paged:
        n = N_RESERVED + PREFIX_ARENA
        specs = paged_cache_specs(cfg, n, 8, N_RESERVED + 4 * PREFIX_SLOTS)
    else:
        specs = cache_specs(cfg, ShapeConfig(name="serve", seq_len=32, global_batch=2,
                                             kind="decode"))
    meta = type(specs)(*(torch.empty(s.shape, dtype=s.dtype, device="meta") for s in specs))
    rule = (sharding.serve_paged_cache_shardings(mesh, None, meta) if paged
            else sharding.serve_cache_shardings(mesh, None, meta, 2))
    want = sharding.placed_bytes(meta, rule, mesh)
    for leaf, r in zip(meta, rule):
        if paged and r:
            want += N_RESERVED * leaf.numel() // leaf.shape[1] * leaf.element_size()
    return want, sum(leaf.numel() * leaf.element_size() for leaf in meta)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("spec", MESHES)
def test_fsdp_cache_bytes_are_placed_bytes(results, spec, family):
    """Each rank's resident cache is its block under ``serve_cache_shardings``
    (half the whole at 2x1 and 2x2, where the two data rows split the 2
    slots; the whole cache at 4x1, whose 4 data ranks do not divide 2
    slots), for every family, the ssm and hybrid conv/ssm leaves included."""
    want, whole = _placed_cache_bytes(FAMILIES[family], spec, False)
    for js in results["ranks"][_world_of(spec)]:
        assert js[f"{spec}/{family}"]["cache_bytes"] == want
    assert (want < whole) == (spec != "4x1")


@pytest.mark.parametrize("spec", MESHES)
def test_fsdp_paged_hybrid_prefix_within_a_data_row(results, spec):
    """A paged hybrid session (K/V and state arenas, chunks of 4, prefix
    sharing, FSDP) of 4 slots: every rank emits repro's single-device
    streams and the same stats; each rank holds its blocks of both arenas
    plus its own reserved pages (at 4x1 the 18-page arenas stay whole: 4
    does not divide them); where two slots share a data row (2x1, 2x2)
    later requests adopt their row's prefix."""
    want, whole = _placed_cache_bytes(FAMILIES["hybrid"], spec, True)
    ranks = results["ranks"][_world_of(spec)]
    first = ranks[0][f"{spec}/prefix"]
    for js in ranks:
        got = js[f"{spec}/prefix"]
        assert got["tokens"] == results["streams"]["prefix"]
        assert got["stats"] == first["stats"]
        assert got["cache_bytes"] == want
    paged = first["stats"]["paged"]
    assert paged["pages_in_use"] == 0 and paged["state_pages_in_use"] == 0
    if spec != "4x1":
        assert want < whole and paged["prefix_hits"] > 0


@pytest.mark.parametrize("spec", MESHES)
def test_fsdp_stats_equal_on_every_rank(results, spec):
    ranks = results["ranks"][_world_of(spec)]
    for family in FAMILIES:
        first = ranks[0][f"{spec}/{family}"]["stats"]
        assert all(js[f"{spec}/{family}"]["stats"] == first for js in ranks[1:])
        assert first["decode_builds"] == 1 and first["decode_graphs"] == 0


@pytest.mark.parametrize("spec", MESHES)
def test_fsdp_capacity_overflow_exact(results, spec):
    """Every token to expert 0 at capacity factor 0.25 (``grouped``, 8
    slots): the FSDP session overflows and stays token-identical to the
    replicated one."""
    for js in results["ranks"][_world_of(spec)]:
        assert js[f"{spec}/overflow/fsdp"] == js[f"{spec}/overflow/replicated"]
        assert js[f"{spec}/overflow/fsdp/count"] > 0


@pytest.mark.parametrize("spec", MESHES)
def test_fsdp_gather_layer_full_rows_bit_exact(results, spec):
    """``layer``, ``full`` and ``rows`` rebuild the replicated leaves bit for
    bit; ``rows`` moves only the (ids, d / ndata) activation rows."""
    ndata = int(spec.split("x")[0])
    d = results["shapes"]["qwen2-1.5b"]["embed/table"][1]
    for js in results["ranks"][_world_of(spec)]:
        got = js[f"{spec}/gather"]
        assert got["layer"] and got["gate"] and got["rows"]
        assert got["rows_moved"] == [[3, d // ndata]]


@pytest.mark.parametrize("spec", MESHES)
def test_fsdp_encdec_bundle_matches(results, spec):
    """whisper-base's prefill (encoder, cross K/V, learned positions) and
    four decode steps (vector and scalar ``pos``) from FSDP-stored weights:
    equal to the replicated bundle bit for bit, ids equal to repro's."""
    for js in results["ranks"][_world_of(spec)]:
        got = js[f"{spec}/encdec"]
        assert got["fsdp"] == got["replicated"]
        for (v, i), (jv, ji) in zip(got["fsdp"], results["encdec"]):
            np.testing.assert_array_equal(np.asarray(i), ji)
            np.testing.assert_allclose(np.asarray(v, np.float32), jv, **HEAD_TOL)


if __name__ == "__main__":
    _worker(*sys.argv[1:4])
