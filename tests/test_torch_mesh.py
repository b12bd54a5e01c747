"""The mesh's placement rules, the ``*_ep`` registry specs, the table
padding and the trivial (1x1) mesh in this process, held against ``repro``
(``tests/test_distributed.py``, ``tests/test_serve_sharded.py:203``,
``tests/test_serve_fsdp.py:68``); the launcher's ``--mesh`` in a 2-rank
``gloo`` world."""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dssoftmax as jds
from repro.distributed import sharding as jsh
from repro.kernels import registry as jreg
from repro_torch import configs
from repro_torch.core import dssoftmax as ds
from repro_torch.distributed import sharding
from repro_torch.kernels import registry
from repro_torch.launch import mesh as tmesh
from repro_torch.utils.tree import map_with_path

SPECS = ("1x1", "2x1", "4x1", "2x2", "1x8")


def _stand_in(spec):
    d, m = (int(x) for x in spec.split("x"))
    return types.SimpleNamespace(shape={"data": d, "model": m}, axis_names=("data", "model"))


@pytest.fixture(scope="module")
def leaves():
    """Every leaf path and shape of every registered config at reduced width."""
    from repro_torch.models import build

    out = {}
    torch.set_num_threads(1)
    for arch in configs.ARCHS:
        cfg = configs.reduce_config(configs.get_config(arch), vocab=128)
        params, _ = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        paths = {}
        map_with_path(lambda p, x: paths.__setitem__(p, tuple(x.shape)), params)
        out[arch] = paths
    return out


@pytest.mark.parametrize("spec", SPECS)
def test_param_rules_match_repro(leaves, spec):
    """``param_pspec``, ``_fitted_pspec`` and ``serve_param_pspec`` equal
    repro's for every leaf of every config (repro's with a stand-in mesh,
    as its tests do for meshes wider than the host)."""
    mesh = _stand_in(spec)
    n = 0
    for arch, paths in leaves.items():
        for path, shape in paths.items():
            assert sharding.param_pspec(path, len(shape)) == tuple(
                jsh.param_pspec(path, len(shape))), (arch, path)
            assert sharding._fitted_pspec(path, shape, mesh) == tuple(
                jsh._fitted_pspec(path, shape, mesh)), (arch, path)
            assert sharding.serve_param_pspec(path, shape, mesh) == tuple(
                jsh.serve_param_pspec(path, shape, mesh)), (arch, path)
            n += 1
    assert n > 150


@pytest.mark.parametrize("spec", SPECS)
def test_batch_and_cache_rules(spec):
    """Batch and serving-cache placements on the same stand-in meshes: the
    token rows split over data when it divides them, cache slots (or pages)
    likewise, the sequence never; the EP table rule puts experts on model."""
    mesh = _stand_in(spec)
    d = mesh.shape["data"]
    for B in (1, 2, 8):
        want = (("data",) if B % d == 0 and B >= d else None, None)
        assert sharding.batch_pspec(mesh, B) == want
    cache = {"k": torch.zeros(2, 8, 16, 2, 4), "n": torch.zeros(3)}
    got = sharding.serve_cache_shardings(mesh, None, cache, n_slots=8)
    assert got == ({"k": (None, "data"), "n": ()} if d > 1 else {"k": (), "n": ()})
    paged = sharding.serve_paged_cache_shardings(mesh, None, {"k": torch.zeros(2, 6, 4)})
    assert paged == {"k": (None, "data") if d in (2,) else ()}
    t = ds.ServeTable(ids=torch.zeros(4, 8, dtype=torch.int32), weights=torch.zeros(4, 8, 2))
    assert sharding.serve_table_ep_shardings(mesh, t) == ds.ServeTable(
        ids=("model", None), weights=("model", None, None))


def test_parse_mesh_errors():
    with pytest.raises(ValueError, match="DxM or PxDxM"):
        tmesh.parse_mesh("8", device="cpu")
    with pytest.raises(ValueError, match="DxM or PxDxM"):
        tmesh.parse_mesh("2xa", device="cpu")


def test_cuda_world_wider_than_the_cards_raises(monkeypatch):
    """NCCL puts one rank on each card: a 2-rank world on a 1-card host
    raises, nothing moves to gloo or the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        tmesh.init_distributed("cuda", rank=0, world_size=2)


@pytest.mark.parametrize("B,K,ep,ndata", [(8, 16, 2, 1), (64, 16, 4, 2), (1, 6, 4, 1),
                                          (2048, 16, 8, 4), (40, 6, 2, 2)])
def test_kernel_context_local_and_merge_bytes_match_repro(B, K, ep, ndata):
    kw = dict(B=B, d=64, K=K, v_pad=256, k=8, capacity_factor=1.25, ep=ep, ndata=ndata)
    mine, theirs = registry.KernelContext(**kw).local(), jreg.KernelContext(**kw).local()
    assert (mine.B, mine.K, mine.capacity, mine.ep, mine.ndata) == (
        theirs.B, theirs.K, theirs.capacity, theirs.ep, theirs.ndata)
    ctx = registry.KernelContext(**kw)
    for base in ("jnp", "grouped", "cuda_grouped", "cuda_fused", "cuda_pertoken"):
        spec = registry.get_spec(f"{base}_ep")
        assert spec.ici_bytes(ctx) == jreg.get_spec("jnp_ep").ici_bytes(jreg.KernelContext(**kw))
        assert spec.bytes_moved(ctx) == registry.get_spec(base).bytes_moved(ctx.local())
        assert spec.local_name == base and spec.sharded


def test_sharded_specs_feasible_only_at_ep_above_1():
    one = registry.KernelContext(B=8, d=64, K=16, v_pad=256, backend="cuda")
    two = registry.KernelContext(B=8, d=64, K=16, v_pad=256, backend="cuda", ep=2)
    for name in registry.kernel_names():
        spec = registry.get_spec(name)
        assert spec.feasible(one) != spec.sharded
        assert spec.feasible(two) == spec.sharded
    hist = []
    registry.AutoPolicy(history=hist).resolve(two)
    assert hist[-1][1].endswith("_ep")
    # the data-sheet ratio: H100 HBM3 over one direction of NVLink 4
    assert registry.ICI_HBM_BYTE_RATIO == pytest.approx(3.35e12 / 450e9)
    for name in registry.kernel_names():
        spec = registry.get_spec(name)
        assert spec.ici_bytes(two) == ((2 - 1) * 8 * 8 * 8 if spec.sharded else 0)
        assert spec.price(two) == spec.bytes_moved(two) + spec.ici_bytes(
            two) * registry.ICI_HBM_BYTE_RATIO
    t = ds.ServeTable(ids=torch.zeros(4, 8, dtype=torch.int32), weights=torch.zeros(4, 8, 2))
    with pytest.raises(ValueError, match="expert-parallel"):
        ds.serve_topk(torch.zeros(4, 2), t, torch.zeros(3, 2), 2, kernel="grouped_ep",
                      device="cpu")


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("ep", [1, 2, 4, 5])
def test_pad_table_experts_matches_repro(quantized, ep):
    rng = np.random.RandomState(ep)
    ids = rng.randint(-1, 50, (6, 16)).astype(np.int32)
    w = rng.randn(6, 16, 8).astype(np.float32)
    jt = jds.ServeTable(ids=jnp.asarray(ids), weights=jnp.asarray(w))
    tt = ds.ServeTable(ids=torch.from_numpy(ids), weights=torch.from_numpy(w))
    if quantized:
        fb = np.arange(6) == 2
        jt, tt = jds.quantize_table(jt, fb), ds.quantize_table(tt, torch.from_numpy(fb))
    want, got = jds._pad_table_experts(jt, ep), ds._pad_table_experts(tt, ep)
    assert type(got).__name__ == type(want).__name__
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# The trivial mesh, in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh11(tmp_path_factory):
    store = tmp_path_factory.mktemp("pg") / "store"
    tmesh.init_distributed("cpu", store=str(store), rank=0, world_size=1)
    yield tmesh.parse_mesh("1x1", device="cpu")
    tmesh.destroy()


@pytest.fixture(scope="module")
def tiny():
    """repro's tiny qwen2-1.5b of tests/test_serve_sharded.py (vocab 128, K
    4), the port's on the same weights, and repro's streams on its trivial
    1x1 mesh, replicated and FSDP (equal to its unsharded session's,
    ``tests/test_serve_sharded.py:203``, ``tests/test_serve_fsdp.py:68``)."""
    from conftest import make_test_mesh
    from repro.configs import get_config, reduce_config
    from repro.models import build as jbuild
    from repro.train import Request, SamplingParams, ServeSession
    from repro_torch.convert import flatten_paths, params_from_jax
    from repro_torch.models import build

    jcfg = reduce_config(get_config("qwen2-1.5b"), vocab=128).replace(
        ds=get_config("qwen2-1.5b").ds.replace(num_experts=4), dtype="float32")
    tcfg = configs.reduce_config(configs.get_config("qwen2-1.5b"), vocab=128).replace(
        ds=configs.get_config("qwen2-1.5b").ds.replace(num_experts=4), dtype="float32")
    jb = jbuild(jcfg)
    params, state = jb.init(jax.random.PRNGKey(0))
    table = jds.pack_experts(params["head"], state)
    streams = {}
    mesh = make_test_mesh("1x1")
    for name, kw in (("replicated", dict(mesh=mesh)),
                     ("fsdp", dict(mesh=mesh, param_mode="fsdp"))):
        sess = ServeSession(jb, params, table, n_slots=2, max_seq_len=32, kernel="jnp",
                            prefill_chunk=4, **kw)
        reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=m))
                for p, m in zip(_prompts(), [2, 5, 3, 7, 4, 6])]
        sess.run(reqs)
        streams[name] = [list(map(int, r.out_tokens)) for r in reqs]
    tree = flatten_paths(jax.tree.map(np.asarray, params))
    tree["ds_state/mask"] = np.asarray(state.mask)
    tparams, tstate = params_from_jax(tree, tcfg, device="cpu")
    return streams, build(tcfg, device="cpu"), tparams, tstate


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 128, rng.randint(3, 10)).astype(np.int32) for _ in range(6)]


def _run(bundle, params, state, mesh, **kw):
    from repro_torch.train import Request, SamplingParams, ServeSession

    sess = ServeSession(bundle, params, state, n_slots=2, max_seq_len=32, mesh=mesh,
                        device="cpu", **kw)
    reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=m))
            for p, m in zip(_prompts(), [2, 5, 3, 7, 4, 6])]
    sess.run(reqs)
    return sess, [list(r.out_tokens) for r in reqs]


@pytest.mark.parametrize("kern", ["jnp", "grouped", "cuda_fused", "auto"])
@pytest.mark.parametrize("param_mode", ["replicated", "fsdp"])
def test_trivial_mesh_session_matches_repro(mesh11, tiny, param_mode, kern):
    """The port's 1x1 mesh session equals repro's 1x1 mesh session in the
    same mode token for token, on every path."""
    streams, bundle, params, state = tiny
    sess, got = _run(bundle, params, state, mesh11, param_mode=param_mode, kernel=kern)
    assert got == streams[param_mode]
    assert isinstance(sess.table, ds.TableShard) and sess.table.n_experts == 4
    assert sess.stats()["decode_builds"] == 1


def test_fsdp_requires_mesh(tiny):
    from repro_torch.train import ServeSession

    _, bundle, params, state = tiny
    with pytest.raises(ValueError, match="fsdp.*mesh"):
        ServeSession(bundle, params, state, param_mode="fsdp", device="cpu")
    with pytest.raises(ValueError, match="param_mode"):
        ServeSession(bundle, params, state, param_mode="sharded", device="cpu")


def test_world_of_one_rejects_a_wider_mesh(mesh11):
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.parse_mesh("1x2", device="cpu")


# ---------------------------------------------------------------------------
# The launcher in a 2-rank world
# ---------------------------------------------------------------------------

_LAUNCH = ("import sys, json; from repro_torch.launch.serve import main; "
           "s = main(sys.argv[1:-1] + ['--dist-store', sys.argv[-1]]); "
           "print(json.dumps([list(map(int, r.out_tokens)) for r in s.requests]))")
ARGS = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu", "--batch", "4", "--slots", "2",
        "--prompt-len", "6", "--new-tokens", "4"]


def test_launcher_mesh_fsdp_in_a_two_rank_world(tmp_path):
    """``launch/serve.py --mesh 1x2 --param-mode fsdp`` under two ranks ends
    with the replicated run's tokens on both; ``--param-mode fsdp`` without
    ``--mesh`` is an error."""
    from repro_torch.launch.serve import main
    from _spmd import python_argv, start_world, wait_world

    procs = start_world(python_argv("-c", _LAUNCH, *ARGS, "--mesh", "1x2", "--param-mode",
                                    "fsdp"), 2, store_dir=str(tmp_path))
    want = [list(map(int, r.out_tokens)) for r in main(ARGS).requests]
    outs = wait_world(procs, timeout=300)
    for out in outs:
        assert json.loads(out.strip().splitlines()[-1]) == want
    with pytest.raises(SystemExit):
        main(ARGS + ["--param-mode", "fsdp"])


# ---------------------------------------------------------------------------
# The local halves in this process (phase 6f (b) of chip_smoke.py on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("path", ["cuda_fused", "cuda_grouped", "grouped", "jnp"])
def test_local_halves_merge_to_serve_topk(path, ep, quantized):
    """Each model rank's local half run one after another in one process,
    then the merge over the stacked carries: ids equal ``serve_topk``'s bit
    for bit (the CUDA paths through their wrappers' plain versions), values
    within rtol 1e-6 / atol 2e-6 (a rank's fixup multiplies its own tokens
    only, in a batch of another size), the counts concatenate to its counts,
    no -inf."""
    rng = np.random.RandomState(ep)
    K, d = 6, 16
    ids = np.where(rng.rand(K, 64) < 0.8, rng.permutation(K * 64).reshape(K, 64), -1)
    table = ds.ServeTable(ids=torch.from_numpy(ids.astype(np.int32)),
                          weights=torch.from_numpy(rng.randn(K, 64, d).astype(np.float32)))
    if quantized:
        table = ds.quantize_table(table, torch.tensor([0, 1, 0, 0, 0, 1], dtype=bool))
    gate = torch.from_numpy(rng.randn(K, d).astype(np.float32))
    for B, cf in ((8, 2.0), (64, 0.25)):
        h = torch.from_numpy(rng.randn(B, d).astype(np.float32))
        want = ds.serve_topk(gate, table, h, 8, kernel=path, capacity_factor=cf,
                             with_stats=True, device="cpu")
        shards = [ds.table_shard(table, ep, r) for r in range(ep)]
        halves = [ds.serve_topk_local_half(gate, s, h, 8, path, capacity_factor=cf,
                                           with_stats=True) for s in shards]
        assert not any(torch.isinf(v).any() for v, _, _, _ in halves)
        v, i = ds.merge_carries(torch.stack([x[0] for x in halves]),
                                torch.stack([x[1] for x in halves]), halves[0][2],
                                shards[0].local.ids.shape[0])
        assert torch.equal(i, want[1])
        torch.testing.assert_close(v, want[0], rtol=1e-6, atol=2e-6)
        got = {key: torch.cat([x[3][key] for x in halves])[:K] for key in want[2]}
        assert torch.equal(got["dispatched"], want[2]["dispatched"])
        if K % ep == 0:  # else capacity is sized by the padded K, as in repro
            assert torch.equal(got["overflow"], want[2]["overflow"])


# ---------------------------------------------------------------------------
# A slot-split decode's data rows in turn (phase 6f (d) of chip_smoke.py on the CPU)
# ---------------------------------------------------------------------------

def test_data_rows_in_turn_equal_the_whole_cache():
    """``testing.mesh_rows.decode_data_rows`` on the CPU (reduced qwen2-1.5b,
    fp32, 4 slots): 2 data rows stepped in turn, each on its own half cache,
    emit the whole cache's streams (ids equal, values within rtol 1e-6 /
    atol 2e-6); a row's cache is ``serve_cache_block``'s half; 3 rows do
    not divide 4 slots."""
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.models import build
    from repro_torch.testing.mesh_rows import decode_data_rows, row_mesh

    cfg = configs.reduce_config(configs.get_config("qwen2-1.5b")).replace(dtype="float32")
    bundle = build(cfg, device="cpu")
    params, state = bundle.init(torch.Generator().manual_seed(3))
    table = ds.pack_experts(params["head"], state)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 17, 9, 30)]
    kw = dict(new_tokens=6, max_seq_len=40, kernel="jnp", device="cpu")
    whole = decode_data_rows(bundle, params, table, prompts, n_rows=1, **kw)
    rows = decode_data_rows(bundle, params, table, prompts, n_rows=2, **kw)
    assert rows.tokens == whole.tokens
    for a, b in zip(rows.heads, whole.heads):
        for (v, i), (wv, wi) in zip(a, b):
            assert torch.equal(i, wi)
            torch.testing.assert_close(v, wv, rtol=1e-6, atol=2e-6)
    assert [sharding.serve_cache_block(row_mesh(2, r), 4)[:3] for r in (0, 1)] == \
        [(0, 2, 4), (2, 2, 4)]
    assert sharding.tree_shard_bytes(rows.caches[1]) * 2 == \
        sharding.tree_shard_bytes(whole.caches[0])
    with pytest.raises(ValueError, match="do not split"):
        decode_data_rows(bundle, params, table, prompts, n_rows=3, **kw)
