"""Training on a mesh in ``gloo`` worlds (``train.train_step.make_train_step(
mesh=)``, the training rules of ``distributed.sharding``, the
expert-parallel ``models.moe`` FFN), held against the port's single-device
step (which ``tests/test_torch_train.py`` holds against ``repro``) and
against ``repro``.

One world per mesh: 1x2, 2x1 and 2x2 (``tests/_spmd.py``, one process per
rank, every check of a world in one go). Each world steps six reduced
configs 3 times (hybrid once) from the same seeded state on the same batches
of 8 rows: dense (qwen2-1.5b, full-softmax head tied to the embedding), moe
(olmoe-1b-7b with a DS head, through the expert-parallel FFN wherever the
mesh has a model axis; microbatches 2), DS (qwen2-1.5b, gamma 1.0, so the
mask prunes) in fp32, DS in bf16 (microbatches 2), hybrid (zamba2-7b: mamba
layers and the shared attention block, each under ``remat``) and encdec
(whisper-base on 8 seeded frames a row, every layer under ``remat``;
microbatches 2), both fp32 with a DS head. The 1x2 world also runs one
layer's expert-parallel FFN at model 2, the 4-rank world on a 1x4 mesh at
model 4. While the worlds run, this process computes the port's
single-device references and ``repro``'s off-mesh ``moe_block``, and one
subprocess with 4 host devices runs ``repro``'s own ``_moe_ep_shardmap`` (at
1x2 and 1x4) and its sharded train step at 2x2 on the dense, DS and moe
cases, placed as ``repro/launch/dryrun.py:90-116`` places a train cell. The
port's 2x2 step is held to ``repro``'s on the dense and DS cases under the
fp32 tolerances below.

Tolerances:
* fp32 states: params, moments rtol 1e-5 / atol 1e-6, but elements whose
  gradient is below 1e-3 of their leaf's largest at some step (Adam's step
  is ≈ lr·sign(g) there, and a gradient of rounding noise, such as the K
  bias's, which is zero in exact arithmetic, takes either sign) within
  2·lr per step; loss, CE and grad norm rtol 1e-5; masks equal but for
  rows whose norm is within 1e-6 of gamma (counted). The hybrid case
  steps once: from its second step on, its state turns on the last bit of
  the grad norm, which the mesh sums in another order (the gradient is
  clipped to norm 1 from about 21). Its single-device step with the clip
  threshold moved by one part in 10^7 parts from itself by 1.28e-5 in the
  mamba ``in_bc`` after 3 steps, as the mesh step does.
* bf16 states: bit for bit, or params within 2·lr per step (``chip_smoke.py``
  phase 7 (a2)'s rule), loss, CE and grad norm rtol 1e-3, masks equal; the
  first moments within 2^-5 and the second within 2^-4 of each leaf's
  largest. A bf16 gradient summed over half the rows and then across ranks
  in fp32 rounds otherwise than one summed over all rows in bf16 (the
  embedding's scatter-add most: 1.8% of its largest first moment at 2x1):
  ``tests/test_torch_train.py``'s bf16 gradient rule, 2^-5 of the leaf's
  largest, carried to m (a sum of gradients) and doubled for v (squares).
* The expert-parallel FFN (fp32, d 64, E 4, top-2): forward and every
  gradient of ``repro``'s off-mesh ``moe_block`` within rtol 1e-5 and an
  atol of 1e-6 of the array's largest magnitude (the shards' partials are
  summed in another order; y reaches 16).
"""
import functools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
VOCAB, B, S, STEPS, LR = 128, 8, 16, 3, 1e-3
WORLDS = {"1x2": 2, "2x1": 2, "2x2": 4}
# the expert-parallel FFN check each world runs, on a 1xM mesh of its ranks
EP_OF_WORLD = {"1x2": "1x2", "2x2": "1x4"}
CASES = {  # name: (arch, dtype, head, microbatches)
    "dense": ("qwen2-1.5b", "float32", "full", 1),
    "moe": ("olmoe-1b-7b", "float32", "ds", 2),
    "ds": ("qwen2-1.5b", "float32", "ds", 1),
    "ds_bf16": ("qwen2-1.5b", "bfloat16", "ds", 2),
    "hybrid": ("zamba2-7b", "float32", "ds", 1),
    "encdec": ("whisper-base", "float32", "ds", 2),
}
# the cases whose layers run under ``remat`` (the gather runs again in the
# backward's recompute), and the frames a row of the encdec case
REMAT_CASES = ("hybrid", "encdec")
FRAMES = 8
# the cases stepped fewer than STEPS times (module docstring)
CASE_STEPS = {"hybrid": 1}
# the cases repro's own sharded step runs at 2x2 (in the 4-device subprocess)
REPRO_STEP_CASES = ("dense", "ds", "moe")
EP_B, EP_S = 4, 16
F32 = dict(rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Inputs both sides share (seeded)
# ---------------------------------------------------------------------------

def case_cfg(name):
    from repro_torch import configs

    arch, dtype, head, _ = CASES[name]
    cfg = configs.reduce_config(configs.get_config(arch), vocab=VOCAB).replace(
        dtype=dtype, head=head)
    if name in REMAT_CASES:
        cfg = cfg.replace(remat="layer")
    return cfg.replace(ds=cfg.ds.replace(gamma=1.0, lambda_lasso=1e-3, lambda_expert=1e-3))


def batches():
    rng = np.random.RandomState(1)
    return [rng.randint(0, VOCAB, (B, S + 1)).astype(np.int64) for _ in range(STEPS)]


def case_batches(name):
    """``batches()`` as the case's batch dicts of tensors (its first
    ``CASE_STEPS`` of them): the tokens, and for the encdec case seeded
    frames (B, FRAMES, d)."""
    out = [{"tokens": torch.from_numpy(tok)} for tok in batches()[:CASE_STEPS.get(name)]]
    if CASES[name][0] == "whisper-base":
        rng = np.random.RandomState(2)
        d = case_cfg(name).d_model
        for b in out:
            b["frames"] = torch.from_numpy(rng.randn(B, FRAMES, d).astype(np.float32))
    return out


def initial_state(name):
    from repro_torch.models import build
    from repro_torch.optim import adam_init
    from repro_torch.train.train_step import TrainState

    cfg = case_cfg(name)
    bundle = build(cfg, device="cpu")
    params, st = bundle.init(torch.Generator().manual_seed(0))
    return bundle, TrainState(params, adam_init(params), st)


def ep_inputs():
    """One layer of reduced olmoe-1b-7b's MoE (fp32; E 4, top-2, d 64, f
    64), x (4, 16, 64) and the cotangent dy, as numpy."""
    from repro_torch import configs
    from repro_torch.models import moe

    cfg = configs.reduce_config(configs.get_config("olmoe-1b-7b")).replace(dtype="float32")
    g = torch.Generator().manual_seed(5)
    params = {k: v[0].numpy() for k, v in moe.init_moe(g, cfg, 1, device="cpu").items()}
    rng = np.random.RandomState(6)
    x = rng.randn(EP_B, EP_S, cfg.d_model).astype(np.float32)
    dy = rng.randn(EP_B, EP_S, cfg.d_model).astype(np.float32)
    return cfg, params, x, dy


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# The rank processes
# ---------------------------------------------------------------------------

def _step_cases(mesh, arrays, info):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import sharding
    from repro_torch.train.train_step import make_train_step
    from repro_torch.utils import flatten_dict

    for name in CASES:
        bundle, state = initial_state(name)
        local, specs = sharding.shard_train_state(mesh, state)
        grad_parts = _block_grads_two_ways(bundle, mesh, local, specs, name)
        step = make_train_step(bundle, TrainConfig(lr=LR, microbatches=CASES[name][3]),
                               mesh=mesh, shardings=specs)
        hist, recs = [], []
        for batch in case_batches(name):
            with sharding.record_collectives() as rec:
                local, m = step(local, batch)
            hist.append({k: float(v) for k, v in m.items()})
            recs.append([(op, list(shape), str(dt), n) for op, shape, dt, n in rec])
        whole = sharding.gather_tree(mesh, local, specs)
        for k, v in flatten_dict(whole).items():
            arrays[f"{name}/{k}"] = _np(v)
        info[name] = {"metrics": hist, "collectives": recs,
                      "resident_bytes": sharding.tree_shard_bytes(local),
                      "whole_bytes": sharding.tree_shard_bytes(state),
                      "block_grads_two_ways": grad_parts}


def _block_grads_two_ways(bundle, mesh, local, specs, name):
    """The first microbatch's gradients of the first batch, this rank's
    blocks, two ways: through the step's gather (``TrainParamGather``, each
    gather's backward reducing into its block) and as whole-leaf gradients
    of ``gather_params``' tree reduced by ``constrain_like_params`` → {leaf:
    (max |difference|, max |the second|)}."""
    from repro_torch.core import dssoftmax as ds
    from repro_torch.distributed import sharding
    from repro_torch.train.train_step import rank_rows, value_and_grad
    from repro_torch.utils import flatten_dict

    n = CASES[name][3]
    mb = {k: rank_rows(v, mesh, 0, n) for k, v in case_batches(name)[0].items()}
    ds_state = None if local.ds_state is None else ds.DSState(
        mask=sharding.gather_leaf(local.ds_state.mask, specs.ds_state.mask, mesh))
    _, by_gather = value_and_grad(bundle, local.params, ds_state, mb, mesh=mesh,
                                  gather=sharding.TrainParamGather(mesh, specs.params))
    _, whole = value_and_grad(bundle, sharding.gather_params(mesh, local.params, specs.params),
                              ds_state, mb, mesh=mesh)
    by_rule = sharding.constrain_like_params(whole, mesh, specs.params)
    a, b = flatten_dict(by_gather), flatten_dict(by_rule)
    assert set(a) == set(b) and all(a[k].shape == b[k].shape for k in a)
    return {k: (float((a[k].float() - b[k].float()).abs().max()), float(b[k].float().abs().max()))
            for k in a}


def _ep_case(spec, arrays, info):
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models import moe

    mesh = parse_mesh(spec, device="cpu")
    cfg, params, x, dy = ep_inputs()
    n = sharding.mesh_sizes(mesh)["model"]
    m = sharding.axis_index(mesh, "model")
    E = cfg.moe.num_experts
    leaves = {k: torch.from_numpy(v[m * (E // n):(m + 1) * (E // n)] if k != "router" else v)
              .requires_grad_(True) for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    with sharding.record_collectives() as rec:
        y, aux = moe.moe_block(leaves, cfg, xt, mesh=mesh)
        obj = torch.sum(y * torch.from_numpy(dy)) + aux.load_loss
        grads = torch.autograd.grad(obj, [xt] + list(leaves.values()))
    g = dict(zip(["x"] + list(leaves), grads))
    for k in ("w_gate", "w_up", "w_down"):  # the whole stacks, from every model block
        g[k] = sharding.gather_leaf(g[k], ("model",), mesh)
    arrays[f"ep/{spec}/y"] = y.detach().numpy()
    arrays[f"ep/{spec}/load"] = aux.load_loss.detach().numpy()
    for k, v in g.items():
        arrays[f"ep/{spec}/grad/{k}"] = v.numpy()
    info[f"ep/{spec}"] = {"collectives": [(op, list(s), str(d), c) for op, s, d, c in rec],
                          "expert_parallel": moe.expert_parallel(cfg, mesh)}


def _worker(out_dir, spec, store):
    from repro_torch.launch.mesh import destroy, init_distributed, parse_mesh

    torch.set_num_threads(1)
    init_distributed("cpu", store=store)
    rank = torch.distributed.get_rank()
    arrays, info = {}, {}
    _step_cases(parse_mesh(spec, device="cpu"), arrays, info)
    if spec in EP_OF_WORLD:
        _ep_case(EP_OF_WORLD[spec], arrays, info)
    destroy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)


# ---------------------------------------------------------------------------
# repro: the off-mesh FFN here, its expert-parallel FFN and sharded step in
# a subprocess with 4 host devices
# ---------------------------------------------------------------------------

_XLA = r"""
import sys, json
import numpy as np
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
import jax, jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
import test_torch_train_mesh as t
from repro.configs import get_config, reduce_config
from repro.configs.base import TrainConfig
from repro.core import dssoftmax as jds
from repro.distributed import sharding as shard
from repro.launch.mesh import parse_mesh
from repro.models import build
from repro.models import moe as jmoe
from repro.optim import adam_init
from repro.train.train_step import TrainState, make_train_step
from repro.utils.tree import flatten_dict as jflatten, tree_paths
from repro_torch.utils import flatten_dict

out = {}
_, params, x, dy = t.ep_inputs()
cfg = reduce_config(get_config("olmoe-1b-7b")).replace(dtype="float32")
p = {k: jnp.asarray(v) for k, v in params.items()}

def obj(p, x):
    y, aux = jmoe.moe_block(p, cfg, x)
    return jnp.sum(y.astype(jnp.float32) * dy) + aux.load_loss, y

for spec in ("1x2", "1x4"):
    mesh = parse_mesh(spec)
    with mesh:
        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(obj, argnums=(0, 1), has_aux=True))(
            p, jnp.asarray(x))
    out["ep/" + spec] = {"y": np.asarray(y).tolist(), "x": np.asarray(gx).tolist(),
                         **{k: np.asarray(v).tolist() for k, v in gp.items()}}

# the sharded step at 2x2 on the dense, ds and moe cases, placed as
# launch/dryrun.py's lower_cell places a train cell
mesh = parse_mesh("2x2")
repl = NamedSharding(mesh, P())
bsh = NamedSharding(mesh, shard.batch_pspec(mesh, t.B, 1))
for name in t.REPRO_STEP_CASES:
    arch, dtype, head, micro = t.CASES[name]
    _, state_t = t.initial_state(name)
    flat = {k: v.numpy() for k, v in flatten_dict(state_t.params).items()}
    jcfg = reduce_config(get_config(arch), vocab=t.VOCAB).replace(dtype=dtype, head=head)
    jcfg = jcfg.replace(ds=jcfg.ds.replace(gamma=1.0, lambda_lasso=1e-3, lambda_expert=1e-3))
    jb = build(jcfg)
    shapes = jb.abstract_params()[0]  # repro's tree (a tied head is an empty dict)
    params = jax.tree.unflatten(jax.tree.structure(shapes),
                                [jnp.asarray(flat[k]) for k in tree_paths(shapes)])
    ds_state = None if state_t.ds_state is None else jds.DSState(
        mask=jnp.asarray(state_t.ds_state.mask.numpy()))
    opt = adam_init(params)
    state = TrainState(params=params, opt=opt, ds_state=ds_state)
    sh = TrainState(params=shard.param_shardings(mesh, params),
                    opt=type(opt)(step=repl, m=shard.param_shardings(mesh, opt.m),
                                  v=shard.param_shardings(mesh, opt.v)),
                    ds_state=None if ds_state is None else type(ds_state)(
                        mask=NamedSharding(mesh, P(None, "model"))))
    with mesh:
        step = jax.jit(make_train_step(jb, TrainConfig(lr=t.LR, microbatches=micro)),
                       in_shardings=(sh, {"tokens": bsh}))
        hist = []
        for tok in t.batches():
            state, m = step(state, {"tokens": jnp.asarray(tok.astype(np.int32))})
            hist.append({k: float(v) for k, v in m.items()})
    flat = {}
    for part, tree in (("params", state.params), ("opt/m", state.opt.m),
                       ("opt/v", state.opt.v)):
        flat.update({part + "/" + k: np.asarray(v).tolist() for k, v in jflatten(tree).items()})
    if state.ds_state is not None:
        flat["ds_state/mask"] = np.asarray(state.ds_state.mask).tolist()
    out["step/2x2/" + name] = {"metrics": hist, "state": flat}
print(json.dumps(out))
"""


def _repro_off_mesh_ep():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduce_config
    from repro.models import moe as jmoe

    _, params, x, dy = ep_inputs()
    cfg = reduce_config(get_config("olmoe-1b-7b")).replace(dtype="float32")

    def obj(p, x):
        y, aux = jmoe.moe_block(p, cfg, x)
        return jnp.sum(y.astype(jnp.float32) * dy) + aux.load_loss, (y, aux.load_loss)

    (_, (y, load)), (gp, gx) = jax.jit(jax.value_and_grad(obj, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return {"y": np.asarray(y), "load": np.asarray(load), "x": np.asarray(gx),
            **{k: np.asarray(v) for k, v in gp.items()}}


def _single_device_runs():
    """The port's single-device step on every case → {name: (final state as
    a flat numpy dict, metrics per step, the elements whose gradient stays
    above 1e-3 of their leaf's largest at every step)}."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.train_step import make_train_step, value_and_grad
    from repro_torch.utils import flatten_dict

    out = {}
    for name in CASES:
        bundle, state = initial_state(name)
        n = CASES[name][3]
        step = make_train_step(bundle, TrainConfig(lr=LR, microbatches=n))
        hist, big = [], None
        for batch in case_batches(name):
            g = None
            for i in range(n):
                part = {k: v[i * B // n:(i + 1) * B // n] for k, v in batch.items()}
                _, gi = value_and_grad(bundle, state.params, state.ds_state, part)
                gi = {k: v.float().numpy() for k, v in flatten_dict(gi).items()}
                g = gi if g is None else {k: g[k] + gi[k] for k in g}
            b = {k: np.abs(v) >= 1e-3 * np.abs(v).max() for k, v in g.items()}
            big = b if big is None else {k: big[k] & b[k] for k in b}
            state, m = step(state, batch)
            hist.append({k: float(v) for k, v in m.items()})
        out[name] = ({k: _np(v) for k, v in flatten_dict(state).items()}, hist, big)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from _spmd import python_argv, start_world, wait_world

    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("train_mesh")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    xla = subprocess.Popen([sys.executable, "-c", _XLA, str(ROOT / "src"), str(ROOT / "tests")],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    worlds = {}
    for spec, n in WORLDS.items():
        d = tmp / spec
        d.mkdir()
        worlds[spec] = (d, start_world(python_argv(__file__, str(d), spec), n,
                                       store_dir=str(d)))
    single = _single_device_runs()
    off_mesh = _repro_off_mesh_ep()
    ranks = {}
    for spec, (d, procs) in worlds.items():
        wait_world(procs, timeout=600)
        ranks[spec] = [(dict(np.load(d / f"rank{r}.npz")),
                        json.loads((d / f"rank{r}.json").read_text()))
                       for r in range(WORLDS[spec])]
    out, err = xla.communicate(timeout=600)
    assert xla.returncode == 0, err[-4000:]
    return {"ranks": ranks, "single": single, "off_mesh": off_mesh,
            "xla": json.loads(out.strip().splitlines()[-1])}


# ---------------------------------------------------------------------------
# The mesh step against the single-device step
# ---------------------------------------------------------------------------

def _gamma_rows(flat, name):
    """The (K, N) rows of the final experts whose norm is within 1e-6 of
    gamma (where a sum of squares in another order may flip the mask)."""
    w = flat["params/head/experts"].astype(np.float64) * flat["ds_state/mask"][..., None]
    return np.abs(np.sqrt((w ** 2).sum(-1)) - case_cfg(name).ds.gamma) <= 1e-6


def _hold(got, want, want_hist, hist, big, name):
    """Hold a final state (flat numpy) and its metrics per step to another
    run's under the module's tolerances → the count of mask entries that
    part in rows within 1e-6 of gamma."""
    bf16 = CASES[name][1] == "bfloat16"
    tol = dict(rtol=1e-3, atol=0) if bf16 else F32
    for i, (m, w) in enumerate(zip(hist, want_hist)):
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(m[k], w[k], rtol=tol["rtol"], err_msg=f"{name} {i} {k}")
    assert set(got) == set(want)
    if bf16 and all(np.array_equal(got[k], want[k]) for k in want):
        return 0
    n_near = 0
    for k, w in want.items():
        a = got[k]
        if w.dtype == bool:
            near = _gamma_rows(want, name)
            assert not (a != w)[~near].any(), k
            n_near += int((a != w).sum())
        elif k.startswith("params/"):
            assert np.abs(a - w).max() <= 2 * LR * len(want_hist) + 1e-7, k
            if not bf16:
                sel = big[k[len("params/"):]]
                np.testing.assert_allclose(a[sel], w[sel], **F32, err_msg=k)
        elif k == "opt/step":
            assert np.array_equal(a, w)
        elif bf16:
            bound = 2.0 ** -5 if k.startswith("opt/m/") else 2.0 ** -4
            assert np.abs(a - w).max() <= bound * np.abs(w).max(), k
        else:
            sel = big[k.split("/", 2)[2]]
            np.testing.assert_allclose(a[sel], w[sel], **F32, err_msg=k)
    return n_near


def _case_arrays(arrays, name):
    return {k[len(name) + 1:]: v for k, v in arrays.items() if k.startswith(name + "/")}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("spec", list(WORLDS))
def test_mesh_step_equals_the_single_device_step(results, spec, name):
    """After 3 steps (the hybrid case: 1) every rank's gathered params,
    moments and mask, and its loss, CE and grad norm at each step, equal
    the single-device step's (tolerances in the module docstring)."""
    want, want_hist, big = results["single"][name]
    n_near = 0
    for arrays, info in results["ranks"][spec]:
        n_near += _hold(_case_arrays(arrays, name), want, want_hist, info[name]["metrics"],
                        big, name)
    assert n_near <= 4, n_near


@pytest.mark.parametrize("spec", list(WORLDS))
def test_the_gathers_backward_is_constrain_like_params(results, spec):
    """On every rank and case, the block gradients that the step's gathers
    reduce in their backward equal ``constrain_like_params`` of the
    whole-leaf gradients of ``gather_params``' tree (one rule,
    ``block_grad``, applied per gathered use or per leaf): fp32 within 1e-5
    of each leaf's largest (sums in another order: a leaf read twice, as
    the tied embedding, is reduced once per read), bf16 within 2^-5
    (``tests/test_torch_train.py``'s bf16 gradient rule)."""
    for _, info in results["ranks"][spec]:
        for name in CASES:
            tol = 2.0 ** -5 if CASES[name][1] == "bfloat16" else 1e-5
            for leaf, (diff, top) in info[name]["block_grads_two_ways"].items():
                assert diff <= tol * top, (name, leaf, diff, top)


@pytest.mark.parametrize("spec", list(WORLDS))
def test_loss_and_metrics_are_the_same_on_every_rank(results, spec):
    """Every metric of every step is the whole batch's, equal on every rank
    bit for bit."""
    infos = [info for _, info in results["ranks"][spec]]
    for name in CASES:
        for info in infos[1:]:
            assert info[name]["metrics"] == infos[0][name]["metrics"], name


def _stand_in(spec):
    dims = tuple(int(x) for x in spec.split("x"))
    names = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return types.SimpleNamespace(shape=dict(zip(names, dims)), axis_names=names)


def _block_bytes(specs, tree, mesh):
    """Σ over leaves of one rank's block bytes under ``specs``."""
    from repro_torch.utils.tree import tree_leaves

    total = 0
    for s, x in zip(tree_leaves(specs), tree_leaves(tree)):
        n = 1
        for ax in s:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n *= mesh.shape.get(a, 1) if a else 1
        total += x.numel() * x.element_size() // n
    return total


@pytest.mark.parametrize("spec", list(WORLDS))
def test_train_state_placement_and_collectives(results, spec):
    """Each rank holds its blocks of the state (its resident bytes are the
    whole state's under the placement, and less than the whole where the
    mesh splits anything); a step's collectives are all-gathers (a layer,
    an expert or a small leaf of the params at a time, and the mask),
    reduce-scatters of fp32 gradients over ``data``, and
    all-reduces (gradients a leaf's ``data`` dim does not split, statistics,
    the norm, the expert-parallel exit and entry)."""
    from repro_torch.distributed import sharding

    d = _stand_in(spec).shape["data"]
    for name in CASES:
        _, state = initial_state(name)
        mesh = _stand_in(spec)
        want = _block_bytes(sharding.train_state_shardings(mesh, state), state, mesh)
        for _, info in results["ranks"][spec]:
            assert info[name]["resident_bytes"] == want < info[name]["whole_bytes"], name
            for recs in info[name]["collectives"]:
                assert {op for op, _, _, _ in recs} <= {"all_gather", "all_reduce",
                                                      "reduce_scatter"}
                for op, shape, dtype, n in recs:
                    if op == "reduce_scatter":
                        assert dtype == "torch.float32" and n == d, (name, shape)
                    if op == "all_gather":
                        assert dtype != "torch.float32" or CASES[name][1] == "float32"


@pytest.mark.parametrize("spec", list(WORLDS))
def test_every_gather_is_one_layer_one_expert_or_one_small_leaf(results, spec):
    """The step keeps the params as blocks and gathers only what is about
    to run: every all-gather of every step holds, with every rank's part,
    at most as many elements as the largest of one layer's slice of a
    stacked leaf, one DS expert's (N, d) rows and a non-stacked leaf other
    than the experts. Gathering the params whole would exceed it (the
    stacks hold 2 layers, the head 4 experts)."""
    from repro_torch.utils.tree import tree_leaves, tree_paths

    for name in CASES:
        _, state = initial_state(name)
        bound = 0
        for p, x in zip(tree_paths(state.params), tree_leaves(state.params)):
            per = x.numel()
            if p.split("/")[0] in ("layers", "enc_layers", "dec_layers") or p == "head/experts":
                per //= x.shape[0]
            bound = max(bound, per)
        for _, info in results["ranks"][spec]:
            for recs in info[name]["collectives"]:
                sizes = [n * int(np.prod(shape)) for op, shape, _, n in recs if op == "all_gather"]
                assert sizes and max(sizes) <= bound, (name, max(sizes), bound)


# ---------------------------------------------------------------------------
# The expert-parallel FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", list(EP_OF_WORLD))
def test_expert_parallel_ffn_equals_repro_off_mesh_moe_block(results, world):
    """``moe_block(..., mesh=1xM)`` at model 2 and 4 (each rank its E/M
    experts): the output, the aux loss, and the gradients of Σ y·dy + aux
    for x, the router and every expert (gathered from the model blocks)
    equal ``repro``'s off-mesh ``moe_block``'s on every rank."""
    spec = EP_OF_WORLD[world]
    want = results["off_mesh"]
    for arrays, info in results["ranks"][world]:
        assert info[f"ep/{spec}"]["expert_parallel"]
        ops = {op for op, _, _, _ in info[f"ep/{spec}"]["collectives"]}
        assert "all_reduce" in ops  # the exit forward, the entry backward
        for key, w in (("y", want["y"]), ("load", want["load"]),
                       *((f"grad/{k}", want[k]) for k in ("x", "router", "w_gate", "w_up",
                                                         "w_down"))):
            np.testing.assert_allclose(arrays[f"ep/{spec}/{key}"], w, rtol=1e-5,
                                       atol=1e-6 * max(1.0, float(np.abs(w).max())),
                                       err_msg=key)


@pytest.mark.parametrize("spec", ["1x2", "1x4"])
def test_repro_expert_parallel_ffn_against_its_off_mesh_block_and_the_port(results, spec):
    """``repro``'s own ``_moe_ep_shardmap`` (4 host devices, ``with mesh``)
    on the same fp32 inputs. Its region rounds each partial sum to bf16
    whatever the activation dtype (``repro/models/moe.py:103``; the port
    keeps the activation dtype, ROADMAP Queue 3), so it is held to its
    off-mesh ``moe_block`` and to the port's expert-parallel FFN within
    that rounding: the forward within (M + 1) bf16 ulps (2^-8) of the
    largest |y|, every gradient within 2^-7 of its leaf's largest."""
    got, want = results["xla"][f"ep/{spec}"], results["off_mesh"]
    n = int(spec.split("x")[1])
    world = next(w for w, s in EP_OF_WORLD.items() if s == spec)
    port = results["ranks"][world][0][0]
    for ref in (want["y"], port[f"ep/{spec}/y"]):
        assert np.abs(np.asarray(got["y"]) - ref).max() <= (n + 1) * 2.0 ** -8 * np.abs(ref).max()
    for k in ("x", "router", "w_gate", "w_up", "w_down"):
        for ref in (want[k], port[f"ep/{spec}/grad/{k}"]):
            assert np.abs(np.asarray(got[k]) - ref).max() <= 2.0 ** -7 * np.abs(ref).max(), k


@pytest.mark.parametrize("name", ["dense", "ds"])
def test_mesh_step_equals_repro_sharded_step(results, name):
    """``repro``'s jitted step at 2x2 (4 host devices), its state placed as
    ``launch/dryrun.py`` places a train cell (params and moments by
    ``param_shardings``, the step replicated, the mask ``P(None, 'model')``,
    the batch over data), against every rank of the port's mesh step at
    2x2 on the same state and batches: the gathered params, moments and
    mask after 3 steps and the loss, CE and grad norm at each step, under
    the fp32 tolerances of the module docstring (GSPMD and the port sum in
    other orders; these cases have no expert-parallel region)."""
    ref = results["xla"]["step/2x2/" + name]
    want_state, _, big = results["single"][name]
    want = {k: np.asarray(v, dtype=want_state[k].dtype) for k, v in ref["state"].items()}
    assert set(want) == set(want_state) - {"opt/step"}
    n_near = 0
    for arrays, info in results["ranks"]["2x2"]:
        got = {k: v for k, v in _case_arrays(arrays, name).items() if k != "opt/step"}
        n_near += _hold(got, want, ref["metrics"], info[name]["metrics"], big, name)
    assert n_near <= 4, n_near


def test_mesh_step_near_repro_sharded_step(results):
    """``repro``'s jitted step at 2x2 on the moe case, placed as above,
    against the port's mesh step at 2x2: the CE within rtol 1e-3 at each
    step (the two part by 5.7e-5 at most; one step moves the CE by about
    1%). Not a parity test of the state: ``repro``'s expert-parallel region
    rounds its fp32 partials to bf16 (ROADMAP Queue 3), so its moe step is
    not the port's. The port's moe mesh step is held to its single-device step
    above, which ``tests/test_torch_train.py`` holds to ``repro``'s off-mesh
    step, and its expert-parallel FFN to ``repro``'s off-mesh
    ``moe_block``."""
    ref = results["xla"]["step/2x2/moe"]
    _, info = results["ranks"]["2x2"][0]
    for m, w in zip(info["moe"]["metrics"], ref["metrics"]):
        np.testing.assert_allclose(m["ce"], w["ce"], rtol=1e-3)


# ---------------------------------------------------------------------------
# The training placement rules (repro's tests/test_distributed.py:15-40,
# :149-185, with stand-in meshes)
# ---------------------------------------------------------------------------

def test_param_pspec_rules():
    from repro_torch.distributed import sharding

    assert sharding.param_pspec("embed/table", 2) == ("model", "data")
    assert sharding.param_pspec("head/experts", 3) == (None, "model", "data")
    assert sharding.param_pspec("layers/attn/wq", 3) == (None, "data", "model")
    assert sharding.param_pspec("layers/mlp/w_down", 3) == (None, "model", "data")
    assert sharding.param_pspec("layers/moe/w_gate", 4) == (None, "model", "data", None)
    assert sharding.param_pspec("final_norm/scale", 1) == (None,)
    assert sharding.param_pspec("layers/ln1/scale", 2) == (None, None)


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    from repro.configs import get_config
    from repro.models import build as jbuild

    return jbuild(get_config(arch)).abstract_params()[0]


def test_all_big_params_are_sharded():
    """Every leaf over 4M elements of the full-size configs hits a rule
    that splits it (the shapes from ``repro``'s abstract params)."""
    from repro_torch.distributed import sharding
    from repro_torch.utils.tree import map_with_path

    bad = []
    for arch in ("deepseek-67b", "qwen3-moe-235b-a22b", "zamba2-7b", "whisper-base"):
        def check(path, x):
            if int(np.prod(x.shape)) > 4e6 and all(
                    s is None for s in sharding.param_pspec(path, len(x.shape))):
                bad.append((arch, path, x.shape))
        map_with_path(check, _abstract(arch))
    assert not bad, bad


MESH_SPECS = ("1x1", "2x1", "1x2", "2x4", "4x2", "8x1", "1x8", "2x2x2", "16x16")


@pytest.mark.parametrize("spec", MESH_SPECS)
def test_param_shardings_valid_for_every_config(spec):
    """``param_shardings`` over the full-size leaves of every config equals
    ``repro``'s placement (its ``_fitted_pspec``) on a stand-in mesh: a
    rule axis survives where the mesh has it wider than 1 and it divides
    the dim, else the dim is replicated."""
    from repro.configs import ARCHS
    from repro.distributed import sharding as jsh
    from repro.utils.tree import tree_paths
    from repro_torch.distributed import sharding
    from repro_torch.utils.tree import tree_leaves

    mesh = _stand_in(spec)
    for arch in ARCHS:
        params = _abstract(arch)
        got = sharding.param_shardings(mesh, params)
        leaves = dict(zip(tree_paths(params), __import__("jax").tree.leaves(params)))
        for path, s in zip(tree_paths(params), tree_leaves(got)):
            x = leaves[path]
            assert s == tuple(jsh._fitted_pspec(path, tuple(x.shape), mesh)), (arch, path)
            for dim, ax in zip(x.shape, s):
                n = 1
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    n *= mesh.shape.get(a, 1) if a else 1
                assert dim % n == 0, (arch, path, s)


def test_param_shardings_non_divisible_leaf_falls_back():
    """A 63-wide dim on a 2-way data axis replicates that dim while the
    divisible dims keep their rule."""
    from repro_torch.distributed import sharding

    odd = {"layers": {"attn": {"wq": torch.zeros(2, 63, 64)}}}
    for spec, want in (("2x4", (None, None, "model")), ("2x1", (None, None, None)),
                       ("1x4", (None, None, "model")), ("4x2", (None, None, "model"))):
        assert sharding.param_shardings(_stand_in(spec), odd)["layers"]["attn"]["wq"] == want
    even = {"layers": {"attn": {"wq": torch.zeros(2, 64, 64)}}}
    assert sharding.param_shardings(_stand_in("2x4"), even)["layers"]["attn"]["wq"] == (
        None, "data", "model")
    assert sharding.replicated(_stand_in("2x4")) == ()


@pytest.mark.parametrize("spec", ["2x2", "1x4", "4x1", "2x2x2"])
def test_train_state_shardings_place_as_the_dry_run(spec):
    """The step count replicated, both moments as the params, the DS mask
    ``(None, 'model')`` where the model axis divides its classes (as the
    experts' class axis), the whole placement total on the leaves."""
    from repro_torch.distributed import sharding

    mesh = _stand_in(spec)
    for name in ("moe", "ds"):
        _, state = initial_state(name)
        specs = sharding.train_state_shardings(mesh, state)
        p = sharding.param_shardings(mesh, state.params)
        assert specs.params == p and specs.opt.m == p and specs.opt.v == p
        assert specs.opt.step == ()
        N = state.ds_state.mask.shape[1]
        m = mesh.shape["model"]
        assert specs.ds_state.mask == (None, "model" if m > 1 and N % m == 0 else None)
        assert specs.ds_state.mask[1] == specs.params["head"]["experts"][1]


def test_gather_params_keeps_the_expert_stacks_model_block():
    """Only the MoE expert stacks stay model-local in the step's gathered
    tree (``model_local``); the router and everything else come whole."""
    from repro_torch.distributed import sharding

    assert sharding.model_local("layers/moe/w_gate") and sharding.model_local(
        "layers/moe/w_down")
    assert not sharding.model_local("layers/moe/router")
    assert not sharding.model_local("head/experts")


def test_mesh_step_refuses_a_missing_placement_and_an_uneven_batch():
    """A mesh step needs the state's placement; a batch must split into
    the microbatches times the batch ranks."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.train_step import make_train_step, rank_rows

    bundle, _ = initial_state("ds")
    with pytest.raises(ValueError, match="placement"):
        make_train_step(bundle, TrainConfig(), mesh=_stand_in("2x1"))
    with pytest.raises(ValueError, match="does not split"):
        rank_rows(torch.zeros(6, 3), _stand_in("2x1"), 0, 2)


if __name__ == "__main__":
    _worker(*sys.argv[1:])
