"""Port parity: the training path (``repro_torch.models.transformer.
train_loss``, ``train.train_step``, ``train.trainer``, ``checkpoint``,
``data``, ``launch.train``) against ``repro`` on the same seeded inputs,
and the Trainer's own guarantees (exact resume, mitosis, rotation, retry).

Models: ``reduce_config`` of qwen2-1.5b (QKV bias, GQA 4/2) and of
paper-ptb (no bias, MHA), vocab 128, weights JAX-initialized and carried
over by ``convert.train_state_from_jax``.

Tolerances, each stated where it is used:
* fp32 loss, metrics and gradients: rtol 1e-5, atol 1e-6 (sums in other
  orders; measured agreement ~1e-6 of each leaf's largest gradient).
* bf16 (the JAX side jitted with ``xla_allow_excess_precision=False``, so
  it rounds every bf16 intermediate where its program does, as the port
  does): loss and CE rtol 2^-8 (one bf16 ulp); gradients per leaf within
  2^-5 of the leaf's largest gradient, 8 bf16 ulps there: every
  activation and cotangent is rounded to bf16, both sides sum in their own
  orders, and two layers of backward compound those roundings.
* One Adam step (fp32): Adam's first step is ≈ lr·sign(g), so an element
  whose gradient is near zero may take any update in [-lr, lr] on either
  side; new params are held to rtol 1e-5 where |g| ≥ 1e-3·max|g| of the
  leaf and within 2·lr everywhere; masks equal.
* Multi-step runs against ``repro``: the CE curve within rtol 1e-3 (the
  near-zero-gradient elements above part by up to 2·lr per step).
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import DataPipeline as JDataPipeline
from repro.data import TopicLMStream as JTopicLMStream
from repro.models import build as jbuild
from repro.optim import adam_init as jadam_init
from repro.train import Trainer as JTrainer
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.checkpoint import AsyncSaver, CheckpointManager, load, save
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import flatten_paths, params_from_jax, train_state_from_jax
from repro_torch.core import dssoftmax as ds
from repro_torch.data import DataPipeline, TopicLMStream
from repro_torch.models import build
from repro_torch.train import Request, SamplingParams, ServeSession, Trainer
from repro_torch.train.train_step import TrainState, make_train_step, value_and_grad
from repro_torch.utils import flatten_dict

VOCAB = 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and with several
    test processes on the host torch's default thread pool (one thread per
    core in each process) makes each small op wait on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
F32 = dict(rtol=1e-5, atol=1e-6)
BF16_ULP = 2.0 ** -8


def _cfgs(arch, dtype="float32", **ds_kw):
    jcfg = jreduce_config(jget_config(arch), vocab=VOCAB).replace(dtype=dtype)
    tcfg = configs.reduce_config(configs.get_config(arch), vocab=VOCAB).replace(dtype=dtype)
    if ds_kw:
        jcfg = jcfg.replace(ds=jcfg.ds.replace(**ds_kw))
        tcfg = tcfg.replace(ds=tcfg.ds.replace(**ds_kw))
    return jcfg, tcfg


def _np_state(params, opt, ds_state):
    return flatten_paths(jax.tree.map(np.asarray, {"params": params, "opt": opt._asdict(),
                                                   "ds_state": ds_state._asdict()}))


@functools.lru_cache(maxsize=None)
def _models(arch, dtype, **ds_kw):
    jcfg, tcfg = _cfgs(arch, dtype, **dict(ds_kw))
    jb, tb = jbuild(jcfg), build(tcfg, device="cpu")
    params, st = jb.init(jax.random.PRNGKey(0))
    return jb, tb, params, st


def _tokens(seed=1, B=4, S=33):
    return np.random.RandomState(seed).randint(0, VOCAB, (B, S)).astype(np.int32)


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        a.astype(jnp.float32))


def _flat_f32(tree):
    return {k: _f32(v) for k, v in flatten_dict(tree).items()}


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "paper-ptb"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_value_and_grads_match_repro(arch, dtype):
    jb, tb, params, st = _models(arch, dtype)
    tokens = _tokens()
    f = jax.jit(jax.value_and_grad(lambda p, b: jb.train_loss(p, st, b), has_aux=True),
                compiler_options={"xla_allow_excess_precision": False})
    (jl, jm), jg = f(params, {"tokens": jnp.asarray(tokens)})
    ts = train_state_from_jax(_np_state(params, jadam_init(params), st), tb.cfg, device="cpu")
    (tl, tm), tg = value_and_grad(tb, ts.params, ts.ds_state, {"tokens": torch.from_numpy(tokens)})
    assert set(tm) == set(jm)
    tol = F32 if dtype == "float32" else dict(rtol=BF16_ULP, atol=0)
    np.testing.assert_allclose(float(tl), float(jl), **tol)
    for k in ("ce", "ds_lasso", "ds_expert_lasso", "ds_drop_frac", "head_aux_total"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **tol, err_msg=k)
    jgf, tgf = _flat_f32(jax.tree.map(np.asarray, jg)), _flat_f32(tg)
    assert set(tgf) == set(jgf)
    for k in jgf:
        if dtype == "float32":
            np.testing.assert_allclose(tgf[k], jgf[k], **F32, err_msg=k)
        else:
            bound = 2.0 ** -5 * np.abs(jgf[k]).max()
            assert np.abs(tgf[k] - jgf[k]).max() <= bound, k
    for k, v in flatten_dict(tg).items():  # grads keep the params' dtype
        assert v.dtype == flatten_dict(ts.params)[k].dtype, k


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "paper-ptb"])
def test_full_softmax_head_train_loss_matches_repro(arch):
    """The non-DS head (``head="full"``): qwen2-1.5b ties it to the
    embedding, paper-ptb has its own ``unembed``; S 32 runs the chunked CE
    (4 chunks under checkpoint). fp32 tolerances as above."""
    jcfg, tcfg = _cfgs(arch)
    jcfg, tcfg = jcfg.replace(head="full"), tcfg.replace(head="full")
    jb, tb = jbuild(jcfg), build(tcfg, device="cpu")
    params, _ = jb.init(jax.random.PRNGKey(2))
    tokens = _tokens(seed=3)
    f = jax.jit(jax.value_and_grad(lambda p, b: jb.train_loss(p, None, b), has_aux=True))
    (jl, jm), jg = f(params, {"tokens": jnp.asarray(tokens)})
    tparams, _ = params_from_jax(flatten_paths(jax.tree.map(np.asarray, params)), tcfg,
                                 device="cpu")
    (tl, tm), tg = value_and_grad(tb, tparams, None, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(tl), float(jl), **F32)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), **F32)
    jgf, tgf = _flat_f32(jax.tree.map(np.asarray, jg)), _flat_f32(tg)
    assert set(tgf) == set(jgf) and ("head/unembed" in tgf) == (arch == "paper-ptb")
    for k in jgf:
        np.testing.assert_allclose(tgf[k], jgf[k], **F32, err_msg=k)


@pytest.mark.parametrize("remat", ["layer", "dots"])
def test_remat_policies_change_nothing(remat):
    _, tb, params, st = _models("qwen2-1.5b", "float32")
    ts = train_state_from_jax(_np_state(params, jadam_init(params), st), tb.cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens())}
    (l0, _), g0 = value_and_grad(tb, ts.params, ts.ds_state, batch)
    tb2 = build(tb.cfg.replace(remat=remat), device="cpu")
    (l1, _), g1 = value_and_grad(tb2, ts.params, ts.ds_state, batch)
    assert float(l0) == float(l1)
    for k, v in flatten_dict(g0).items():
        torch.testing.assert_close(flatten_dict(g1)[k], v, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="remat"):
        value_and_grad(build(tb.cfg.replace(remat="bogus"), device="cpu"), ts.params,
                       ts.ds_state, batch)


def _check_step(jnew, tnew, jm, tm, grads, lr):
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **F32)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **F32)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), **F32)
    np.testing.assert_array_equal(tnew.ds_state.mask.numpy(), np.asarray(jnew.ds_state.mask))
    assert int(tnew.opt.step) == int(jnew.opt.step)
    jp, tp = _flat_f32(jax.tree.map(np.asarray, jnew.params)), _flat_f32(tnew.params)
    for k in jp:
        assert np.abs(tp[k] - jp[k]).max() <= 2 * lr + 1e-7, k
        g = np.abs(grads[k])
        big = g >= 1e-3 * g.max()
        np.testing.assert_allclose(tp[k][big], jp[k][big], rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_from_converted_state_matches_repro(microbatches):
    """One step from the same state: loss, grad norm, new params, and the
    new mask (gamma at the median row norm, so the step prunes)."""
    lr = 1e-3
    jb, tb, params, st = _models("qwen2-1.5b", "float32", gamma=1.0,
                                 lambda_lasso=1e-3, lambda_expert=1e-3)
    tokens = _tokens(B=4)
    jtc = JTrainConfig(lr=lr, microbatches=microbatches)
    tcfg = TrainConfig(lr=lr, microbatches=microbatches)
    jstate = JTrainState(params=params, opt=jadam_init(params), ds_state=st)
    jnew, jm = jax.jit(jmake_train_step(jb, jtc))(jstate, {"tokens": jnp.asarray(tokens)})
    ts = train_state_from_jax(_np_state(params, jstate.opt, st), tb.cfg, device="cpu")
    tnew, tm = make_train_step(tb, tcfg)(ts, {"tokens": torch.from_numpy(tokens)})
    # the gradient the step used: the mean over the microbatches
    grads = [_flat_f32(value_and_grad(tb, ts.params, ts.ds_state,
                                      {"tokens": torch.from_numpy(t)})[1])
             for t in np.split(tokens, microbatches)]
    _check_step(jnew, tnew, jm, tm, {k: sum(g[k] for g in grads) / microbatches
                                     for k in grads[0]}, lr)
    pruned = ts.ds_state.mask & ~tnew.ds_state.mask
    assert int(pruned.sum()) > 0
    # the step is functional: the state it was given is untouched
    again = train_state_from_jax(_np_state(params, jstate.opt, st), tb.cfg, device="cpu")
    for k, v in flatten_dict(ts).items():
        assert torch.equal(v, flatten_dict(again)[k]), k


def test_microbatch_equivalence():
    """Grads averaged over 2 microbatches update the params as the whole
    batch does (CE is a per-token mean; the rows dispatch on their own)."""
    _, tb, params, st = _models("qwen2-1.5b", "float32")
    ts = train_state_from_jax(_np_state(params, jadam_init(params), st), tb.cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(B=4))}
    out = {}
    for micro in (1, 2):
        step = make_train_step(tb, TrainConfig(lr=1e-3, microbatches=micro, grad_clip=1e9))
        new, m = step(ts, batch)
        out[micro] = new.params["layers"]["attn"]["wq"]
    torch.testing.assert_close(out[1], out[2], rtol=0.2, atol=1e-2)


def test_topic_stream_bit_equal_and_pipeline():
    for kw in (dict(vocab=128, seq_len=32, batch=8, seed=0),
               dict(vocab=5000, seq_len=17, batch=3, seed=7, n_topics=5)):
        j, t = JTopicLMStream(**kw), TopicLMStream(**kw)
        for step in (0, 1, 13):
            a, b = t.batch_at(step), j.batch_at(step)
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    stream = TopicLMStream(vocab=64, seq_len=8, batch=4)
    pipes = [DataPipeline(lambda i: {"tokens": stream.batch_at(i)}, process_index=r,
                          process_count=2) for r in range(2)]
    jpipe = JDataPipeline(lambda i: {"tokens": stream.batch_at(i)}, process_index=1,
                          process_count=2)
    halves = [p.next()["tokens"] for p in pipes]
    np.testing.assert_array_equal(np.concatenate(halves), stream.batch_at(0))
    np.testing.assert_array_equal(halves[1], jpipe.next()["tokens"])
    assert pipes[0].snapshot() == jpipe.snapshot() == {"step": 1, "seed": 0}
    pipes[0].restore({"step": 5, "seed": 0})
    np.testing.assert_array_equal(pipes[0].next()["tokens"], stream.batch_at(5)[:2])


def _tiny(tmp_path, steps, ckpt_every, torch_side=True, **tkw):
    """The Trainer setup of ``tests/test_trainer.py`` on either package."""
    ds_kw = dict(num_experts=4, lambda_lasso=1e-4, lambda_expert=1e-4, lambda_load=1e-2)
    jcfg, tcfg = _cfgs("qwen2-1.5b", **ds_kw)
    if torch_side:
        bundle, Pipe, Cfg = build(tcfg, device="cpu"), DataPipeline, TrainConfig
    else:
        bundle, Pipe, Cfg = jbuild(jcfg), JDataPipeline, JTrainConfig
    stream = TopicLMStream(vocab=VOCAB, seq_len=32, batch=8, seed=0)
    pipe = Pipe(lambda i: {"tokens": stream.batch_at(i)}, process_index=0, process_count=1)
    tc = Cfg(lr=1e-3, total_steps=steps, warmup_steps=5, ckpt_dir=str(tmp_path),
             ckpt_every=ckpt_every, keep_ckpts=2, **tkw)
    return bundle, pipe, tc


def test_trainer_loss_curve_matches_repro(tmp_path):
    """Both Trainers from the same initial state over 6 steps: the CE curve
    within rtol 1e-3, and the port's loss falls."""
    jb, jpipe, jtc = _tiny(tmp_path / "j", 6, 100, torch_side=False)
    jtr = JTrainer(jb, jtc, iter(jpipe), pipeline=jpipe)
    jstate0 = jtr.init_state(0)
    tb, tpipe, tc = _tiny(tmp_path / "t", 6, 100)
    ttr = Trainer(tb, tc, iter(tpipe), pipeline=tpipe)
    tstate0 = train_state_from_jax(_np_state(*jstate0), tb.cfg, device="cpu")
    jtr.train(state=jstate0)
    ttr.train(state=tstate0)
    jce = [m["ce"] for m in jtr.metrics_history]
    tce = [m["ce"] for m in ttr.metrics_history]
    np.testing.assert_allclose(tce, jce, rtol=1e-3)
    assert tce[-1] < tce[0]


def test_trainer_matches_repro_under_the_lm_100m_preset(tmp_path):
    """The DS settings and schedule of the lm-100m preset
    (examples/train_lm_dssoftmax.py: λ_lasso = λ_expert 1e-5, the default
    λ_load 10, prune threshold 6.0, K 8; lr 1e-3, warm-up 20, cosine over
    the run; batch 8 × 64 tokens) at reduced width (2 layers, d 64, V 512,
    fp32), both Trainers from the same state over 24 steps without
    mitosis (its gate noise comes from each package's own generator).
    Per step: CE, the load term and the total loss within rtol 1e-5
    (measured ≤ 1e-6), the share of tokens over capacity equal (a count
    of the same top-1 dispatch)."""
    from repro.configs.base import DSSoftmaxConfig as JDSConfig
    from repro.configs.base import ModelConfig as JModelConfig
    from repro_torch.configs.base import DSSoftmaxConfig, ModelConfig

    V, steps = 512, 24
    kw = dict(name="lm-100m-reduced", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=V, remat="none",
              dtype="float32", head="ds")
    ds_kw = dict(num_experts=8, lambda_lasso=1e-5, lambda_expert=1e-5,
                 prune_task_loss_threshold=6.0)
    trainers = []
    for side in ("j", "t"):
        if side == "j":
            bundle = jbuild(JModelConfig(**kw, ds=JDSConfig(**ds_kw)))
            Pipe, Cfg, Stream, T = JDataPipeline, JTrainConfig, JTopicLMStream, JTrainer
        else:
            bundle = build(ModelConfig(**kw, ds=DSSoftmaxConfig(**ds_kw)), device="cpu")
            Pipe, Cfg, Stream, T = DataPipeline, TrainConfig, TopicLMStream, Trainer
        stream = Stream(vocab=V, seq_len=64, batch=8, seed=0)
        pipe = Pipe(lambda i, st=stream: {"tokens": st.batch_at(i)}, process_index=0,
                    process_count=1)
        tc = Cfg(lr=1e-3, total_steps=steps, warmup_steps=20, ckpt_dir=str(tmp_path / side),
                 ckpt_every=1000, keep_ckpts=1)
        trainers.append(T(bundle, tc, iter(pipe), pipeline=pipe))
    jtr, ttr = trainers
    jstate0 = jtr.init_state(0)
    tstate0 = train_state_from_jax(_np_state(*jstate0), ttr.bundle.cfg, device="cpu")
    jtr.train(state=jstate0)  # donates jstate0
    ttr.train(state=tstate0)
    jh, th = jtr.metrics_history, ttr.metrics_history
    assert len(jh) == len(th) == steps
    for k in ("ce", "ds_load", "loss"):
        np.testing.assert_allclose([m[k] for m in th], [m[k] for m in jh], rtol=1e-5,
                                   err_msg=k)
    assert [m["ds_drop_frac"] for m in th] == [m["ds_drop_frac"] for m in jh]


def test_trainer_loss_falls_and_rotates(tmp_path):
    tb, pipe, tc = _tiny(tmp_path, 30, 10)
    tr = Trainer(tb, tc, iter(pipe), pipeline=pipe)
    tr.train()
    ce = [m["ce"] for m in tr.metrics_history]
    assert ce[-1] < ce[0] and all(np.isfinite(ce))
    assert tr.mgr.latest() == 30 and tr.mgr.all_steps() == [20, 30]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert {"loss", "ce", "grad_norm", "ds_lasso", "ds_load", "dt", "step"} <= set(
        tr.metrics_history[0])


def _same_state(a: TrainState, b: TrainState):
    fa, fb = flatten_dict(a), flatten_dict(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("mitosis_at", [None, 3])
def test_trainer_exact_resume(tmp_path, mitosis_at):
    """0→10 uninterrupted against 0→5, then a new Trainer (a fresh K-4
    bundle) that auto-resumes at 5 and runs to 10: bit-identical state on
    the CPU, the pipeline resumed at batch 5; with mitosis at step 3 the
    resumed Trainer rebuilds its bundle for 8 experts."""
    ms = {mitosis_at: 8} if mitosis_at else None
    tb, pipe, tc = _tiny(tmp_path / "a", 10, 5)
    full = Trainer(tb, tc, iter(pipe), pipeline=pipe, mitosis_steps=ms).train()

    tb, pipe, tc = _tiny(tmp_path / "b", 10, 5)
    Trainer(tb, tc, iter(pipe), pipeline=pipe, mitosis_steps=ms).train(steps=5)
    tb2, pipe2, tc2 = _tiny(tmp_path / "b", 10, 5)
    tr2 = Trainer(tb2, tc2, iter(pipe2), pipeline=pipe2, mitosis_steps=ms)
    resumed = tr2.train(steps=10)
    assert tr2.metrics_history[0]["step"] == 5 and pipe2.state.step == 10
    _same_state(resumed, full)
    if mitosis_at:
        assert tr2.cfg.ds.num_experts == 8 == resumed.params["head"]["gate"].shape[0]


def test_trainer_mitosis(tmp_path):
    tb, pipe, tc = _tiny(tmp_path, 8, 100)
    seen = {}
    tr = Trainer(tb, tc, iter(pipe), pipeline=pipe, mitosis_steps={4: 8},
                 hooks={"on_step": lambda s, m, st: seen.setdefault(s, st)})
    state = tr.train(steps=8)
    before, after = seen[3], tr._apply_mitosis(seen[3])
    K = before.params["head"]["gate"].shape[0]
    assert K == 4 and after.params["head"]["gate"].shape[0] == 8
    assert tr.bundle.cfg.ds.num_experts == 8
    m = before.ds_state.mask
    assert torch.equal(after.ds_state.mask, torch.cat([m, m]))
    e = before.params["head"]["experts"]
    assert torch.equal(after.params["head"]["experts"], torch.cat([e, e]))
    g, g2 = before.params["head"]["gate"], after.params["head"]["gate"]
    # one fp32 rounding of each offspring gate (rtol 2^-23 of the largest)
    torch.testing.assert_close(g2[:K] + g2[K:], 2 * g, rtol=0,
                               atol=4 * 2.0 ** -23 * float(g.abs().max()))
    # every moment starts afresh (repro's adam_init), the step is kept
    assert int(after.opt.step) == int(before.opt.step)
    assert all(float(v.abs().sum()) == 0 for v in flatten_dict(after.opt.m).values())
    assert all(float(v.abs().sum()) == 0 for v in flatten_dict(after.opt.v).values())
    assert state.params["head"]["gate"].shape[0] == 8
    assert np.isfinite([r["loss"] for r in tr.metrics_history]).all()


def test_apply_mitosis_matches_repro(tmp_path):
    """Both Trainers' ``_apply_mitosis`` on the same state (repro's after 3
    steps, converted): the experts, mask, step and every moment equal,
    both K 8 bundles. The gate noise comes from each package's own
    generator, so the gates are held to the sum rule (offspring sum to
    2·gate, one fp32 rounding each) and to the noise scale of
    ``clone_experts``' default (1e-2·std(gate); N(0, 1) draws over 256
    entries stay within 6σ)."""
    jb, jpipe, jtc = _tiny(tmp_path / "j", 3, 100, torch_side=False)
    jtr = JTrainer(jb, jtc, iter(jpipe), pipeline=jpipe)
    jstate = jtr.train(state=jtr.init_state(0))
    tb, tpipe, tc = _tiny(tmp_path / "t", 3, 100)
    ttr = Trainer(tb, tc, iter(tpipe), pipeline=tpipe)
    tstate = train_state_from_jax(_np_state(*jstate), tb.cfg, device="cpu")
    jafter, tafter = jtr._apply_mitosis(jstate), ttr._apply_mitosis(tstate)
    assert jtr.cfg.ds.num_experts == ttr.cfg.ds.num_experts == 8
    assert ttr.bundle.cfg.ds.num_experts == 8
    jf = flatten_paths(jax.tree.map(np.asarray, {"opt": jafter.opt._asdict(),
                                                 "ds_state": jafter.ds_state._asdict(),
                                                 "params": jafter.params}))
    tf = {k: v.numpy() for k, v in flatten_dict({"opt": tafter.opt, "ds_state": tafter.ds_state,
                                                 "params": tafter.params}).items()}
    assert set(tf) == set(jf)
    for k in jf:
        if k != "params/head/gate":
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
    assert int(jf["opt/step"]) == 3 and not any(
        np.any(jf[k]) for k in jf if k.startswith(("opt/m/", "opt/v/")))
    g = np.asarray(jstate.params["head"]["gate"])
    bound = 6 * 1e-2 * g.std()
    for g2 in (tf["params/head/gate"], jf["params/head/gate"]):
        np.testing.assert_allclose(g2[:4] + g2[4:], 2 * g, rtol=0,
                                   atol=4 * 2.0 ** -23 * np.abs(g).max())
        assert 0 < np.abs(g2[:4] - g).max() <= bound


@pytest.mark.parametrize("where", ["after_step", "in_loss"])
def test_trainer_retry_ends_where_an_uninterrupted_run_does(tmp_path, where):
    """A step that fails once — after the whole update, or inside the loss
    — is retried from the state it was given, and the run ends bit-equal
    to one that never failed."""
    tb, pipe, tc = _tiny(tmp_path / "a", 6, 100)
    clean = Trainer(tb, tc, iter(pipe), pipeline=pipe).train()

    tb, pipe, tc = _tiny(tmp_path / "b", 6, 100)
    tr = Trainer(tb, tc, iter(pipe), pipeline=pipe)
    fails = {"left": 1, "calls": 0}
    if where == "after_step":
        orig = tr._compile

        def compile_with_fault():
            orig()
            step = tr._step_fn

            def faulty(state, batch):
                out = step(state, batch)
                fails["calls"] += 1
                if fails["calls"] == 3 and fails["left"]:
                    fails["left"] -= 1
                    raise RuntimeError("injected failure after the update")
                return out

            tr._step_fn = faulty

        tr._compile = compile_with_fault
    else:
        loss = tb.train_loss

        def faulty_loss(p, s, b, **kw):
            out = loss(p, s, b, **kw)
            fails["calls"] += 1
            if fails["calls"] == 3 and fails["left"]:
                fails["left"] -= 1
                raise RuntimeError("injected failure in the loss")
            return out

        object.__setattr__(tb, "train_loss", faulty_loss)
    state = tr.train()
    assert fails["left"] == 0
    _same_state(state, clean)


def test_trainer_gives_up_after_max_retries(tmp_path):
    tb, pipe, tc = _tiny(tmp_path, 4, 100)
    tr = Trainer(tb, tc, iter(pipe), pipeline=pipe, max_retries=1)

    def broken(p, s, b, **kw):
        raise RuntimeError("always fails")

    object.__setattr__(tb, "train_loss", broken)
    with pytest.raises(RuntimeError, match="always fails"):
        tr.train()
    assert tr.mgr.latest() == 0  # the last good state is checkpointed


def test_checkpoint_round_trip_bf16_and_async_copy(tmp_path):
    rng = np.random.RandomState(0)
    tree = {"a": {"w": torch.from_numpy(rng.randn(4, 5).astype(np.float32)).to(torch.bfloat16),
                  "m": torch.from_numpy(rng.rand(3) < 0.5)},
            "step": torch.tensor(7, dtype=torch.int32),
            "s": ds.DSState(mask=torch.ones(2, 3, dtype=torch.bool))}
    save(str(tmp_path / "c"), tree, meta={"x": 1})
    back, meta = load(str(tmp_path / "c"), like=tree)
    assert meta == {"x": 1}
    for k, v in flatten_dict(tree).items():
        got = flatten_dict(back)[k]
        assert got.dtype == v.dtype and torch.equal(got, v), k
    assert isinstance(back["s"], ds.DSState)
    flat, _ = load(str(tmp_path / "c"))
    assert torch.equal(flat["a"]["w"], tree["a"]["w"])
    assert json.load(open(tmp_path / "c" / "dtypes.json")) == {"a/w": "bfloat16"}
    # the async saver copies before it returns: a change after submit is
    # not in the checkpoint
    saver = AsyncSaver()
    want = tree["a"]["w"].clone()
    saver.submit(str(tmp_path / "d"), tree)
    tree["a"]["w"].add_(1.0)
    saver.wait()
    back, _ = load(str(tmp_path / "d"), like=tree)
    assert torch.equal(back["a"]["w"], want)
    # the manager's save returns before its write is done; each save
    # joins the write before it, and wait() the last one
    mgr = CheckpointManager(str(tmp_path / "m"), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, tree)
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest() == 3


def test_manager_save_returns_before_its_write(tmp_path, monkeypatch):
    """``CheckpointManager.save`` returns while its write is still running
    (held here on an event); the rotation runs after the write, and
    ``wait`` joins it."""
    import threading

    from repro_torch.checkpoint import checkpointer

    gate, real_save = threading.Event(), checkpointer.save

    def held_save(path, tree, *, meta=None):
        assert gate.wait(30)
        real_save(path, tree, meta=meta)

    tree = {"w": torch.arange(6, dtype=torch.float32)}
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, tree)
    mgr.wait()
    monkeypatch.setattr(checkpointer, "save", held_save)
    mgr.save(2, tree)
    assert mgr.all_steps() == [1]  # the write of step 2 has not finished
    gate.set()
    mgr.wait()
    assert mgr.all_steps() == [2]


def test_trained_table_serves_on_the_cpu(tmp_path):
    """Train, pack the trained head, serve: 'jnp' and 'cuda_grouped' (its
    plain version here) stream the same greedy tokens."""
    tb, pipe, tc = _tiny(tmp_path, 6, 100)
    tr = Trainer(tb, tc, iter(pipe), pipeline=pipe, mitosis_steps={3: 8})
    state = tr.train()
    table = ds.pack_experts(state.params["head"], state.ds_state)
    assert table.ids.shape[0] == 8
    streams = {}
    for kern in ("jnp", "cuda_grouped", "cuda_fused"):
        sess = ServeSession(tr.bundle, state.params, table, n_slots=2, max_seq_len=16,
                            kernel=kern, device="cpu")
        reqs = [Request(prompt=np.arange(5, dtype=np.int32),
                        sampling=SamplingParams(max_new_tokens=4)),
                Request(prompt=np.arange(3, dtype=np.int32) + 7,
                        sampling=SamplingParams(max_new_tokens=4))]
        sess.run(reqs)
        streams[kern] = [list(r.out_tokens) for r in reqs]
        assert all(len(s) == 4 and all(0 <= t < VOCAB for t in s) for s in streams[kern])
    assert streams["jnp"] == streams["cuda_grouped"] == streams["cuda_fused"]


def test_launch_train_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    tr = launch_train.main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                            "--steps", "3", "--batch", "2", "--seq", "16",
                            "--ckpt-dir", str(tmp_path)])
    assert len(tr.metrics_history) == 3 and tr.mgr.latest() == 3
    assert "step 0 loss=" in capsys.readouterr().out
    tr = launch_train.main(["--arch", "whisper-base", "--reduced", "--device", "cpu",
                            "--steps", "2", "--batch", "2", "--seq", "8",
                            "--ckpt-dir", str(tmp_path / "whisper")])
    assert len(tr.metrics_history) == 2 and tr.bundle.cfg.family == "encdec"
    with pytest.raises(KeyError, match="unknown arch"):
        launch_train.main(["--arch", "whisper-tiny", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path)])


def test_train_state_from_jax_checks():
    _, tb, params, st = _models("paper-ptb", "float32")
    np_state = _np_state(params, jadam_init(params), st)
    ts = train_state_from_jax(np_state, tb.cfg, device="cpu")
    assert ts.opt.step.dtype == torch.int32 and int(ts.opt.step) == 0
    assert set(flatten_dict(ts.opt.m)) == set(flatten_dict(ts.params))
    bad = dict(np_state)
    bad.pop("opt/v/head/gate")
    with pytest.raises(KeyError, match="opt/v"):
        train_state_from_jax(bad, tb.cfg, device="cpu")


WRAPPER_ARGS = {
    "gate_top1": lambda: (torch.randn(4, 8), torch.randn(2, 8)),
    "dss_topk_grouped": lambda: (torch.randn(4, 16, 8), torch.zeros(4, 16, dtype=torch.int32),
                                 torch.randn(4, 2, 8), torch.ones(4, 2), 2),
    "dss_topk_fused": lambda: (torch.randn(4, 8), torch.randn(4, 16, 8),
                               torch.zeros(4, 16, dtype=torch.int32), torch.randn(2, 8), 2),
    "dss_topk_kernel": lambda: (torch.randn(4, 16, 8), torch.zeros(4, 16, dtype=torch.int32),
                                torch.randn(2, 8), torch.zeros(2, dtype=torch.int32), 2),
    "lasso_prune": lambda: (torch.randn(4, 16, 8), torch.ones(4, 16, dtype=torch.bool), 0.5),
    "flash_attention": lambda: (torch.randn(1, 4, 8, 16), torch.randn(1, 2, 8, 16),
                                torch.randn(1, 2, 8, 16)),
}


@pytest.mark.parametrize("name", sorted(WRAPPER_ARGS))
def test_kernel_wrappers_raise_on_inputs_that_require_grad(name):
    """A forward-only kernel never hands autograd a result without a
    gradient: with grad mode on and a float input that requires grad, the
    wrapper raises (here on CPU tensors; the GPU tests do it on the card);
    under ``torch.no_grad()`` the same call runs."""
    from repro_torch.kernels import ops

    fn = getattr(ops, name)
    args = WRAPPER_ARGS[name]()
    fn(*args, device="cpu")
    req = [a.requires_grad_(True) if torch.is_tensor(a) and a.is_floating_point() else a
           for a in args]
    with pytest.raises(RuntimeError, match="forward-only"):
        fn(*req, device="cpu")
    with torch.no_grad():
        fn(*req, device="cpu")


def test_train_attention_is_the_differentiable_one(monkeypatch):
    """``attention_block(train=True)`` takes ``full_attention`` at S ≤
    attn_q_chunk and ``chunked_causal_attention`` above, as ``repro``
    trains, and never the kernel wrapper."""
    from repro_torch.models import layers

    calls = []
    for name in ("full_attention", "chunked_causal_attention", "flash_attention"):
        orig = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n), _o(*a, **k))[1])
    _, tb, params, st = _models("qwen2-1.5b", "float32")
    ts = train_state_from_jax(_np_state(params, jadam_init(params), st), tb.cfg, device="cpu")
    lp = {k: v[0] for k, v in ts.params["layers"]["attn"].items()}
    cfg = tb.cfg.replace(attn_q_chunk=8, attn_kv_chunk=8)
    for S, want in ((8, "full_attention"), (16, "chunked_causal_attention")):
        calls.clear()
        x = torch.randn(2, S, cfg.d_model, requires_grad=True)
        out, _ = layers.attention_block(lp, cfg, x, torch.arange(S).expand(2, S), train=True)
        out.sum().backward()
        assert calls == [want] and x.grad is not None and x.grad.abs().sum() > 0


def test_train_entry_points_default_to_cuda(tmp_path):
    """Without ``device="cpu"`` the training entry points ask for CUDA and
    raise on a host without it."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the cuda device is reachable here")
    from repro_torch.launch import train as launch_train

    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "1",
                           "--ckpt-dir", str(tmp_path)])
    _, tb, params, st = _models("paper-ptb", "float32")
    with pytest.raises(RuntimeError, match="cuda"):
        train_state_from_jax(_np_state(params, jadam_init(params), st), tb.cfg)
