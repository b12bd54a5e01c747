"""Port parity: the paper's accounting periphery against ``repro``:
``core/metrics`` (numpy, equal), ``core/analysis`` over the port's
``DSState`` (equal), ``core/baselines`` (plain PyTorch against ``jnp``:
ids equal, values within rtol/atol 1e-5; the SVD baseline's within 1e-4,
its U·S within 1e-4 of the largest singular value, column signs aside:
two SVD routines round differently), ``utils/timing``, the
hierarchy, translation and classification sets of ``data/synthetic``
(bit-equal), ``configs/shapes`` with ``ARCHS``, ``arch_shapes`` and
``dryrun_cells``, and ``model_zoo``'s ``input_specs``,
``serve_table_spec``, ``count_params_analytic`` and
``head_flops_per_token`` for every arch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import analysis as janalysis
from repro.core import baselines as jbl
from repro.core import metrics as jmetrics
from repro.core.dssoftmax import DSState as JDSState
from repro.data import synthetic as jsyn
from repro.models import model_zoo as jzoo
from repro.utils import timing as jtiming
from repro_torch import configs
from repro_torch.core import analysis, metrics
from repro_torch.core import baselines as bl
from repro_torch.core.dssoftmax import DSState
from repro_torch.data import synthetic as syn
from repro_torch.models import model_zoo
from repro_torch.utils import timing

ALL_ARCHS = configs.ARCHS + ("paper-ptb", "paper-wiki2", "paper-envi", "paper-casia")
TOL = dict(rtol=1e-5, atol=1e-5)


def _mask(seed, K=6, N=50, p=0.3):
    rng = np.random.RandomState(seed)
    m = rng.rand(K, N) < p
    m[rng.randint(0, K, N), np.arange(N)] = True
    return m


# ---------------------------------------------------------------------------
# core/metrics and core/analysis
# ---------------------------------------------------------------------------

def test_metrics_equal_repro():
    rng = np.random.RandomState(0)
    choices = rng.randint(0, 8, 500)
    sizes = rng.randint(100, 900, 8)
    np.testing.assert_array_equal(metrics.utilization(choices, 8),
                                  jmetrics.utilization(choices, 8))
    np.testing.assert_array_equal(metrics.utilization(choices[:0], 8),
                                  jmetrics.utilization(choices[:0], 8))
    util = metrics.utilization(choices, 8)
    assert metrics.paper_speedup(7709, sizes, util) == jmetrics.paper_speedup(7709, sizes, util)
    assert metrics.padded_speedup(7709, 1024, 8) == jmetrics.padded_speedup(7709, 1024, 8)
    assert metrics.softmax_flops(51865, 512, 8) == jmetrics.softmax_flops(51865, 512, 8)
    assert metrics.ds_flops(sizes, util, 512, 8, 4) == jmetrics.ds_flops(sizes, util, 512, 8, 4)


@pytest.mark.parametrize("seed", [0, 1])
def test_analysis_equals_repro(seed):
    m = _mask(seed)
    mine, ref = DSState(mask=torch.from_numpy(m)), JDSState(mask=jnp.asarray(m))
    np.testing.assert_array_equal(analysis.expert_sizes(mine), janalysis.expert_sizes(ref))
    assert analysis.redundancy_histogram(mine) == janalysis.redundancy_histogram(ref)
    np.testing.assert_array_equal(analysis.overlap_matrix(mine), janalysis.overlap_matrix(ref))
    for e in range(m.shape[0]):
        np.testing.assert_array_equal(analysis.exclusive_classes(mine, e),
                                      janalysis.exclusive_classes(ref, e))
    choices = np.random.RandomState(seed + 7).randint(0, m.shape[0], 300)
    for kw in ({}, dict(vocab=45, v_pad=128)):
        got, want = analysis.speedup_report(mine, choices, **kw), \
            janalysis.speedup_report(ref, choices, **kw)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), key)


def test_analysis_reads_the_repro_test_masks():
    """``tests/test_analysis.py``'s hand-made cases, on the port."""
    st = DSState(mask=torch.tensor([[1, 1, 0, 0], [0, 1, 1, 0], [0, 0, 0, 1]], dtype=torch.bool))
    assert analysis.redundancy_histogram(st) == {1: 3, 2: 1}
    assert np.isclose(analysis.overlap_matrix(st)[0, 1], 1 / 3)
    mask = torch.ones(4, 100, dtype=torch.bool)
    mask[:, 50:] = False
    rep = analysis.speedup_report(DSState(mask=mask), np.repeat(np.arange(4), 25), v_pad=64)
    assert np.isclose(rep["paper_speedup"], 100 / 54) and rep["util_cv"] < 1e-9
    assert np.isclose(rep["padded_speedup"], 100 / 68)


# ---------------------------------------------------------------------------
# core/baselines
# ---------------------------------------------------------------------------

def _wh(N=300, d=32, B=5, seed=0):
    rng = np.random.RandomState(seed)
    return rng.normal(size=(N, d)).astype(np.float32), rng.normal(size=(B, d)).astype(np.float32)


def test_full_topk_equals_repro():
    w, h = _wh()
    jv, ji = jbl.full_topk(jnp.asarray(w), jnp.asarray(h), 7)
    tv, ti = bl.full_topk(torch.from_numpy(w), torch.from_numpy(h), 7)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    # ties go to the lowest index, as jax.lax.top_k
    w2 = np.repeat(w[:3], 2, axis=0)
    jv, ji = jbl.full_topk(jnp.asarray(w2), jnp.asarray(h), 4)
    tv, ti = bl.full_topk(torch.from_numpy(w2), torch.from_numpy(h), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert bl.full_flops(300, 32, 5) == jbl.full_flops(300, 32, 5)


@pytest.mark.parametrize("window,n_top", [(32, 300), (8, 40), (16, 100)])
def test_svd_softmax_equals_repro(window, n_top):
    w, h = _wh(seed=1)
    jm = jbl.svd_build(jnp.asarray(w), window, n_top)
    tm = bl.svd_build(torch.from_numpy(w), window, n_top)
    assert (tm.window, tm.n_top) == (jm.window, jm.n_top)
    assert tuple(tm.b_tilde.shape) == jm.b_tilde.shape and tuple(tm.v_t.shape) == jm.v_t.shape
    # U·S and V are unique up to a sign a column, which the preview and
    # refine products do not see; two SVD routines agree on them to ~1e-4
    # of the largest singular value (fp32 roundings times the condition)
    s_max = float(np.abs(np.asarray(jm.b_tilde)).max())
    np.testing.assert_allclose(np.abs(tm.b_tilde.numpy()), np.abs(np.asarray(jm.b_tilde)),
                               rtol=0, atol=1e-4 * s_max)
    jv, ji = jbl.svd_topk(jm, jnp.asarray(h), 5)
    tv, ti = bl.svd_topk(tm, torch.from_numpy(h), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)
    if window == 32 and n_top == 300:  # the whole width and every row: exact
        fv, fi = bl.full_topk(torch.from_numpy(w), torch.from_numpy(h), 5)
        np.testing.assert_array_equal(ti.numpy(), fi.numpy())
    assert bl.svd_flops(300, 32, window, n_top, 4) == jbl.svd_flops(300, 32, window, n_top, 4)


def test_dsoftmax_equals_repro():
    fractions, dims = [0.25, 0.25, 0.5], [64, 32, 16]
    jm = jbl.dsoftmax_build(jax.random.PRNGKey(0), n=1000, d=64, fractions=fractions, dims=dims)
    tm = bl.dsoftmax_build(torch.Generator().manual_seed(0), n=1000, d=64, fractions=fractions,
                           dims=dims, device="cpu")
    assert (tm.sizes, tm.dims) == (jm.sizes, jm.dims) and sum(tm.sizes) == 1000
    assert [tuple(b.shape) for b in tm.blocks] == [b.shape for b in jm.blocks]
    assert all(b.dtype == torch.float32 for b in tm.blocks)
    # the same blocks give the same logits and top-k
    same = bl.DSoftmax(blocks=tuple(torch.from_numpy(np.array(b)) for b in jm.blocks),
                       sizes=jm.sizes, dims=jm.dims)
    h = np.random.RandomState(2).normal(size=(4, 64)).astype(np.float32)
    np.testing.assert_allclose(bl.dsoftmax_logits(same, torch.from_numpy(h)).numpy(),
                               np.asarray(jbl.dsoftmax_logits(jm, jnp.asarray(h))), **TOL)
    jv, ji = jbl.dsoftmax_topk(jm, jnp.asarray(h), 5)
    tv, ti = bl.dsoftmax_topk(same, torch.from_numpy(h), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    assert bl.dsoftmax_flops(tm, 3) == jbl.dsoftmax_flops(jm, 3) < bl.full_flops(1000, 64, 3)


def test_dsoftmax_build_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the cuda device is reachable here")
    with pytest.raises(RuntimeError, match="cuda"):
        bl.dsoftmax_build(torch.Generator(), 10, 8, [0.5, 0.5], [8, 4])


# ---------------------------------------------------------------------------
# utils/timing
# ---------------------------------------------------------------------------

def test_bench_and_timer_behave_as_repros():
    """The same number of calls (warm-up, then timed), the median of the
    timed calls, in seconds; ``Timer`` times its block."""
    for mod in (timing, jtiming):
        calls = []

        def fn(x):
            calls.append(x)
            return {"out": (torch.ones(3) if mod is timing else jnp.ones(3)) * x}

        s = mod.bench(fn, 2.0, warmup=3, iters=5)
        assert len(calls) == 8 and 0.0 <= s < 1.0
        with mod.Timer("t") as t:
            sum(range(1000))
        assert t.name == "t" and t.elapsed > 0.0


def test_bench_waits_only_on_cuda_outputs():
    out = {"a": (torch.ones(2), [torch.zeros(1)]), "b": 3}
    assert timing._cuda_devices(out, set()) == set()


# ---------------------------------------------------------------------------
# data/synthetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(n_super=3, n_sub_per_super=4, n_per_sub=7, dim=5,
                                         d=2.0, seed=3)])
def test_hierarchy_dataset_equals_repros(kw):
    got, want = syn.hierarchy_dataset(**kw), jsyn.hierarchy_dataset(**kw)
    assert type(got).__name__ == "HierarchyData" and got._fields == want._fields
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kw", [{}, dict(vocab=96, seq_len=7, batch=3, step=5, seed=2)])
def test_translation_and_classification_sets_equal_repros(kw):
    for a, b in zip(syn.translation_dataset(**kw), jsyn.translation_dataset(**kw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ckw = {} if not kw else dict(n_classes=50, dim=8, n=9, step=5, seed=2)
    for a, b in zip(syn.classification_dataset(**ckw), jsyn.classification_dataset(**ckw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# configs/shapes, the arch registry and model_zoo's specs and counts
# ---------------------------------------------------------------------------

def test_shapes_and_cells_equal_repros():
    assert configs.ARCHS == jconfigs.ARCHS
    assert list(configs.SHAPES) == list(jconfigs.SHAPES)
    for name, s in configs.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(jconfigs.SHAPES[name])
    for arch in configs.ARCHS:
        assert configs.is_sub_quadratic(arch) == jconfigs.is_sub_quadratic(arch), arch
        assert [s.name for s in configs.arch_shapes(arch)] == \
            [s.name for s in jconfigs.arch_shapes(arch)]
    assert [(a, s.name) for a, s in configs.dryrun_cells()] == \
        [(a, s.name) for a, s in jconfigs.dryrun_cells()]
    assert {a for a in configs.ARCHS if configs.is_sub_quadratic(a)} == {"mamba2-130m",
                                                                       "zamba2-7b"}
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("whisper-large")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_specs_and_counts_equal_repros(arch):
    tcfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for name, shape in configs.SHAPES.items():
        got = model_zoo.input_specs(tcfg, shape)
        want = jzoo.input_specs(jcfg, jconfigs.SHAPES[name])
        assert list(got) == list(want), (arch, name)
        for key, t in got.items():
            assert t.device.type == "meta", (arch, name, key)
            assert tuple(t.shape) == want[key].shape and str(t.dtype)[6:] == str(
                want[key].dtype), (arch, name, key)
    got, want = model_zoo.serve_table_spec(tcfg), jzoo.serve_table_spec(jcfg)
    assert got._fields == want._fields
    for a, b in zip(got, want):
        assert a.shape == b.shape and str(a.dtype)[6:] == str(b.dtype), arch
    for active in (False, True):
        assert model_zoo.count_params_analytic(tcfg, active) == \
            jzoo.count_params_analytic(jcfg, active), (arch, active)
    for serve in (False, True):
        assert model_zoo.head_flops_per_token(tcfg, serve) == \
            jzoo.head_flops_per_token(jcfg, serve), (arch, serve)


def test_counts_of_a_full_softmax_head_and_a_serve_pad_equal_repros():
    for arch in ("qwen2-1.5b", "whisper-base", "zamba2-7b", "olmoe-1b-7b"):
        for kw in (dict(head="full"), dict(ds_pad=640)):
            t, j = configs.get_config(arch), jconfigs.get_config(arch)
            if "ds_pad" in kw:
                t = t.replace(ds=t.ds.replace(serve_pad=kw["ds_pad"]))
                j = j.replace(ds=j.ds.replace(serve_pad=kw["ds_pad"]))
            else:
                t, j = t.replace(**kw), j.replace(**kw)
            assert model_zoo.count_params_analytic(t, True) == jzoo.count_params_analytic(j, True)
            assert model_zoo.head_flops_per_token(t, True) == jzoo.head_flops_per_token(j, True)
            spec = model_zoo.serve_table_spec(t)
            assert (spec is None) == (jzoo.serve_table_spec(j) is None)
            if spec is not None:
                assert spec.ids.shape == jzoo.serve_table_spec(j).ids.shape
