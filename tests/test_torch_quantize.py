"""Port parity: int8 serve tables and the per-token kernel path against
``repro`` on the same seeded inputs.

- ``quantize_table`` / ``dequantize_table`` / ``pack_experts(quantize=)``
  and ``convert.table_from_jax``: fields equal bit for bit (f32, bf16).
- ``calibrate_quantized_table`` on one calibration array: the same report.
- ``serve_topk`` on int8 tables, each port path against its ``repro``
  counterpart (Pallas kernels in interpret mode), with and without
  fallback experts and under capacity overflow. Every fixture keeps at
  least one expert on int8 rows.
- The per-token path (``cuda_pertoken``, the plain version on the CPU)
  against ``repro``'s ``dss_topk`` kernel and its ``'pallas'`` path.
- The registry's pricing of quantized tables, and ``ServeSession(
  quantize='int8')`` on a 2-layer qwen2 against ``repro``'s session.

Tolerances: ids equal; fp32 values rtol 1e-6, atol 2e-6
(``tests/test_quantize.py:219``: fp32 sums of exact products in another
order)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.configs.base import DSSoftmaxConfig as JDSConfig
from repro.core import dssoftmax as jds
from repro.kernels import ops as pallas_ops
from repro.models import build as jbuild
from repro.train import Request as JRequest
from repro.train import SamplingParams as JSamplingParams
from repro.train import ServeSession as JServeSession
from repro_torch import configs
from repro_torch.convert import flatten_paths, params_from_jax, table_from_jax, to_tensor
from repro_torch.core import dssoftmax as ds
from repro_torch.kernels import ops, ref, registry
from repro_torch.models import build
from repro_torch.train import Request, SamplingParams, ServeSession

RTOL, ATOL = 1e-6, 2e-6
# port path -> the repro path it stands for
PAIRS = {"jnp": "jnp", "grouped": "grouped", "cuda_grouped": "pallas_grouped",
         "cuda_fused": "pallas_fused"}


def _t(a):
    return to_tensor(np.asarray(a), "cpu")


def _np_fields(table):
    return {f: np.asarray(v) for f, v in table._asdict().items()}


def _port(table):
    return table_from_jax(_np_fields(table), "cpu")


def _check(got, want):
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), rtol=RTOL, atol=ATOL)


@functools.lru_cache(maxsize=None)
def _fixture(dtype="float32", K=4, d=32, n_classes=900, keep=0.5):
    """repro's ``tests/test_quantize.py`` fixture: (gate, fp ServeTable)."""
    params, _ = jds.init(jax.random.PRNGKey(0), d, n_classes, JDSConfig(num_experts=K),
                         dtype=getattr(jnp, dtype))
    mask = jax.random.uniform(jax.random.PRNGKey(2), (K, n_classes)) < keep
    return params, mask, jds.pack_experts(params, jds.DSState(mask=mask))


@functools.lru_cache(maxsize=None)
def _flip_prone():
    """repro's flip-prone fixture (``tests/test_quantize.py:138``): expert
    0's rows are near-ties that int8 scrambles, experts 1-2 are ladders
    int8 keeps exactly; at flip threshold 0.05 only expert 0 falls back."""
    d, v_pad, n_tied, K = 16, 128, 64, 3
    rng = np.random.RandomState(3)
    w = np.zeros((K, v_pad, d), np.float32)
    ids = np.full((K, v_pad), -1, np.int32)
    v = rng.randn(d).astype(np.float32)
    w[0, :n_tied] = v[None, :] + 1e-4 * rng.randn(n_tied, d)
    ids[0, :n_tied] = np.arange(n_tied)
    u = rng.randn(d).astype(np.float32)
    for e in (1, 2):
        c = 1.0 + 0.1 * np.arange(n_tied, dtype=np.float32)
        w[e, :n_tied] = c[:, None] * u[None, :] * e
        ids[e, :n_tied] = n_tied * e + np.arange(n_tied)
    table = jds.ServeTable(ids=jnp.asarray(ids), weights=jnp.asarray(w))
    gate = 5.0 * np.eye(K, d, dtype=np.float32)
    calib = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (192, d), jnp.float32))
    return gate, table, calib


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_table_matches_repro(dtype):
    params, mask, jtable = _fixture(dtype)
    fb = np.array([False, True, False, True])
    ttable = _port(jtable)
    for fb_mask in (None, fb):
        want = jds.quantize_table(jtable, fb_mask=fb_mask)
        got = ds.quantize_table(ttable, fb_mask=fb_mask)
        assert got.qweights.dtype == torch.int8 and got.scales.dtype == torch.float32
        for f in jds.QuantizedServeTable._fields:
            a, b = getattr(got, f), np.asarray(getattr(want, f))
            np.testing.assert_array_equal(
                (a.float() if a.dtype == torch.bfloat16 else a).numpy(),
                b.astype(np.float32) if b.dtype.name == "bfloat16" else b, err_msg=f)
        assert got.n_fallback == int(want.n_fallback) < 4
        deq, jdeq = ds.dequantize_table(got), jds.dequantize_table(want)
        np.testing.assert_array_equal(deq.weights.numpy(), np.asarray(jdeq.weights))
    # pack_experts(quantize='int8') from the port's own packing
    tparams = {"gate": _t(params["gate"]), "experts": _t(params["experts"])}
    qt = ds.pack_experts(tparams, ds.DSState(mask=_t(mask)), quantize="int8")
    jqt = jds.pack_experts(params, jds.DSState(mask=mask), quantize="int8")
    np.testing.assert_array_equal(qt.qweights.numpy(), np.asarray(jqt.qweights))
    np.testing.assert_array_equal(qt.scales.numpy(), np.asarray(jqt.scales))
    with pytest.raises(ValueError, match="quantize"):
        ds.pack_experts(tparams, ds.DSState(mask=_t(mask)), quantize="int4")


def test_table_from_jax_round_trip():
    """Both table kinds: bf16 rows through an int16 view, int8 stays int8;
    back to numpy the fields are unchanged."""
    _, _, jtable = _fixture("bfloat16")
    jq = jds.quantize_table(jtable, fb_mask=np.array([True, False, False, False]))
    for jt in (jtable, jq):
        fields = _np_fields(jt)
        tt = table_from_jax(fields, "cpu")
        assert type(tt).__name__ == type(jt).__name__
        for f, a in fields.items():
            t = getattr(tt, f)
            back = (t.view(torch.int16).numpy().view(a.dtype) if t.dtype == torch.bfloat16
                    else t.numpy())
            assert back.dtype == a.dtype, f
            np.testing.assert_array_equal(back.view(np.uint8), a.view(np.uint8), err_msg=f)
    assert tt.qweights.dtype == torch.int8 and tt.n_fallback == 1
    bad = _np_fields(jq)
    bad["scales"] = bad["scales"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        table_from_jax(bad, "cpu")
    del bad["fb_index"]
    with pytest.raises(KeyError, match="fb_index"):
        table_from_jax(bad, "cpu")


# ---------------------------------------------------------------------------
# Exactness gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["flip_prone", "random"])
def test_calibration_report_matches_repro(case):
    """Same gate, table and calibration array: the same report, the same
    fallback experts and the same served table."""
    if case == "flip_prone":
        gate, jtable, calib = _flip_prone()
        thr = 0.05
    else:
        params, _, jtable = _fixture()
        gate = np.asarray(params["gate"])
        calib = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (128, 32)))
        thr = 0.26  # some experts fall back, some stay on int8 rows
    jq, jrep = jds.calibrate_quantized_table(jnp.asarray(gate), jtable, jnp.asarray(calib),
                                             k=8, flip_threshold=thr)
    tq, trep = ds.calibrate_quantized_table(_t(gate), _port(jtable), _t(calib), k=8,
                                            flip_threshold=thr)
    assert trep.as_dict() == jrep.as_dict()
    assert 0 < tq.n_fallback < jtable.ids.shape[0]
    np.testing.assert_array_equal(tq.fb_index.numpy(), np.asarray(jq.fb_index))
    with pytest.raises(TypeError, match="full-precision"):
        ds.calibrate_quantized_table(_t(gate), tq, _t(calib))


# ---------------------------------------------------------------------------
# serve_topk on int8 tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _gated():
    """The random fixture under the exactness gate at a threshold where
    some experts fall back and the others stay on int8 rows (the
    flip-prone fixture's deliberate near-ties, ~1e-8 apart, would order
    differently under another fp32 summation order)."""
    params, _, jtable = _fixture()
    calib = jax.random.normal(jax.random.PRNGKey(9), (128, 32))
    jq, _ = jds.calibrate_quantized_table(params["gate"], jtable, calib, k=8,
                                          flip_threshold=0.26)
    return np.asarray(params["gate"]), jq


@functools.lru_cache(maxsize=None)
def _jax_serve(case, jkern, B, cf=2.0):
    """(gate, jax quantized table, h, repro's outputs with stats)."""
    if case == "fallback":
        gate, jq = _gated()
    else:
        params, _, jtable = _fixture()
        gate, jq = np.asarray(params["gate"]), jds.quantize_table(jtable)
    h = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (B, 32)))
    if case == "fallback":  # tokens on fallback and on int8 experts
        fb = np.asarray(jq.fb_index)[np.asarray(jds.top1_gate(gate, h)[0])] >= 0
        assert fb.any() and not fb.all()
    out = jds.serve_topk(jnp.asarray(gate), jq, jnp.asarray(h), 8, kernel=jkern,
                         capacity_factor=cf, with_stats=True)
    return gate, jq, h, out


@pytest.mark.parametrize("kern", list(PAIRS))
@pytest.mark.parametrize("case,B", [("int8", 16), ("int8", 64),
                                    ("fallback", 16), ("fallback", 64)])
def test_quantized_serve_matches_repro(kern, case, B):
    gate, jq, h, (v2, i2, st2) = _jax_serve(case, PAIRS[kern], B)
    tq = _port(jq)
    assert tq.n_fallback < tq.ids.shape[0]
    assert (tq.n_fallback > 0) == (case == "fallback")
    v1, i1, st1 = ds.serve_topk(_t(gate), tq, _t(h), 8, kernel=kern, with_stats=True,
                                device="cpu")
    _check((v1, i1), (v2, i2))
    np.testing.assert_array_equal(st1["dispatched"].numpy(), np.asarray(st2["dispatched"]))
    np.testing.assert_array_equal(st1["overflow"].numpy(), np.asarray(st2["overflow"]))


@pytest.mark.parametrize("kern", ["grouped", "cuda_grouped"])
def test_quantized_capacity_overflow_matches_repro(kern):
    """cf 0.25 on the table with a fallback expert: overflowed tokens and
    the fallback expert's tokens are fixed up exactly; the overflow
    telemetry leaves the fallback tokens out, as repro's does."""
    gate, jq, h, (v2, i2, st2) = _jax_serve("fallback", PAIRS[kern], 64, 0.25)
    v1, i1, st1 = ds.serve_topk(_t(gate), _port(jq), _t(h), 8, kernel=kern,
                                capacity_factor=0.25, with_stats=True, device="cpu")
    assert int(st1["overflow"].sum()) > 0
    _check((v1, i1), (v2, i2))
    np.testing.assert_array_equal(st1["overflow"].numpy(), np.asarray(st2["overflow"]))


def test_quantized_bf16_tokens_match_repro():
    """bf16 table and tokens: int8 rows cast to bf16 on both sides."""
    params, _, jtable = _fixture("bfloat16")
    jq = jds.quantize_table(jtable)
    h = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (32, 32)).astype(jnp.bfloat16))
    v2, i2 = jds.serve_topk(params["gate"], jq, jnp.asarray(h), 8, kernel="jnp")
    tq = _port(jq)
    for kern in PAIRS:
        _check(ds.serve_topk(_t(params["gate"]), tq, _t(h), 8, kernel=kern, device="cpu"),
               (v2, i2))


def test_int8_wrappers_match_pallas_bodies():
    """The grouped and fused wrappers' int8 plain versions against the
    Pallas ``_kernel_q`` bodies in interpret mode, on one all-padding
    expert and a v_pad no 64- or 128-row tile divides."""
    rng = np.random.RandomState(4)
    K, d, v_pad, C, B = 4, 32, 200, 6, 24
    q = rng.randint(-127, 128, (K, v_pad, d)).astype(np.int8)
    scales = (rng.rand(K, v_pad) * 0.01 + 1e-3).astype(np.float32)
    ids = rng.permutation(10 * K * v_pad)[: K * v_pad].reshape(K, v_pad).astype(np.int32)
    ids[2] = -1
    ids[1, 150:] = -1
    buf = rng.randn(K, C, d).astype(np.float32)
    g_buf = rng.rand(K, C).astype(np.float32) + 0.1
    got = ops.dss_topk_grouped(_t(q), _t(ids), _t(buf), _t(g_buf), 8, scales=_t(scales),
                               device="cpu")
    want = pallas_ops.dss_topk_grouped(jnp.asarray(q), jnp.asarray(ids), jnp.asarray(buf),
                                       jnp.asarray(g_buf), 8, scales=jnp.asarray(scales),
                                       interpret=True)
    _check(got, want)
    assert (got[1][2] == -1).all() and (got[0][2] == -1e9).all()
    gate = rng.randn(K, d).astype(np.float32)
    h = rng.randn(B, d).astype(np.float32)
    got = ops.dss_topk_fused(_t(gate), _t(q), _t(ids), _t(h), 8, scales=_t(scales),
                             device="cpu")
    want = pallas_ops.dss_topk_fused(jnp.asarray(gate), jnp.asarray(q), jnp.asarray(ids),
                                     jnp.asarray(h), 8, scales=jnp.asarray(scales),
                                     interpret=True)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _check(got[:2], want[:2])
    with pytest.raises(ValueError, match="scales"):
        ops.dss_topk_grouped(_t(q), _t(ids), _t(buf), _t(g_buf), 8, device="cpu")
    assert ops.launch_counts()["dss_topk_grouped_q"] == 0  # plain versions launch nothing


# ---------------------------------------------------------------------------
# The per-token path
# ---------------------------------------------------------------------------

def _pertoken_inputs(dtype, short_expert=True):
    """A table whose expert 2 holds only 5 real rows (< k = 8)."""
    rng = np.random.RandomState(6)
    K, d, v_pad, B = 4, 32, 384, 24
    w = (rng.randn(K, v_pad, d) / np.sqrt(d)).astype(np.float32)
    ids = rng.permutation(8 * K * v_pad)[: K * v_pad].reshape(K, v_pad).astype(np.int32)
    sizes = np.array([300, 384, 5 if short_expert else 200, 250])
    pad = np.arange(v_pad)[None, :] >= sizes[:, None]
    ids[pad], w[pad] = -1, 0.0
    h = rng.randn(B, d).astype(np.float32)
    e = rng.randint(0, K, B).astype(np.int32)
    e[:3] = 2
    g = (rng.rand(B) * 0.9 + 0.1).astype(np.float32)
    cast = lambda a: np.asarray(jnp.asarray(a, getattr(jnp, dtype)))
    return cast(w), ids, cast(h), e, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dss_topk_matches_pallas_kernel(dtype):
    """``ops.dss_topk`` (the g fold + the kernel wrapper's plain version)
    and ``ref.dss_topk_ref`` against ``repro.kernels.ops.dss_topk`` in
    interpret mode. The fold is bit-exact; tokens of the expert with 5
    real rows agree on those 5 slots, and their tail is (-1e9, -1) where
    the Pallas kernel repeats real ids at -1e9."""
    w, ids, h, e, g = _pertoken_inputs(dtype)
    h_scaled = (_t(h).float() * _t(g)[:, None]).to(_t(h).dtype)
    jh = (jnp.asarray(h).astype(jnp.float32) * jnp.asarray(g)[:, None]).astype(h.dtype)
    np.testing.assert_array_equal(h_scaled.float().numpy(), np.asarray(jh, np.float32))
    got = ops.dss_topk(_t(w), _t(ids), _t(h), _t(e), _t(g), 8, device="cpu")
    plain = ref.dss_topk_ref(_t(w), _t(ids), h_scaled, _t(e), 8)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    want = pallas_ops.dss_topk(jnp.asarray(w), jnp.asarray(ids), jnp.asarray(h),
                               jnp.asarray(e), jnp.asarray(g), 8, interpret=True)
    full = e != 2
    _check((got[0][full], got[1][full]), (np.asarray(want[0])[full], np.asarray(want[1])[full]))
    _check((got[0][~full, :5], got[1][~full, :5]),
           (np.asarray(want[0])[~full, :5], np.asarray(want[1])[~full, :5]))
    assert (got[1][~full, 5:] == -1).all() and (got[0][~full, 5:] == -1e9).all()
    assert (np.asarray(want[0])[~full, 5:] == -1e9).all()
    assert ops.launch_counts()["dss_topk"] == 0


def test_dss_topk_wrapper_matches_repro_oracle():
    """The kernel wrapper on h_scaled against repro's jnp oracle of the
    per-token kernel, which also pads with (-1e9, -1)."""
    from repro.kernels import ref as jref

    w, ids, h, e, _ = _pertoken_inputs("float32")
    got = ops.dss_topk_kernel(_t(w), _t(ids), _t(h), _t(e), 8, device="cpu")
    _check(got, jref.dss_topk_ref(jnp.asarray(w), jnp.asarray(ids), jnp.asarray(h),
                                  jnp.asarray(e), 8))
    with pytest.raises(TypeError, match="fp tables"):
        ops.dss_topk_kernel(_t(w).to(torch.int8), _t(ids), _t(h), _t(e), 8, device="cpu")


@pytest.mark.parametrize("B", [16, 64])
def test_cuda_pertoken_path_matches_repro_pallas_path(B):
    """serve_topk(kernel='cuda_pertoken') against repro's 'pallas' path
    (the same per-token kernel in interpret mode), fp32."""
    params, _, jtable = _fixture()
    h = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (B, 32)))
    want = jds.serve_topk(params["gate"], jtable, jnp.asarray(h), 8, kernel="pallas")
    got = ds.serve_topk(_t(params["gate"]), _port(jtable), _t(h), 8, kernel="cuda_pertoken",
                        device="cpu")
    _check(got, want)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def test_registry_prices_quantized_tables():
    """serve_kernel_context reads the row dtype; every path prices the
    4-byte scale per packed row it reads; cuda_pertoken is infeasible on
    a quantized table and naming it raises."""
    params, _, jtable = _fixture()
    tt = _port(jtable)
    tq = ds.quantize_table(tt)
    h = torch.zeros(16, 32)
    cq, cf = ds.serve_kernel_context(tq, h, 8), ds.serve_kernel_context(tt, h, 8)
    assert cq.quantized and cq.wbytes == 1 and not cf.quantized and cf.wbytes == 4
    plain1 = dataclasses.replace(cq, quantized=False)
    K, v = cq.K, cq.v_pad
    for name, rows in (("grouped", K * v), ("cuda_grouped", K * v), ("jnp", 2 * 16 * v)):
        spec = registry.get_spec(name)
        assert spec.bytes_moved(cq) - spec.bytes_moved(plain1) == 4 * rows, name
    cuda_q, cuda_f = (dataclasses.replace(c, backend="cuda") for c in (cq, cf))
    pertoken = registry.get_spec("cuda_pertoken")
    assert not pertoken.feasible(cuda_q) and pertoken.feasible(cuda_f)
    assert not pertoken.quantized_ok and registry.get_spec("cuda_fused").quantized_ok
    with pytest.raises(ValueError, match="quantized"):
        ds.serve_topk(_t(params["gate"]), tq, h, 8, kernel="cuda_pertoken", device="cpu")
    with pytest.raises(ValueError, match="quantized"):
        registry.resolve_kernel(registry.FixedPolicy("cuda_pertoken"), cq)


@pytest.mark.parametrize("B,backend,quantized,expected", [
    (8, "cpu", True, "jnp"), (2048, "cpu", True, "grouped"),
    (8, "cuda", True, "cuda_fused"), (2048, "cuda", True, "cuda_grouped"),
    (1, "cuda", False, "cuda_fused"), (8, "cuda", False, "cuda_fused"),
])
def test_auto_policy_never_picks_pertoken(B, backend, quantized, expected):
    """qwen2-1.5b head shapes (K 16, V_pad 12032, d 1536, bf16 tokens):
    the per-token path costs more than the fused one at every batch, and
    is never feasible on a quantized table."""
    hist = []
    ctx = registry.KernelContext(B=B, d=1536, K=16, v_pad=12032, k=8, backend=backend,
                                 wbytes=1 if quantized else 2, hbytes=2, quantized=quantized)
    assert registry.AutoPolicy(history=hist).resolve(ctx) == expected
    assert hist == [(B, expected)]


# ---------------------------------------------------------------------------
# ServeSession(quantize='int8')
# ---------------------------------------------------------------------------

PROMPTS = [(4, 4), (7, 3), (5, 5), (4, 2), (9, 4)]


def _requests(cls, sp_cls, vocab):
    rng = np.random.RandomState(0)
    return [cls(prompt=rng.randint(0, vocab, S).astype(np.int32),
                sampling=sp_cls(max_new_tokens=m)) for S, m in PROMPTS]


@functools.lru_cache(maxsize=None)
def _session_setup():
    """repro's int8 session (jnp path) on a 2-layer qwen2 and the port's
    model on the same weights and the same calibration array."""
    vocab = 128
    jcfg = jreduce_config(jget_config("qwen2-1.5b"), vocab=vocab).replace(dtype="float32")
    tcfg = configs.reduce_config(configs.get_config("qwen2-1.5b"), vocab=vocab).replace(
        dtype="float32")
    jb = jbuild(jcfg)
    params, state = jb.init(jax.random.PRNGKey(0))
    calib = np.random.RandomState(5).randn(64, jcfg.d_model).astype(np.float32)
    sess = JServeSession(jb, params, state, n_slots=2, max_seq_len=16, kernel="jnp",
                         prefill_chunk=4, quantize="int8", quantize_calib=calib,
                         quantize_flip_threshold=0.3)
    reqs = _requests(JRequest, JSamplingParams, vocab)
    sess.run(reqs)
    tree = flatten_paths(jax.tree.map(np.asarray, params))
    tree["ds_state/mask"] = np.asarray(state.mask)
    tparams, tstate = params_from_jax(tree, tcfg, device="cpu")
    return ([r.out_tokens for r in reqs], sess.stats()["quantize_report"], calib,
            build(tcfg, device="cpu"), tparams, tstate)


@pytest.mark.parametrize("kern", ["jnp", "cuda_fused", "cuda_grouped", "auto"])
def test_session_int8_token_identical_to_repro(kern):
    expected, jreport, calib, bundle, params, state = _session_setup()
    sess = ServeSession(bundle, params, state, n_slots=2, max_seq_len=16, kernel=kern,
                        quantize="int8", quantize_calib=calib, quantize_flip_threshold=0.3,
                        device="cpu")
    assert isinstance(sess.table, ds.QuantizedServeTable)
    assert 0 < sess.table.n_fallback < 4  # int8 rows and fallback rows both serve
    reqs = _requests(Request, SamplingParams, 128)
    sess.run(reqs)
    assert [r.out_tokens for r in reqs] == expected
    st = sess.stats()
    assert st["quantize"] == "int8" and st["quantize_report"] == jreport
    assert st["n_admitted"] == len(PROMPTS) > sess.n_slots


def test_session_int8_pre_quantized_table_and_arguments():
    """A pre-quantized table passes through with no report; an int
    quantize_calib draws from the seeded generator (same table twice);
    bad arguments raise before any compute."""
    _, _, _, bundle, params, state = _session_setup()
    qt = ds.pack_experts(params["head"], state, quantize="int8")
    sess = ServeSession(bundle, params, qt, n_slots=2, max_seq_len=16, quantize="int8",
                        device="cpu")
    assert sess.table is qt and sess.stats()["quantize_report"] is None
    a, b = (ServeSession(bundle, params, state, n_slots=2, max_seq_len=16, quantize="int8",
                         quantize_calib=32, device="cpu") for _ in range(2))
    assert a.stats()["quantize_report"] == b.stats()["quantize_report"]
    assert a.stats()["quantize_report"]["n_tokens"] == 32
    assert torch.equal(a.table.fb_index, b.table.fb_index)
    with pytest.raises(ValueError, match="quantize"):
        ServeSession(bundle, params, state, quantize="int4", device="cpu")
    fs_cfg = bundle.cfg.replace(head="full")
    fs_bundle = dataclasses.replace(bundle, cfg=fs_cfg)
    with pytest.raises(ValueError, match="DS head"):
        ServeSession(fs_bundle, params, None, quantize="int8", device="cpu")
    sess = ServeSession(bundle, params, qt, n_slots=2, max_seq_len=16,
                        kernel="cuda_pertoken", device="cpu")
    with pytest.raises(ValueError, match="cuda_pertoken"):
        sess.run(_requests(Request, SamplingParams, 128)[:1])
