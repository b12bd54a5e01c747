"""Port parity: the Mamba2 SSD block (``repro_torch.models.mamba2``) against
``repro.models.mamba2`` on the same inputs, made from a seed with numpy.

* ``ssd_chunked`` against ``repro``'s over chunks 4–32 and groups 1–2, S
  not a chunk multiple (7, 37, 257) and a sequence split at any point with
  the first part's final state seeding the second: outputs and states
  within rtol/atol 1e-5 in fp32 (the bf16 intra-chunk products take the
  same bf16-rounded operands on both sides, exact in fp32; only the
  summation order differs). Against the port's own ``ssd_reference`` with
  ``tests/test_ssd.py``'s tolerances (the dual form's bf16 products).
* ``mamba2_prefill_chunk`` streaming a prompt in right-padded chunks,
  ``mamba2_verify_scan`` with per-row ``n_valid`` and ``mamba2_decode``
  against ``repro``: fp32 within rtol/atol 1e-5 (states) and 2e-5
  (outputs); bf16 (the JAX side jitted with
  ``xla_allow_excess_precision=False``) within one bf16 ulp (2^-7
  relative) of each tensor's largest magnitude.
* The port's own invariants: a chunked stream equals the whole block, and
  the verify scan equals one-token decoding row by row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import mamba2 as jm
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import to_tensor
from repro_torch.models import mamba2 as m

F32 = dict(rtol=1e-5, atol=1e-5)
STRICT = {"xla_allow_excess_precision": False}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and beside other
    test processes torch's default pool makes each small op wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_ssd(S, H=8, P=8, N=16, G=2, b=2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, S, H))).astype(np.float32)
    A = (-np.exp(rng.randn(H))).astype(np.float32)
    B = rng.randn(b, S, G, N).astype(np.float32)
    C = rng.randn(b, S, G, N).astype(np.float32)
    return x, dt, A, B, C


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close_to_reference(y_ref, st_ref, y_chk, st_chk, st_tol=1e-3):
    """``tests/test_ssd.py``'s bound of the dual form against the oracle."""
    y_ref, y_chk = np.asarray(y_ref), np.asarray(y_chk)
    rms = float(np.sqrt(np.mean(y_ref ** 2)))
    assert float(np.sqrt(np.mean((y_ref - y_chk) ** 2))) < 0.02 * rms
    assert float(np.max(np.abs(y_ref - y_chk))) < 0.15 * max(1.0, rms)
    np.testing.assert_allclose(np.asarray(st_ref), np.asarray(st_chk), rtol=st_tol, atol=st_tol)


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_matches_repro(chunk, groups):
    x, dt, A, B, C = _rand_ssd(32, G=groups, seed=chunk + groups)
    jy, jst = jm.ssd_chunked(*_j(x, dt, A, B, C), chunk=chunk)
    y, st = m.ssd_chunked(*_t(x, dt, A, B, C), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **F32)
    y_ref, st_ref = m.ssd_reference(*_t(x, dt, A, B, C))
    jy_ref, jst_ref = jm.ssd_reference(*_j(x, dt, A, B, C))
    np.testing.assert_allclose(y_ref.numpy(), np.asarray(jy_ref), **F32)
    np.testing.assert_allclose(st_ref.numpy(), np.asarray(jst_ref), **F32)
    _close_to_reference(y_ref, st_ref, y, st)


@pytest.mark.parametrize("S", [7, 37, 257])
def test_ssd_chunked_tail_not_a_chunk_multiple(S):
    x, dt, A, B, C = _rand_ssd(S, seed=S)
    jy, jst = jm.ssd_chunked(*_j(x, dt, A, B, C), chunk=8)
    y, st = m.ssd_chunked(*_t(x, dt, A, B, C), chunk=8)
    assert y.shape == (2, S, 8, 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **F32)
    _close_to_reference(*m.ssd_reference(*_t(x, dt, A, B, C)), y, st)


@pytest.mark.parametrize("split", [1, 5, 16, 36])
def test_ssd_initial_state_split_matches_repro(split):
    x, dt, A, B, C = _rand_ssd(37, seed=split)
    cut = lambda t, a, b: t[:, a:b]
    parts = []
    for lib, wrap in ((jm, _j), (m, _t)):
        xs, dts, As, Bs, Cs = wrap(x, dt, A, B, C)
        y1, s1 = lib.ssd_chunked(cut(xs, 0, split), cut(dts, 0, split), As,
                                 cut(Bs, 0, split), cut(Cs, 0, split), chunk=8)
        y2, s2 = lib.ssd_chunked(cut(xs, split, 37), cut(dts, split, 37), As,
                                 cut(Bs, split, 37), cut(Cs, split, 37), chunk=8,
                                 initial_state=s1)
        parts.append((np.concatenate([np.asarray(y1), np.asarray(y2)], axis=1), np.asarray(s2)))
    (jy, js), (y, s) = parts
    np.testing.assert_allclose(y, jy, **F32)
    np.testing.assert_allclose(s, js, **F32)
    _close_to_reference(*m.ssd_reference(*_t(x, dt, A, B, C)), y, s, st_tol=2e-3)


def _block(dtype, groups=2, seed=0):
    """repro's and the port's ModelConfig and one Mamba2 block's params
    (JAX-initialized, copied bit for bit)."""
    kw = dict(d_model=32, ssm_state=16, ssm_headdim=8, ssm_expand=2, ssm_chunk=8,
              ssm_ngroups=groups, dtype=dtype)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    jp = jm.init_mamba2(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed + 1)
    # non-trivial norm, D and conv bias (init leaves them at 1, 1 and 0)
    jp["norm_scale"] = jnp.asarray(1.0 + 0.1 * rng.randn(*jp["norm_scale"].shape), jnp.float32)
    jp["D"] = jnp.asarray(1.0 + 0.1 * rng.randn(*jp["D"].shape), jnp.float32)
    jp["conv_b"] = jnp.asarray(0.1 * rng.randn(*jp["conv_b"].shape)).astype(jcfg.jdtype)
    tp = {k: to_tensor(np.asarray(v), "cpu") for k, v in jp.items()}
    return jcfg, cfg, jp, tp


def _inputs(cfg, b, S, seed, dtype):
    rng = np.random.RandomState(seed)
    u = rng.randn(b, S, cfg.d_model).astype(np.float32)
    ju = jnp.asarray(u).astype(jnp.dtype(dtype))
    return ju, to_tensor(np.asarray(ju), "cpu")


def _check(got, want, dtype):
    """fp32: within 2e-5; bf16: within one bf16 ulp of the tensor's largest
    magnitude."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    tol = (dict(rtol=2e-5, atol=2e-5) if dtype == "float32"
           else dict(rtol=0, atol=2.0 ** -7 * float(np.abs(want).max())))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_chunk_stream_matches_repro(dtype):
    """A 13-token prompt in chunks of 4 (the last one valid row and three
    padding) from a zero state: every chunk's valid outputs and the handed
    on (conv tail, ssm state) equal repro's; the stream equals the port's
    whole-prompt block."""
    jcfg, cfg, jp, tp = _block(dtype)
    b, S, Cn = 2, 13, 4
    ju, tu = _inputs(cfg, b, S, 7, dtype)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    jcs = jnp.zeros((b, cfg.ssm_conv_width - 1, conv_dim), jcfg.jdtype)
    jss = jnp.zeros((b, H, P, N), jnp.float32)
    cs, ss = to_tensor(np.asarray(jcs), "cpu"), torch.zeros((b, H, P, N))
    jchunk = jax.jit(lambda p, u, c, s, nv: jm.mamba2_prefill_chunk(p, jcfg, u, c, s, nv),
                     static_argnums=4, compiler_options=STRICT)
    outs = []
    for lo in range(0, S, Cn):
        nv = min(Cn, S - lo)
        jbuf = jnp.zeros((b, Cn, cfg.d_model), jcfg.jdtype).at[:, :nv].set(ju[:, lo:lo + nv])
        buf = torch.zeros((b, Cn, cfg.d_model), dtype=cfg.jdtype)
        buf[:, :nv] = tu[:, lo:lo + nv]
        jo, jcs, jss = jchunk(jp, jbuf, jcs, jss, nv)
        o, cs, ss = m.mamba2_prefill_chunk(tp, cfg, buf, cs, ss, nv)
        _check(o[:, :nv], jo[:, :nv], dtype)
        _check(cs, jcs, dtype)
        _check(ss, jss, dtype)
        outs.append(o[:, :nv])
    full, (ctail, sfin) = m.mamba2_block(tp, cfg, tu, return_state=True)
    if dtype == "float32":
        np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), rtol=2e-4, atol=2e-4)
        assert torch.equal(cs, ctail)
        np.testing.assert_allclose(ss.numpy(), sfin.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_and_verify_scan_match_repro(dtype):
    """Three one-token decodes after a prefill, then a (B, 4) verify scan
    with per-row n_valid (2, 4): outputs and states equal repro's; each
    row of the scan's state equals decoding that row's first n_valid
    tokens one at a time (the batch decoded together), bit for bit."""
    jcfg, cfg, jp, tp = _block(dtype, groups=1, seed=3)
    b = 2
    ju, tu = _inputs(cfg, b, 9, 11, dtype)
    _, (jcs, jss) = jm.mamba2_block(jp, jcfg, ju, return_state=True)
    _, (cs, ss) = m.mamba2_block(tp, cfg, tu, return_state=True)
    jdec = jax.jit(lambda p, u, c, s: jm.mamba2_decode(p, jcfg, u, c, s), compiler_options=STRICT)
    steps_j, steps_t = _inputs(cfg, b, 7, 12, dtype)
    # start both sides from repro's handed-off state: the decode comparison
    # is the step's own
    cs, ss = to_tensor(np.asarray(jcs), "cpu"), to_tensor(np.asarray(jss), "cpu")
    for t in range(3):
        jo, jcs, jss = jdec(jp, steps_j[:, t:t + 1], jcs, jss)
        o, cs, ss = m.mamba2_decode(tp, cfg, steps_t[:, t:t + 1], cs, ss)
        _check(o, jo, dtype)
        _check(cs, jcs, dtype)
        _check(ss, jss, dtype)
    nv = np.array([2, 4], np.int32)
    jscan = jax.jit(lambda p, u, c, s, n: jm.mamba2_verify_scan(p, jcfg, u, c, s, n),
                    compiler_options=STRICT)
    jo, jc2, js2 = jscan(jp, steps_j[:, 3:7], jcs, jss, jnp.asarray(nv))
    o, c2, s2 = m.mamba2_verify_scan(tp, cfg, steps_t[:, 3:7], cs, ss, torch.from_numpy(nv))
    _check(o, jo, dtype)
    _check(c2, jc2, dtype)
    _check(s2, js2, dtype)
    # one-token decodes of the whole batch; row r's state after nv[r] of them
    c, s = cs, ss
    for t in range(4):
        _, c, s = m.mamba2_decode(tp, cfg, steps_t[:, 3 + t:4 + t].contiguous(), c, s)
        for r in np.nonzero(nv == t + 1)[0]:
            assert torch.equal(c2[r], c[r]) and torch.equal(s2[r], s[r]), (r, t)


def test_softplus_is_jax_softplus():
    x = np.linspace(-40, 40, 1601).astype(np.float32)
    np.testing.assert_allclose(m.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=0)


def test_repeat_groups_is_jnp_repeat():
    a = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    for dim in (0, 1, 2, -1):
        np.testing.assert_array_equal(m.repeat_groups(torch.from_numpy(a), 3, dim).numpy(),
                                      np.repeat(a, 3, axis=dim))
