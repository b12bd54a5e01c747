"""Port parity: ``repro_torch.train.ServeSession`` against
``repro.train.ServeSession(kernel="jnp")`` on the same JAX-initialized
weights (``convert.params_from_jax``), on the mixed workload of
``tests/test_serve_session.py``: 6 requests of different prompt lengths
and ``max_new_tokens`` through 2 slots, so slots are reused mid-flight.
One request samples at temperature 0.8 (the host Philox sampler is
copied, so its stream must match too).

Greedy and sampled streams must be token-identical for every port serve
path (``cuda_*`` paths run their wrappers' plain versions on the CPU).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.core import dssoftmax as jds
from repro.models import build as jbuild
from repro.train import Request as JRequest
from repro.train import SamplingParams as JSamplingParams
from repro.train import ServeSession as JServeSession
from repro_torch import configs
from repro_torch.convert import flatten_paths, params_from_jax
from repro_torch.core import dssoftmax as ds
from repro_torch.models import build
from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession

MAX_NEWS = [2, 5, 3, 7, 4, 6]
SAMPLED = 3


def _prompts(n=6, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, rng.randint(3, 10)).astype(np.int32) for _ in range(n)]


def _sp(cls, i, m):
    return cls(max_new_tokens=m, temperature=0.8 if i == SAMPLED else 0.0, seed=11)


@functools.lru_cache(maxsize=None)
def _setup(dtype):
    """JAX reference streams + the port's model on the same weights."""
    jcfg = jreduce_config(jget_config("qwen2-1.5b"), vocab=128).replace(
        ds=jget_config("qwen2-1.5b").ds.replace(num_experts=4), dtype=dtype)
    tcfg = configs.reduce_config(configs.get_config("qwen2-1.5b"), vocab=128).replace(
        ds=configs.get_config("qwen2-1.5b").ds.replace(num_experts=4), dtype=dtype)
    jb = jbuild(jcfg)
    params, state = jb.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)  # prune each class from ~half its experts
    mask = np.asarray(state.mask) & (rng.rand(*state.mask.shape) < 0.5)
    mask[rng.randint(0, 4, mask.shape[1]), np.arange(mask.shape[1])] = True
    state = jds.DSState(mask=jax.numpy.asarray(mask))
    # repro's chunked prefill is token-identical to its whole-prompt prefill
    # (tests/test_serve_session.py:73) and compiles once for every length
    sess = JServeSession(jb, params, jds.pack_experts(params["head"], state), n_slots=2,
                         max_seq_len=32, kernel="jnp", prefill_chunk=4)
    reqs = [JRequest(prompt=p, sampling=_sp(JSamplingParams, i, m))
            for i, (p, m) in enumerate(zip(_prompts(), MAX_NEWS))]
    sess.run(reqs)
    tree = flatten_paths(jax.tree.map(np.asarray, params))
    tree["ds_state/mask"] = mask
    tparams, tstate = params_from_jax(tree, tcfg, device="cpu")
    return [r.out_tokens for r in reqs], build(tcfg, device="cpu"), tparams, tstate


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kern", ["jnp", "grouped", "cuda_grouped", "cuda_fused", "auto"])
def test_mixed_workload_token_identical_to_repro(dtype, kern):
    expected, bundle, params, state = _setup(dtype)
    sess = ServeSession(bundle, params, state, n_slots=2, max_seq_len=32, kernel=kern,
                        device="cpu")
    reqs = [Request(prompt=p, sampling=_sp(SamplingParams, i, m))
            for i, (p, m) in enumerate(zip(_prompts(), MAX_NEWS))]
    sess.run(reqs)
    for r, want, m in zip(reqs, expected, MAX_NEWS):
        assert r.status is RequestStatus.COMPLETED
        assert len(r.out_tokens) == m
        assert r.out_tokens == want
    st = sess.stats()
    assert st["n_admitted"] == st["n_released"] == 6 > sess.n_slots
    # every decode step dispatches the whole slot batch, empty slots included
    assert sum(st["expert_dispatched"]) == sess.n_steps * sess.n_slots


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["chunked", "paged", "paged_chunked"])
def test_chunked_and_paged_workload_token_identical_to_repro(dtype, mode):
    """``tests/test_serve_session.py:72`` with ``prefill_chunk=4`` (the
    reference streams themselves come from repro's chunk-4 session), and the
    same workload on the paged cache: slots reused mid-flight, greedy and
    sampled streams equal repro's, no page leaked."""
    expected, bundle, params, state = _setup(dtype)
    kw = {"chunked": dict(prefill_chunk=4), "paged": dict(paged=True, page_size=8),
          "paged_chunked": dict(prefill_chunk=4, paged=True, page_size=8)}[mode]
    sess = ServeSession(bundle, params, state, n_slots=2, max_seq_len=32, kernel="jnp",
                        device="cpu", **kw)
    reqs = [Request(prompt=p, sampling=_sp(SamplingParams, i, m))
            for i, (p, m) in enumerate(zip(_prompts(), MAX_NEWS))]
    sess.run(reqs)
    assert [r.out_tokens for r in reqs] == expected
    st = sess.stats()
    assert st["n_admitted"] == st["n_released"] == 6 > sess.n_slots
    if "paged" in st:
        assert st["paged"]["pages_in_use"] == 0


def test_submit_validates_before_any_compute():
    _, bundle, params, state = _setup("float32")
    sess = ServeSession(bundle, params, state, n_slots=2, max_seq_len=16, device="cpu")
    bad = [Request(prompt=np.array([1, 2, 3]), sampling=SamplingParams(max_new_tokens=15)),
           Request(prompt=np.array([1, 999]), max_new_tokens=2),
           Request(prompt=np.array([], np.int32), max_new_tokens=2),
           Request(prompt=np.array([1]), sampling=SamplingParams(top_k=9)),
           Request(prompt=np.array([1]), sampling=SamplingParams(temperature=-1.0))]
    for r in bad:
        with pytest.raises(ValueError):
            sess.submit(r)
        assert r.status is RequestStatus.REJECTED
    assert sess.n_steps == 0 and not sess.scheduler.has_work()


def test_non_finite_output_quarantines_only_its_slot():
    """A NaN token embedding poisons exactly one request: it ends FAILED
    and its slot is scrubbed and reused; the others are unaffected."""
    expected, bundle, params, state = _setup("float32")
    poisoned = {k: v for k, v in params.items()}
    table = params["embed"]["table"].clone()
    prompts = _prompts()
    bad_tok = 127
    assert all(bad_tok not in p for p in prompts)
    table[bad_tok] = float("nan")
    poisoned["embed"] = {"table": table}
    sess = ServeSession(bundle, poisoned, state, n_slots=2, max_seq_len=32, kernel="jnp",
                        device="cpu")
    reqs = [Request(prompt=p, sampling=_sp(SamplingParams, i, m))
            for i, (p, m) in enumerate(zip(prompts, MAX_NEWS))]
    victim = Request(prompt=np.array([5, bad_tok, 7], np.int32), max_new_tokens=3)
    sess.run([victim] + reqs)
    assert victim.status is RequestStatus.FAILED and "non-finite" in victim.error
    assert [r.out_tokens for r in reqs] == expected


def test_non_finite_output_quarantines_only_its_paged_slot():
    """The poisoned request of the test above on the paged cache with
    chunked prefill: it ends FAILED, every page it held is zeroed as it
    returns to the free list, and the others' streams are unchanged."""
    expected, bundle, params, state = _setup("float32")
    table = params["embed"]["table"].clone()
    table[127] = float("nan")
    poisoned = dict(params, embed={"table": table})
    sess = ServeSession(bundle, poisoned, state, n_slots=2, max_seq_len=32, kernel="jnp",
                        prefill_chunk=4, paged=True, page_size=8, device="cpu")
    reqs = [Request(prompt=p, sampling=_sp(SamplingParams, i, m))
            for i, (p, m) in enumerate(zip(_prompts(), MAX_NEWS))]
    victim = Request(prompt=np.array([5, 127, 7], np.int32), max_new_tokens=3)
    sess.run([victim] + reqs)
    assert victim.status is RequestStatus.FAILED and "non-finite" in victim.error
    assert [r.out_tokens for r in reqs] == expected
    assert sess.stats()["paged"]["pages_in_use"] == 0
    assert torch.isfinite(sess._cache.k).all() and torch.isfinite(sess._cache.v).all()


def test_session_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is reachable")
    _, bundle, params, state = _setup("float32")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeSession(bundle, params, state, n_slots=2, max_seq_len=32)


def test_decode_graph_on_the_cpu_raises():
    _, bundle, params, state = _setup("float32")
    with pytest.raises(ValueError, match="decode_graph=True needs a CUDA device"):
        ServeSession(bundle, params, state, n_slots=2, max_seq_len=32, device="cpu",
                     decode_graph=True)


@pytest.mark.parametrize("decode_graph", [None, False], ids=["default", "off"])
def test_cpu_session_steps_eagerly(decode_graph):
    """On the CPU the default session captures nothing (``decode_graphs``
    0) and its streams are repro's, as with the graph turned off."""
    expected, bundle, params, state = _setup("float32")
    sess = ServeSession(bundle, params, state, n_slots=2, max_seq_len=32, kernel="jnp",
                        device="cpu", decode_graph=decode_graph)
    reqs = [Request(prompt=p, sampling=_sp(SamplingParams, i, m))
            for i, (p, m) in enumerate(zip(_prompts(), MAX_NEWS))]
    sess.run(reqs)
    assert [r.out_tokens for r in reqs] == expected
    assert sess._graph is None and sess.stats()["decode_graphs"] == 0
