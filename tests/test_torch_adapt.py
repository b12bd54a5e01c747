"""Port parity: ``ServeSession``'s adaptation surface (the stats window,
``traffic_profile``, ``swap_table``, the overflow breaker, ``adapt_policy``
/ ``adapt_now``, ``decode_builds``) against ``repro.train.ServeSession``
on the same JAX-initialized 2-layer qwen2 (K 4, vocab 128, fp32).

Skewed traffic comes from ``testing.skew_gate``: a zero gate routes every
token to expert 0, and with B 8 slots at capacity factor 0.25 each expert
has one slot, so 7 of 8 tokens overflow. A zero gate also makes the
mitosis noise ``eps`` exactly 0 on both sides, so a whole adaptive session
can be held against ``repro``'s token for token. Tokens are compared
exactly; tables after ``convert.table_from_jax``, ids and rows exactly.
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
from repro.serve import AdaptPolicy as JAdaptPolicy
from repro.serve import repack_for_traffic as jrepack
from repro.testing import skew_gate as jskew_gate
from repro.train import Request as JRequest
from repro.train import SamplingParams as JSamplingParams
from repro.train import ServeSession as JServeSession
from repro_torch import configs
from repro_torch.convert import flatten_paths, params_from_jax
from repro_torch.core import dssoftmax as ds
from repro_torch.models import build
from repro_torch.serve import AdaptPolicy, repack_for_traffic
from repro_torch.testing import gamma_between, skew_gate
from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession
from test_torch_table_manager import HOT0, np_norms, profiles, same_table

VOCAB = 128
BREAKER_OFF = 1.1   # overflow_threshold > 1: the repair is the repack's alone


def _cfgs(cf):
    jbase, tbase = jget_config("qwen2-1.5b"), configs.get_config("qwen2-1.5b")
    jcfg = jreduce_config(jbase, vocab=VOCAB).replace(
        ds=jbase.ds.replace(num_experts=4, capacity_factor=cf), dtype="float32")
    tcfg = configs.reduce_config(tbase, vocab=VOCAB).replace(
        ds=tbase.ds.replace(num_experts=4, capacity_factor=cf), dtype="float32")
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _setup(cf=2.0):
    """repro's bundle/params/state and the port's on the same weights."""
    jcfg, tcfg = _cfgs(cf)
    jb = jbuild(jcfg)
    params, state = jb.init(jax.random.PRNGKey(0))
    tree = flatten_paths(jax.tree.map(np.asarray, params))
    tree["ds_state/mask"] = np.asarray(state.mask)
    tparams, tstate = params_from_jax(tree, tcfg, device="cpu")
    return jb, params, state, build(tcfg, device="cpu"), tparams, tstate


def _requests(cls, sp_cls, n=2, seed=0, max_new=8):
    rng = np.random.RandomState(seed)
    return [cls(prompt=rng.randint(0, VOCAB, rng.randint(4, 9)).astype(np.int32),
                sampling=sp_cls(max_new_tokens=max_new)) for _ in range(n)]


def _skew_gamma(state):
    """A re-prune threshold at the 0.3 quantile of the alive rows' norms."""
    jb, params, _, _, _, _ = _setup()
    return gamma_between(np_norms(np.asarray(params["head"]["experts"])),
                         np.asarray(state.mask), 0.3)


# ---------------------------------------------------------------------------
# swap_table: validation, and identity from the swap point
# ---------------------------------------------------------------------------

def test_swap_table_and_adapt_policy_validate():
    _, _, _, bundle, params, state = _setup()
    sess = ServeSession(bundle, params, state, n_slots=1, max_seq_len=16, kernel="jnp",
                        device="cpu")
    res = repack_for_traffic(params["head"], state, profiles(**HOT0)[1],
                             generator=torch.Generator().manual_seed(0))
    assert res.cloned == (0,) and res.table.ids.shape[0] == 5
    with pytest.raises(ValueError, match="gate and table swap as one pair"):
        sess.swap_table(res.table)
    with pytest.raises(ValueError, match="one versioned pair"):
        sess.swap_table(res.table, new_gate=params["head"]["gate"])
    with pytest.raises(ValueError, match="ServeTable"):
        sess.swap_table("not-a-table")
    assert sess.table_version == 0 and sess.stats()["decode_builds"] == 1
    with pytest.raises(ValueError, match="adapt_policy="):
        sess.adapt_now()
    with pytest.raises(ValueError, match="raw DS mask state"):
        ServeSession(bundle, params, ds.pack_experts(params["head"], state), n_slots=1,
                     max_seq_len=16, adapt_policy=AdaptPolicy(), device="cpu")


@functools.lru_cache(maxsize=None)
def _repro_midflight_swap():
    """repro: decode 3 steps, swap in a mitosed (noise 0) table off a hot
    window, drain. → (pre-swap tokens, all tokens, the new table)."""
    jb, params, state, _, _, _ = _setup()
    reqs = _requests(JRequest, JSamplingParams)
    sess = JServeSession(jb, params, state, n_slots=2, max_seq_len=32, kernel="jnp")
    for r in reqs:
        sess.submit(r)
    for _ in range(3):
        sess.step()
    pre = [list(r.out_tokens) for r in reqs]
    res = jrepack(params["head"], state, profiles(**HOT0)[0],
                  key=jax.random.PRNGKey(3), noise=0.0)
    sess.swap_table(res.table, new_gate=res.head_params["gate"],
                    capacity_factor=res.capacity_factor)
    while sess.step():
        pass
    assert sess.stats()["decode_builds"] == 2
    return pre, [list(r.out_tokens) for r in reqs], res.table


@pytest.mark.parametrize("kern", ["jnp", "grouped", "cuda_grouped"])
def test_hot_swap_identity_and_parity(kern):
    """Swap mid-flight: the streams equal repro's, and the post-swap suffix
    equals a fresh session on the new table replaying prompt ++ pre-swap
    tokens; one decode rebind for the swap."""
    jpre, jall, jtable = _repro_midflight_swap()
    _, _, _, bundle, params, state = _setup()
    max_new = 8
    reqs = _requests(Request, SamplingParams, max_new=max_new)
    sess = ServeSession(bundle, params, state, n_slots=2, max_seq_len=32, kernel=kern,
                        device="cpu")
    for r in reqs:
        sess.submit(r)
    for _ in range(3):
        sess.step()
    pre = [list(r.out_tokens) for r in reqs]
    assert pre == jpre and sess.traffic_profile() is not None
    res = repack_for_traffic(params["head"], state, profiles(**HOT0)[1],
                             generator=torch.Generator().manual_seed(3), noise=0.0)
    same_table(res.table, jtable)
    assert sess.swap_table(res.table, new_gate=res.head_params["gate"],
                           capacity_factor=res.capacity_factor) == 1
    assert sess.traffic_profile() is None and sess.stats()["window_steps"] == 0
    while sess.step():
        pass
    s = sess.stats()
    assert s["n_swaps"] == 1 and s["table_version"] == 1 and s["decode_builds"] == 2
    assert s["effective_capacity_factor"] == res.capacity_factor
    assert len(s["expert_dispatched_window"]) == 5
    assert [r.out_tokens for r in reqs] == jall
    fresh = ServeSession(bundle, dict(params, head=res.head_params), res.table, n_slots=2,
                         max_seq_len=32, kernel="jnp", device="cpu")
    refs = [Request(prompt=np.concatenate([r.prompt, np.asarray(p, np.int32)]),
                    sampling=SamplingParams(max_new_tokens=max_new - len(p)))
            for r, p in zip(reqs, pre)]
    fresh.run(refs)
    for r, p, f in zip(reqs, pre, refs):
        assert r.status is RequestStatus.COMPLETED and len(r.out_tokens) == max_new
        assert r.out_tokens[len(p):] == f.out_tokens


# ---------------------------------------------------------------------------
# the step-stamped window
# ---------------------------------------------------------------------------

WINDOW_KEYS = ("expert_dispatched", "expert_overflow", "expert_dispatched_window",
               "expert_overflow_window", "window_start_step", "window_end_step",
               "window_steps", "overflow_rate_window", "overflow_rate", "n_steps")


@functools.lru_cache(maxsize=None)
def _repro_window_stats():
    jb, params, state, _, _, _ = _setup()
    sess = JServeSession(jb, params, state, n_slots=2, max_seq_len=32, kernel="jnp",
                         stats_window=4)
    sess.run(_requests(JRequest, JSamplingParams, max_new=10))
    return {k: sess.stats()[k] for k in WINDOW_KEYS}


def test_stats_window_matches_repro():
    _, _, _, bundle, params, state = _setup()
    sess = ServeSession(bundle, params, state, n_slots=2, max_seq_len=32, kernel="jnp",
                        stats_window=4, device="cpu")
    sess.run(_requests(Request, SamplingParams, max_new=10))
    s = sess.stats()
    assert {k: s[k] for k in WINDOW_KEYS} == _repro_window_stats()
    assert s["window_steps"] == 4 and s["window_end_step"] == sess.n_steps
    assert s["window_end_step"] - s["window_start_step"] == 3
    prof = sess.traffic_profile()
    assert prof.steps == 4 and prof.n_experts == 4
    assert prof.dispatched.tolist() == s["expert_dispatched_window"]


# ---------------------------------------------------------------------------
# the online adaptation loop on skewed traffic
# ---------------------------------------------------------------------------

def _skewed_session(kern, policy, cf=0.25, max_new=16, **kw):
    _, _, _, bundle, params, state = _setup(cf)
    sess = ServeSession(bundle, skew_gate(params), state, n_slots=8, max_seq_len=40,
                        kernel=kern, overflow_threshold=BREAKER_OFF, adapt_policy=policy,
                        device="cpu", **kw)
    return sess, _requests(Request, SamplingParams, n=8, max_new=max_new)


@pytest.mark.parametrize("kern", ["grouped", "cuda_grouped"])
def test_adapt_loop_swaps_once_and_clears_overflow(kern):
    sess, reqs = _skewed_session(kern, AdaptPolicy(
        interval=6, min_window_steps=4, overflow_threshold=0.05,
        mitosis_overflow_threshold=0.1, max_swaps=1))
    sess.run(reqs)
    s = sess.stats()
    assert s["n_swaps"] == 1 and s["decode_builds"] == 2 and s["breaker_trips"] == 0
    assert s["overflow_rate_window"] == 0.0 and s["effective_capacity_factor"] > 0.25
    assert all(r.status is RequestStatus.COMPLETED and len(r.out_tokens) == 16 for r in reqs)


def test_adapt_now_lowers_the_window_overflow_rate():
    sess, reqs = _skewed_session("grouped", AdaptPolicy(interval=10_000, min_window_steps=4),
                                 max_new=24)
    assert sess.adapt_now() is False  # an empty window: nothing to adapt to
    for r in reqs:
        sess.submit(r)
    for _ in range(8):
        sess.step()
    before = sess.stats()["overflow_rate_window"]
    assert before == pytest.approx(7 / 8)
    assert sess.adapt_now() is True
    while sess.step():
        pass
    s = sess.stats()
    assert s["overflow_rate_window"] < before and s["n_swaps"] == 1


def test_adapt_loop_respects_max_swaps():
    sess, reqs = _skewed_session("grouped", AdaptPolicy(
        interval=2, min_window_steps=1, overflow_threshold=-1.0,
        mitosis_overflow_threshold=0.1, max_swaps=2), max_new=20)
    sess.run(reqs)
    s = sess.stats()
    assert s["n_swaps"] == 2 and s["decode_builds"] == 1 + 2
    # expert 0 cloned at the first swap; after it nothing overflows to clone
    assert sess.table.ids.shape[0] == 5
    assert all(r.status is RequestStatus.COMPLETED for r in reqs)


@functools.lru_cache(maxsize=None)
def _repro_adaptive_session(gamma):
    jb, params, state, _, _, _ = _setup(0.25)
    reqs = _requests(JRequest, JSamplingParams, n=8, max_new=16)
    sess = JServeSession(jb, jskew_gate(params), state, n_slots=8, max_seq_len=40,
                         kernel="grouped", overflow_threshold=BREAKER_OFF,
                         adapt_policy=JAdaptPolicy(interval=6, min_window_steps=4,
                                                   mitosis_overflow_threshold=0.1,
                                                   max_swaps=1, prune_gamma=gamma))
    sess.run(reqs)
    keys = ("n_swaps", "effective_capacity_factor", "decode_builds", "overflow_rate_window",
            "expert_dispatched", "expert_overflow")
    return [r.out_tokens for r in reqs], {k: sess.stats()[k] for k in keys}, sess.table


@pytest.mark.parametrize("kern", ["grouped", "cuda_grouped"])
def test_adaptive_session_matches_repro(kern):
    """The same skewed setup and policy (re-prune + mitosis) in both
    packages: identical tokens, swaps, capacity factor, telemetry and the
    swapped-in table (so the same experts cloned and rows pruned)."""
    _, _, _, _, _, state = _setup(0.25)
    gamma = _skew_gamma(state)
    jtokens, jstats, jtable = _repro_adaptive_session(gamma)
    sess, reqs = _skewed_session(kern, AdaptPolicy(
        interval=6, min_window_steps=4, mitosis_overflow_threshold=0.1, max_swaps=1,
        prune_gamma=gamma))
    sess.run(reqs)
    s = sess.stats()
    assert [r.out_tokens for r in reqs] == jtokens
    assert {k: s[k] for k in jstats} == jstats
    assert jstats["n_swaps"] == 1
    same_table(sess.table, jtable)
    assert sess.table.ids.shape[0] == 5  # expert 0 cloned
    assert s["rows_pruned"] == int(state.mask.sum()) - int(sess._ds_state.mask[:4].sum()) > 0


# ---------------------------------------------------------------------------
# the overflow breaker
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _repro_breaker():
    jb, params, state, _, _, _ = _setup(0.25)
    table = jds.pack_experts(params["head"], state)
    skewed = jskew_gate(params)
    sess = JServeSession(jb, skewed, table, n_slots=8, max_seq_len=32, kernel="grouped",
                         overflow_threshold=0.3, overflow_window=4)
    reqs = _requests(JRequest, JSamplingParams, n=8, seed=4, max_new=12)
    sess.run(reqs)
    keys = ("breaker_trips", "effective_kernel", "effective_capacity_factor",
            "decode_builds", "expert_dispatched", "expert_overflow", "overflow_rate")
    return [r.out_tokens for r in reqs], {k: sess.stats()[k] for k in keys}


@pytest.mark.parametrize("kern", ["grouped", "cuda_grouped"])
def test_overflow_breaker_trips_twice_like_repro(kern):
    """Trip 1 doubles the capacity factor (0.25 -> 0.5: one slot -> still
    one), trip 2 serves through 'cuda_fused' where repro takes 'jnp' (both
    uncapped); tokens, counters and trips stay repro's."""
    jtokens, jstats = _repro_breaker()
    _, _, _, bundle, params, state = _setup(0.25)
    skewed = skew_gate(params)
    reqs = _requests(Request, SamplingParams, n=8, seed=4, max_new=12)
    sess = ServeSession(bundle, skewed, state, n_slots=8, max_seq_len=32, kernel=kern,
                        overflow_threshold=0.3, overflow_window=4, device="cpu")
    sess.run(reqs)
    s = sess.stats()
    assert s["breaker_trips"] == 2 and s["effective_kernel"] == "cuda_fused"
    assert jstats["effective_kernel"] == "jnp"
    assert s["effective_capacity_factor"] == pytest.approx(0.5)
    assert s["decode_builds"] == 1 + 2
    assert {k: s[k] for k in jstats if k != "effective_kernel"} \
        == {k: v for k, v in jstats.items() if k != "effective_kernel"}
    assert [r.out_tokens for r in reqs] == jtokens
    plain = ServeSession(bundle, skewed, state, n_slots=8, max_seq_len=32, kernel="jnp",
                         overflow_window=2, device="cpu")
    ref_reqs = _requests(Request, SamplingParams, n=8, seed=4, max_new=12)
    plain.run(ref_reqs)
    assert [r.out_tokens for r in ref_reqs] == jtokens
    assert plain.stats()["breaker_trips"] == 0 and plain.stats()["overflow_rate"] == 0.0


# ---------------------------------------------------------------------------
# an int8 session stays quantized across a swap
# ---------------------------------------------------------------------------

CALIB = np.random.RandomState(5).randn(64, 64).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _repro_int8_adapt():
    jb, params, state, _, _, _ = _setup(0.25)
    sess = JServeSession(jb, jskew_gate(params), state, n_slots=8, max_seq_len=40,
                         kernel="grouped", overflow_threshold=BREAKER_OFF,
                         quantize="int8", quantize_calib=CALIB, quantize_flip_threshold=1.0,
                         adapt_policy=JAdaptPolicy(interval=10_000,
                                                   mitosis_overflow_threshold=0.1))
    reqs = _requests(JRequest, JSamplingParams, n=8, max_new=12)
    for r in reqs:
        sess.submit(r)
    for _ in range(4):
        sess.step()
    assert sess.adapt_now()
    sess.run()
    return [r.out_tokens for r in reqs], sess.stats()["quantize_report"], sess.table


@pytest.mark.parametrize("kern", ["grouped", "cuda_grouped"])
def test_int8_session_stays_quantized_across_a_swap(kern):
    jtokens, jreport, jtable = _repro_int8_adapt()
    sess, reqs = _skewed_session(kern, AdaptPolicy(interval=10_000,
                                                   mitosis_overflow_threshold=0.1),
                                 max_new=12, quantize="int8", quantize_calib=CALIB,
                                 quantize_flip_threshold=1.0)
    before = sess.stats()["quantize_report"]
    assert isinstance(sess.table, ds.QuantizedServeTable)
    for r in reqs:
        sess.submit(r)
    for _ in range(4):
        sess.step()
    assert sess.adapt_now()
    sess.run()
    s = sess.stats()
    assert isinstance(sess.table, ds.QuantizedServeTable) and sess.table.ids.shape[0] == 5
    assert len(before["per_expert_flip_rate"]) == 4
    assert s["quantize_report"] == jreport and len(jreport["per_expert_flip_rate"]) == 5
    same_table(sess.table, jtable)
    assert [r.out_tokens for r in reqs] == jtokens
