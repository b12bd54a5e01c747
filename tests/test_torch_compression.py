"""``repro_torch.optim.compression`` against ``repro.optim.compression`` on the
same seeded inputs, bit for bit: the int8 quantization and its inverse, the
error-feedback step carried over several rounds, top-k sparsification (ties
broken to the lower index, as ``jax.lax.top_k`` breaks them), the zero
residuals, and the compressed all-reduce computed per rank in a 4-rank
``gloo`` world (the whole world and two 2-rank groups), held against
``repro``'s ``psum``/``pmax`` under ``jax.vmap`` with a named axis."""
import json
import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import compression as jc
from repro_torch.optim import compression as tc

SHAPES = [(7,), (33, 65), (4, 8, 16)]
GROUPS = {"world": [0, 1, 2, 3], "pair0": [0, 1], "pair1": [2, 3]}


def _grad(seed, shape, dtype="float32"):
    """A seeded gradient with a spread of magnitudes, some exact ties and
    zeros, as numpy (bf16 as ``ml_dtypes``)."""
    rng = np.random.RandomState(seed)
    g = (rng.randn(*shape) * np.exp(rng.randn(*shape))).astype(np.float32)
    flat = g.reshape(-1)
    flat[::5] = 0.75
    flat[1::7] = -0.75
    flat[2::11] = 0.0
    return g.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else g


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(t, j):
    """Bit for bit: equal values of equal dtypes (fp32 compared as bits)."""
    a, b = t.numpy(), np.asarray(j)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_compress_int8_and_back_bit_for_bit(shape, dtype):
    g = _grad(0, shape, dtype)
    q, s = tc.compress_int8(_t(g))
    jq, js = jc.compress_int8(jnp.asarray(g))
    _same(q, jq)
    _same(s, js)
    _same(tc.decompress_int8(q, s), jc.decompress_int8(jq, js))


def test_compress_int8_of_zeros_takes_the_floor_scale():
    q, s = tc.compress_int8(torch.zeros(5))
    jq, js = jc.compress_int8(jnp.zeros(5))
    _same(q, jq)
    _same(s, js)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_with_feedback_over_rounds(dtype):
    """Four rounds, the residual carried on each side: q, scale and the new
    residual equal every round."""
    params = {"a": torch.zeros(33, 65), "b": {"c": torch.zeros(7)}}
    st = tc.init_compression(params)
    jst = jc.init_compression({"a": jnp.zeros((33, 65)), "b": {"c": jnp.zeros(7)}})
    _same(st.residual["a"], jst.residual["a"])
    _same(st.residual["b"]["c"], jst.residual["b"]["c"])
    r, jr = st.residual["a"], jst.residual["a"]
    for i in range(4):
        g = _grad(10 + i, (33, 65), dtype)
        q, s, r = tc.compress_with_feedback(_t(g), r)
        jq, js, jr = jc.compress_with_feedback(jnp.asarray(g), jr)
        _same(q, jq)
        _same(s, js)
        _same(r, jr)


@pytest.mark.parametrize("frac", [0.001, 0.05, 0.3, 1.0])
@pytest.mark.parametrize("shape", SHAPES)
def test_topk_sparsify_ties_like_lax_top_k(shape, frac):
    """The kept set among exact ties (the ±0.75 entries) is the lowest
    indices, as ``jax.lax.top_k`` keeps them; kept and residual bit for bit
    over two rounds."""
    r = torch.zeros(shape)
    jr = jnp.zeros(shape)
    for i in range(2):
        g = _grad(20 + i, shape)
        kept, r = tc.topk_sparsify(_t(g), r, frac)
        jkept, jr = jc.topk_sparsify(jnp.asarray(g), jr, frac)
        _same(kept, jkept)
        _same(r, jr)


# ---------------------------------------------------------------------------
# The compressed all-reduce, per rank
# ---------------------------------------------------------------------------

def _worker(out_dir, store):
    import torch.distributed as dist

    from repro_torch.launch.mesh import destroy, init_distributed

    torch.set_num_threads(1)
    init_distributed("cpu", store=store)
    rank = dist.get_rank()
    groups = {name: (dist.new_group(ranks) if name != "world" else None, ranks)
              for name, ranks in GROUPS.items()}
    out = {}
    for name, (group, ranks) in groups.items():
        if rank not in ranks:
            continue
        for shape in SHAPES:
            g = _grad(100 + rank, shape)
            got = tc.compressed_allreduce_int8(_t(g), group)
            out[f"{name}/{shape}"] = got.numpy().view(np.int32).tolist()
    destroy()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from _spmd import python_argv, start_world, wait_world

    d = tmp_path_factory.mktemp("compression")
    wait_world(start_world(python_argv(__file__, str(d)), 4, store_dir=str(d)), timeout=300)
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(4)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("group", list(GROUPS))
def test_compressed_allreduce_per_rank_equals_repro(ranks, group, shape):
    """Every rank of the group gets ``repro``'s result bit for bit: the
    int32 sum of the ranks' int8 values times the group's largest scale."""
    members = GROUPS[group]
    stack = jnp.asarray(np.stack([_grad(100 + r, shape) for r in members]))
    want = jax.vmap(lambda g: jc.compressed_allreduce_int8(g, "r"), axis_name="r")(stack)
    for i, r in enumerate(members):
        got = np.asarray(ranks[r][f"{group}/{shape}"], dtype=np.int32).reshape(shape)
        np.testing.assert_array_equal(got, np.asarray(want[i]).view(np.int32))


if __name__ == "__main__":
    _worker(*sys.argv[1:])
