"""Baselines the paper compares against (§3, Tables 1–4), in plain PyTorch
(``repro``'s are plain ``jnp`` products; no kernel is involved).

* Full softmax: the O(N·d) reference.
* SVD-Softmax (Shim et al., 2017): post-approximation; preview logits from a
  width-W window of the SVD-rotated embedding, refine only the top-N_t
  preview candidates with the full dot product.
* D-Softmax (Chen et al., 2015): differentiated softmax; frequency-sorted
  vocabulary buckets use decreasing embedding widths (slices of h).

Every top-k takes ties to the lowest index (``ref.topk_stable``, as
``jax.lax.top_k``) and returns int32 ids.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ref import topk_stable


def _topk(z: torch.Tensor, k: int):
    vals, ids = topk_stable(z, k)
    return vals, ids.to(torch.int32)


# ---------------------------------------------------------------------------
# Full softmax
# ---------------------------------------------------------------------------

def full_topk(w: torch.Tensor, h: torch.Tensor, k: int):
    """w: (N, d), h: (B, d) → (values, ids) (B, k), fp32 logits."""
    return _topk(h.float() @ w.float().T, k)


def full_flops(n: int, d: int, batch: int = 1) -> int:
    return 2 * batch * n * d


# ---------------------------------------------------------------------------
# SVD-Softmax
# ---------------------------------------------------------------------------

class SVDSoftmax(NamedTuple):
    b_tilde: torch.Tensor  # (N, d) = U·S: rows in the importance-sorted column space
    v_t: torch.Tensor      # (d, d)
    window: int            # preview width W
    n_top: int             # candidates refined with the full width


def svd_build(w: torch.Tensor, window: int, n_top: int) -> SVDSoftmax:
    """Decompose a trained softmax W = U·S·Vᵀ (once, after training)."""
    u, s, vt = torch.linalg.svd(w.float(), full_matrices=False)
    return SVDSoftmax(b_tilde=u * s[None, :], v_t=vt, window=window, n_top=n_top)


def svd_topk(m: SVDSoftmax, h: torch.Tensor, k: int):
    """Two-stage preview/refine top-k. h: (B, d)."""
    h_rot = h.float() @ m.v_t.T                                     # (B, d)
    preview = h_rot[:, :m.window] @ m.b_tilde[:, :m.window].T       # (B, N)
    _, cand = topk_stable(preview, m.n_top)                         # (B, n_top)
    rows = m.b_tilde[cand]                                          # (B, n_top, d)
    exact = torch.einsum("btd,bd->bt", rows, h_rot)
    vals, pos = topk_stable(exact, k)
    return vals, torch.gather(cand, 1, pos).to(torch.int32)


def svd_flops(n: int, d: int, window: int, n_top: int, batch: int = 1) -> int:
    # rotation d² + preview N·W + refine N_t·d (per query, x2 for MAC)
    return 2 * batch * (d * d + n * window + n_top * d)


# ---------------------------------------------------------------------------
# D-Softmax
# ---------------------------------------------------------------------------

class DSoftmax(NamedTuple):
    """Frequency-bucketed embedding widths. blocks[i]: (n_i, d_i) reads
    h[:, :d_i] (nested prefix slices, as in differentiated softmax)."""

    blocks: tuple
    sizes: tuple
    dims: tuple


def dsoftmax_build(generator: torch.Generator, n: int, d: int, fractions: Sequence[float],
                   dims: Sequence[int], device="cuda") -> DSoftmax:
    """Seeded fp32 blocks on ``device``: bucket i holds round(f_i·n) classes
    (the last bucket the rest) at width dims[i], N(0, 1/dims[i])."""
    dev = resolve_device(device)
    sizes = [int(round(f * n)) for f in fractions]
    sizes[-1] = n - sum(sizes[:-1])
    blocks = tuple(torch.randn((sizes[i], dims[i]), generator=generator, device=dev)
                   / math.sqrt(dims[i]) for i in range(len(sizes)))
    return DSoftmax(blocks=blocks, sizes=tuple(sizes), dims=tuple(dims))


def dsoftmax_logits(m: DSoftmax, h: torch.Tensor) -> torch.Tensor:
    zs = [h[:, :dim].float() @ blk.T for blk, dim in zip(m.blocks, m.dims)]
    return torch.cat(zs, dim=1)


def dsoftmax_topk(m: DSoftmax, h: torch.Tensor, k: int):
    return _topk(dsoftmax_logits(m, h), k)


def dsoftmax_flops(m: DSoftmax, batch: int = 1) -> int:
    return 2 * batch * sum(n_i * d_i for n_i, d_i in zip(m.sizes, m.dims))
