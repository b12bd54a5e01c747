"""Post-training analysis of a learned DS-Softmax model (paper §3.7/§3.8),
over the port's :class:`~repro_torch.core.dssoftmax.DSState`: expert sizes,
redundancy, overlap, exclusive classes and the speedup accounting.

The mask may lie on any device; each function reads it to the host once
and computes in numpy, as ``repro.core.analysis`` does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import metrics
from repro_torch.core.dssoftmax import DSState


def _mask(state: DSState) -> np.ndarray:
    """The (K, N) bool mask on the host."""
    return state.mask.detach().cpu().numpy().astype(bool)


def expert_sizes(state: DSState) -> np.ndarray:
    return _mask(state).sum(axis=1)


def redundancy_histogram(state: DSState) -> dict[int, int]:
    """#experts-per-class histogram (paper Fig. 5b's y-axis)."""
    vals, counts = np.unique(_mask(state).sum(axis=0), return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}


def overlap_matrix(state: DSState) -> np.ndarray:
    """Jaccard overlap between experts' class sets (K, K)."""
    m = _mask(state).astype(np.float64)
    inter = m @ m.T
    sizes = m.sum(axis=1)
    union = sizes[:, None] + sizes[None, :] - inter
    return inter / np.maximum(union, 1.0)


def exclusive_classes(state: DSState, expert: int) -> np.ndarray:
    """Classes that live only in ``expert`` (the paper reads the smallest
    expert's exclusive words and finds semantic clusters)."""
    m = _mask(state)
    only = m[expert] & (m.sum(axis=0) == 1)
    return np.nonzero(only)[0]


def speedup_report(state: DSState, expert_choices: np.ndarray, vocab: Optional[int] = None,
                   v_pad: Optional[int] = None) -> dict:
    """The paper's speedup, the padded-table variant (with ``v_pad``) and
    the utilization CV the load loss controls."""
    m = _mask(state)
    sizes = m.sum(axis=1)
    K = sizes.shape[0]
    vocab = vocab or m.shape[1]
    util = metrics.utilization(expert_choices, K)
    out = {
        "paper_speedup": metrics.paper_speedup(vocab, sizes, util),
        "util_cv": float(np.std(util) / max(np.mean(util), 1e-12)),
        "mean_redundancy": float(m.sum(0).mean()),
        "expert_sizes": sizes,
        "utilization": util,
    }
    if v_pad:
        out["padded_speedup"] = metrics.padded_speedup(vocab, v_pad, K)
    return out
