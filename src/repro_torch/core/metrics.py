"""Speedup and FLOPs accounting as the paper defines them (numpy; a copy of
``repro.core.metrics``).

Paper §2.3 "Loading Balance": speedup = |V| / (Σ_k |v_k|·u_k + K), where
u_k is the share of queries expert k serves, measured on data. A serving
path that pads every expert to V_pad rows pays V_pad per query instead of
|v_{k*}|, so both are reported:

* ``paper_speedup``: the paper's formula (what a per-query branching
  implementation achieves; comparable to the paper's tables).
* ``padded_speedup``: |V| / (V_pad + K), the padded serve table's cost.
"""
from __future__ import annotations

import numpy as np


def utilization(expert_choices: np.ndarray, num_experts: int) -> np.ndarray:
    """u_k from a sample of top-1 expert choices."""
    counts = np.bincount(np.asarray(expert_choices).ravel(), minlength=num_experts)
    return counts / max(1, counts.sum())


def paper_speedup(vocab: int, expert_sizes: np.ndarray, util: np.ndarray) -> float:
    expert_sizes = np.asarray(expert_sizes, np.float64)
    util = np.asarray(util, np.float64)
    denom = float((expert_sizes * util).sum()) + len(expert_sizes)
    return vocab / max(denom, 1.0)


def padded_speedup(vocab: int, v_pad: int, num_experts: int) -> float:
    return vocab / float(v_pad + num_experts)


def softmax_flops(vocab: int, d: int, batch: int = 1) -> int:
    """Full softmax inference FLOPs (matmul dominated): 2·B·N·d."""
    return 2 * batch * vocab * d


def ds_flops(expert_sizes: np.ndarray, util: np.ndarray, d: int, num_experts: int,
             batch: int = 1) -> float:
    """Paper cost model: gate (2·K·d) + expected expert matmul (2·E[|v|]·d)."""
    exp_rows = float((np.asarray(expert_sizes) * np.asarray(util)).sum())
    return batch * (2 * num_experts * d + 2 * exp_rows * d)
