"""Config dataclasses for the models and the DS-Softmax head.

Plain frozen dataclasses, copied from ``repro.configs.base`` with the
fields this slice reads. ``jdtype`` keeps its name from ``repro`` and is
the torch dtype of ``dtype`` here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass(frozen=True)
class DSSoftmaxConfig:
    """Doubly-Sparse softmax head configuration (the paper's technique)."""

    num_experts: int = 8           # K
    # Serving: padded active-set size per expert. None => the largest
    # expert rounded up to a multiple of 128.
    serve_pad: Optional[int] = None
    # serve compute path: a kernel name registered in
    # repro_torch.kernels.registry or a policy name ('auto').
    serve_kernel: str = "auto"
    # Grouped serve paths: per-expert capacity = B/K * capacity_factor;
    # overflowing tokens fall back to the exact gather path.
    capacity_factor: float = 2.0

    def replace(self, **kw) -> "DSSoftmaxConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: Optional[int] = None        # None => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    act: str = "swiglu"                   # swiglu | gelu
    dtype: str = "bfloat16"
    head: str = "ds"                      # 'full' | 'ds'
    ds: DSSoftmaxConfig = field(default_factory=DSSoftmaxConfig)
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    pad_vocab_to: int = 512

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def padded_vocab(self) -> int:
        m = max(1, self.pad_vocab_to)
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def jdtype(self) -> torch.dtype:
        """The torch dtype named by ``dtype``."""
        return getattr(torch, self.dtype)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: a sequence length and a batch."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'
