"""Config dataclasses for the models, the DS-Softmax head and training.

Plain frozen dataclasses, copied from ``repro.configs.base`` with the
fields the port reads. ``jdtype`` keeps its name from ``repro`` and is
the torch dtype of ``dtype`` here.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass(frozen=True)
class DSSoftmaxConfig:
    """Doubly-Sparse softmax head configuration (the paper's technique)."""

    num_experts: int = 8           # K
    lambda_lasso: float = 1.0      # group-lasso weight (tuned per task in paper)
    lambda_expert: float = 1.0     # expert-level lasso weight (== lambda_lasso in paper)
    lambda_load: float = 10.0      # load-balance CV^2 weight (fixed =10 in paper)
    gamma: float = 0.01            # pruning threshold on row l2 norm (fixed in paper)
    prune_task_loss_threshold: float = float("inf")  # prune only when task loss < t
    mask_mode: str = "zero"        # 'zero' (paper-faithful) | 'neg_inf' (beyond-paper)
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
class MoEConfig:
    """Token-choice MoE FFN configuration (for moe-family backbones)."""

    num_experts: int = 64
    top_k: int = 8
    d_ff_expert: int = 1024
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class VisionStubConfig:
    """Modality frontend stub: precomputed patch/frame embeddings."""

    num_patches: int = 256   # patches (vlm) or frames (audio) per example
    embed_dim: int = 0       # 0 => d_model


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"                 # dense | moe | vlm | ssm | hybrid | encdec
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: Optional[int] = None        # None => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5                # the Mamba2 block's gated norm
    tie_embeddings: bool = False
    act: str = "swiglu"                   # swiglu | gelu
    dtype: str = "bfloat16"
    # SSM (mamba2 / hybrid)
    ssm_state: int = 0                    # N (state dim); 0 => no ssm
    ssm_expand: int = 2                   # d_inner = expand * d_model
    ssm_headdim: int = 64                 # P
    ssm_ngroups: int = 1                  # B/C groups
    ssm_conv_width: int = 4
    ssm_chunk: int = 256                  # SSD chunk length
    # hybrid (zamba2-style): the shared attention block is applied after
    # every ``attn_period`` ssm layers
    attn_period: int = 6
    # enc-dec (whisper-style): encoder layers; ``n_layers`` counts the decoder's
    n_encoder_layers: int = 0
    moe: Optional[MoEConfig] = None       # the MoE FFN of a moe-family backbone
    vision: Optional[VisionStubConfig] = None  # the vlm family's patch-prefix stub
    head: str = "ds"                      # 'full' | 'ds'
    ds: DSSoftmaxConfig = field(default_factory=DSSoftmaxConfig)
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    # remat policy for train: 'none' | 'layer' (checkpoint each layer) |
    # 'dots' (each layer, saving its weight matmuls' outputs)
    remat: str = "layer"
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

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: a sequence length and a batch."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"          # constant | linear | cosine
    microbatches: int = 1             # gradient accumulation
    seed: int = 0
    # checkpointing (the default directory lies under the temp directory)
    ckpt_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 200
    keep_ckpts: int = 3
