"""Fault injection for serving tests (``faults``), tie-safe pruning
thresholds and the flash_attention limit (``thresholds``); the chaos
harness of ``repro.testing`` is a later slice."""
from repro_torch.testing.faults import skew_gate
from repro_torch.testing.thresholds import (FP32_SAFE_GAP, flash_attention_limit,
                                           gamma_between)

__all__ = ["FP32_SAFE_GAP", "flash_attention_limit", "gamma_between", "skew_gate"]
