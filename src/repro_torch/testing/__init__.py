"""Fault injection for serving tests (``faults``) and tie-safe pruning
thresholds (``thresholds``); the chaos harness of ``repro.testing`` is a
later slice."""
from repro_torch.testing.faults import skew_gate
from repro_torch.testing.thresholds import FP32_SAFE_GAP, gamma_between

__all__ = ["FP32_SAFE_GAP", "gamma_between", "skew_gate"]
