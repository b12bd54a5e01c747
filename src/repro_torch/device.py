"""Device selection shared by every entry point of the port.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Asking for ``cuda`` on a host without CUDA raises: nothing carries on
quietly on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` (str or torch.device) → a reachable ``torch.device``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch versions"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev


def check_on(dev: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on ``dev``'s device type."""
    for name, t in tensors.items():
        if t.device.type != dev.type:
            raise ValueError(f"{name} lies on {t.device}, expected {dev.type}")
