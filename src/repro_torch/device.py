"""Device selection shared by every entry point of the port.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Asking for ``cuda`` on a host without CUDA raises: nothing carries on
quietly on the CPU. The dry-run (``launch.dryrun``) traces the card's path
on ``meta`` tensors, shapes without memory: the model build and the kernel
wrappers admit ``meta`` (``resolve_device(..., meta=True)``), and
:func:`on_card` sends a meta tensor down the path a CUDA tensor takes.
The hand-written kernels are forward-only: their wrappers raise
(:func:`check_forward_only`) rather than return a result autograd cannot
differentiate.
"""
from __future__ import annotations

import torch


def resolve_device(device, meta: bool = False) -> torch.device:
    """``device`` (str or torch.device) → a reachable ``torch.device``.
    ``meta=True`` also admits ``'meta'`` (the dry-run's abstract build)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch versions"
            )
    elif dev.type != "cpu" and not (meta and dev.type == "meta"):
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's path where CUDA and CPU tensors part
    (the kernels, bf16 products with fp32 outputs): a CUDA tensor, or a
    meta tensor, which the dry-run traces as the card would run it."""
    return t.is_cuda or t.is_meta


def check_on(dev: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on ``dev``'s device type."""
    for name, t in tensors.items():
        if t.device.type != dev.type:
            raise ValueError(f"{name} lies on {t.device}, expected {dev.type}")


def check_forward_only(kernel: str, **tensors) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad: the
    kernel ``kernel`` has no backward, and a result without a ``grad_fn``
    would silently cut the gradient. ``None`` entries are skipped."""
    if not torch.is_grad_enabled():
        return
    needs = [name for name, t in tensors.items() if t is not None and t.requires_grad]
    if needs:
        raise RuntimeError(
            f"{kernel} is a forward-only kernel, but {', '.join(needs)} require grad with "
            "grad mode on; call it under torch.no_grad() or use the differentiable "
            "plain version (training takes the plain attention and head loss)")
