"""Declarative kernel-policy registry for the serving top-k hot path.

Every ``serve_topk`` compute path registers a :class:`KernelSpec`
(capabilities, backend support, bytes-moved cost model), and
``serve_topk(kernel=...)`` takes a registered name, the policy name
``'auto'``, or any object with ``resolve(ctx) -> str``.

The names ``'jnp'`` and ``'grouped'`` are kept from ``repro`` so configs
and strings carry over; in the port both are plain PyTorch: ``'jnp'`` the
per-token gather (the oracle), ``'grouped'`` the expert-batched matmul.
``'cuda_grouped'`` and ``'cuda_fused'`` are the hand-written kernels and
run only on CUDA tensors.

The cost model is bytes moved, the formulas of ``repro``'s registry
without its TPU constants. The fused path is priced by what the port's
kernel reads: per token tile of ``dss_topk_fused.TOKEN_TILE`` tokens (not
the TPU's 128 rows), only the experts those tokens chose. The per-path rates behind these bytes are H100 measurements
still to be taken (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from repro_torch.kernels.dss_topk_fused import TOKEN_TILE as _FUSED_TILE

__all__ = [
    "KernelContext",
    "KernelSpec",
    "KernelPolicy",
    "FixedPolicy",
    "AutoPolicy",
    "register_kernel",
    "get_spec",
    "kernel_names",
    "resolve_kernel",
]


@dataclass(frozen=True)
class KernelContext:
    """Call-site shapes for kernel selection. ``backend`` is the device
    type of the hidden states (``'cpu'`` or ``'cuda'``); ``wbytes`` /
    ``hbytes`` are the element sizes of the table rows and of ``h``."""

    B: int
    d: int
    K: int
    v_pad: int
    k: int = 8
    backend: str = "cpu"
    capacity_factor: float = 2.0
    wbytes: int = 4
    hbytes: int = 4

    @property
    def capacity(self) -> int:
        """Per-expert slots of the grouped dispatch (as in
        ``core.dssoftmax._serve_topk_grouped``; Python's round)."""
        return int(max(1, round(self.B / self.K * self.capacity_factor)))

    @property
    def out_bytes(self) -> int:
        """fp32 values + int32 ids written — every path pays this."""
        return self.B * self.k * 8


@dataclass(frozen=True)
class KernelSpec:
    """One registered serve path: capabilities + bytes-moved cost model."""

    name: str
    description: str
    cost: Callable[[KernelContext], int] = field(compare=False)
    backends: Optional[Tuple[str, ...]] = None  # None => every device type
    fused: bool = False            # in-kernel gating (no dispatch pre-pass)

    def feasible(self, ctx: KernelContext) -> bool:
        return self.backends is None or ctx.backend in self.backends

    def bytes_moved(self, ctx: KernelContext) -> int:
        return int(self.cost(ctx))


_REGISTRY: dict[str, KernelSpec] = {}


def register_kernel(spec: KernelSpec) -> KernelSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"serve kernel {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def kernel_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get_spec(name: str) -> KernelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown serve kernel {name!r} "
            f"(expected one of {' | '.join(map(repr, _REGISTRY))}, "
            "a policy name like 'auto', or a KernelPolicy)"
        ) from None


class KernelPolicy:
    """Resolves a kernel name from call-site shapes."""

    def resolve(self, ctx: KernelContext) -> str:
        raise NotImplementedError


class FixedPolicy(KernelPolicy):
    """Always the same (validated) kernel."""

    def __init__(self, name: str):
        self.name = get_spec(name).name

    def resolve(self, ctx: KernelContext) -> str:
        return self.name


class AutoPolicy(KernelPolicy):
    """Cheapest feasible path by the bytes-moved model (ties by name).
    Pass ``history=[]`` to record ``(B, chosen)`` per resolution."""

    def __init__(self, history: Optional[List[Tuple[int, str]]] = None):
        self.history = history

    def resolve(self, ctx: KernelContext) -> str:
        feasible = [s for s in _REGISTRY.values() if s.feasible(ctx)]
        if not feasible:
            raise ValueError(f"no serve kernel supports backend {ctx.backend!r}")
        best = min(feasible, key=lambda s: (s.bytes_moved(ctx), s.name))
        if self.history is not None:
            self.history.append((ctx.B, best.name))
        return best.name


_POLICIES: dict[str, KernelPolicy] = {}


def resolve_kernel(kernel, ctx: KernelContext) -> str:
    """str | KernelPolicy → validated registered kernel name."""
    if isinstance(kernel, KernelPolicy):
        return get_spec(kernel.resolve(ctx)).name
    if isinstance(kernel, str):
        if kernel in _POLICIES:
            return get_spec(_POLICIES[kernel].resolve(ctx)).name
        return get_spec(kernel).name
    raise TypeError(
        f"kernel must be a registered name, policy name, or KernelPolicy; "
        f"got {type(kernel).__name__}"
    )


# ---------------------------------------------------------------------------
# The serve paths. wb/hb = weight/hidden bytes; every formula ends with the
# O(B·k) outputs.
# ---------------------------------------------------------------------------

def _cost_jnp(c: KernelContext) -> int:
    # Expert rows re-read once per TOKEN, plus the (B, V_pad, d) gather
    # materialized before the product (write + re-read).
    return 2 * c.B * c.v_pad * c.d * c.wbytes + c.B * c.d * c.hbytes + c.out_bytes


def _cost_grouped(c: KernelContext) -> int:
    # Rows once per EXPERT, the grouped buffers' round trip, and the
    # (K, C, V_pad) fp32 logits written and read back for the top-k.
    return (c.K * c.v_pad * c.d * c.wbytes
            + 2 * c.K * c.capacity * c.d * c.hbytes
            + 2 * c.K * c.capacity * c.v_pad * 4 + c.out_bytes)


def _cost_cuda_grouped(c: KernelContext) -> int:
    # Rows once per expert + the grouped buffers' round trip; logits and
    # the running top-k stay on chip.
    return (c.K * c.v_pad * c.d * c.wbytes
            + 2 * c.K * c.capacity * c.d * c.hbytes
            + c.K * c.capacity * c.k * 8 + c.out_bytes)


def _cost_cuda_fused(c: KernelContext) -> int:
    # Gating in the kernel: no dispatch round trip. Each token tile reads
    # only the experts its tokens chose, at most min(tokens in tile, K)
    # of them; plus the gate matrix and the (B,) expert ids.
    reads = sum(min(_FUSED_TILE, c.B - t, c.K) for t in range(0, c.B, _FUSED_TILE))
    return (reads * c.v_pad * c.d * c.wbytes
            + c.K * c.d * c.wbytes + c.B * c.d * c.hbytes + c.B * 4 + c.out_bytes)


register_kernel(KernelSpec(
    name="jnp",
    description="per-token gather + product in plain PyTorch (oracle)",
    cost=_cost_jnp,
))
register_kernel(KernelSpec(
    name="grouped",
    description="expert-batched weight-stationary product in plain PyTorch",
    cost=_cost_grouped,
))
register_kernel(KernelSpec(
    name="cuda_grouped",
    description="gate_top1 + expert-grouped CUDA retrieval kernel",
    cost=_cost_cuda_grouped,
    backends=("cuda",),
))
register_kernel(KernelSpec(
    name="cuda_fused",
    description="single-launch gate→dispatch→retrieve CUDA decode kernel",
    cost=_cost_cuda_fused,
    backends=("cuda",),
    fused=True,
))

_POLICIES["auto"] = AutoPolicy()
