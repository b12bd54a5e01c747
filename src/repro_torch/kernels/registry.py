"""Declarative kernel-policy registry for the serving top-k hot path.

Every ``serve_topk`` compute path registers a :class:`KernelSpec`
(capabilities, backend support, bytes-moved cost model), and
``serve_topk(kernel=...)`` takes a registered name, the policy name
``'auto'``, or any object with ``resolve(ctx) -> str``.

The names ``'jnp'`` and ``'grouped'`` are kept from ``repro`` so configs
and strings carry over; in the port both are plain PyTorch: ``'jnp'`` the
per-token gather (the oracle), ``'grouped'`` the expert-batched matmul.
The hand-written kernel paths are renamed for their hardware and are
feasible only on CUDA tensors:

    repro (Pallas)      port (CUDA)
    'pallas'            'cuda_pertoken'   per-token kernel, fp tables only
    'pallas_grouped'    'cuda_grouped'
    'pallas_fused'      'cuda_fused'

A quantized table (``KernelContext.quantized``: int8 rows, ``wbytes``
1, plus a 4-byte fp32 scale per packed row that every formula prices)
is served only by specs with ``quantized_ok``; naming any other raises.

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
    ``hbytes`` are the element sizes of the table rows and of ``h``;
    ``quantized`` marks an int8 table with per-row fp32 scales."""

    B: int
    d: int
    K: int
    v_pad: int
    k: int = 8
    backend: str = "cpu"
    capacity_factor: float = 2.0
    wbytes: int = 4
    hbytes: int = 4
    quantized: bool = False

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
    quantized_ok: bool = True      # can serve int8 rows + per-row scales

    def feasible(self, ctx: KernelContext) -> bool:
        """Native on the call's backend and able to serve its table."""
        return ((self.backends is None or ctx.backend in self.backends)
                and (self.quantized_ok or not ctx.quantized))

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
    """str | KernelPolicy → validated registered kernel name. A name that
    cannot serve the call's quantized table raises ``ValueError``."""
    if isinstance(kernel, KernelPolicy):
        spec = get_spec(kernel.resolve(ctx))
    elif isinstance(kernel, str):
        spec = get_spec(_POLICIES[kernel].resolve(ctx) if kernel in _POLICIES else kernel)
    else:
        raise TypeError(
            f"kernel must be a registered name, policy name, or KernelPolicy; "
            f"got {type(kernel).__name__}"
        )
    if ctx.quantized and not spec.quantized_ok:
        raise ValueError(
            f"serve kernel {spec.name!r} cannot serve a quantized (int8) table: "
            "its kernel has no per-row scales operand; use 'cuda_fused', "
            "'cuda_grouped', 'grouped', 'jnp' or 'auto'")
    return spec.name


# ---------------------------------------------------------------------------
# The serve paths. wb/hb = weight/hidden bytes; every formula ends with the
# O(B·k) outputs. An expert's rows cost ``_row_bytes`` per packed row: d
# elements, plus the fp32 scale on a quantized table.
# ---------------------------------------------------------------------------

def _row_bytes(c: KernelContext) -> int:
    return c.d * c.wbytes + (4 if c.quantized else 0)


def _cost_jnp(c: KernelContext) -> int:
    # Expert rows re-read once per TOKEN, plus the (B, V_pad, d) gather
    # (and the gathered scales) materialized before the product.
    return 2 * c.B * c.v_pad * _row_bytes(c) + c.B * c.d * c.hbytes + c.out_bytes


def _cost_grouped(c: KernelContext) -> int:
    # Rows once per EXPERT, the grouped buffers' round trip, and the
    # (K, C, V_pad) fp32 logits written and read back for the top-k.
    return (c.K * c.v_pad * _row_bytes(c)
            + 2 * c.K * c.capacity * c.d * c.hbytes
            + 2 * c.K * c.capacity * c.v_pad * 4 + c.out_bytes)


def _cost_cuda_grouped(c: KernelContext) -> int:
    # Rows once per expert + the grouped buffers' round trip; logits and
    # the running top-k stay on chip.
    return (c.K * c.v_pad * _row_bytes(c)
            + 2 * c.K * c.capacity * c.d * c.hbytes
            + c.K * c.capacity * c.k * 8 + c.out_bytes)


def _cost_cuda_fused(c: KernelContext) -> int:
    # Gating in the kernel: no dispatch round trip. Each token tile reads
    # only the experts its tokens chose, at most min(tokens in tile, K)
    # of them; plus the gate matrix and the (B,) expert ids.
    reads = sum(min(_FUSED_TILE, c.B - t, c.K) for t in range(0, c.B, _FUSED_TILE))
    return (reads * c.v_pad * _row_bytes(c)
            + c.K * c.d * c.hbytes + c.B * c.d * c.hbytes + c.B * 4 + c.out_bytes)


def _cost_cuda_pertoken(c: KernelContext) -> int:
    # gate_top1 first (the gate matrix and h read, (B,) ids + g written),
    # the fold writes h_scaled, then every TOKEN reads its expert's rows
    # and ids and its h_scaled, ids and g: never below the fused path.
    gate = c.K * c.d * c.hbytes + c.B * c.d * c.hbytes + c.B * 8
    fold = 2 * c.B * c.d * c.hbytes
    return (gate + fold + c.B * c.v_pad * (_row_bytes(c) + 4)
            + c.B * c.d * c.hbytes + c.B * 8 + c.out_bytes)


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
register_kernel(KernelSpec(
    name="cuda_pertoken",
    description="gate_top1 + per-token CUDA retrieval kernel (g folded into h)",
    cost=_cost_cuda_pertoken,
    backends=("cuda",),
    quantized_ok=False,
))

_POLICIES["auto"] = AutoPolicy()
