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
without its TPU constants. The fused path, the per-token path and the
grouped path at decode capacities are priced by what the port's streaming
retrieval reads: each
expert that holds a token, its rows once per group of
``retrieve_stream.token_group(d)`` of its tokens (not the TPU's 128 rows).
The grouped kernel's bodies are priced by what bounds each on the H100:
its bytes, or its operations at the rate of their unit (the tensor-core
body's bf16 products, the CUDA-core bodies' fp32 FMAs) expressed as the
bytes the memory moves in the same time, whichever is larger. On CUDA
tensors the plain ``grouped`` path adds its bmm's products over every slot
to its bytes, at the rate of the token dtype's unit.
``chip_smoke.py``'s head-path step times every exact path interleaved on
the H100 at B 1, 8, 64 and 2048 and fails if ``'auto'``'s pick takes more
than 1.5× the fastest.

Expert-parallel variants register as ``*_ep`` specs, one per base path
(``core.dssoftmax.serve_topk_sharded``): their memory price is the base
path's at the per-rank shapes (:meth:`KernelContext.local`: K/ep experts,
B/ndata token rows), and they add the merge's interconnect bytes, the
(B_loc, k) value and id carries of the other ep − 1 ranks, priced at
``ICI_HBM_BYTE_RATIO`` bytes of memory each. A sharded spec is feasible
only at ``ctx.ep > 1`` and a base spec only at ``ctx.ep == 1``, so a
policy never hands a sharded name to the single-device ``serve_topk``.
So every candidate of one call pays the same merge, and the merge's price
never changes ``AutoPolicy``'s pick: it makes the price the call's whole
cost (what :meth:`KernelSpec.price` reports), and would weigh only if a
path without the merge were feasible at ep > 1.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, List, Optional, Tuple

import functools
import importlib
import math

import torch

from repro_torch.kernels.retrieve_stream import token_group

_grouped = importlib.import_module("repro_torch.kernels.dss_topk_grouped")

# H100 SXM (NVIDIA data sheet, dense): the memory rate, and the peak rate of
# the units the grouped kernel's bodies compute on.
HBM_BYTES_PER_S = 3.35e12
TENSOR_BF16_OPS = 989e12
CUDA_CORE_FP32_OPS = 67e12
# NVLink 4 on the same card: 900 GB/s both directions together, 450 GB/s each
# way (NVIDIA data sheet). A merge carry crosses one way, so a byte of it
# costs HBM_BYTES_PER_S / NVLINK_BYTES_PER_S bytes of memory time (7.4).
# A data-sheet ratio: no run of this repo has had two cards.
NVLINK_BYTES_PER_S = 450e9
ICI_HBM_BYTE_RATIO = HBM_BYTES_PER_S / NVLINK_BYTES_PER_S

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
    "ICI_HBM_BYTE_RATIO",
]


@dataclass(frozen=True)
class KernelContext:
    """Call-site shapes for kernel selection. ``backend`` is the device
    type of the hidden states (``'cpu'`` or ``'cuda'``); ``wbytes`` /
    ``hbytes`` are the element sizes of the table rows and of ``h``;
    ``quantized`` marks an int8 table with per-row fp32 scales; ``ep`` and
    ``ndata`` are the call's expert-parallel degree (the mesh's ``model``
    axis) and token-split degree (its ``pod`` × ``data`` axes)."""

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
    ep: int = 1
    ndata: int = 1

    @property
    def capacity(self) -> int:
        """Per-expert slots of the grouped dispatch (as in
        ``core.dssoftmax._serve_topk_grouped``; Python's round)."""
        return int(max(1, round(self.B / self.K * self.capacity_factor)))

    @property
    def out_bytes(self) -> int:
        """fp32 values + int32 ids written — every path pays this."""
        return self.B * self.k * 8

    def local(self) -> "KernelContext":
        """What one rank's kernel sees inside ``serve_topk_sharded``: K/ep
        experts, B/ndata token rows, degrees 1. ``capacity_factor`` is
        scaled by 1/ep so that ``capacity`` is the runtime's: the sharded
        grouped dispatch sizes its buffers by the GLOBAL expert count."""
        return replace(self, B=-(-self.B // self.ndata), K=-(-self.K // self.ep),
                       capacity_factor=self.capacity_factor / self.ep, ep=1, ndata=1)


@dataclass(frozen=True)
class KernelSpec:
    """One registered serve path: capabilities + bytes-moved cost model.
    A ``sharded`` spec runs the base path ``local_name`` on each rank and
    adds the merge's interconnect bytes."""

    name: str
    description: str
    cost: Callable[[KernelContext], int] = field(compare=False)
    backends: Optional[Tuple[str, ...]] = None  # None => every device type
    fused: bool = False            # in-kernel gating (no dispatch pre-pass)
    quantized_ok: bool = True      # can serve int8 rows + per-row scales
    sharded: bool = False          # expert-parallel execution over a mesh
    local_name: Optional[str] = None  # the per-rank path a sharded spec runs

    def feasible(self, ctx: KernelContext) -> bool:
        """Native on the call's backend, matching its sharding (``*_ep``
        specs at ep > 1 only) and able to serve its table."""
        return ((self.backends is None or ctx.backend in self.backends)
                and self.sharded == (ctx.ep > 1)
                and (self.quantized_ok or not ctx.quantized))

    def bytes_moved(self, ctx: KernelContext) -> int:
        return int(self.cost(ctx))

    def ici_bytes(self, ctx: KernelContext) -> int:
        """Interconnect bytes this rank receives: the merge's carries, 0
        for a single-device path."""
        return _ici_merge(ctx) if self.sharded else 0

    def price(self, ctx: KernelContext) -> float:
        """Memory bytes plus the interconnect bytes at
        ``ICI_HBM_BYTE_RATIO`` bytes of memory time each."""
        return self.bytes_moved(ctx) + self.ici_bytes(ctx) * ICI_HBM_BYTE_RATIO


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
    """Cheapest feasible path by :meth:`KernelSpec.price` (ties by name).
    Pass ``history=[]`` to record ``(B, chosen)`` per resolution."""

    def __init__(self, history: Optional[List[Tuple[int, str]]] = None):
        self.history = history

    def resolve(self, ctx: KernelContext) -> str:
        feasible = [s for s in _REGISTRY.values() if s.feasible(ctx)]
        if not feasible:
            raise ValueError(f"no serve kernel supports backend {ctx.backend!r}")
        best = min(feasible, key=lambda s: (s.price(ctx), s.name))
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
    # (K, C, V_pad) fp32 logits written and read back for the top-k. On the
    # card the bmm also multiplies every slot, at the rate of the token
    # dtype's unit (as bytes the memory moves in the same time), before the
    # top-k reads its logits. The CPU price stays bytes. Both prices add the
    # gather fixup of the tokens that overflow (``expected_overflow``).
    nbytes = (c.K * c.v_pad * _row_bytes(c)
              + 2 * c.K * c.capacity * c.d * c.hbytes
              + 2 * c.K * c.capacity * c.v_pad * 4 + c.out_bytes
              + _fixup_bytes(c))
    if c.backend != "cuda":
        return nbytes
    rate = TENSOR_BF16_OPS if c.hbytes == 2 else CUDA_CORE_FP32_OPS
    return nbytes + int(2 * c.K * c.capacity * c.v_pad * c.d * HBM_BYTES_PER_S / rate)


def fused_expert_reads(B: int, K: int, d: int) -> int:
    """Passes of ``dss_topk_fused`` over an expert's rows, at most: each
    chosen expert once per group of ``token_group(d)`` of its tokens. With
    m experts chosen that is at most m + (B − m) // group, largest at
    m = min(B, K)."""
    m = min(B, K)
    return m + (B - m) // token_group(d)


def grouped_expert_reads(B: int, K: int, C: int, d: int) -> int:
    """Passes of the grouped decode body over an expert's rows, at most:
    each expert with a live slot once per group of ``token_group(d)`` of
    them. B tokens over at most min(B, K) experts give at most
    ``fused_expert_reads``; C slots per expert at most K·⌈C / group⌉."""
    return min(fused_expert_reads(B, K, d), K * -(-C // token_group(d)))


@functools.lru_cache(maxsize=256)
def tiled_live_tiles(B: int, K: int, C: int, n_tile: int) -> float:
    """Token tiles of ``n_tile`` slots per expert that a top-1 dispatch of B
    tokens at capacity C leaves live, in expectation over a gate that picks
    each of the K experts with probability 1/K: an expert's slots fill from
    the first, so its tile j is live when more than j·n_tile tokens chose
    it, and the count X of its tokens is Binomial(B, 1/K). At B 2048, K 16,
    C 256 that is 23.6 of 32 tiles, not the 16 of a balanced dispatch."""
    tiles = -(-C // n_tile)
    if K == 1:
        return float(-(-min(B, C) // n_tile))
    lp, lq = math.log(1.0 / K), math.log1p(-1.0 / K)
    cdf, live = 0.0, 0.0
    for j in range(tiles):
        lo = j * n_tile  # tile j is live when X > lo
        if lo >= B:
            break
        for x in range(0 if j == 0 else (j - 1) * n_tile + 1, lo + 1):
            cdf += math.exp(math.lgamma(B + 1) - math.lgamma(x + 1) - math.lgamma(B - x + 1)
                            + x * lp + (B - x) * lq)
        live += max(0.0, 1.0 - cdf)
    return K * live


@functools.lru_cache(maxsize=256)
def expected_overflow(B: int, K: int, C: int) -> float:
    """Tokens that a top-1 dispatch of B tokens at capacity C leaves over
    (the grouped paths send them through the exact gather fixup), in
    expectation over a gate that picks each of the K experts with
    probability 1/K: K·E[(X − C)⁺] with X ~ Binomial(B, 1/K). At
    qwen2-1.5b's verify step (B 40, K 16, C 5) 0.81 tokens, at B 64 (C 8)
    0.55; at B 2048 (C 256) none to within 1e-9."""
    if K == 1:
        return float(max(0, B - C))
    lp, lq = math.log(1.0 / K), math.log1p(-1.0 / K)
    over = 0.0
    for x in range(C + 1, B + 1):
        over += (x - C) * math.exp(math.lgamma(B + 1) - math.lgamma(x + 1)
                                   - math.lgamma(B - x + 1) + x * lp + (B - x) * lq)
    return K * over


def fixup_rows(c: KernelContext) -> int:
    """Packed rows the grouped paths' gather fixup reads, in expectation:
    each overflowed token (``expected_overflow``) reads its expert's
    V_pad rows."""
    return int(expected_overflow(c.B, c.K, c.capacity) * c.v_pad)


def _fixup_bytes(c: KernelContext) -> int:
    # the gather path (core/dssoftmax._exact_rows_logits): each row read,
    # gathered (written, read back), widened to fp32 (written, read by the
    # product)
    return fixup_rows(c) * (3 * _row_bytes(c) + 8 * c.d)


def grouped_body(c: KernelContext) -> str:
    """The grouped kernel's body for the call (``dss_topk_grouped.select_body``
    by capacity and token dtype; data pointers are taken as TMA-aligned)."""
    dtype = torch.bfloat16 if c.hbytes == 2 else torch.float32
    wdtype = torch.int8 if c.quantized else dtype
    return _grouped.select_body(c.capacity, dtype,
                                dtype != torch.bfloat16 or _grouped.tma_addressable(c.d, wdtype))


def _cost_cuda_grouped(c: KernelContext) -> int:
    # The grouped buffers' round trip and the (K, C, k) outputs gathered
    # back; logits and the running top-k stay on chip. The decode body
    # reads the live experts' rows once per token group and multiplies the
    # live slots only; the tensor-core body reads every expert's rows once
    # per token tile and multiplies every slot; the tiled body reads the
    # rows once per token tile that holds a live slot and multiplies those
    # tiles whole (``tiled_live_tiles``: the tiles a top-1 dispatch of B
    # tokens leaves live). Operations count as the bytes the memory moves
    # in their time at the body's unit. The tokens that overflow their
    # expert's capacity (``expected_overflow``) go through the gather
    # fixup after the kernel.
    C, body = c.capacity, grouped_body(c)
    if body == _grouped.DECODE:
        reads = grouped_expert_reads(c.B, c.K, C, c.d)
        flops, rate = 2 * min(c.B, c.K * C) * c.v_pad * c.d, CUDA_CORE_FP32_OPS
    elif body == _grouped.WGMMA:
        reads = c.K * _grouped.wgmma_plan(c.K, C, c.v_pad, c.k, c.quantized).token_tiles
        flops, rate = 2 * c.K * C * c.v_pad * c.d, TENSOR_BF16_OPS
    else:
        n_tile = _grouped.tiled_plan(c.K, C, c.v_pad, c.k, c.quantized).n_tile
        reads = tiled_live_tiles(c.B, c.K, C, n_tile)
        flops, rate = 2 * reads * n_tile * c.v_pad * c.d, CUDA_CORE_FP32_OPS
    nbytes = (reads * c.v_pad * _row_bytes(c) + 2 * c.K * C * c.d * c.hbytes
              + c.K * C * c.k * 8 + c.out_bytes)
    return int(max(nbytes, flops * HBM_BYTES_PER_S / rate)) + _fixup_bytes(c)


def _cost_cuda_fused(c: KernelContext) -> int:
    # Gating in the kernel, once per token: no dispatch round trip. The
    # chosen experts' rows once per token group; the gate matrix, h, the
    # (B,) expert ids and gate values.
    return (fused_expert_reads(c.B, c.K, c.d) * c.v_pad * _row_bytes(c)
            + c.K * c.d * c.hbytes + c.B * c.d * c.hbytes + c.B * 8 + c.out_bytes)


def _cost_cuda_pertoken(c: KernelContext) -> int:
    # gate_top1 first (the gate matrix and h read, (B,) ids + g written),
    # the fold (h and g read, h_scaled written), then the streaming
    # retrieval: the experts that hold a token once per token group, as the
    # fused path reads them, h_scaled and the (B,) expert ids. The same rows
    # as the fused path plus the gate's and the fold's round trips, so never
    # below it.
    gate = c.K * c.d * c.hbytes + c.B * c.d * c.hbytes + c.B * 8
    fold = 2 * c.B * c.d * c.hbytes + c.B * 4
    return (gate + fold + fused_expert_reads(c.B, c.K, c.d) * c.v_pad * _row_bytes(c)
            + c.B * c.d * c.hbytes + c.B * 4 + c.out_bytes)


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


# --- expert-parallel variants (core.dssoftmax.serve_topk_sharded) ----------
#
# Memory: the base path at the per-rank shapes (ctx.local(); a per-token
# local path still streams the rows of every token it holds, owned or not).
# Interconnect: the merge's all-gather brings this rank the other ep − 1
# ranks' (B_loc, k) fp32 value and int32 id carries.

def _ici_merge(c: KernelContext) -> int:
    return (c.ep - 1) * -(-c.B // c.ndata) * c.k * 8


def _register_sharded(base: KernelSpec) -> None:
    register_kernel(KernelSpec(
        name=f"{base.name}_ep",
        description=f"expert-parallel '{base.name}' (K/ep experts per rank, "
                    "O(B·k) all-gather merge)",
        cost=lambda c, _b=base: _b.cost(c.local()),
        backends=base.backends,
        fused=base.fused,
        quantized_ok=base.quantized_ok,
        sharded=True,
        local_name=base.name,
    ))


for _base in list(_REGISTRY.values()):
    _register_sharded(_base)

_POLICIES["auto"] = AutoPolicy()
