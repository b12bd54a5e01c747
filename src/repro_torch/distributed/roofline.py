"""Roofline terms of a traced step (``repro.distributed.roofline``'s
counterpart), on NVIDIA H100 SXM constants.

Per-rank costs (``distributed.hlo_analysis``) over one card's rates, in
seconds per step:

    compute = Σ over dtypes of matmul flops / peak rate of that dtype
    memory  = op bytes / HBM rate
    nvlink  = wire bytes of collectives inside a node / NVLink rate
    network = wire bytes of collectives across nodes / network rate

The step's bound is the largest term (``bottleneck`` names it). The rates
are specification figures, not measurements: the host this port was
measured on has one card, so no run here times an interconnect, and the
dense peaks are the ones ``chip_smoke.py``'s kernel bounds use.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional

# NVIDIA H100 SXM5 80GB, specification figures (dense, no sparsity)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}  # FLOP/s
HBM_BW = 3.35e12          # bytes/s, HBM3
NVLINK_BW = 450e9         # bytes/s per direction per card, NVLink 4 (18 links)
NETWORK_BW = 50e9         # bytes/s per card, one 400 Gb/s NDR InfiniBand port
HBM_BYTES = 80e9          # device memory, where no card is present to ask


@dataclass
class Roofline:
    flops: float                 # per rank
    hbm_bytes: float             # per rank: Σ op operand + result bytes
    coll_operand_bytes: float    # per rank
    coll_wire_bytes: float       # per rank (ring model), both fabrics
    coll_wire_bytes_nvlink: float
    coll_wire_bytes_network: float
    compute_s: float
    memory_s: float
    nvlink_s: float
    network_s: float
    bottleneck: str
    model_flops: Optional[float] = None   # 6·N·D (train) or 2·N·D (inference), global
    useful_ratio: Optional[float] = None  # model_flops / (flops · n_devices)
    coll_counts: Optional[dict] = None
    step_time_s: Optional[float] = None   # the largest term
    achievable_frac: Optional[float] = None  # model-flops time / step_time_s

    def to_dict(self):
        return asdict(self)


def roofline_from_cost(cost: dict, *, n_devices: int, model_flops: Optional[float] = None,
                       model_dtype: str = "bfloat16") -> Roofline:
    """The terms of ``cost`` (``hlo_analysis``'s dict for one rank of
    ``n_devices``). ``model_dtype``: the dtype whose peak sets the ideal
    time of ``model_flops``."""
    by_dtype = cost.get("flops_by_dtype") or {model_dtype: cost["flops"]}
    terms = {
        # each dtype's matmuls at its peak (fp32 products on the CUDA cores)
        "compute": sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"])
                       for dt, f in by_dtype.items()),
        "memory": cost["bytes"] / HBM_BW,
        "nvlink": cost.get("coll_wire_bytes_nvlink", 0.0) / NVLINK_BW,
        "network": cost.get("coll_wire_bytes_network", 0.0) / NETWORK_BW,
    }
    bottleneck = max(terms, key=terms.get)
    step = terms[bottleneck]
    useful = achievable = None
    if model_flops:
        useful = model_flops / max(1.0, cost["flops"] * n_devices)
        ideal = model_flops / (PEAK_FLOPS[model_dtype] * n_devices)
        achievable = ideal / step if step > 0 else None
    return Roofline(
        flops=cost["flops"],
        hbm_bytes=cost["bytes"],
        coll_operand_bytes=cost["coll_operand_bytes"],
        coll_wire_bytes=cost["coll_wire_bytes"],
        coll_wire_bytes_nvlink=cost.get("coll_wire_bytes_nvlink", 0.0),
        coll_wire_bytes_network=cost.get("coll_wire_bytes_network", 0.0),
        compute_s=terms["compute"],
        memory_s=terms["memory"],
        nvlink_s=terms["nvlink"],
        network_s=terms["network"],
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=useful,
        coll_counts=cost.get("coll_counts"),
        step_time_s=step,
        achievable_frac=achievable,
    )
