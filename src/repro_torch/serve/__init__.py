"""Serving resources beside ``train/serve.py``: the versioned table and the
traffic-adaptive repack (``table_manager``). The paged cache is a later
slice."""
from repro_torch.serve.table_manager import (
    AdaptPolicy,
    RepackResult,
    TableResource,
    TrafficProfile,
    clone_selected,
    repack_for_traffic,
    suggested_capacity_factor,
)

__all__ = [
    "AdaptPolicy",
    "RepackResult",
    "TableResource",
    "TrafficProfile",
    "clone_selected",
    "repack_for_traffic",
    "suggested_capacity_factor",
]
