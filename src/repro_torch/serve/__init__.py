"""Serving resources beside ``train/serve.py``: the versioned table and the
traffic-adaptive repack (``table_manager``), and the paged KV cache's
host-side page table (``paged_cache``)."""
from repro_torch.serve.paged_cache import (
    N_RESERVED,
    PAGE_GARBAGE,
    PAGE_ZERO,
    PagedCacheManager,
    PrefixEntry,
    WritePlan,
    prefix_hash,
)
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
    "N_RESERVED",
    "PAGE_GARBAGE",
    "PAGE_ZERO",
    "AdaptPolicy",
    "PagedCacheManager",
    "PrefixEntry",
    "RepackResult",
    "TableResource",
    "TrafficProfile",
    "WritePlan",
    "clone_selected",
    "prefix_hash",
    "repack_for_traffic",
    "suggested_capacity_factor",
]
