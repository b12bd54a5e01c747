"""Fault injection for serving tests (``faults``, the port of
``repro.testing``), tie-safe pruning thresholds and the flash_attention
limit (``thresholds``), and a slot-split mesh session's decode emulated on
one device (``mesh_rows``)."""
from repro_torch.testing.faults import (
    CancelAfter,
    RaisingStreamCB,
    exhaust_pages,
    oversized_prompt,
    poison_cache_slot,
    poison_layer,
    poison_page,
    poison_token_embedding,
    release_hoarded_pages,
    skew_gate,
    swap_storm,
)
from repro_torch.testing.thresholds import (FP32_SAFE_GAP, flash_attention_limit,
                                           gamma_between)

__all__ = [
    "CancelAfter",
    "FP32_SAFE_GAP",
    "RaisingStreamCB",
    "exhaust_pages",
    "flash_attention_limit",
    "gamma_between",
    "oversized_prompt",
    "poison_cache_slot",
    "poison_layer",
    "poison_page",
    "poison_token_embedding",
    "release_hoarded_pages",
    "skew_gate",
    "swap_storm",
]
