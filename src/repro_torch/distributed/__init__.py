"""Serving on a mesh over ``torch.distributed`` (the serving half of
``repro.distributed``): the placement rules, the FSDP serving storage and
its per-layer gather, and the one collective every serving path goes
through. ``repro``'s XLA-only helpers (``hints``, ``hlo_analysis``,
``roofline``) are not part of the port."""
from repro_torch.distributed import sharding

__all__ = ["sharding"]
