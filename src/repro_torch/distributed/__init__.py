"""Work on a mesh over ``torch.distributed`` (``repro.distributed``): the
placement rules for serving and training, the FSDP serving storage and its
per-layer gather, the train state's gather and gradient reduction, and the
one collective every path goes through. ``repro``'s XLA-only helpers
(``hints``, ``hlo_analysis``, ``roofline``) are not part of the port: the
port passes ``mesh=`` where ``repro`` reads an ambient mesh for its layout
hints."""
from repro_torch.distributed import sharding

__all__ = ["sharding"]
