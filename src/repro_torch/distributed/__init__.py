"""Work on a mesh over ``torch.distributed`` (``repro.distributed``): the
placement rules for serving and training, the FSDP serving storage and its
per-layer gather, the train state's gather and gradient reduction, and the
one collective every path goes through; the dry-run's per-rank cost
counter over a traced step (``hlo_analysis``) and its H100 roofline
(``roofline``). ``repro``'s ``hints`` has no counterpart: the port passes
``mesh=`` where ``repro`` reads an ambient mesh for its layout hints."""
from repro_torch.distributed import sharding

__all__ = ["sharding"]
