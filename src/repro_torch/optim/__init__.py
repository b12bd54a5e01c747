from repro_torch.optim.adam import OptState, adam_init, adam_update
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.compression import (
    CompressionState,
    compress_int8,
    compress_with_feedback,
    compressed_allreduce_int8,
    decompress_int8,
    init_compression,
    topk_sparsify,
)
from repro_torch.optim.schedules import make_schedule

__all__ = [
    "OptState",
    "adam_init",
    "adam_update",
    "clip_by_global_norm",
    "make_schedule",
    "CompressionState",
    "init_compression",
    "compress_int8",
    "decompress_int8",
    "compress_with_feedback",
    "compressed_allreduce_int8",
    "topk_sparsify",
]
