"""The input-shape suite (one for every LM-family arch), as ``repro``'s."""
from __future__ import annotations

from repro_torch.configs.base import ShapeConfig

TRAIN_4K = ShapeConfig(name="train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig(name="prefill_32k", seq_len=32768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig(name="decode_32k", seq_len=32768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig(name="long_500k", seq_len=524288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shapes_for(family: str, sub_quadratic: bool) -> list[ShapeConfig]:
    """The shape cells an architecture family runs: ``long_500k`` only for
    sub-quadratic (ssm, hybrid) archs; no arch is encoder-only, so every
    one runs the decode shapes."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if sub_quadratic:
        out.append(LONG_500K)
    return out
