"""The launch plan of the streaming retrieval (``csrc/retrieve_stream.cuh``).

The fused decode kernel, the decode body of the grouped kernel and the
per-token kernel share one retrieval: a grid fixed by the shapes
(``BLOCKS_PER_SM`` blocks on each SM) walks a work list that the kernel
builds on the device, the experts that hold a token cut into row chunks
(:func:`chunk_rows`, which mirrors the kernel's ``chunk_rows_for``). The
constants mirror the kernel's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

TOKEN_GROUP = 8    # most tokens staged per pass over a row chunk (kTB)
TOKEN_BYTES = 40 * 1024  # shared memory for the staged fp32 tokens (kTokenBytes)
ROW_STEP = 16      # chunk lengths are multiples of this (kRowStep)
MAX_CHUNK_ROWS = 1024  # a chunk's ids and scales sit in shared memory (kMaxChunkRows)
BLOCKS_PER_SM = 2  # retrieval blocks resident on each SM


class StreamPlan(NamedTuple):
    """The retrieval launch: ``grid`` blocks walking the (expert, row chunk)
    work list that the kernel builds on the device; ``max_chunks`` row
    chunks of one expert at most (the partial lists' first dimension);
    row loads of ``vec_bytes``."""

    grid: int
    max_chunks: int
    vec_bytes: int


def token_group(d: int) -> int:
    """Tokens one pass over a row chunk serves: as many fp32 rows of d as
    ``TOKEN_BYTES`` holds, 1 to ``TOKEN_GROUP``."""
    return min(TOKEN_GROUP, max(1, TOKEN_BYTES // (4 * d)))


def chunk_rows(n_sel: int, v_pad: int, grid: int) -> int:
    """Rows per chunk when ``n_sel`` experts with tokens share ``grid``
    blocks: each gets ``grid // n_sel`` of them (``chunk_rows_for`` in the
    .cuh, which runs this on the device once it has counted the experts)."""
    per = max(1, grid // max(1, n_sel))
    rows = -(-(-(-v_pad // per)) // ROW_STEP) * ROW_STEP
    return min(MAX_CHUNK_ROWS, max(ROW_STEP, rows))


def row_vec_bytes(d: int, elem: int, ptr: int = 0) -> int:
    """Bytes per row load: 16 or 4 where the row pitch ``d·elem`` and the
    base address allow it, else one element."""
    for vb in (16, 4):
        if vb >= elem and (d * elem) % vb == 0 and ptr % vb == 0:
            return vb
    return elem


def stream_plan(slots: int, v_pad: int, d: int, wdtype: torch.dtype) -> StreamPlan:
    """The launch from the shapes alone, when at most ``slots`` experts can
    hold a token: ``BLOCKS_PER_SM`` blocks on each SM, or fewer where
    ``slots`` experts of ``ROW_STEP``-row chunks cannot use them. Whatever
    number of experts hold tokens, the kernel splits their rows over the
    same grid."""
    slots = max(1, slots)
    grid = min(BLOCKS_PER_SM * _build.SMS, slots * -(-v_pad // ROW_STEP))
    max_chunks = -(-v_pad // chunk_rows(1, v_pad, grid))
    elem = torch.empty((), dtype=wdtype).element_size()
    return StreamPlan(grid, max_chunks, row_vec_bytes(d, elem))
