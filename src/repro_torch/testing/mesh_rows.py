"""A slot-split mesh session's decode, emulated on one device: the data rows
of a mesh whose batch ranks split the slots, stepped one after another.

A mesh ``ServeSession`` whose ``n_rows`` data rows divide its slots holds,
on the ranks of row r, only slots ``[r·n/n_rows, (r+1)·n/n_rows)`` in a cache
of their own (``distributed.sharding.serve_cache_block``), steps their
backbone, and merges the rows' head outputs in row order. One card cannot
run two ranks, so :func:`decode_data_rows` runs each row's block in turn on
this device, each against its own block cache, and concatenates the rows'
``(vals, ids)`` as the merge returns them. ``n_rows=1`` is the whole-cache
session's step, so the two are held against each other.
"""
from __future__ import annotations

import types
from typing import List

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.models import heads
from repro_torch.models.model_zoo import cache_kv_leaves, cache_specs


def row_mesh(n_rows: int, row: int):
    """A stand-in for the mesh as rank (``row``, model 0) of an
    ``n_rows`` x 1 mesh sees it: what the placement rules and
    ``serve_cache_block`` read."""
    return types.SimpleNamespace(shape={"data": n_rows, "model": 1},
                                 get_local_rank=lambda axis: row if axis == "data" else 0)


def decode_data_rows(bundle, params, table, prompts: List[np.ndarray], *, n_rows: int,
                     new_tokens: int, max_seq_len: int, k: int = 8, kernel=None,
                     device="cuda"):
    """Greedy decode of one prompt a slot (``len(prompts)`` slots, each
    prefilled whole) with the slots split over ``n_rows`` data rows, the
    rows stepped one after another on ``device``: each step, per row,
    ``bundle.decode_hidden`` over the row's slots against its block cache,
    then ``heads.head_topk`` over its rows; the rows' outputs concatenated.
    → a namespace: ``tokens`` [slot] (``new_tokens`` ids), ``heads``
    [slot][emission] ((k,) vals, (k,) ids) and ``gates`` [slot][emission]
    ((K,) gate probabilities of a DS head, else None) on the host, and
    ``caches`` (one a row)."""
    from repro_torch.train.serve import ServeSession, _zeros

    cfg, n = bundle.cfg, len(prompts)
    dev = torch.device(device)
    blocks = [sharding.serve_cache_block(row_mesh(n_rows, r), n) for r in range(n_rows)]
    if n_rows > 1 and not all(b.splits for b in blocks):
        raise ValueError(f"{n_rows} data rows do not split {n} slots")
    caches = [_zeros(cache_specs(cfg, ShapeConfig(name="rows", seq_len=max_seq_len,
                                                  global_batch=b.count, kind="decode")), dev)
              for b in blocks]
    kv_leaf = tuple(cache_kv_leaves(cfg))
    gate = params["head"].get("gate") if cfg.head == "ds" else None

    def head(h):
        return heads.head_topk(params["head"], table, cfg, h, k,
                               embed_table=params["embed"]["table"], kernel=kernel)

    def gates(h):
        if gate is None:
            return [None] * h.shape[0]
        return list(torch.softmax(h.float() @ gate.float().T, dim=-1).cpu())

    out = types.SimpleNamespace(tokens=[[] for _ in range(n)], heads=[[] for _ in range(n)],
                                gates=[[] for _ in range(n)], caches=caches)

    def emit(i, vals, ids, g):
        out.tokens[i].append(int(ids[0]))
        out.heads[i].append((vals.cpu(), ids.cpu()))
        out.gates[i].append(g)

    pos = np.zeros(n, np.int64)
    for i, p in enumerate(prompts):
        b = next(b for b in blocks if b.local(i) is not None)
        toks = torch.from_numpy(np.asarray(p, np.int64)[None]).to(dev)
        vals, ids, row = bundle.prefill(params, table, {"tokens": toks}, k=k, kernel=kernel)
        ServeSession._insert(caches[blocks.index(b)], kv_leaf, row, b.local(i), len(p))
        # the prefill's gate reads the last position's hidden state; the
        # head's output stands for it here
        emit(i, vals[0], ids[0], None)
        pos[i] = len(p)
    for _ in range(new_tokens - 1):
        tok = np.array([t[-1] for t in out.tokens], np.int64)
        vals, ids, g = [], [], []
        for b, cache in zip(blocks, caches):
            sl = slice(b.offset, b.offset + b.count)
            h = bundle.decode_hidden(params, cache, torch.from_numpy(tok[sl]).to(dev),
                                     torch.from_numpy(pos[sl]).to(dev))
            v, i_ = head(h)
            vals.append(v)
            ids.append(i_)
            g += gates(h)
        vals, ids = torch.cat(vals), torch.cat(ids)
        for i in range(n):
            emit(i, vals[i], ids[i], g[i])
        pos += 1
    return out
