"""Per-rank cost of a traced step (``repro.distributed.hlo_analysis``'s
counterpart).

``repro`` parses the compiled SPMD module's HLO text. The port has no HLO:
it runs its real step, as one rank of the mesh, on meta tensors (shapes
without memory, ``launch.dryrun``) under :class:`CostCounter`, a
``TorchDispatchMode`` that sees every operation the step dispatches,
backward included. It returns ``repro``'s keys, per rank:

* ``flops``: the matmuls', ``bmm``'s and convolutions' (PyTorch's
  ``flop_counter`` formulas, 2 per multiply-add), also split by the
  operands' dtype (``flops_by_dtype``) for the roofline's peak rates;
* ``bytes``: Σ of each op's operand and result bytes. Views and the other
  free ops (allocation, aliasing) are left out, as ``repro`` leaves out
  reshapes and bitcasts. The port runs eagerly on the card, so each op's
  operands and result cross HBM; there is no fusion to look inside;
* the collectives, from ``sharding.record_collectives`` (every collective
  of the port goes through ``sharding.collective``): ``coll_operand_bytes``
  (this rank's operands), ``coll_wire_bytes`` by ``repro``'s ring model
  (all-reduce 2·s·(n−1)/n, all-gather the result's (n−1)/n, reduce-scatter
  s·(n−1)/n), split into the bytes of groups inside one NVLink node
  (``coll_wire_bytes_nvlink``: the ``model`` axis) and of groups across
  nodes (``coll_wire_bytes_network``: ``data``, ``pod``), ``coll_counts``
  and ``coll_bytes_by_kind`` under ``repro``'s kind names.

A kernel call counts as the kernel does on the card, not as its plain
version: on meta tensors each wrapper runs its plain version through
``kernels.ref.plain``, which the counter turns into one op that reads its
operands and writes its results once (what ``repro`` counts for a custom
call), its temporaries never resident; its flops are the plain version's
products, or the body's own count where that is less (the causal
``flash_attention`` skips the tiles above the diagonal).

The counter also follows every storage the trace allocates (weak
references, so a storage counts until the last tensor or saved-for-backward
reference to it goes): ``peak_bytes`` is the most that is alive at once,
the step's arguments included; ``peak_top`` names the largest storages
alive at that peak (at most ``TOP_N``, each of at least
``TOP_MIN_BYTES``): the op that made it, its shape and dtype, and the
innermost line of the port on the Python stack when it was made (a
backward op's is the line that asked for the gradient, or the checkpoint
or custom backward that ran it);
``largest_tensor`` is the largest storage made at any time, named so.

``repro``'s HLO text parser (``HLOCost``, ``parse_module``, ``type_bytes``)
and ``xla_cost_analysis`` read XLA's output and have no counterpart here.
"""
from __future__ import annotations

import sys
import weakref
from collections import Counter
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import sharding
from repro_torch.kernels import ref
from repro_torch.launch.mesh import NODE_CARDS
from repro_torch.utils.tree import tree_leaves


# the port's collective → ``repro``'s HLO kind
KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "all_reduce_max": "all-reduce", "reduce_scatter": "reduce-scatter"}

_aten = torch.ops.aten
# ops that move no bytes of their own (views are found by their schema)
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
         _aten.new_empty_strided, _aten._unsafe_view, _aten.lift_fresh, _aten.detach,
         _aten.alias, _aten.set_, _aten.resize_}


class _Uncached(Exception):
    pass


def _meta_key(x):
    """A hashable key of an op's argument for the meta-result cache: a meta
    tensor by its shape, strides and dtype, a plain value by type and value."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _Uncached
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_meta_key(v) for v in x)
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype, torch.device,
                                   torch.layout, torch.memory_format)):
        return (type(x), x)
    raise _Uncached


def _meta_spec(out):
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)) and all(isinstance(t, torch.Tensor) for t in out):
        return [_meta_spec(t) for t in out]
    raise _Uncached


def _from_spec(spec):
    if isinstance(spec, list):
        return tuple(_from_spec(s) for s in spec)
    return torch.empty_strided(spec[0], spec[1], dtype=spec[2], device="meta")


# (op, argument keys) → its result's shapes, strides and dtypes: the meta
# kernels of elementwise ops run PyTorch's Python reference
# implementations, ~0.2 ms a call, so a trace reuses what a repeated op
# gave before. Only ops that write no input and alias none.
_META_CACHE: dict = {}
_CACHEABLE: dict = {}


def _run_meta(func, args, kwargs):
    ok = _CACHEABLE.get(func)
    if ok is None:
        schema = func._schema
        # c10d's collectives write their output without saying so in
        # their schemas; ``_unsafe_view`` aliases its input
        ok = _CACHEABLE[func] = func.namespace == "aten" and not (
            func.is_view or schema.is_mutable or func._overloadpacket in _FREE
            or any(r.alias_info for r in schema.returns))
    if not ok or not _tensors(args):  # a factory may make a tensor off the meta device
        return func(*args, **kwargs)
    try:
        key = (func, _meta_key(args), _meta_key(tuple(sorted(kwargs.items()))))
    except _Uncached:
        return func(*args, **kwargs)
    spec = _META_CACHE.get(key)
    if spec is not None:
        return _from_spec(spec)
    out = func(*args, **kwargs)
    try:
        _META_CACHE[key] = _meta_spec(out)
    except _Uncached:
        pass
    return out


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def intra_node(group) -> bool:
    """Whether every rank of ``group`` lies in one NVLink node
    (``rank // NODE_CARDS`` the same)."""
    return len({r // NODE_CARDS for r in dist.get_process_group_ranks(group)}) == 1


def wire_bytes(op: str, operand_bytes: float, n: int) -> float:
    """Bytes a rank sends by the ring model for one collective of ``op``
    on an ``operand_bytes`` operand over ``n`` ranks."""
    if n <= 1:
        return 0.0
    if op in ("all_reduce", "all_reduce_max"):
        return 2.0 * operand_bytes * (n - 1) / n
    if op == "all_gather":
        return operand_bytes * n * (n - 1) / n  # the result's (n-1)/n
    return operand_bytes * (n - 1) / n


def collective_costs(records) -> dict:
    """The collective keys of :func:`analyze` from ``record_collectives``
    records (each ``(op, shape, dtype, n)`` with its ``group``)."""
    out = {"coll_operand_bytes": 0.0, "coll_wire_bytes": 0.0, "coll_wire_bytes_nvlink": 0.0,
           "coll_wire_bytes_network": 0.0, "coll_counts": {}, "coll_bytes_by_kind": {}}
    for rec in records:
        op, shape, dtype, n = rec
        numel = 1
        for s in shape:
            numel *= s
        operand = float(numel * torch.empty((), dtype=dtype).element_size())
        wire = wire_bytes(op, operand, n)
        kind = KINDS[op]
        out["coll_operand_bytes"] += operand
        out["coll_wire_bytes"] += wire
        where = "nvlink" if intra_node(rec.group) else "network"
        out[f"coll_wire_bytes_{where}"] += wire
        out["coll_counts"][kind] = out["coll_counts"].get(kind, 0) + 1
        out["coll_bytes_by_kind"][kind] = out["coll_bytes_by_kind"].get(kind, 0.0) + operand
    return out


# ops that read rows of their first operand, not all of it: their read of
# an argument counts as the rows they return
_ROW_READS = {_aten.index, _aten.embedding, _aten.index_select, _aten.gather}

# ``peak_top``: the storages of at least this many bytes alive at the peak
# (a stack walk is made only for these), the largest ``TOP_N`` of them
TOP_MIN_BYTES = 1 << 26
TOP_N = 12


class CostCounter(TorchDispatchMode):
    """Counts flops, op bytes, collectives and live storage over the ops
    run inside the block. ``resident``: a dict of trees of tensors alive
    before the block (the step's arguments, by kind), which count toward
    the peak from the start; ``read_once_bytes_by_kind`` counts, per kind,
    the bytes of its storages the block reads, each storage once (the rows
    of a row gather each time). :meth:`totals` gives :func:`analyze`'s
    dict."""

    def __init__(self, resident: Optional[dict] = None):
        super().__init__()
        self.flops_by_dtype: Counter = Counter()
        self.bytes = 0
        self.ops = 0
        self.kernel_calls: Counter = Counter()
        self.live = 0
        self.peak = 0
        self._storages: dict = {}
        self._large: dict = {}
        self.peak_top: list = []
        self._top_stale = False
        self.largest: dict = {"bytes": -1}
        self._in_kernel = 0
        self._records = None
        self._prev_counter = None
        self._rec_cm = None
        self.read_once: Counter = Counter()
        self._arg_of: dict = {}
        for kind, tree in (resident or {}).items():
            for t in tree_leaves(tree):
                if isinstance(t, torch.Tensor):
                    self._track(t, f"argument {kind}")
                    self._arg_of.setdefault(id(t.untyped_storage()),
                                            (kind, t.untyped_storage().nbytes()))

    def _reads(self, packet, inputs, out) -> None:
        for i, t in enumerate(inputs):
            arg = self._arg_of.get(id(t.untyped_storage()))
            if arg is None:
                continue
            kind, n = arg
            if i == 0 and packet in _ROW_READS:
                self.read_once[kind] += _nbytes(_tensors(out))
            elif n:
                self.read_once[kind] += n
                self._arg_of[id(t.untyped_storage())] = (kind, 0)

    # --- live storage ---------------------------------------------------
    def _track(self, t: torch.Tensor, op: str) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n):
            if self._storages.pop(key, None) is not None:
                self.live -= n
                if self._large.pop(key, None) is not None:
                    self._top_stale = True

        self._storages[key] = weakref.ref(st, freed)
        if n >= TOP_MIN_BYTES or n > self.largest["bytes"]:
            row = {"bytes": n, "op": op, "shape": list(t.shape),
                   "dtype": str(t.dtype).replace("torch.", ""), "where": _where()}
            if n > self.largest["bytes"]:
                self.largest = row
            if n >= TOP_MIN_BYTES:
                self._large[key] = row
                self._top_stale = True
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
            if self._top_stale:  # the large storages alive at this peak
                self.peak_top = sorted(self._large.values(), key=lambda r: -r["bytes"])
                self._top_stale = False

    # --- the dispatch ---------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = _run_meta(func, args, kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            a = _tensors(args)
            dtype = str(a[0].dtype).replace("torch.", "") if a else "float32"
            if packet in (_aten.mm, _aten.bmm):  # ``bmm.dtype``'s out_dtype is positional
                args = args[:2]
            self.flops_by_dtype[dtype] += int(flop_registry[packet](*args, **kwargs,
                                                                   out_val=out))
        if self._in_kernel:
            return out
        if not (func.is_view or packet in _FREE):
            self.ops += 1
            inputs = _tensors(args) + _tensors(kwargs)
            self.bytes += _nbytes(inputs) + _nbytes(_tensors(out))
            if self._arg_of:
                self._reads(packet, inputs, out)
        for t in _tensors(out):
            self._track(t, str(packet))
        return out

    def kernel_call(self, name: str, fn, args, kw, flops: Optional[int]):
        """``fn(*args, **kw)`` (a kernel's plain version) counted as the
        kernel: one op, its operands and results once, its flops ``flops``
        where given."""
        before = self.flops_by_dtype.copy()
        self._in_kernel += 1
        try:
            out = fn(*args, **kw)
        finally:
            self._in_kernel -= 1
        if self._in_kernel:
            return out
        if flops is not None:
            self.flops_by_dtype = before
            dtype = str(_tensors(args)[0].dtype).replace("torch.", "")
            self.flops_by_dtype[dtype] += int(flops)
        self.kernel_calls[name] += 1
        self.ops += 1
        inputs = _tensors(args) + _tensors(kw)
        self.bytes += _nbytes(inputs) + _nbytes(_tensors(out))
        if self._arg_of:
            self._reads(None, inputs, out)
        for t in _tensors(out):
            self._track(t, f"kernel {name}")
        return out

    def __enter__(self):
        self._prev_counter, ref._COUNTER = ref._COUNTER, self
        self._rec_cm = sharding.record_collectives()
        self._records = self._rec_cm.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._rec_cm.__exit__(*exc)
            ref._COUNTER = self._prev_counter

    def totals(self) -> dict:
        """Per-rank costs with ``repro``'s keys, and the port's extras
        (``flops_by_dtype``, the NVLink/network split of the wire bytes,
        ``ops``, ``kernel_calls``, ``peak_bytes``)."""
        out = {"flops": float(sum(self.flops_by_dtype.values())),
               "bytes": float(self.bytes)}
        out.update(collective_costs(self._records or []))
        out.update({"flops_by_dtype": {k: float(v) for k, v in self.flops_by_dtype.items()},
                    "ops": self.ops, "kernel_calls": dict(self.kernel_calls),
                    "peak_bytes": int(self.peak),
                    "peak_top": self.peak_top[:TOP_N],
                    "largest_tensor": self.largest,
                    "read_once_bytes_by_kind": dict(self.read_once)})
        return out


def _where() -> str:
    """The innermost line of the port (not this module) on the Python
    stack, as ``repro_torch/…/file.py:line``."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        i = fn.rfind("repro_torch")
        if i >= 0 and not fn.endswith("hlo_analysis.py"):
            return f"{fn[i:]}:{f.f_lineno}"
        f = f.f_back
    return "?"


def analyze(fn, *args, resident: Optional[dict] = None, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter` → (its
    output, the per-rank costs)."""
    with CostCounter(resident) as counter:
        out = fn(*args, **kwargs)
    return out, counter.totals()
