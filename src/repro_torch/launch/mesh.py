"""Mesh construction over ``torch.distributed`` (after ``repro.launch.mesh``).

``repro`` drives every device from one controller; the port runs one
process per rank (SPMD, as ``torchrun`` starts it), each holding its own
shard. A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with
``repro``'s axis names: ``(data, model)``, or ``(pod, data, model)`` for a
``PxDxM`` spec. Collectives run over NCCL on the card and over ``gloo`` only
when the caller asks for the CPU.

:func:`init_distributed` starts the default process group once: from
``torchrun``'s ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` environment, or
from an explicit ``file://`` store (tests and ``chip_smoke.py``: no network
and no port number). A process started without either is a world of one on
a file store in a fresh temporary directory. On CUDA each rank takes
``cuda:LOCAL_RANK``, and a world wider than the cards this host shows
raises: nothing moves to ``gloo`` or to the CPU.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def init_distributed(device="cuda", *, store: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     local_rank: Optional[int] = None) -> torch.device:
    """Start the default process group (once) and return this rank's device.

    ``store``: path of a file store shared by the ranks (``file://`` is
    added); without it the group rendezvous through ``torchrun``'s env
    (``MASTER_ADDR``/``MASTER_PORT``), or, with no ``WORLD_SIZE`` in the
    environment, a world of one on a temporary file store. ``rank``,
    ``world_size`` and ``local_rank`` default to ``RANK``, ``WORLD_SIZE``
    and ``LOCAL_RANK`` (0, 1 and ``rank``). NCCL on CUDA (each rank on
    ``cuda:LOCAL_RANK``), ``gloo`` on the CPU."""
    dev = resolve_device(device)
    env = os.environ
    if rank is None:
        rank = int(env.get("RANK", 0))
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", 1))
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
        n_cards = torch.cuda.device_count()
        if local_world > n_cards or local_rank >= n_cards:
            raise RuntimeError(
                f"a world of {local_world} ranks on this host needs {local_world} CUDA "
                f"devices, only {n_cards} visible: NCCL puts one rank on each card (run "
                "wider worlds on the CPU with device='cpu')")
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    if dist.is_initialized():
        want = "nccl" if dev.type == "cuda" else "gloo"
        if dist.get_backend() != want or dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a {dist.get_backend()} process group of {dist.get_world_size()} ranks is "
                f"already running; this call asks for {want} with {world_size}")
        return dev
    if store is not None:
        init_method = f"file://{os.path.abspath(store)}"
    elif "WORLD_SIZE" in env or "MASTER_ADDR" in env:
        init_method = "env://"
    else:
        init_method = f"file://{tempfile.mkdtemp(prefix='repro_torch_pg_')}/store"
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda"):
    """A DeviceMesh of ``shape`` with axis names ``axes`` over the running
    world (started by :func:`init_distributed` if need be). The world must
    hold exactly ``prod(shape)`` ranks."""
    dev = init_distributed(device)
    n = 1
    for s in shape:
        n *= int(s)
    if n != dist.get_world_size():
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} ranks, the world "
                         f"has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(device="cuda"):
    """Every rank of the world as a 1×N (data, model) mesh."""
    init_distributed(device)
    return make_mesh((1, dist.get_world_size()), ("data", "model"), device)


def parse_mesh(spec: str, device="cuda", store: Optional[str] = None):
    """``--mesh DxM`` (or ``PxDxM``) → a (data, model) mesh (or (pod, data,
    model)) over the world (expert-parallel serving: tokens shard over
    ``data``, the packed expert table over ``model``), starting the process
    group if none runs (``store`` as in :func:`init_distributed`). Raises,
    before it starts anything, when the spec is malformed or the world
    does not hold D·M ranks."""
    try:
        dims = tuple(int(x) for x in spec.lower().split("x"))
    except ValueError:
        dims = ()
    if len(dims) == 2:
        axes = ("data", "model")
    elif len(dims) == 3:
        axes = ("pod", "data", "model")
    else:
        raise ValueError(f"--mesh expects DxM or PxDxM (e.g. 2x4), got {spec!r}")
    if min(dims) < 1:
        raise ValueError(f"--mesh {spec}: every axis needs at least one rank")
    n = 1
    for d in dims:
        n *= d
    world = dist.get_world_size() if dist.is_initialized() else int(
        os.environ.get("WORLD_SIZE", 1))
    if n != world:
        raise ValueError(f"--mesh {spec} needs {n} ranks, the world has {world} "
                         f"(start one process per rank: torchrun --nproc-per-node {n})")
    init_distributed(device, store=store)
    return make_mesh(dims, axes, device)


def destroy() -> None:
    """Tear the default process group down once every rank has called this
    (so no rank leaves while another is still in a collective); a no-op if
    none is running."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


# Cards an NVLink node holds: the ``model`` axis (the innermost, so its
# ranks are consecutive) stays inside one node.
NODE_CARDS = 8


def production_mesh_shape(multi_pod: bool = False) -> tuple:
    """(shape, axis names) of the production mesh: (data 32, model 8), 256
    cards in 32 nodes; or (pod 2, data 32, model 8), 512 cards."""
    if multi_pod:
        return (2, 32, NODE_CARDS), ("pod", "data", "model")
    return (32, NODE_CARDS), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over the running world, which must hold 256 (512
    with ``multi_pod``) ranks: torchrun's over that many cards, or the one
    process of :func:`fake_world`."""
    shape, axes = production_mesh_shape(multi_pod)
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"the production mesh {'x'.join(map(str, shape))} needs a running "
                           f"world of {n} ranks (torchrun, or launch.mesh.fake_world)")
    from torch.distributed.device_mesh import init_device_mesh

    kind = "cpu" if dist.get_backend() in ("fake", "gloo") else "cuda"
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


@contextlib.contextmanager
def fake_world(world_size: int):
    """A world of ``world_size`` ranks in this one process, as rank 0, for
    the length of the block: a ``fake`` process group, whose
    collectives return at once and move nothing, so a step traced on meta
    tensors runs every collective a rank of a real world of that size runs.
    ``repro`` gets its 512 devices from
    ``--xla_force_host_platform_device_count``; this is the counterpart,
    from PyTorch's private ``torch.testing._internal.distributed.fake_pg``
    (imported here only: nothing else of the port needs it). Refuses to
    start while a process group runs, and tears its own down on the way
    out, so no fake group outlives its block."""
    if dist.is_initialized():
        raise RuntimeError(f"a {dist.get_backend()} process group of {dist.get_world_size()} "
                           "ranks is already running; a fake world needs none")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
