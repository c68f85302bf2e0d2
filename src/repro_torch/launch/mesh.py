"""Meshes and ranks of the port (``repro.launch.mesh``).

    shape = parse_shape("2x2")                          # data x model
    launch(body, prod(shape), backend="gloo", device="cpu", args=(...))
    # in each rank: body(device, *args), where make_mesh(shape) builds
    # the mesh over the default process group

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose axes are
the trailing names of ("pod", "data", "model"), over ranks 0 .. prod(shape)
- 1 of the default group. ``launch`` starts the ranks with
torch.multiprocessing (the spawn method) unless the process already is one
(``RANK`` and ``WORLD_SIZE`` set, as under torchrun): then it joins that
group and runs the body in this process. Rank r takes cuda:(r %
device_count), or the CPU when asked; either way a rank takes its share
of the host's threads.

The backend is explicit: nccl for CUDA ranks by default, gloo for CPU ranks.
NCCL takes one rank a card, so nccl with more ranks than cards raises and
names ``--dist-backend gloo``, under which ranks share a card and their
collectives go through host memory (all_reduce, all_gather, broadcast and
barrier take CUDA tensors there). Nothing switches backend on its own.

Not carried over: ``force_host_devices`` (XLA's host platform device count)
and ``make_production_mesh`` (the fleet mesh of ``launch/dryrun.py``).
"""
from __future__ import annotations

import math
import os
import tempfile

import torch
import torch.distributed as dist

AXES = ("pod", "data", "model")
BACKENDS = ("nccl", "gloo")


def parse_shape(spec: str):
    """Parse a ``'DxM'`` (or ``'PxDxM'``) mesh-shape string: ``'2x2'`` ->
    ``(2, 2)``; the grammar of ``launch.prune --mesh``."""
    return tuple(int(x) for x in spec.lower().split("x"))


def default_backend(device) -> str:
    """nccl for CUDA ranks, gloo for CPU ranks."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, world: int, device) -> None:
    """Raise unless ``backend`` can run ``world`` ranks on ``device``'s
    type: nccl needs CUDA and one card a rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; need one of {BACKENDS}")
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise ValueError("the nccl backend needs CUDA ranks; CPU ranks take "
                         "--dist-backend gloo")
    cards = torch.cuda.device_count()
    if world > cards:
        raise RuntimeError(
            f"{world} ranks over {cards} CUDA device(s): nccl takes one rank "
            f"a card; pass --dist-backend gloo to run the ranks on shared "
            f"cards, their collectives through host memory")


def joined() -> bool:
    """Whether this process already is a rank (``RANK`` and ``WORLD_SIZE``
    set, as under torchrun)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def host_ranks(world: int) -> int:
    """The ranks of a ``world`` that run on this host: all of them when
    ``launch`` spawns them, ``LOCAL_WORLD_SIZE`` under torchrun."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world)) if joined() \
        else world


def make_mesh(shape, axes=None, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default process group (ranks
    0 .. prod(shape) - 1; a rank past them lies outside the mesh). ``axes``
    default to the trailing names of ("pod", "data", "model"). Every rank of
    the group calls it: it creates the mesh's process groups."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = tuple(int(s) for s in shape)
    axes = AXES[-len(shape):] if axes is None else tuple(axes)
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} with axes {axes}")
    n, world = math.prod(shape), dist.get_world_size()
    if n > world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the group has "
                         f"{world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def launch(body, world: int, *, backend: str, device, args=(),
           init_method=None):
    """Run ``body(device, *args)`` on ``world`` ranks, each with the default
    process group initialised (``backend``) and its device set.

    Spawned ranks rendezvous at ``init_method`` (default: a ``file://``
    store in a fresh temporary directory); ``body`` and ``args`` are
    pickled, so ``body`` is a module-level function. A rank that raises
    fails the launch: the others are stopped and the error re-raised here.
    Spawned, returns None; joined (under torchrun), returns ``body``'s
    result in this rank."""
    dev_type = torch.device(device).type
    check_backend(backend, host_ranks(world), dev_type)
    if joined():
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"WORLD_SIZE {os.environ['WORLD_SIZE']} but the "
                             f"mesh needs {world} ranks")
        return _rank(int(os.environ["RANK"]), world, init_method or "env://",
                     backend, dev_type, body, args)
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            _rank, args=(world, init_method or f"file://{tmp}/rendezvous",
                         backend, dev_type, body, args),
            nprocs=world, join=True)
    return None


def _rank(rank, world, init_method, backend, dev_type, body, args):
    if dev_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    # the ranks of a host share its cores
    torch.set_num_threads(max(1, torch.get_num_threads()
                              // host_ranks(world)))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    try:
        return body(device, *args)
    finally:
        dist.destroy_process_group()
