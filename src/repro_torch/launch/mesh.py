"""Mesh construction. Mirrors ``repro/launch/mesh.py``.

Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the ``pod`` axis carries pure data parallelism.
Both need a ``torchrun`` world of that many ranks, one card each:

  torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train \\
      --arch dbrx-132b --mesh single-pod

``make_host_mesh`` is the 1x1 (data, model) mesh over one rank on one
device. :func:`fake_production_mesh` is the production mesh's shape over a
``fake`` process group of 256 or 512 ranks in this one process, for the dry
run (:mod:`repro_torch.launch.dryrun`) only: its collectives send nothing,
and its tensors are meant to hold no data (meta or fake tensors). Functions, so
importing this module touches no process group.
"""
from __future__ import annotations

import contextlib
import math
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def _world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ``(data, model)`` mesh, or (2, 16, 16) ``(pod, data,
    model)``, over a ``torchrun`` world of 256 or 512 ranks. Under any other
    world size it raises ``ValueError`` before it touches NCCL."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, world = math.prod(shape), _world_size()
    if world != need:
        raise ValueError(
            f"the {'multi' if multi_pod else 'single'}-pod mesh {shape} {axes} "
            f"needs a torchrun world of {need} ranks, one card each; this world "
            f"has {world}")
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_host_mesh(device=None):
    """A 1x1 ``(data, model)`` mesh over one rank on ``device`` (the CUDA
    card unless given). Where no default process group exists it creates a
    one-rank group: NCCL on CUDA (bound to the card, so its communicator
    exists before any CUDA graph captures a collective), gloo on the CPU."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        kwargs = {}
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            kwargs["device_id"] = dev
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0, **kwargs)
    if dist.get_world_size() != 1:
        raise ValueError(f"the host mesh is one rank; this world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_production_mesh(*, multi_pod: bool = False):
    """The production mesh's shape and axes, ``(16, 16)`` ``(data,
    model)`` or ``(2, 16, 16)`` ``(pod, data, model)``, over a ``fake``
    process group of 256 or 512 ranks that this process joins as rank 0,
    for the block: a dry run of the placement and the collectives with no
    card and no other process. The group is destroyed on the way out; a
    process group that already exists raises ``ValueError``. The fake
    backend lives in ``torch.testing._internal``: without it this raises
    ``RuntimeError``. Never used by :mod:`repro_torch.launch.train`."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry run needs torch's fake process group "
                           "(torch.testing._internal.distributed.fake_pg)") from e
    if dist.is_initialized():
        raise ValueError("the fake production mesh needs a process with no "
                         "process group: run the dry run in a process of its own")
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    from repro_torch.distributed.sharding import region_groups

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        region_groups(mesh)   # every group a placed step uses, made before any trace
        yield mesh
    finally:
        dist.destroy_process_group()
