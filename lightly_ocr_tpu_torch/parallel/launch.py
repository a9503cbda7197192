"""One process per device of a mesh: the spawn launcher, and ``torchrun``.

:func:`spawn` starts one process per device (of a list, or of every row of
a :class:`~lightly_ocr_tpu_torch.parallel.mesh.Mesh`, row-major) with the
``spawn`` start method (a fresh interpreter each: no JAX, no forked CUDA
state).  Each runs :func:`_worker`, which joins a process group on
``tcp://127.0.0.1:<free port>``, makes its device the current one and calls
``target(*args, device=<its device>, group=<its group>)``; rank 0's return
value comes back to the caller through a file in a temporary directory.
``target`` must be importable by name (a module-level function of the
port).  The group is the whole world for a list or a mesh with a model
axis of 1, else the rank's :class:`~lightly_ocr_tpu_torch.parallel.mesh.
MeshGroups` (:func:`~lightly_ocr_tpu_torch.parallel.mesh.new_mesh_groups`).

The backend is NCCL where every rank has a CUDA device of its own, and gloo
otherwise (the CPU, or several ranks on one card, which NCCL refuses).

:func:`from_torchrun` joins the group that ``torchrun`` describes in the
environment (``RANK``, ``WORLD_SIZE = data * model``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``); a CUDA rank takes ``cuda:<LOCAL_RANK>``.
"""
from __future__ import annotations

import os
import socket
import tempfile
from typing import Any, Callable, Sequence

import torch

from lightly_ocr_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    initialize_distributed,
    new_mesh_groups,
)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL where every rank has a CUDA device of its own, else gloo."""
    cuda = all(d.type == "cuda" for d in devices)
    distinct = len({(d.type, d.index) for d in devices}) == len(devices)
    return "nccl" if cuda and distinct else "gloo"


def _groups(model: int):
    """The group a rank's target takes in a mesh with ``model`` ranks a data
    index."""
    import torch.distributed as dist

    if model == 1:
        return dist.group.WORLD
    return new_mesh_groups(dist.get_world_size() // model, model)


def _worker(rank: int, target: Callable, args: tuple, devices: list, backend: str,
            init_method: str, result_path: str, model: int = 1) -> None:
    import torch.distributed as dist

    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # the CPU ranks share the cores
        torch.set_num_threads(max(1, torch.get_num_threads() // len(devices)))
    initialize_distributed(backend=backend, init_method=init_method,
                           world_size=len(devices), rank=rank)
    try:
        out = target(*args, device=device, group=_groups(model))
        if rank == 0:
            torch.save(out, result_path)
    finally:
        dist.destroy_process_group()


def spawn(target: Callable, args: tuple = (), devices: Sequence[Any] | Mesh = ("cuda",),
          backend: str | None = None) -> Any:
    """Run ``target(*args, device=..., group=...)`` in one process per entry
    of ``devices`` (or per device of a mesh) and return rank 0's result.
    Raises when a process fails (with its traceback)."""
    import torch.multiprocessing as mp

    model = 1
    if isinstance(devices, Mesh):
        model = devices.shape[MODEL_AXIS]
        devices = [d for row in devices.devices for d in row]
    devices = [torch.device(d) for d in devices]
    if backend is None:
        backend = backend_for(devices)
    init_method = f"tcp://127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="lightly_ocr_dp_") as tmp:
        result_path = os.path.join(tmp, "rank0.pt")
        ctx = mp.start_processes(
            _worker, args=(target, tuple(args), devices, backend, init_method, result_path, model),
            nprocs=len(devices), join=False, start_method="spawn")
        while not ctx.join():
            pass
        return torch.load(result_path, weights_only=False)


def from_torchrun(device="cuda", model: int = 1):
    """(device, group) of a process that ``torchrun`` started: the process
    group joined from the environment (NCCL for CUDA, gloo for the CPU),
    and ``cuda:<LOCAL_RANK>`` made current for a CUDA rank; with ``model``
    ranks a data index, the rank's ``MeshGroups``."""
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    initialize_distributed(device=device)
    return device, _groups(model)
