"""Device mesh and sharding rules (port of ``lightly_ocr_tpu/parallel/mesh.py``).

The reference's parallelism is single-host ``nn.DataParallel``
(``ocr/net.py:62-63,137-138``, ``ocr/train/crnn.py:100-101``): replicate
the module, scatter the batch, gather the outputs.  The JAX package builds
a ``('data', 'model')`` mesh, shards batches over ``data`` and lets GSPMD
insert the collectives.  Here the mesh is a grid of ``torch.device``\\ s:

* serving (:class:`lightly_ocr_tpu_torch.serving.batch.BatchedOCR` with
  ``mesh=``) keeps one replica of each network on every data-axis device
  and runs each contiguous chunk of the batch on its own device;
* training runs one process per device of the mesh (:mod:`.launch`): the
  processes of one data index share their rows of the global batch, with
  every statistic over the batch reduced across the data axis
  (:mod:`.collectives`); along the model axis (``model > 1``, GSPMD tensor
  parallelism in the JAX package) each holds its slice of every tensor
  that :func:`param_sharding_rules` splits (:mod:`.tensor`).

A mesh's processes are its devices in row-major order: rank ``r`` sits at
data index ``r // model`` and model index ``r % model``.
:class:`MeshGroups` is one process's view of that grid.
:func:`param_sharding_rules` keeps the JAX package's rule as a pure
function of the state dict's names and shapes.
"""
from __future__ import annotations

import copy
import os
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of devices: ``devices[i][j]`` is the device
    at data index ``i`` and model index ``j``.  A device may appear more
    than once (two replicas on one card)."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    @property
    def data_devices(self) -> tuple[torch.device, ...]:
        """The device of each data-axis index (model index 0)."""
        return tuple(row[0] for row in self.devices)


def visible_devices(device="cuda") -> list[torch.device]:
    """Every visible device of ``device``'s type: each CUDA device, or the
    one CPU.  Raises without a CUDA device where CUDA is asked for."""
    kind = torch.device(device).type
    if kind == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is visible; pass devices=[...] "
                               "(e.g. torch.device('cpu') replicas) to run on the CPU")
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device(kind)]


def make_mesh(data: int = -1, model: int = 1, devices: Sequence[Any] | None = None) -> Mesh:
    """Build a ``(data, model)`` mesh over ``devices`` (default: every
    visible CUDA device).  ``data=-1`` uses all remaining devices.  The
    errors are the JAX package's on the same sizes."""
    devices = [torch.device(d) for d in (devices if devices is not None else visible_devices())]
    n = len(devices)
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} must divide device count {n}")
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    rows = tuple(tuple(devices[i * model:(i + 1) * model]) for i in range(data))
    return Mesh(rows)


@dataclass(frozen=True)
class MeshGroups:
    """One process's place in a ``(data, model)`` mesh of processes: its
    **data group** (the ranks of its model index, over which the batch is
    split), its **model group** (the ranks of its data index, over which
    the sharded tensors are split) and its coordinates.  A group is
    ``None`` where its axis has one process, so ``MeshGroups()`` is one
    process alone and ``model == 1`` is today's data-parallel group."""

    data: Any = None
    model: Any = None
    data_index: int = 0
    model_index: int = 0
    data_size: int = 1
    model_size: int = 1

    @property
    def shape(self) -> dict[str, int]:
        """The axis sizes, as :attr:`Mesh.shape` (what
        :func:`param_sharding_rules` reads)."""
        return {DATA_AXIS: self.data_size, MODEL_AXIS: self.model_size}

    @property
    def lead(self) -> bool:
        """Whether this is rank 0 of the mesh (it logs and writes)."""
        return self.data_index == 0 and self.model_index == 0


def mesh_groups(group) -> MeshGroups:
    """``group`` as a :class:`MeshGroups`: ``None`` (one process), a
    ``torch.distributed`` process group (a data axis only), or a
    :class:`MeshGroups`, returned as it is."""
    if isinstance(group, MeshGroups):
        return group
    if group is None:
        return MeshGroups()
    import torch.distributed as dist

    return MeshGroups(data=group, data_index=dist.get_rank(group),
                      data_size=dist.get_world_size(group))


def new_mesh_groups(data: int, model: int) -> MeshGroups:
    """This process's :class:`MeshGroups` in a ``data x model`` mesh over
    the default process group (world size ``data * model``).  Every rank
    must call it: every rank creates every subgroup, in the same order
    (``dist.new_group`` waits for all of them).  With ``model == 1`` the
    data group is the whole world."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} processes")
    if model == 1:
        return mesh_groups(dist.group.WORLD)
    i, j = divmod(rank, model)
    data_group = model_group = None
    if data > 1:
        for jj in range(model):
            g = dist.new_group([ii * model + jj for ii in range(data)])
            data_group = g if jj == j else data_group
    for ii in range(data):
        g = dist.new_group([ii * model + jj for jj in range(model)])
        model_group = g if ii == i else model_group
    return MeshGroups(data_group, model_group, i, j, data, model)


def shard_batch(batch: Any, mesh: Mesh) -> list:
    """A batch (a tensor, or a dict / list / tuple of them, every leaf with
    the same leading dimension) -> one batch per data-axis device: its
    contiguous chunk of rows, moved to that device.  Raises where the data
    axis does not divide the batch (the JAX package's ``shard_map``
    error)."""
    def leaves(x) -> list:
        if isinstance(x, Mapping):
            x = list(x.values())
        if isinstance(x, (list, tuple)):
            return [leaf for v in x for leaf in leaves(v)]
        return [x]

    sizes = {leaf.shape[0] for leaf in leaves(batch)}
    if len(sizes) != 1:
        raise ValueError(f"batch leaves disagree on their leading dimension: {sorted(sizes)}")
    rows, n = sizes.pop(), mesh.shape[DATA_AXIS]
    if rows % n:
        raise ValueError(
            f"the batch axis (of size {rows}) maps to mesh axis '{DATA_AXIS}' "
            f"(of size {n}), but {n} does not evenly divide {rows}")
    per = rows // n

    def take(x, i, dev):
        if isinstance(x, Mapping):
            return {k: take(v, i, dev) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v, i, dev) for v in x)
        return torch.as_tensor(x[i * per:(i + 1) * per]).to(dev)

    return [take(batch, i, d) for i, d in enumerate(mesh.data_devices)]


def replicated(module: torch.nn.Module, mesh: Mesh) -> list[torch.nn.Module]:
    """One copy of ``module`` on each data-axis device."""
    return [copy.deepcopy(module).to(d) for d in mesh.data_devices]


def param_sharding_rules(state_dict: Mapping[str, torch.Tensor], mesh: Mesh) -> dict:
    """``{name: dim or None}``: the dimension of each tensor that a model
    axis would split, by the JAX package's rule on the port's names (never
    a contraction dimension):

    * 2D and 4D ``weight`` (Linear ``[out, in]``, conv ``[out, in, kh, kw]``;
      the JAX ``[in, out]`` / HWIO kernels transposed) -> their output
      dimension, 0;
    * LSTM ``weight_ih*`` / ``weight_hh*`` ``[4H, *]`` (torch layout on both
      sides) -> the gate dimension, 0;
    * biases and BatchNorm -> None (replicated).

    ``mesh`` is a :class:`Mesh` or a :class:`MeshGroups` (its ``shape``
    is read).  A tensor whose dimension the axis does not divide, or that is under
    twice the axis, stays replicated; with ``model == 1`` every tensor does."""
    model_size = mesh.shape[MODEL_AXIS]

    def fits(dim: int) -> bool:
        return dim % model_size == 0 and dim >= 2 * model_size

    def rule(name: str, t) -> int | None:
        shape = tuple(t.shape)
        if model_size > 1 and shape:
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith(("weight_ih", "weight_hh")):
                if len(shape) == 2 and fits(shape[0]):
                    return 0
            elif leaf == "weight" and len(shape) in (2, 4) and fits(shape[0]):
                return 0
        return None

    return {k: rule(k, v) for k, v in state_dict.items()}


def initialize_distributed(backend: str | None = None, device="cuda", **kwargs) -> None:
    """``torch.distributed.init_process_group``: NCCL for CUDA and gloo for
    the CPU unless ``backend`` is given; ``init_method`` defaults to
    ``env://`` (``torchrun``'s variables).  A no-op when a group is already
    up."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kwargs.setdefault("init_method", "env://")
    dist.init_process_group(backend=backend, **kwargs)


def launched_by_torchrun() -> bool:
    """Whether ``torchrun`` (``python -m torch.distributed.run``) set this
    process's rank and world size."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR"))
