"""The collectives of a parallel step over ``torch.distributed``.

In the JAX package's mesh step every quantity computed over the batch is
computed over the *global* batch (GSPMD inserts the reductions).  Each
process of the port holds its rows of that batch, so each such quantity is
a sum over the processes of a per-process part:

* BatchNorm's sums of ``x`` and ``x^2`` (:class:`~lightly_ocr_tpu_torch.
  models.layers.BatchNorm2d`), summed with :func:`all_sum_autograd` so that
  the backward carries each process's share of every other's loss;
* loss normalisers (token counts, positive-pixel counts) and OHEM's
  ``min``, ``max`` and halving counts, with :func:`global_sum` and
  :func:`global_min_max`, outside the graph;
* the gradients (:func:`all_reduce_grads_`), before the clip's norm.

``group`` is a ``torch.distributed`` process group, or ``None`` for one
process.  With one process (``None``, or a group of size 1) the global
statistics are the local ones: :func:`global_sum` and
:func:`global_min_max` return the local values, and the step takes the
single-device code bit for bit.

Along a model axis (:mod:`.tensor`) the gathers are Megatron's pair of
autograd functions over the model group of a :class:`~lightly_ocr_tpu_torch.
parallel.mesh.MeshGroups`: :func:`copy_to_model` (identity; its backward
sums the input's gradient over the model group) and
:func:`gather_from_model` (the slices side by side along a dimension; its
backward takes this rank's slice of the gradient).

Only ``all_reduce`` is used (SUM and MAX), which both NCCL and gloo run on
CUDA tensors (whether gloo's ``all_gather`` takes CUDA tensors depends on
the build).  A gather is the SUM of a zero buffer into which each rank has
written its own slice, which is exact (``x + 0 == x``).
"""
from __future__ import annotations

import torch


def group_size(group) -> int:
    """Processes in ``group`` (1 for ``None``)."""
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank in ``group`` (0 for ``None``)."""
    if group is None:
        return 0
    import torch.distributed as dist

    return dist.get_rank(group)


def is_split(group) -> bool:
    """Whether the batch is split over more than one process."""
    return group_size(group) > 1


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    import torch.distributed as dist

    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def global_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the processes of ``t`` (outside the graph); ``t`` itself
    with one process."""
    if not is_split(group):
        return t
    import torch.distributed as dist

    return _all_reduce(t, group, dist.ReduceOp.SUM)


def global_min_max(t: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """(min, max) of ``t`` over every process's elements, in one MAX
    reduction (the min as the max of ``-t``)."""
    lo, hi = t.min(), t.max()
    if not is_split(group):
        return lo, hi
    import torch.distributed as dist

    m = _all_reduce(torch.stack([-lo, hi]), group, dist.ReduceOp.MAX)
    return -m[0], m[1]


class _AllSum(torch.autograd.Function):
    """Sum over the processes; the backward sums the incoming gradients
    over the processes too."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist

        ctx.group = group
        return _all_reduce(t, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return _AllSum.apply(grad, ctx.group), None


def all_sum_autograd(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the processes of ``t``, differentiable: each process
    gets the gradient of the sum of every process's loss."""
    return _AllSum.apply(t, group)


@torch.no_grad()
def all_reduce_grads_(grads: list[torch.Tensor], group) -> None:
    """Sum the gradients over the processes in place, as one flat buffer.
    With a group of one process this runs its all-reduce (a copy)."""
    if group is None or not grads:
        return
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(r)


@torch.no_grad()
def sync_replicated_grads_(grads: list[torch.Tensor], groups) -> None:
    """Give every rank of the model group the gradients of model index 0
    for the tensors it replicates, in place, in one collective (the others
    add zeros, so the values are rank 0's exactly).  Each rank computes
    them alone, and a kernel that is not deterministic (atomics in a
    backward) would let the replicas drift apart by round-off."""
    if groups.model is None or not grads:
        return
    if groups.model_index:
        torch._foreach_zero_(grads)
    all_reduce_grads_(grads, groups.model)


def any_rank(flag: bool, group, device) -> bool:
    """Whether ``flag`` holds on any process of ``group``."""
    if group is None:
        return flag
    return bool(global_sum(torch.tensor(float(flag), device=device), group).item() > 0)


# -- the model axis ------------------------------------------------------------

def gather_along(t: torch.Tensor, dim: int, groups) -> torch.Tensor:
    """The model group's slices of a tensor side by side along ``dim``
    (rank ``j``'s slice at ``j``), outside the graph: one SUM of a zero
    buffer holding this rank's slice."""
    import torch.distributed as dist

    m, j = groups.model_size, groups.model_index
    buf = t.new_zeros((m, *t.shape))
    buf[j] = t
    dist.all_reduce(buf, group=groups.model)
    return buf.movedim(0, dim).flatten(dim, dim + 1) if dim else buf.flatten(0, 1)


def slice_along(t: torch.Tensor, dim: int, groups) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim`` (contiguous)."""
    n = t.shape[dim] // groups.model_size
    return t.narrow(dim, groups.model_index * n, n).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return global_sum(grad, ctx.groups.model), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        return gather_along(x, dim, groups)

    @staticmethod
    def backward(ctx, grad):
        return slice_along(grad, ctx.dim, ctx.groups), None, None


def copy_to_model(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` (the same on every rank of the model group), as the input of
    a sharded op: the identity, whose backward sums the gradient of ``x``
    over the model group (each rank's gradient holds only its slice's
    share)."""
    return _CopyToModel.apply(x, groups)


def gather_from_model(x: torch.Tensor, dim: int, groups) -> torch.Tensor:
    """The model group's slices ``x`` side by side along ``dim``
    (:func:`gather_along`), differentiable: the backward takes this rank's
    slice of the gradient, which is the same on every rank (what follows
    the gather is replicated)."""
    return _GatherFromModel.apply(x, dim % x.ndim, groups)
