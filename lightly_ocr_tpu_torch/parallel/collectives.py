"""The reductions of a data-parallel step over ``torch.distributed``.

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
single-device code bit for bit.  Only ``all_reduce`` is used (SUM and
MAX), which both NCCL and gloo run on CUDA tensors.
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
