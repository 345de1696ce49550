"""Autograd-aware collectives: the port's counterparts of ``jax.lax.psum``
and ``jax.lax.pmean`` over one mesh axis, an axis being a process group.

JAX transposes ``psum`` to ``psum``; :func:`all_reduce_sum` does the same:
its backward all-reduces the cotangent over the group of its forward. So a
loss that every rank of an event group computes from the merged partial
IWEs hands each rank's splat an E-fold cotangent, and the gradients come
out E times each shard's contribution: the train step under a mesh
(``training.step.make_train_step``) sums them over the data group and
averages them over the event group (:func:`..event.reduce_gradients`), as
``parallel/event.py`` of the JAX package does.

Every rank of a group must call every collective of that group in the same
order, backward included; the loss and validation code paths are identical
on every rank, so their autograd graphs, and the order the engine runs the
backward in, are too.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``psum(x)`` over ``group``: the sum of every rank's ``x``, with the
    all-reduce of the cotangent as its backward."""
    return _AllReduceSum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """``pmean(x)`` over ``group``: :func:`all_reduce_sum` over the group's
    size."""
    return all_reduce_sum(x, group) / dist.get_world_size(group)
