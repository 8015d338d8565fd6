"""Differentiable collectives over ``torch.distributed``.

The JAX package writes its multi-device code inside ``shard_map`` and
lets XLA derive each collective's transpose.  The port runs one process
per part (rank), so the transposes are written here as autograd
Functions:

* ``all_to_all``: row q of a (P, ...) tensor goes to rank q; the
  backward is the reverse all_to_all of the cotangent.  ``async_op=True``
  returns a ``Pending`` whose ``wait()`` gives the received tensor, so
  that a caller can reduce its own rows while the exchange is in flight
  (the port of XLA's latency-hiding overlap);
* ``all_gather`` (tiled over dim 0); its backward is a reduce_scatter;
* ``reduce_scatter`` (a sum, tiled over dim 0, JAX's ``psum_scatter``);
  its backward is an all_gather;
* ``all_reduce_grads``: the psum of the gradients of replicated
  parameters that JAX's AD emits through ``shard_map``, here one
  all_reduce of the flattened gradients after ``backward``.

A ``group`` is a ``torch.distributed`` process group, None for the
default group, or a ``DeviceMesh`` together with the name of one of its
dimensions (``group_of``).  Backends: NCCL between cards, gloo on the
CPU and for ranks that share a card; the caller picks it when it starts
the group.  gloo runs every collective used here on CPU and on CUDA
tensors (``all_to_all_single``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``, in float32 and bf16; checked
under torch 2.11 and 2.13), so each is called as it is on either
backend: nothing here tries one form and falls back to another.
"""
from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def group_of(mesh=None, axis: str = "node"):
    """The process group of ``mesh``'s dimension ``axis``: ``mesh`` a
    ``DeviceMesh`` (its dimension of that name), a process group (itself)
    or None (the default group)."""
    if mesh is not None and hasattr(mesh, "get_group"):
        return mesh.get_group(axis)
    return mesh


def world(group=None) -> int:
    return dist.get_world_size(group)


def rank(group=None) -> int:
    return dist.get_rank(group)


def _all_to_all_start(x: Tensor, group):
    """Start the exchange of x's rows (P, ...) -> (out, work)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    return out, dist.all_to_all_single(out, x, group=group, async_op=True)


def _all_to_all(x: Tensor, group) -> Tensor:
    out, work = _all_to_all_start(x, group)
    work.wait()
    return out


class Pending:
    """An all_to_all in flight; ``wait()`` returns the received rows,
    differentiable with respect to the rows sent."""

    def __init__(self, x: Tensor, group):
        self.x, self.group = x, group
        self.out, self.work = _all_to_all_start(x.detach(), group)

    def wait(self) -> Tensor:
        return _AllToAllWait.apply(self.x, self)


class _AllToAllWait(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, pending: Pending) -> Tensor:
        ctx.group = pending.group
        pending.work.wait()
        return pending.out

    @staticmethod
    def backward(ctx, g: Tensor):
        return _all_to_all(g, ctx.group), None


def all_to_all(x: Tensor, group=None, async_op: bool = False):
    """x (P, ...) with row q for rank q -> (P, ...) with row q from rank q
    (JAX's ``all_to_all(x, axis, 0, 0, tiled=False)``); a ``Pending`` when
    ``async_op``."""
    if x.shape[0] != world(group):
        raise ValueError(f"all_to_all takes ({world(group)}, ...) rows, "
                         f"got {tuple(x.shape)}")
    pending = Pending(x, group)
    return pending if async_op else pending.wait()


def _gather(x: Tensor, group) -> Tensor:
    x = x.contiguous()
    out = torch.empty((world(group) * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _scatter_sum(x: Tensor, group) -> Tensor:
    P = world(group)
    if x.shape[0] % P:
        raise ValueError(f"reduce_scatter of {x.shape[0]} rows over {P} "
                         "ranks")
    n = x.shape[0] // P
    out = torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g: Tensor):
        return _scatter_sum(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        return _scatter_sum(x, group)

    @staticmethod
    def backward(ctx, g: Tensor):
        return _gather(g, ctx.group), None


def all_gather(x: Tensor, group=None) -> Tensor:
    """(n, ...) on each rank -> (P * n, ...), rank r's rows at [r*n, (r+1)*n)
    (JAX's ``all_gather(x, axis, axis=0, tiled=True)``)."""
    return _AllGather.apply(x, group)


def reduce_scatter(x: Tensor, group=None) -> Tensor:
    """(P * n, ...) on each rank -> (n, ...): block r of the sum over ranks
    (JAX's ``psum_scatter(x, axis, scatter_dimension=0, tiled=True)``)."""
    return _ReduceScatter.apply(x, group)


def all_reduce_grads(params: Iterable[Tensor], group=None,
                     mean: bool = False) -> None:
    """Sum (or average) the ``.grad`` of each parameter over the group, in
    one all_reduce of their flattened concatenation.  A parameter without
    a gradient takes zeros, so that every rank sends the same layout."""
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce(flat, group=group)
    if mean:
        flat /= world(group)
    off = 0
    for p in params:
        n = p.numel()
        p.grad = flat[off:off + n].view_as(p).clone()
        off += n


def all_reduce_sum(x: Tensor, group=None) -> Tensor:
    """A detached copy of x summed over the group (a loss or a count)."""
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out
