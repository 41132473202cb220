"""The collectives of a tensor-parallel forward, as autograd Functions over
plain ``torch.distributed`` with explicit groups (no DTensor dispatch).

They come in conjugate pairs, each one's backward the other's forward, so
a backward is itself differentiable: KronNewton's exact Hvp
(``optim.hvp.hvp_exact``) differentiates the first backward a second time.

* ``copy`` (Megatron's f): identity forward, the sum over the group
  backward.  Where a tensor every rank holds alike feeds a computation
  that differs by rank (a column-parallel product), each rank's backward
  gives its part of the gradient; the sum makes it whole.
* ``reduce`` (Megatron's g): the sum over the group forward (in float32
  or wider, cast back once, as ``parallel.mesh.MeshAxes.sum``), identity
  backward: a row-parallel product's partial sums made whole.
* ``gather``: the blocks of a tensor dim over the group (in group order).
  Its output is used alike by every rank, so its backward takes this
  rank's block of the gradient (``_Split``, whose backward gathers).

Every call reports itself to the open ``utils.profiling.count_collectives``
windows.  On a group of one rank each is the identity (no call)."""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import _bytes, _sum


def _size(group) -> int:
    return dist.get_world_size(group)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The blocks of ``dim`` from every rank of ``group``, in group order:
    one ``all_gather`` of their bytes (exact in every dtype)."""
    from ..utils.profiling import record_collective
    k = _size(group)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((k * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather([_bytes(c) for c in out.chunk(k)], _bytes(x), group=group)
    record_collective("all-gather", out, group)
    return out.movedim(0, dim)


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x.chunk(_size(group), dim)[dist.get_rank(group)].contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _Split.apply(g, ctx.group, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.group, ctx.dim), None, None


def copy(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, the sum over ``group`` backward (f)."""
    return x if _size(group) == 1 else _Copy.apply(x, group)


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` forward, identity backward (g)."""
    return x if _size(group) == 1 else _Reduce.apply(x, group)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The blocks of ``dim`` over ``group``, in group order; backward this
    rank's block."""
    return x if _size(group) == 1 else _Gather.apply(x, group, dim)


def max_(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over ``group`` of a tensor outside autograd
    (exact in any dtype)."""
    from .mesh import _max
    return x if _size(group) == 1 else _max(x.detach(), group)
