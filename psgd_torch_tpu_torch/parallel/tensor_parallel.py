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
windows.  On a group of one rank each is the identity (no call).

The models' shared tensor-parallel machinery (GPT-2's and LLaMA's
``shard_model`` and forwards): ``shard`` places a model's parameters as
DTensors and returns its ``TPLayout`` (the tp group, this rank's index,
the fsdp gathers of each block; ``PLAIN`` the unsharded model's, whose
collectives are the identity), ``embedding`` the vocab-parallel lookup and
``cross_entropy`` the vocab-parallel cross-entropy."""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

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


class TPLayout:
    """A model's tensor-parallel layout: the tp group, its size and this
    rank's index on it, and per sharded parameter the (group, tensor dim)
    gathers that make its block its tp block (the minor mesh dim first).
    The unsharded model's, ``PLAIN``, has size 1 and no gathers: every
    collective is then the identity."""

    def __init__(self, group=None, size: int = 1, index: int = 0,
                 gathers: dict | None = None):
        self.group, self.size, self.index = group, size, index
        self.gathers = gathers or {}

    def block(self, p, name: str):
        """Parameter ``name``'s tp block: a sharded one's local block (in
        the autograd graph) gathered over the other mesh dims that shard
        it; an unsharded one as it is."""
        if name not in self.gathers:
            return p
        x = p.to_local()
        for group, dim in self.gathers[name]:
            x = gather(x, group, dim)
        return x

    def copy(self, x):
        return x if self.size == 1 else copy(x, self.group)

    def reduce(self, x):
        return x if self.size == 1 else reduce(x, self.group)

    def gather(self, x, dim: int):
        return x if self.size == 1 else gather(x, self.group, dim)

    def max_(self, x):
        return max_(x, self.group)


PLAIN = TPLayout()


def shard(model, mesh, placements: dict, tp_dims: dict) -> TPLayout:
    """Place ``model``'s parameters on ``mesh`` (``placements``: name ->
    DTensor placements, naming every parameter) and return the layout its
    tensor-parallel forward takes (the model's ``shard_model`` sets it).
    ``tp_dims``: parameter name -> the tensor dim its forward takes
    sharded over the mesh dim "tp" (absent: replicated over tp).  Each
    DTensor parameter is cut from the whole tensor this rank holds (every
    rank must hold the same, as a seeded init makes them; no collective).
    The mesh dim "tp" (absent: tp 1) must shard the dims ``tp_dims`` names
    and no other; the other mesh dims may shard any dim tp does not, each
    sharded dim evenly.  Every rank calls it alike.  Raises ValueError for
    another layout."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    if model._tp is not PLAIN:
        raise ValueError("the model is sharded already")
    names = tuple(mesh.mesh_dim_names)
    params = dict(model.named_parameters())
    if sorted(placements) != sorted(params):
        raise ValueError(f"placements name {sorted(placements)}, the model "
                         f"has {sorted(params)}")
    coord = mesh.get_coordinate()

    def group_of(md):
        group = mesh.get_group(md)
        if dist.get_rank(group) != coord[md]:
            raise ValueError(f"mesh dim {names[md]}: the group's rank order "
                             "is not the mesh's")
        return group

    t_md = names.index("tp") if "tp" in names else None
    tp_size = 1 if t_md is None else mesh.size(t_md)
    gathers = {}
    for name, p in params.items():
        pl = tuple(placements[name])
        want = tp_dims.get(name)
        have = Replicate() if t_md is None else pl[t_md]
        if tp_size > 1 and not (have == Replicate() if want is None else
                                have == Shard(want)):
            raise ValueError(f"{name}: placements {pl} put tp on "
                             f"{have}; the tensor-parallel forward takes "
                             f"{'Replicate()' if want is None else Shard(want)}")
        steps, ways = [], {}
        for md, x in enumerate(pl):
            if not isinstance(x, (Shard, Replicate)):
                raise ValueError(f"{name}: placement {x} is neither Shard "
                                 "nor Replicate")
            if isinstance(x, Replicate):
                continue
            d = x.dim % p.ndim
            ways[d] = ways.get(d, 1) * mesh.size(md)
            if md == t_md:
                continue
            if tp_size > 1 and d == want:
                raise ValueError(f"{name}: placements {pl} shard dim {d} over "
                                 f"tp and {names[md]}")
            steps.append((group_of(md), d))
        for d, k in ways.items():
            if p.shape[d] % k:
                raise ValueError(f"{name}: dim {d} of size {p.shape[d]} does "
                                 f"not divide over its {k}-way sharding")
        gathers[name] = steps[::-1]              # the minor mesh dim first
    with torch.no_grad():
        for name, p in params.items():
            dt = distribute_tensor(p.detach(), mesh, tuple(placements[name]),
                                   src_data_rank=None)
            owner, _, attr = name.rpartition(".")
            setattr(model.get_submodule(owner), attr,
                    nn.Parameter(dt, requires_grad=p.requires_grad))
    return TPLayout(None if t_md is None else group_of(t_md), tp_size,
                    0 if t_md is None else coord[t_md], gathers)


def embedding(table: torch.Tensor, tokens: torch.Tensor,
              lay: TPLayout) -> torch.Tensor:
    """The rows of ``tokens`` in ``table``, this rank's tp block of the
    embedding's rows: vocab-parallel at tp > 1 (each rank looks up the
    tokens of its rows, zeros for the others, and the sum over tp is the
    lookup)."""
    if lay.size == 1:
        return table[tokens]
    n = table.shape[0]
    lo = lay.index * n
    inside = (tokens >= lo) & (tokens < lo + n)
    rows = table[(tokens - lo).clamp(0, n - 1)]
    return lay.reduce(torch.where(inside[..., None], rows, 0.0))


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  lay: TPLayout) -> torch.Tensor:
    """The mean cross-entropy over vocab-parallel logits (this rank's
    columns [r V/tp, (r+1) V/tp) of the float32 logits): the max, the sum
    of exponentials and the target's logit summed over tp."""
    n = logits.shape[-1]
    lo = lay.index * n
    m = lay.max_(logits.detach().amax(-1))
    total = lay.reduce(torch.exp(logits - m[..., None]).sum(-1))
    inside = (targets >= lo) & (targets < lo + n)
    # the target's logit where this rank holds it, else 0 (nll_loss's
    # ignored rows): its backward has a deterministic CUDA kernel
    mine = -F.nll_loss(logits.reshape(-1, n),
                       torch.where(inside, targets - lo, -100).reshape(-1),
                       reduction="none", ignore_index=-100)
    target = lay.reduce(mine.reshape(targets.shape))
    return torch.mean(torch.log(total) + m - target)
