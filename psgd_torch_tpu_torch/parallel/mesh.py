"""Meshes, partition maps and the drift check on ``torch.distributed``
(counterpart of psgd_torch_tpu/parallel/mesh.py).

The reference keeps replicated PSGD state consistent by broadcasting RNG
states and re-broadcasting parameters now and then (its DDP wrapper).  The
port needs neither: every rank derives the same threefry key tree on the
host from the same seed (``ops.fastrand``), so replicas that see the same
gradients stay bit for bit equal.  What is left is where the state lives:

* ``make_mesh``: a ``DeviceMesh`` with named dims, the world size factored
  as the JAX ``make_mesh`` factors a device count; ``make_multihost_mesh``
  with a leading dim across hosts (``LOCAL_WORLD_SIZE`` ranks each);
* ``gpt2_partition_specs`` and ``llama_partition_specs``: each parameter
  name of ``models.gpt2`` / ``models.llama`` mapped to its DTensor
  placements on such a mesh (fsdp and tp as the JAX maps place them);
* ``shard_group``: the process group, shard index and shard count of a
  ``stack_sharding`` argument (a mesh dim, a tuple of dims taken as one
  flattened dim, or a ``ProcessGroup``);
* ``all_gather_stack``: a layer stack assembled from its shards, bit for
  bit (``all_gather`` of the shards' bytes);
* ``MeshAxes``: the collectives of the dim-sharded (``factor_sharding``)
  fit over named mesh dims; ``gather_whole``, a DTensor's local block
  made whole by ``all_gather`` of bytes over the dims that shard it;
* ``LayerReshard``: a layer stack sharded within its layers (JAX's
  ``(None, fsdp, tp)``) to and from the rank's layers that
  ``stack_sharding`` fits, by bytes;
* ``RowReduce``: the sums and maxes of the row-sharded (``vector_sharding``)
  LRA and dense fits over one group;
* ``psgd_state_specs``, ``lra_state_specs`` and ``dense_state_specs``: the
  placements of an optimizer's state under ``stack_sharding``,
  ``factor_sharding`` and ``vector_sharding``;
* ``drift_check``: max |x - rank 0's copy| per tensor over a group.

Every collective here but the drift check's reports itself to the open
``utils.profiling.count_collectives`` windows.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.profiling import record_collective


def _factor(n: int, n_axes: int) -> list:
    """The JAX ``make_mesh`` factoring of n devices over n_axes axes: tp
    (the last) takes 2 when n is even and >= 4, the one before it the rest."""
    sizes = [1] * n_axes
    if n_axes >= 3 and n % 2 == 0 and n >= 4:
        sizes[-1] = 2
        n //= 2
    sizes[-2 if n_axes >= 2 else -1] = n
    return sizes


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp", "fsdp", "tp"),
              axis_sizes: Optional[Sequence[int]] = None,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` over the ranks of the default process group
    (``torch.distributed.init_process_group`` first, on every rank).

    ``axis_sizes`` pins the factoring (it must multiply to the world
    size); without it the world size is factored greedily from the last
    axis, as the JAX ``make_mesh`` factors a device count: 8 ranks ->
    (dp 1, fsdp 4, tp 2), 4 -> (1, 2, 2), 2 -> (1, 2, 1).  ``n_devices``,
    when given, must equal the world size (a mesh spans every rank).
    ``device_type`` is the mesh's device: "cuda" (default; without a card
    it raises) or "cpu"; the collectives are the default group's backend's
    (gloo in the tests and on a one-card machine, where several ranks
    share ``cuda:0``)."""
    from torch.distributed.device_mesh import init_device_mesh
    from .. import resolve_device
    resolve_device(device_type)
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"n_devices {n_devices} is not the world size {world}")
    names = tuple(axis_names)
    if axis_sizes is not None:
        sizes = [int(s) for s in axis_sizes]
        if len(sizes) != len(names):
            raise ValueError(f"axis_sizes {sizes} does not match axis_names "
                             f"{names}")
        prod = 1
        for s in sizes:
            prod *= s
        if prod != world:
            raise ValueError(f"axis_sizes {sizes} multiply to {prod}, but the "
                             f"world size is {world}")
    else:
        sizes = _factor(world, len(names))
    return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=names)


def make_multihost_mesh(axis_names: Sequence[str] = ("dcn", "fsdp", "tp"),
                        ici_shape: Optional[Sequence[int]] = None,
                        device_type: str = "cuda"):
    """A ``DeviceMesh`` whose leading dim spans hosts and whose trailing
    dims stay within one host (JAX ``make_multihost_mesh``): shard the
    parameters over the trailing dims, keep the leading one for data
    parallelism, whose gradient all-reduce tolerates the slower link.

    A host is a node of ranks: ``LOCAL_WORLD_SIZE`` of them (as torchrun
    sets it; unset, the whole world is one host), numbered host-major, so
    rank r sits on host r // LOCAL_WORLD_SIZE.  With one host it returns
    ``make_mesh(axis_names=axis_names)``.  Otherwise ``ici_shape`` (the
    trailing dims' sizes, multiplying to the per-host count) defaults to
    the JAX factoring: tp 2 when the per-host count is even and at least
    4, the rest fsdp, ones before them; fewer axis names than 1 +
    len(ici_shape) raise ValueError, as JAX does.  ``device_type`` as
    ``make_mesh``'s."""
    from torch.distributed.device_mesh import init_device_mesh
    from .. import resolve_device
    resolve_device(device_type)
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_host < 1 or world % per_host:
        raise ValueError(f"LOCAL_WORLD_SIZE {per_host} does not divide the "
                         f"world size {world}")
    n_hosts = world // per_host
    if n_hosts == 1:
        return make_mesh(axis_names=axis_names, device_type=device_type)
    names = tuple(axis_names)
    min_axes = 1 + (len(ici_shape) if ici_shape is not None else 2)
    if len(names) < min_axes:
        raise ValueError(
            f"make_multihost_mesh needs at least {min_axes} axis names "
            f"(one leading DCN axis + {min_axes - 1} ICI axes), got "
            f"{names}. With fewer axes an ICI dimension would "
            "fold into the DCN axis and its collectives would cross DCN.")
    if ici_shape is None:
        tp = 2 if per_host % 2 == 0 and per_host >= 4 else 1
        ici_shape = [1] * (len(names) - 3) + [per_host // tp, tp]
    ici = [int(s) for s in ici_shape]
    if math.prod(ici) != per_host:
        raise ValueError(f"ici_shape {tuple(ici)} does not multiply to the "
                         f"{per_host} ranks of a host")
    shape = [n_hosts] + [1] * (len(names) - 1 - len(ici)) + ici
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def _placements(mesh, dims) -> tuple:
    """DTensor placements for per-tensor-dim mesh axes: ``dims[d]`` is None,
    a mesh dim name or a tuple of them (the tensor dim sharded over each,
    major to minor in mesh order).  Names that are not dims of ``mesh``
    leave that axis replicated, so one map serves a 1-D fsdp mesh too."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(dims):
        if axes is None:
            continue
        for ax in ((axes,) if isinstance(axes, str) else tuple(axes)):
            if ax in names:
                out[names.index(ax)] = Shard(d)
    return tuple(out)


def gpt2_partition_specs(mesh, fsdp_axis="fsdp", tp_axis="tp") -> dict:
    """Parameter name of ``models.gpt2.GPT2`` -> DTensor placements on
    ``mesh``: the JAX ``gpt2_partition_specs`` (column-parallel qkv and fc,
    tp on the output dim; row-parallel proj, tp on the input dim; fsdp on
    the opposite dim; the embeddings vocab x embd; LayerNorms and biases
    replicated or with their matmul's tp).  ``fsdp_axis`` or ``tp_axis`` may
    be a tuple of mesh dims (that tensor dim sharded over each) or a name
    that ``mesh`` lacks (that axis replicated)."""
    f, t = fsdp_axis, tp_axis
    dims = {
        "wte": (t, f), "wpe": (None, f),
        "blocks.ln1_scale": (None, None), "blocks.ln1_bias": (None, None),
        "blocks.attn_qkv_w": (None, f, t), "blocks.attn_qkv_b": (None, t),
        "blocks.attn_proj_w": (None, t, f), "blocks.attn_proj_b": (None, None),
        "blocks.ln2_scale": (None, None), "blocks.ln2_bias": (None, None),
        "blocks.mlp_fc_w": (None, f, t), "blocks.mlp_fc_b": (None, t),
        "blocks.mlp_proj_w": (None, t, f), "blocks.mlp_proj_b": (None, None),
        "lnf_scale": (None,), "lnf_bias": (None,),
    }
    return {k: _placements(mesh, v) for k, v in dims.items()}


def llama_partition_specs(mesh, model=None, fsdp_axis="fsdp",
                          tp_axis="tp") -> dict:
    """Parameter name of ``models.llama.Llama`` -> DTensor placements on
    ``mesh``: the JAX ``llama_partition_specs`` (column-parallel ``wqkv``
    and ``w_gu``, row-parallel ``wo`` and ``w_down``, RMSNorm scales
    replicated, the embedding vocab x embd).  With ``model`` the untied
    ``lm_head`` is included when the model has one.  Axes as
    ``gpt2_partition_specs``."""
    f, t = fsdp_axis, tp_axis
    dims = {
        "wte": (t, f),
        "blocks.rms1_scale": (None, None), "blocks.wqkv": (None, f, t),
        "blocks.wo": (None, t, f), "blocks.rms2_scale": (None, None),
        "blocks.w_gu": (None, f, t), "blocks.w_down": (None, t, f),
        "rmsf_scale": (None,),
    }
    if model is not None and getattr(model, "lm_head", None) is not None:
        dims["lm_head"] = (f, t)
    return {k: _placements(mesh, v) for k, v in dims.items()}


class ShardGroup(NamedTuple):
    """A process group over which a layer stack is sharded: ``index`` is
    this rank's shard, ``size`` the shard count and ``order[j]`` the shard
    that group rank j holds."""
    group: object
    index: int
    size: int
    order: tuple


def shard_group(spec) -> ShardGroup:
    """The group of a ``stack_sharding`` argument: a ``ProcessGroup``
    (shards in group-rank order), or ``(mesh, dim)`` with ``dim`` a mesh
    dim name or index, or a tuple of them taken as one flattened dim whose
    shards run major to minor in the tuple's order (JAX
    ``axis_index((a, b))``).  Every rank of the mesh must call it alike:
    one dim is the mesh's own group along it (a mesh cut from a larger one
    too), several make one group per slice of the mesh along the other
    dims (the mesh must span the world)."""
    if isinstance(spec, dist.ProcessGroup):
        size = dist.get_world_size(spec)
        return ShardGroup(spec, dist.get_rank(spec), size, tuple(range(size)))
    mesh, dims = spec
    names = tuple(mesh.mesh_dim_names or ())
    dims = dims if isinstance(dims, (tuple, list)) else (dims,)
    idx = [names.index(d) if isinstance(d, str) else int(d) for d in dims]
    if len(set(idx)) != len(idx):
        raise ValueError(f"stack_sharding dims {tuple(dims)} repeat a dim")
    ranks = mesh.mesh
    me = dist.get_rank()
    if len(idx) == 1:
        cut = list(mesh.get_coordinate())
        cut[idx[0]] = slice(None)
        row = ranks[tuple(cut)].reshape(-1).tolist()     # mesh order
        group = mesh.get_group(idx[0])
        return ShardGroup(group, row.index(me), len(row), tuple(
            row.index(r) for r in dist.get_process_group_ranks(group)))
    if ranks.numel() != dist.get_world_size():
        raise ValueError(f"stack_sharding over dims {tuple(dims)} of a mesh "
                         "that does not span the world: pass one dim")
    rest = [d for d in range(ranks.ndim) if d not in idx]
    rows = ranks.permute(rest + idx).reshape(-1, int(
        torch.tensor([ranks.shape[d] for d in idx]).prod()))
    mine = None
    for row in rows.tolist():
        group = dist.new_group(row)          # collective: every row, in order
        if me in row:
            mine = (group, row)
    group, row = mine
    order = tuple(row.index(r) for r in dist.get_process_group_ranks(group))
    return ShardGroup(group, row.index(me), len(row), order)


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """x's bytes as a uint8 tensor: collectives that copy them are exact
    for every dtype (bf16, complex) and keep -0 and NaN payloads."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def all_gather_stack(local: torch.Tensor, sg: ShardGroup) -> torch.Tensor:
    """The whole stack (sg.size * local.shape[0], ...) from every rank's
    slice, shard i at rows [i n, (i+1) n): one ``all_gather`` of the
    slices' bytes.  A copy, so the stack is each owner's slice bit for
    bit (an all_reduce of zero-padded slices would turn -0 into +0)."""
    out = torch.empty((sg.size * local.shape[0],) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    chunks = [_bytes(c) for c in out.chunk(sg.size)]
    dist.all_gather([chunks[s] for s in sg.order], _bytes(local),
                    group=sg.group)
    record_collective("all-gather", out, sg.group)
    return out


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """JAX ``psum`` over ``group``: in float32 or wider
    (``torch.promote_types(dtype, float32)``: bf16 partials summed in
    float32 and cast back once), by an all-reduce, which leaves every rank
    the same bits."""
    acc = x.to(torch.promote_types(x.dtype, torch.float32)).contiguous()
    flat = torch.view_as_real(acc) if acc.is_complex() else acc
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    record_collective("all-reduce", flat, group)
    return acc.to(x.dtype)


def _max(x: torch.Tensor, group) -> torch.Tensor:
    """JAX ``pmax`` over ``group`` (exact in any dtype)."""
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    record_collective("all-reduce", x, group)
    return x


class RowReduce:
    """The reductions of a row-sharded (``vector_sharding``) LRA or dense
    fit over one ``ShardGroup`` (JAX ``psum`` and ``pmax`` over the mesh
    axis inside ``shard_map``): ``sum`` (in float32 or wider, as
    ``MeshAxes.sum``), ``max`` and this rank's shard ``index``, which keys
    its probes (``precond.lra.shard_key``)."""

    def __init__(self, sg: ShardGroup):
        self.sg = sg
        self.index = sg.index
        self.size = sg.size

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _sum(x, self.sg.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return _max(x, self.sg.group)


class MeshAxes:
    """The collectives of the dim-sharded (``factor_sharding``) fit over
    named dims of a ``DeviceMesh`` (JAX's ``all_gather``, ``all_to_all``,
    ``psum``, ``pmax`` and ``axis_index`` over mesh axes inside
    ``shard_map``).  ``axes`` arguments are tuples of mesh dim names, taken
    as one flattened dim whose shards run major to minor in the tuple's
    order (JAX ``_linear_axis_index``).  Each tuple's process group is made
    by ``groups`` (a collective: every rank calls it alike, in the same
    order) or on first use.

    Copies move bytes (``_bytes``), so every dtype crosses exactly.  Sums
    run in float32 or wider (``torch.promote_types(dtype, float32)``: bf16
    partials summed in float32 and cast back once), by gloo's (or NCCL's)
    all-reduce, which leaves every rank of the group the same bits; so a
    replicated factor fitted from the sum stays equal on every rank."""

    def __init__(self, mesh):
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        self._size = dict(zip(names, (int(s) for s in mesh.mesh.shape)))
        self._coord = dict(zip(names, mesh.get_coordinate()))
        self._groups = {}

    @property
    def sizes(self) -> dict:
        """Mesh dim name -> size."""
        return dict(self._size)

    def size(self, axes) -> int:
        k = 1
        for ax in axes:
            k *= self._size[ax]
        return k

    def index(self, axes) -> int:
        """This rank's linear shard index over ``axes``."""
        idx = 0
        for ax in axes:
            idx = idx * self._size[ax] + self._coord[ax]
        return idx

    def groups(self, *axes_list) -> None:
        """Make the groups of these axes tuples now."""
        for axes in axes_list:
            self.group(axes)

    def group(self, axes) -> ShardGroup:
        axes = tuple(axes)
        if axes not in self._groups:
            self._groups[axes] = shard_group((self.mesh, axes))
        return self._groups[axes]

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The blocks of ``dim`` over one mesh dim, in shard order (JAX
        ``all_gather(..., tiled=True)``)."""
        whole = all_gather_stack(x.movedim(dim, 0), self.group((axis,)))
        return whole.movedim(0, dim)

    def all_to_all(self, x: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """JAX ``all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
        block j of ``split_dim`` goes to shard j of ``axis``, and the blocks
        received are joined along ``concat_dim`` in shard order.  One
        ``all_to_all_single`` of the blocks' bytes."""
        sg = self.group((axis,))
        blocks = x.chunk(sg.size, dim=split_dim)
        send = torch.cat([_bytes(blocks[s]) for s in sg.order])
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=sg.group)
        record_collective("all-to-all", recv, sg.group)
        shape = blocks[0].shape
        parts = [None] * sg.size
        for j, part in enumerate(recv.chunk(sg.size)):
            parts[sg.order[j]] = part.view(x.dtype).reshape(shape)
        return torch.cat(parts, dim=concat_dim)

    def sum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """JAX ``psum`` over ``axes``, in float32 or wider, cast back."""
        return _sum(x, self.group(axes).group)

    def max(self, x: torch.Tensor, axes) -> torch.Tensor:
        """JAX ``pmax`` over ``axes`` (exact in any dtype)."""
        return _max(x, self.group(axes).group)


def sharding_axes(placements, mesh_names) -> list:
    """(mesh dim name, tensor dim) of each ``Shard`` placement, in mesh
    order; raises ValueError on a placement that is neither ``Shard`` nor
    ``Replicate`` (a ``Partial`` parameter has no whole to gather)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name, pl in zip(mesh_names, placements):
        if isinstance(pl, Shard):
            out.append((name, pl.dim))
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl} is neither Shard nor Replicate")
    return out


def gather_whole(local: torch.Tensor, axes: MeshAxes, placements) -> torch.Tensor:
    """The whole tensor from every rank's block of a DTensor laid out by
    ``placements`` on ``axes.mesh`` (evenly divided): an ``all_gather`` of
    bytes along each sharded tensor dim, the minor mesh dim first, so the
    whole is each owner's block bit for bit.  Every rank calls it alike."""
    x = local
    for name, d in reversed(sharding_axes(placements, axes.mesh.mesh_dim_names)):
        if axes.size((name,)) > 1:
            x = axes.all_gather(x.contiguous(), name, d % x.ndim)
    return x


def _mesh_coordinate(mesh, rank: int) -> Optional[tuple]:
    """Where global ``rank`` sits in ``mesh`` (None: not in it)."""
    hit = (mesh.mesh == int(rank)).nonzero()
    return tuple(int(c) for c in hit[0]) if hit.shape[0] == 1 else None


class LayerReshard:
    """A layer stack placed within its layers (JAX ``gpt2_partition_specs``'
    ``(None, fsdp, tp)``: each rank a block of every layer) and the same
    stack as ``stack_sharding`` fits it: this rank's layers [r L/k, (r+1)
    L/k), whole within each layer (JAX's shard_map ``in_specs`` /
    ``out_specs`` ``PS(axis, None, ...)``, psgd_torch_tpu/optim/
    transforms.py:410-422).  Bytes only, so the layers are each owner's
    blocks bit for bit.

    ``to_layers(block)``: an ``all_gather`` over each mesh dim outside the
    stack axis that shards the leaf (``gather_whole``'s, those dims only),
    then one ``all_to_all_single`` over the stack axis's group (layer chunk
    ``order[j]`` to group rank j; each rank's block of this rank's layers
    back, placed by the sender's mesh coordinate).  ``to_layers``'s
    inverse, ``to_block(layers)``: one ``all_to_all_single`` (each group
    rank's block of this rank's layers to it; its layers of this rank's
    block back).  Both report to ``count_collectives``.

    ``mesh`` and ``placements``: the leaf's DTensor layout; ``shape`` its
    global shape; ``sg`` and ``stack_dims``: the stack axis's
    ``ShardGroup`` and mesh dim names.  Raises NotImplementedError, naming
    the placements, for a layout the reshard cannot express: a sharded
    layer dim, a stack dim the mesh lacks, a tensor dim sharded both over
    stack dims and over others, an uneven block, a group that is not the
    stack dims' row of ``mesh``."""

    def __init__(self, mesh, placements, shape, sg: ShardGroup, stack_dims,
                 name: str):
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(mesh.mesh_dim_names or ())
        self.mesh, self.shape, self.sg = mesh, tuple(int(n) for n in shape), sg
        self.placements = tuple(placements)

        def refuse(why):
            raise NotImplementedError(
                f"stack_sharding: {name} has placements {self.placements} on "
                f"mesh dims {names}: {why}, which the layer reshard cannot "
                "express")

        stack = tuple(stack_dims or ())
        if not stack:
            refuse("stack_sharding is a process group, not mesh dims")
        missing = [d for d in stack if d not in names]
        if missing:
            refuse(f"the stack dims {missing} are not dims of its mesh")
        self.by_dim = {}                  # tensor dim -> mesh dims, mesh order
        for md, pl in enumerate(self.placements):
            if isinstance(pl, Shard):
                self.by_dim.setdefault(pl.dim % len(shape), []).append(md)
            elif not isinstance(pl, Replicate):
                refuse(f"{pl} is neither Shard nor Replicate")
        if 0 in self.by_dim:
            refuse("its layer dim is sharded")
        in_stack = {names.index(d) for d in stack}
        self.gather = []                  # (mesh dim name, tensor dim)
        for d, mds in self.by_dim.items():
            kinds = {md in in_stack for md in mds}
            if len(kinds) > 1:
                refuse(f"dim {d} is sharded over stack dims and others")
            k = math.prod(mesh.size(md) for md in mds)
            if self.shape[d] % k:
                refuse(f"dim {d} of size {self.shape[d]} is not divisible by "
                       f"its {k}-way sharding")
            if kinds == {False}:
                self.gather += [(names[md], d) for md in mds]
        self.gather.sort(key=lambda x: names.index(x[0]))
        self.coord = mesh.get_coordinate()
        # each group rank's mesh coordinate: the stack dims' row of mesh
        self.members = []
        for r in dist.get_process_group_ranks(sg.group):
            c = _mesh_coordinate(mesh, r)
            if c is None or any(c[m] != self.coord[m] for m in range(len(names))
                                if m not in in_stack):
                refuse(f"the stack group's rank {r} is not in this rank's "
                       f"row of {stack}")
            self.members.append(c)
        self.axes = MeshAxes(mesh)
        self.axes.groups(*[(n,) for n, _ in self.gather])
        self.layers = self.shape[0] // sg.size

    def block_slices(self, coord, dims=None) -> tuple:
        """The block of the rank at ``coord``: a slice per tensor dim
        (``dims``: those tensor dims only, the others whole)."""
        out = [slice(None)] * len(self.shape)
        for d, mds in self.by_dim.items():
            if dims is not None and d not in dims:
                continue
            k, idx = 1, 0
            for md in mds:
                k *= self.mesh.size(md)
                idx = idx * self.mesh.size(md) + coord[md]
            n = self.shape[d] // k
            out[d] = slice(idx * n, (idx + 1) * n)
        return tuple(out)

    def _exchange(self, send: list, shapes: list, dtype) -> list:
        """One all_to_all_single: ``send[j]`` to group rank j; what each
        group rank sent back, by group rank."""
        buf = torch.cat([_bytes(x) for x in send])
        recv = torch.empty_like(buf)
        dist.all_to_all_single(recv, buf, group=self.sg.group)
        record_collective("all-to-all", recv, self.sg.group)
        out, at = [], 0
        for shape in shapes:
            n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
            out.append(recv[at:at + n].view(dtype).reshape(shape))
            at += n
        return out

    def to_layers(self, block: torch.Tensor) -> torch.Tensor:
        """This rank's layers, whole, from every rank's block: the
        exchange over the stack axis first (the ranks that differ only
        outside it hold the same layers), then the gathers."""
        chunks = block.contiguous().chunk(self.sg.size, 0)
        part = tuple(chunks[0].shape)
        got = self._exchange([chunks[s] for s in self.sg.order],
                             [part] * self.sg.size, block.dtype)
        kept = set(self.by_dim) - {d for _, d in self.gather}
        mid = torch.empty([self.shape[d] if d in kept else n
                           for d, n in enumerate(part)], dtype=block.dtype,
                          device=block.device)
        for c, piece in zip(self.members, got):
            mid[self.block_slices(c, kept)] = piece
        for name, d in reversed(self.gather):     # the minor dim first
            mid = self.axes.all_gather(mid.contiguous(), name, d)
        return mid.contiguous()

    def to_block(self, layers: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole stack from every rank's layers
        (``to_layers``'s inverse)."""
        send = [layers[self.block_slices(c)].contiguous() for c in self.members]
        mine = tuple(layers[self.block_slices(self.coord)].shape)
        got = self._exchange(send, [mine] * self.sg.size, layers.dtype)
        parts = [None] * self.sg.size
        for j, piece in enumerate(got):
            parts[self.sg.order[j]] = piece
        return torch.cat(parts, 0)


def drift_check(tensors, group=None):
    """Max |x - rank 0's copy| of each tensor over ``group`` (default: the
    world), the debug counterpart of the reference's resync broadcasts
    (JAX ``drift_check``).  Rank 0's copy is taken by ``broadcast``, which
    copies it exactly, never by a mean (summing k equal copies rounds, so a
    mean-based check would report drift on equal replicas); the max over
    ranks by ``all_reduce(MAX)``.  Bitwise replicas give exactly 0.
    ``tensors``: a dict (name -> tensor) or a sequence; returns floats in
    the same structure."""
    names = list(tensors) if isinstance(tensors, dict) else None
    xs = list(tensors.values()) if names is not None else list(tensors)
    src = 0 if group is None else dist.get_global_rank(group, 0)
    out = []
    for x in xs:
        # a contiguous copy, its bytes a view that the broadcast writes
        x0 = x.detach().clone(memory_format=torch.contiguous_format)
        dist.broadcast(_bytes(x0), src=src, group=group)
        d = torch.amax(torch.abs(x.detach() - x0)) if x.numel() else \
            torch.zeros((), device=x.device)
        d = torch.real(d).to(torch.float64).reshape(1)
        dist.all_reduce(d, op=dist.ReduceOp.MAX, group=group)
        out.append(float(d))
    return dict(zip(names, out)) if names is not None else out


def squeezed_axes(shape, placements, mesh_names) -> tuple:
    """Per squeezed dim of a leaf, the mesh dims that shard it, as
    ``mesh_names`` names them (in mesh order: DTensor's major to minor);
    a singleton dim is dropped (JAX ``_squeeze_spec``)."""
    from torch.distributed.tensor import Shard
    per = [[] for _ in shape]
    for md, pl in enumerate(placements):
        if isinstance(pl, Shard):
            per[pl.dim % len(shape)].append(mesh_names[md])
    return tuple(tuple(a) for n, a in zip(shape, per) if int(n) != 1)


def routed_axes(shape, placements, mesh_names, *, scanned: bool,
                shared: bool, dq: str) -> Optional[tuple]:
    """The one factor-sharding rule (JAX transforms.py:896-912), read by
    the optimizers' routing, ``ShardingRecipe.routed`` and
    ``psgd_state_specs``: a leaf goes through the dim-sharded fit when it
    is unscanned, unpooled, its geometry (canonical name) is in
    ``kron.DIM_SHARDABLE_DQS`` and a squeezed dim is sharded.  Returns its
    ``squeezed_axes`` then, else None."""
    from ..precond.kron import DIM_SHARDABLE_DQS
    if scanned or shared or dq not in DIM_SHARDABLE_DQS:
        return None
    axes = squeezed_axes(shape, placements, mesh_names)
    return axes if any(axes) else None


def _named_bools(value, names, what: str) -> dict:
    """A per-leaf flag (None, True: every leaf, a dict name -> bool) by
    name."""
    if value is None or value is True:
        return {n: value is True for n in names}
    unknown = sorted(set(value) - set(names))
    if unknown:
        raise ValueError(f"{what} names {unknown}, which are not parameters")
    return {n: bool(value.get(n, False)) for n in names}


def psgd_state_specs(param_placements: dict, optimizer, scanned_layers=None,
                     stack_axis=None, factor_sharding_params=None, mesh=None,
                     shared_layers=None) -> dict:
    """The DTensor placements of a KronWhiten or KronNewton state (JAX
    ``psgd_state_specs``, psgd_torch_tpu/parallel/mesh.py:206-355, with
    placements where JAX has PartitionSpecs): parameter name ->
    {"mu", "q", "lips", "pcache"}, each a placements tuple (a tuple of them
    per factor; None where the state has no such entry).

    ``param_placements``: name -> the parameter's placements (a
    ``gpt2_partition_specs`` map), in the optimizer's parameters' order
    once sorted by dotted path.  The momentum follows the parameter; with
    ``stack_axis`` (a mesh dim name or a tuple of them) a scanned
    (``scanned_layers``: name -> bool), unpooled leaf's Q, L and cache are
    ``Shard(0)`` over it; with ``factor_sharding_params`` (name -> tensor,
    for the leaf shapes) the diagonal factors (and cache) of a leaf that
    ``routed_axes`` routes, read with the optimizer's plans, are sharded
    over the axes ``kron.dim_shard_reshard_plan`` gives their dim in the
    compute layout, given ``mesh``; without ``mesh`` it warns,
    as JAX does, and takes the raw axes of the parameter's dims; a pooled
    (``shared_layers``) leaf and everything else is ``Replicate()``.  Where
    a dim's compute axes are not in mesh order (GPT-2's ``wte`` under
    (tp, fsdp): tp major), the port's blocks run major to minor in the
    plan's order, which DTensor's placements do not spell."""
    from torch.distributed.tensor import Replicate, Shard
    from ..precond.kron import dim_shard_reshard_plan
    names = sorted(param_placements, key=lambda n: tuple(n.split(".")))
    params = optimizer.param_groups[0]["params"]
    if len(params) != len(names):
        raise ValueError(f"param_placements names {len(names)} parameters, "
                         f"the optimizer holds {len(params)}")
    n_mesh = len(param_placements[names[0]]) if names else 0
    mesh_names = (tuple(mesh.mesh_dim_names) if mesh is not None
                  else tuple(range(n_mesh)))
    rep = (Replicate(),) * n_mesh

    def sharded0(axes) -> tuple:
        out = list(rep)
        for ax in axes:
            out[mesh_names.index(ax)] = Shard(0)
        return tuple(out)

    flags = _named_bools(scanned_layers, names, "scanned_layers")
    shared = (dict(flags) if shared_layers is True else
              _named_bools(shared_layers, names, "shared_layers"))
    shapes = (None if factor_sharding_params is None else
              {n: tuple(t.shape) for n, t in dict(factor_sharding_params).items()})
    if shapes is not None and mesh is None:
        warnings.warn(
            "psgd_state_specs(factor_sharding_params=...) without mesh=: "
            "the placements take the raw per-dim axes, not the compute "
            "layout (dense-dim axes moved onto a diagonal dim by "
            "dim_shard_reshard_plan) the optimizer holds. Pass mesh= to "
            "match it.", stacklevel=2)
    if stack_axis is not None:
        if mesh is None:
            raise ValueError("psgd_state_specs: stack_axis needs mesh=")
        stack = (stack_axis,) if isinstance(stack_axis, str) else tuple(stack_axis)

    def dim_sharded(q, plan, axes) -> tuple:
        if mesh is not None:       # the compute layout the optimizer holds
            sizes = dict(zip(mesh_names, (int(s) for s in mesh.mesh.shape)))
            axes = dim_shard_reshard_plan(plan, axes, sizes)[0]
        return tuple(sharded0(axes[i]) if f.ndim == 1 and axes[i] else rep
                     for i, f in enumerate(q))

    out = {}
    for k, (name, p) in enumerate(zip(names, params)):
        st = optimizer.state[p]
        q, pc = st["q"], st.get("pcache")
        reps = (tuple(rep for _ in q), tuple(rep for _ in st["lips"]))
        axes = None if shapes is None else routed_axes(
            shapes[name], param_placements[name], mesh_names,
            scanned=flags[name], shared=shared[name], dq=optimizer.plans[k].dq)
        if shared[name]:
            qs, ls = reps
        elif flags[name] and stack_axis is not None:
            qs = tuple(sharded0(stack) for _ in q)
            ls = tuple(sharded0(stack) for _ in st["lips"])
        elif axes is not None:
            qs, ls = dim_sharded(q, optimizer.plans[k], axes), reps[1]
        else:
            qs, ls = reps
        out[name] = {"mu": tuple(param_placements[name]) if "mu" in st else None,
                     "q": qs, "lips": ls, "pcache": None if pc is None else qs}
    return out


def _row_placements(mesh, axis) -> tuple:
    """(rows sharded over ``axis``, replicated) placements on ``mesh``;
    ``axis`` a mesh dim name or a tuple of them (the rows sharded over
    each, major to minor)."""
    return _placements(mesh, (axis,)), _placements(mesh, ())


def _flat_core(optimizer, field: str, what: str):
    opt = getattr(optimizer, "optimizer", optimizer)
    precond = getattr(opt, "precond", None)
    if precond is None or not hasattr(precond, field):
        raise ValueError(f"{what} takes an optimizer whose state is "
                         f"{'an LRA' if field == 'u' else 'a dense'} "
                         f"preconditioner, not {type(opt).__name__}")
    return opt


def lra_state_specs(optimizer, mesh, axis) -> dict:
    """The DTensor placements of an LRAWhiten or LRANewton state (or a
    closure class's) under ``vector_sharding=(mesh, axis)`` (JAX
    ``lra_state_specs``, psgd_torch_tpu/parallel/mesh.py:356-376): U, V,
    d and the momentum ``Shard(0)`` over ``axis``; the Lipschitz
    estimates, the count and the key ``Replicate()``.  {"u", "v", "d",
    "lu", "lv", "ld", "mu", "count", "key"}; "mu" None without momentum."""
    opt = _flat_core(optimizer, "u", "lra_state_specs")
    rows, rep = _row_placements(mesh, axis)
    return dict(u=rows, v=rows, d=rows, lu=rep, lv=rep, ld=rep,
                mu=None if opt.mu is None else rows, count=rep, key=rep)


def dense_state_specs(optimizer, mesh, axis) -> dict:
    """The DTensor placements of a DenseNewton state under
    ``vector_sharding=(mesh, axis)`` (JAX ``dense_state_specs``,
    psgd_torch_tpu/parallel/mesh.py:379-397): Q ``Shard(0)`` (its rows)
    over ``axis``; L, the momentum (a vector of n, whole on every rank),
    the count and the key ``Replicate()``.  {"q", "lips", "mu", "count",
    "key"}; "mu" None without momentum."""
    opt = _flat_core(optimizer, "lips", "dense_state_specs")
    rows, rep = _row_placements(mesh, axis)
    return dict(q=rows, lips=rep, mu=None if opt.mu is None else rep,
                count=rep, key=rep)
