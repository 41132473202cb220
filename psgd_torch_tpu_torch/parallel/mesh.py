"""Meshes, partition maps and the drift check on ``torch.distributed``
(counterpart of psgd_torch_tpu/parallel/mesh.py).

The reference keeps replicated PSGD state consistent by broadcasting RNG
states and re-broadcasting parameters now and then (its DDP wrapper).  The
port needs neither: every rank derives the same threefry key tree on the
host from the same seed (``ops.fastrand``), so replicas that see the same
gradients stay bit for bit equal.  What is left is where the state lives:

* ``make_mesh``: a ``DeviceMesh`` with named dims, the world size factored
  as the JAX ``make_mesh`` factors a device count;
* ``gpt2_partition_specs`` and ``llama_partition_specs``: each parameter
  name of ``models.gpt2`` / ``models.llama`` mapped to its DTensor
  placements on such a mesh (fsdp and tp as the JAX maps place them);
* ``shard_group``: the process group, shard index and shard count of a
  ``stack_sharding`` argument (a mesh dim, a tuple of dims taken as one
  flattened dim, or a ``ProcessGroup``);
* ``all_gather_stack``: a layer stack assembled from its shards, bit for
  bit (``all_gather`` of the shards' bytes);
* ``drift_check``: max |x - rank 0's copy| per tensor over a group.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


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
    ``device_type`` is the mesh's device: "cuda" (default) or "cpu"; the
    collectives are the default group's backend's (gloo in the tests and
    on a one-card machine, where several ranks share ``cuda:0``)."""
    from torch.distributed.device_mesh import init_device_mesh
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
    it creates one group per slice of the mesh along the other dims."""
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
    rest = [d for d in range(ranks.ndim) if d not in idx]
    rows = ranks.permute(rest + idx).reshape(-1, int(
        torch.tensor([ranks.shape[d] for d in idx]).prod()))
    me = dist.get_rank()
    mine = None
    for row in rows.tolist():
        group = dist.new_group(row)          # collective: every row, in order
        if me in row:
            mine = (group, row)
    group, row = mine
    order = tuple(row.index(r) for r in sorted(row))
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
    return out


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
        x0 = x.detach().clone()
        dist.broadcast(_bytes(x0), src=src, group=group)
        d = torch.amax(torch.abs(x.detach() - x0)) if x.numel() else \
            torch.zeros((), device=x.device)
        d = torch.real(d).to(torch.float64).reshape(1)
        dist.all_reduce(d, op=dist.ReduceOp.MAX, group=group)
        out.append(float(d))
    return dict(zip(names, out)) if names is not None else out
