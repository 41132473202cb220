"""One declaration -> the optimizer's sharding kwargs and the parameters'
placement, consistent with each other (counterpart of
psgd_torch_tpu/parallel/recipe.py).

The sharded layout needs the same facts in two places: the optimizer takes
``stack_sharding=(mesh, axis)`` and ``factor_sharding=(mesh, placements)``,
while the routed parameters must be DTensors with exactly those placements
(and ``psgd_state_specs`` describes the state they lead to).
``sharding_recipe`` derives both from one declaration, resolves the stack
axis against the layer counts, and leaves the dim-sharded embedding path
off for a geometry the optimizer would not route.

Usage::

    recipe = sharding_recipe(mesh, gpt2_partition_specs(mesh),
                             model.named_parameters(),
                             scanned_layers=gpt2.scanned_layers_mask(model))
    opt = KronWhiten(recipe.place(model.named_parameters()),
                     **recipe.transform_kwargs)

To shard the model too, by FSDP2 over the recipe's mesh (1-D, or 2-D with
the replicas first), both take one placement map, ``model_placements()``:
each stack the optimizer shards ``Shard(0)`` over the stack axis (its
layers), the routed embeddings at the map's placements, the rest
replicated (left to FSDP2 as ignored parameters)::

    recipe = sharding_recipe(mesh, gpt2_partition_specs(mesh),
                             model.named_parameters(), scanned_layers=mask)
    fully_shard(model, **recipe.fsdp_kwargs(model))
    opt = KronWhiten(model.named_parameters(), **recipe.transform_kwargs)

``models.gpt2.shard_model`` and ``models.llama.shard_model`` take the
same map on any mesh (the trainer, ``examples/train_gpt2_sharded.py``,
shards so at every tp size).  On a mesh whose "tp" dim is larger than 1
(JAX's production layout, (dp, fsdp, tp)), ``model_placements()`` is the
map itself, the blocks placed within their layers as JAX's recipe places
them, and only the model shards itself, tensor parallelism inside its
forward (not FSDP2)::

    recipe = sharding_recipe(mesh, llama_partition_specs(mesh, model),
                             model.named_parameters(), scanned_layers=mask)
    llama.shard_model(model, mesh, recipe.model_placements())
    opt = KronWhiten(model.named_parameters(), **recipe.transform_kwargs)
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Optional, Tuple, Union

from .mesh import _named_bools, psgd_state_specs, routed_axes

StackAxis = Union[None, str, Tuple[str, ...]]


@dataclass(frozen=True)
class ShardingRecipe:
    """The resolved layout: give ``transform_kwargs`` to ``KronWhiten`` /
    ``KronNewton`` together with the parameters ``place`` returns."""

    mesh: Any
    param_placements: dict
    params: dict                   # name -> tensor
    scanned_layers: Optional[dict]
    stack_axis: StackAxis          # resolved; None: stack sharding off
    factor_sharded: bool           # the dim-sharded embedding path on or off
    dq: str
    shared_layers: Any = None      # the layer-stack pooling mask

    @property
    def within_layers(self) -> bool:
        """Whether the mesh has a "tp" dim larger than 1: the blocks then
        stay within-layer-sharded, as the map places them."""
        names = tuple(self.mesh.mesh_dim_names)
        return "tp" in names and int(self.mesh.mesh.shape[names.index("tp")]) > 1

    @property
    def transform_kwargs(self) -> dict:
        kw: dict = {"dq": self.dq}
        if self.scanned_layers is not None:
            kw["scanned_layers"] = self.scanned_layers
        if self.shared_layers is not None:
            kw["shared_layers"] = self.shared_layers
        if self.stack_axis is not None:
            kw["stack_sharding"] = (self.mesh, self.stack_axis)
        if self.factor_sharded:
            kw["factor_sharding"] = (self.mesh, self.param_placements)
        return kw

    def routed(self) -> list:
        """The names of the leaves the optimizer routes through the
        dim-sharded fit (``routed_axes``)."""
        if not self.factor_sharded:
            return []
        names = list(self.params)
        flags = _named_bools(self.scanned_layers, names, "scanned_layers")
        shared = (dict(flags) if self.shared_layers is True else
                  _named_bools(self.shared_layers, names, "shared_layers"))
        mesh_names = tuple(self.mesh.mesh_dim_names)
        return [n for n in names if routed_axes(
            self.params[n].shape, self.param_placements[n], mesh_names,
            scanned=flags[n], shared=shared[n], dq=self.dq) is not None]

    def model_placements(self) -> dict:
        """Name -> the placements the model's parameters take.  On a mesh
        whose tp dim is larger than 1 (``within_layers``): the map's, every
        leaf (JAX's recipe ``place``: the blocks ``(None, fsdp, tp)``, for
        ``models.gpt2.shard_model`` and ``models.llama.shard_model``).
        Otherwise the layer-sharded one
        (FSDP2's, or ``shard_model``'s): a routed leaf the map's; a stack
        the optimizer shards (scanned, unpooled, the stack axis resolved)
        ``Shard(0)`` over the stack axis; every other leaf
        ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        if self.within_layers:
            return {n: tuple(self.param_placements[n]) for n in self.params}
        names = tuple(self.mesh.mesh_dim_names)
        rep = (Replicate(),) * len(names)
        flags = _named_bools(self.scanned_layers, list(self.params),
                             "scanned_layers")
        shared = (dict(flags) if self.shared_layers is True else _named_bools(
            self.shared_layers, list(self.params), "shared_layers"))
        stack = ((self.stack_axis,) if isinstance(self.stack_axis, str)
                 else tuple(self.stack_axis or ()))
        routed = set(self.routed())
        out = {}
        for n in self.params:
            if n in routed:
                out[n] = tuple(self.param_placements[n])
            elif stack and flags[n] and not shared[n]:
                out[n] = tuple(Shard(0) if m in stack else Replicate()
                               for m in names)
            else:
                out[n] = rep
        return out

    def fsdp_kwargs(self, model) -> dict:
        """``fully_shard``'s mesh, ``shard_placement_fn`` and
        ``ignored_params`` for ``model_placements()``: a sharded leaf's
        ``Shard`` on the mesh's last dim (FSDP2 shards over it and keeps
        replicas over a leading dim), a replicated leaf ignored (its
        gradients must then be equal on every rank, or averaged by the
        caller).  Raises ValueError for a placement FSDP2 cannot take,
        and on a mesh whose tp dim is larger than 1: the port does not hand
        that layout to FSDP2 (``models.gpt2.shard_model`` or
        ``models.llama.shard_model`` shards it, its
        forward gathering the fsdp blocks itself), because under FSDP2 the
        forward runs on the unsharded parameters FSDP2 swaps in, which
        autograd from the loss reaches instead of the DTensor shards, so
        KronNewton's exact Hvp could not differentiate the shards (ROADMAP
        A8c)."""
        from torch.distributed.tensor import Shard
        if self.within_layers:
            raise ValueError(
                "fsdp_kwargs: the mesh's tp dim is larger than 1; "
                "the port shards this layout with models.gpt2.shard_model or "
                "models.llama.shard_model(model, mesh, "
                "recipe.model_placements()), not FSDP2: under FSDP2 "
                "autograd from the loss reaches the unsharded parameters FSDP2 "
                "swaps in, not the DTensor shards that KronNewton's exact Hvp "
                "differentiates (ROADMAP A8c)")
        placements = self.model_placements()
        by_id, ignored = {}, set()
        for n, p in model.named_parameters():
            pl = placements[n]
            if not any(isinstance(x, Shard) for x in pl):
                ignored.add(p)
                continue
            if any(isinstance(x, Shard) for x in pl[:-1]):
                raise ValueError(f"{n}: placements {pl} shard over a mesh dim "
                                 "other than the last, which FSDP2 cannot take")
            by_id[id(p)] = pl[-1]
        return dict(mesh=self.mesh, shard_placement_fn=lambda p: by_id.get(id(p)),
                    ignored_params=ignored)

    def state_specs(self, optimizer) -> dict:
        """The placements of ``optimizer``'s state in the layout the
        transform kwargs select (``psgd_state_specs``).  An optimizer over
        DTensor blocks (non-routed DTensor leaves: FSDP2's layer-sharded
        stacks, or ``shard_model``'s within-layer ones) is described over
        ``model_placements()``: the momentum follows each parameter's
        block; a stack the optimizer fits by layer (owned, or resharded to
        the rank's layers) holds its Q, L and cache ``Shard(0)`` over the
        stack axis and ``Replicate()`` over the other dims (tp), as
        ``psgd_state_specs`` says; a stack the optimizer gathers whole, a
        diagonal one, holds them ``Replicate()``, where JAX's specs place
        them over the stack axis (ROADMAP A8c)."""
        whole = getattr(optimizer, "whole", ())
        layer_sharded = any(getattr(optimizer, "owned", ())) or any(
            w is not None for w in whole) or any(
            r is not None for r in getattr(optimizer, "resharded", ()))
        out = psgd_state_specs(
            self.model_placements() if layer_sharded else self.param_placements,
            optimizer, scanned_layers=self.scanned_layers,
            stack_axis=self.stack_axis,
            factor_sharding_params=self.params if self.factor_sharded else None,
            mesh=self.mesh, shared_layers=self.shared_layers)
        if layer_sharded:
            from torch.distributed.tensor import Replicate
            rep = (Replicate(),) * len(self.mesh.mesh_dim_names)
            names = sorted(out, key=lambda n: tuple(n.split(".")))
            for name, w in zip(names, whole):
                if w is not None:
                    spec = out[name]
                    for key in ("q", "lips", "pcache"):
                        if spec[key] is not None:
                            spec[key] = tuple(rep for _ in spec[key])
        return out

    def place(self, named_params) -> list:
        """(name, parameter) pairs as the optimizer takes them: each routed
        leaf ``distribute_tensor``-ed to its placements (a DTensor
        parameter, cut from the whole tensor this rank holds, so every
        rank must hold the same values; no collective), the others as they
        are (the counterpart of JAX's ``device_put``)."""
        import torch
        from torch.distributed.tensor import distribute_tensor
        routed = set(self.routed())
        out = []
        for name, p in named_params:
            if name in routed:
                p = torch.nn.Parameter(
                    distribute_tensor(p.detach(), self.mesh,
                                      self.param_placements[name],
                                      src_data_rank=None),
                    requires_grad=p.requires_grad)
            out.append((name, p))
        return out


def _axis_size(mesh, axis) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.mesh.shape)))
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    missing = [a for a in names if a not in sizes]
    if missing:
        raise ValueError(f"stack_axis {missing} not in mesh axes "
                         f"{tuple(mesh.mesh_dim_names)}")
    k = 1
    for a in names:
        k *= sizes[a]
    return k


def sharding_recipe(mesh, param_placements: dict, params,
                    scanned_layers: Optional[dict] = None,
                    stack_axis: Union[StackAxis, str] = "auto",
                    dq: str = "Q0.5EQ1.5",
                    shared_layers: Any = None) -> ShardingRecipe:
    """The sharded optimizer layout from one declaration (JAX
    ``sharding_recipe``).

    ``mesh``: the ``DeviceMesh``; ``param_placements``: name -> DTensor
    placements (``gpt2_partition_specs``), naming every parameter;
    ``params``: (name, tensor) pairs or a dict (the leaf shapes decide
    the layer counts and the routed leaves); ``scanned_layers``: name ->
    bool.  ``stack_axis``: the mesh dim (or tuple of dims) to shard the
    layer stacks over; ``"auto"`` takes the largest single dim whose size
    divides every stack's layer count, and warns (stack sharding off) when
    none does; None turns stack sharding off.  ``dq``: the optimizer's
    geometry: the dim-sharded path exists for ``kron.DIM_SHARDABLE_DQS``
    only, so for another the embeddings stay replicated.
    ``shared_layers``: the optimizer's pooling mask (True: every scanned
    leaf); pooled leaves hold one state and are not stack-sharded."""
    from ..precond import kron as kron_p
    dq = kron_p.canonical_dq(dq)
    params = dict(params)
    names = list(params)
    if sorted(param_placements) != sorted(names):
        raise ValueError(
            f"param_placements names {len(param_placements)} leaves but params "
            f"has {len(names)} — the two must match leaf-for-leaf")
    flags = _named_bools(scanned_layers, names, "scanned_layers")
    shared = (dict(flags) if shared_layers is True else
              _named_bools(shared_layers, names, "shared_layers"))
    counts = sorted({int(params[n].shape[0]) for n in names
                     if flags[n] and not shared[n]})
    sizes = dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.mesh.shape)))
    resolved: StackAxis = None
    if counts:
        if stack_axis == "auto":
            best, best_size = None, 1
            for name in mesh.mesh_dim_names:
                size = _axis_size(mesh, name)
                if size > best_size and all(c % size == 0 for c in counts):
                    best, best_size = name, size
            resolved = best
            if resolved is None and max(sizes.values()) > 1:
                warnings.warn(
                    f"sharding_recipe: no mesh axis of {sizes} divides the "
                    f"layer counts {counts}; preconditioner stack sharding "
                    "disabled (Q replicated)", stacklevel=2)
        elif stack_axis is not None:
            size = _axis_size(mesh, stack_axis)
            bad = [c for c in counts if c % size]
            if bad:
                raise ValueError(
                    f"stack_axis {stack_axis!r} (size {size}) does not divide "
                    f"the stacked layer counts {bad}")
            resolved = stack_axis
    factor_sharded = dq in kron_p.DIM_SHARDABLE_DQS and any(
        not flags[n] and any(pl.is_shard() for pl in param_placements[n])
        for n in names)
    return ShardingRecipe(mesh=mesh, param_placements=param_placements,
                          params=params, scanned_layers=scanned_layers,
                          stack_axis=resolved, factor_sharded=factor_sharded,
                          dq=dq, shared_layers=shared_layers)
