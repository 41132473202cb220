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

    def state_specs(self, optimizer) -> dict:
        """The placements of ``optimizer``'s state in the layout the
        transform kwargs select (``psgd_state_specs``)."""
        return psgd_state_specs(
            self.param_placements, optimizer,
            scanned_layers=self.scanned_layers, stack_axis=self.stack_axis,
            factor_sharding_params=self.params if self.factor_sharded else None,
            mesh=self.mesh, shared_layers=self.shared_layers)

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
