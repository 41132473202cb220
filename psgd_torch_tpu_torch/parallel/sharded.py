"""Per-shard Kron preconditioning over DTensor parameters (counterpart of
psgd_torch_tpu/parallel/sharded.py, the reference's DTensor/FSDP2 wrapper).

The reference's DTensor wrapper preconditions each local shard of a
parameter on its own ("not optimal but acceptable"): a (4096, 8192) weight
sharded 8 ways gets eight independent (512, 8192) Kron preconditioners and
the optimizer communicates nothing.  ``PerShardKronWhiten`` and
``PerShardKronNewton`` (factories ``per_shard_kron_whiten`` and
``per_shard_kron_newton``) do the same as ``torch.optim.Optimizer``\\ s over
DTensor parameters, as FSDP2 and tensor parallelism leave them: each
parameter's local shard (``p.to_local()``, its gradient
``p.grad.to_local()``) gets its own Kron state, planned from the squeezed
local shape, and is updated in place.

Keys.  Leaf i's fit key is ``fold_in(k_fit, i)`` folded once more per
sharded tensor dim, in dim order, with this rank's shard index along that
dim, linearised major to minor over the mesh dims that shard it (JAX
``_linear_index``, sharded.py:91-97).  Ranks that hold the same shard (a
replicated mesh dim) draw the same keys, so their state stays bit for bit
equal without communication.

Collectives.  On step 0 without ``preconditioner_init_scale`` each leaf's
statistics are averaged over the mesh dims that shard it (JAX ``pmean``,
sharded.py:329-348): the shards' values are gathered and summed in shard
order, so every rank, and the JAX mean of two shards, sums them alike.
Newton's ``grad_clip_max_norm`` reads the global update tree, as JAX's
``_global_norm_scale`` does: its ``outs`` are the shard_map's global
arrays, not the local views (sharded.py:473-477).  So a finite clip adds
one gather of the leaves' squared norms per set of sharding mesh dims per
step; each shard counts once however many ranks hold it.  Nothing else
communicates.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..ops import fastrand
from ..ops.linalg import real_dtype_of
from ..optim.transforms import (KronNewton, KronWhiten, _cast, _classic_decay,
                                _descend, _pytree_order, _sched)
from ..precond import kron as kron_p
from .mesh import all_gather_stack, shard_group

_NOT_PER_SHARD = ("scanned_layers", "shared_layers", "pipelined_fit",
                  "stack_sharding", "factor_sharding")


class _LeafShard:
    """Where one DTensor leaf's local shard sits: ``index[d]`` the linear
    shard index along each sharded tensor dim, ``axes`` the mesh dims
    that shard it (mesh order), ``slices`` its rows of the global tensor."""

    def __init__(self, p, mesh, name):
        from torch.distributed.tensor import Replicate, Shard
        coord = mesh.get_coordinate()
        per_dim = {}
        for md, pl in enumerate(p.placements):
            if isinstance(pl, Shard):
                per_dim.setdefault(pl.dim % p.ndim, []).append(md)
            elif not isinstance(pl, Replicate):
                raise ValueError(f"{name}: placement {pl} is neither Shard "
                                 "nor Replicate")
        self.index, self.slices = {}, [slice(None)] * p.ndim
        for d, mds in sorted(per_dim.items()):
            k, idx = 1, 0
            for md in mds:
                k *= mesh.size(md)
                idx = idx * mesh.size(md) + coord[md]
            if p.shape[d] % k:
                raise ValueError(f"{name}: dim {d} of size {p.shape[d]} is "
                                 f"not divisible by its {k}-way sharding")
            n = p.shape[d] // k
            self.index[d] = idx
            self.slices[d] = slice(idx * n, (idx + 1) * n)
        self.axes = tuple(sorted(md for mds in per_dim.values() for md in mds))

    @classmethod
    def given(cls, index: dict) -> "_LeafShard":
        """A shard known only by its indices (``on_shards``)."""
        self = cls.__new__(cls)
        self.index, self.slices, self.axes = dict(index), None, ()
        return self


class _PerShard:
    """What the two per-shard optimizers add to KronWhiten / KronNewton:
    DTensor parameters turned into their local shards (the optimizer's
    parameters), the shard-folded keys, the step-0 per-leaf init scale and
    the per-rank layout."""

    def _setup(self, params, mesh, kwargs: dict):
        from torch.distributed.tensor import DTensor
        for k in _NOT_PER_SHARD:
            if k in kwargs:
                raise TypeError(f"a per-shard optimizer takes no {k!r}")
        kwargs.setdefault("preconditioner_init_scale", 1.0)
        items = list(params)
        names, tensors, _ = _pytree_order(items)
        names = names or [f"leaf {i}" for i in range(len(tensors))]
        for n, p in zip(names, tensors):
            if not isinstance(p, DTensor):
                raise TypeError(
                    f"{n} is a plain tensor: a per-shard optimizer takes "
                    "DTensor parameters (over unsharded tensors use "
                    "KronWhiten / KronNewton)")
            if p.device_mesh != mesh:
                raise ValueError(f"{n} lives on another mesh")
        self.mesh = mesh
        self.dparams = tensors
        self.shards = [_LeafShard(p, mesh, n) for n, p in zip(names, tensors)]
        with torch.no_grad():   # the shards' storage, updated in place
            local = [p.to_local() for p in tensors]
        # one group per set of sharding mesh dims, created in the same order
        # on every rank
        self.groups = {}
        for s in self.shards:
            if s.axes and s.axes not in self.groups:
                self.groups[s.axes] = shard_group((mesh, s.axes))
        return local

    @classmethod
    def on_shards(cls, shards, lr=None, **kwargs):
        """The optimizer that one rank of a per-shard run is, built in one
        process from that rank's shards, to hold the rank against:
        ``shards`` = [(name, local tensor, {tensor dim: shard index})] in
        any order (sorted by name, as the DTensor run sorts them).  No
        mesh and no collective: the init scale must be explicit; set the
        local tensors' ``.grad`` and call ``step()`` (whitening).  ``lr``
        and ``kwargs`` as the class takes them."""
        if kwargs.get("preconditioner_init_scale", 1.0) is None:
            raise ValueError("on_shards needs an explicit "
                             "preconditioner_init_scale (no collective)")
        self = cls.__new__(cls)
        names, tensors, order = _pytree_order([(n, t) for n, t, _ in shards])
        self.mesh, self.dparams, self.groups = None, None, {}
        self.shards = [_LeafShard.given(shards[i][2]) for i in order]
        kwargs.setdefault("preconditioner_init_scale", 1.0)
        if lr is not None:
            kwargs["lr"] = lr
        super(_PerShard, self).__init__(tensors, **kwargs)
        return self

    @property
    def per_rank(self) -> bool:
        return True

    def _unsharded_layout(self):
        """None: a per-shard state has no unsharded form (each shard's Q
        is planned from the shard's shape), so its checkpoint restores only
        at the world size that wrote it."""
        return None

    def _pieces(self):
        return None

    def _layout(self) -> dict:
        out = super()._layout()
        out["per_shard"] = dict(
            world=dist.get_world_size() if self.mesh is not None else 1,
            coordinate=(list(self.mesh.get_coordinate())
                        if self.mesh is not None else None))
        for i, s in enumerate(self.shards):
            out[f"leaf {i}"]["shard"] = [[d, s.index[d]] for d in sorted(s.index)]
        return out

    def _leaf_key(self, k_fit, i):
        kk = fastrand.fold_in(k_fit, i)
        for d in sorted(self.shards[i].index):
            kk = fastrand.fold_in(kk, self.shards[i].index[d])
        return kk

    def _local_grads(self) -> list:
        local = self.param_groups[0]["params"]
        grads = ([p.grad for p in local] if self.dparams is None else
                 [None if p.grad is None else p.grad.to_local()
                  for p in self.dparams])
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(local, grads)]

    def _global_sums(self, values) -> list:
        return global_sums(values, self.shards, self.groups)

    def _global_means(self, values) -> list:
        """The JAX ``pmean`` of each leaf's scalar over its shards."""
        sums = self._global_sums(values)
        return [s if not sh.axes else s / self.groups[sh.axes].size
                for s, sh in zip(sums, self.shards)]

    def _rescale_leaves(self, params, scales) -> None:
        """Multiply each leaf's Q by its own init scale (squared for the
        fit-P geometries), spread over the factors; refresh the cache."""
        for p, plan, scale in zip(params, self.plans, scales):
            st = self.state[p]
            eff = scale * scale if plan.fits_p else scale
            mult = eff ** (1.0 / max(plan.order, 1))
            st["q"] = tuple(q * mult.to(real_dtype_of(q.dtype)) for q in st["q"])
            if self.cache_p:
                st["pcache"] = kron_p.compute_p_factors(
                    kron_p.KronState(q=st["q"], lips=st["lips"]), plan)


def global_sums(values, shards, groups) -> list:
    """Each leaf's scalar summed over its shards (every shard once, in
    shard order), so every rank holds the same bits; a leaf sharded
    nowhere keeps its own.  ``shards``: each leaf's ``_LeafShard``;
    ``groups``: its mesh dims (``_LeafShard.axes``) -> ``ShardGroup``."""
    out = list(values)
    batches = {}      # one gather per set of mesh dims and dtype
    for i, (s, v) in enumerate(zip(shards, values)):
        if s.axes:
            batches.setdefault((s.axes, v.dtype), []).append(i)
    for (axes, _), idx in batches.items():
        sg = groups[axes]
        local = torch.stack([values[i].reshape(()) for i in idx])[None]
        every = all_gather_stack(local, sg)      # (k, len(idx))
        for j, i in enumerate(idx):
            acc = every[0, j]
            for r in range(1, sg.size):
                acc = acc + every[r, j]
            out[i] = acc
    return out


def _m4(x) -> torch.Tensor:
    return torch.mean(torch.abs(_cast(x, torch.float32)) ** 4)


class PerShardKronWhiten(_PerShard, KronWhiten):
    """Per-shard gradient/momentum whitening (JAX
    ``scale_by_per_shard_kron_whiten`` with ``per_shard_kron_whiten``'s
    weight decay and -lr; the reference's DTensor wrapper).

    ``params``: DTensor parameters, or (name, DTensor) pairs such as
    ``model.named_parameters()`` (sorted by name, the JAX pytree order);
    ``mesh``: the ``DeviceMesh`` they live on.  The other arguments are
    ``KronWhiten``'s with the JAX per-shard defaults
    (``preconditioner_init_scale=1.0``; None sets it on the fly at step 0,
    which also forces that step's fit), minus ``scanned_layers``,
    ``shared_layers``, ``pipelined_fit`` and ``stack_sharding``: each
    local shard is one tensor to its preconditioner.  ``share_fit_apply``,
    ``cache_p``, ``whiten_grad``, ``update_preconditioner_first``, the
    weight decay modes, ``preconditioner_dtype`` and the schedules follow
    JAX ``_per_shard_core``.  ``step()`` reads ``p.grad.to_local()``."""

    def __init__(self, params, mesh, lr: float | Callable = 1e-3,
                 weight_decay: float = 0.0,
                 weight_decay_mode: str = "decoupled", **kwargs):
        local = self._setup(params, mesh, kwargs)
        KronWhiten.__init__(self, local, lr, weight_decay, weight_decay_mode,
                            **kwargs)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._step(self._local_grads())
        return loss

    def _step(self, grads) -> None:
        group = self.param_groups[0]
        params = group["params"]
        count = self.count
        grads = _classic_decay(group, grads, params)
        mus = (self._momentum(params, grads, count) if self.momentum > 0
               else None)
        keys = fastrand.split(self.key, 4)
        self.key, k_gate, k_fit = keys[0], keys[1], keys[3]
        onthefly = self.init_scale is None and count == 0
        do_fit = self._gate(k_gate, count) or onthefly
        damping = _sched(group["damping"], count)
        fit_args = (_sched(group["lr_preconditioner"], count),
                    _sched(group["betaL"], count), damping)
        clip = tuple(_sched(a, count) for a in group["grad_clip_max_amps"])
        fit_src = grads if self.whiten_grad else mus
        apply_src = mus if self.momentum > 0 else grads
        if onthefly:
            m4 = self._global_means([_m4(x) for x in fit_src])
            self._rescale_leaves(params, [(m + damping ** 4) ** (-1.0 / 8.0)
                                          for m in m4])
        fit_src = [(x,) for x in fit_src]
        if self.share_fit_apply and do_fit:
            pgs = self._fit(params, fit_src, k_fit, *fit_args, return_pg=True)
            updates = [self._finish(i, p, pgs[i], clip)
                       for i, p in enumerate(params)]
        elif self.update_preconditioner_first:
            if do_fit:
                self._fit(params, fit_src, k_fit, *fit_args)
            updates = self._apply(params, apply_src, clip)
        else:
            updates = self._apply(params, apply_src, clip)
            if do_fit:
                self._fit(params, fit_src, k_fit, *fit_args)
        self.fit_steps += int(do_fit)
        _descend(group, params, updates, count)
        self.count += 1


class PerShardKronNewton(_PerShard, KronNewton):
    """Per-shard Newton-type preconditioning (JAX
    ``scale_by_per_shard_kron_newton`` with ``per_shard_kron_newton``'s
    weight decay and -lr): each local shard's Kron preconditioner is fitted
    from the local views of a global probe v and its Hessian-vector
    product.  Arguments as ``PerShardKronWhiten`` (``KronNewton``'s, with
    ``preconditioner_init_scale=1.0`` by default and
    ``grad_clip_max_norm`` over the global tree).

    ``step(hvp_fn=None, vs=None, hvs=None)`` reads ``p.grad.to_local()``.
    On a fit step it needs the pair: ``hvp_fn(vs) -> hvs`` is called with
    the probes at the parameters' global shapes (plain tensors, drawn from
    split(k_v) per leaf as JAX ``rand_like_tree``; every rank draws the
    same) and returns H v per leaf, global plain tensors or DTensors; or
    the caller passes ``vs`` and ``hvs`` (global) itself.  Off fit steps
    ``hvp_fn`` is not called."""

    def __init__(self, params, mesh, lr: float | Callable = 0.01,
                 weight_decay: float = 0.0,
                 weight_decay_mode: str = "decoupled", **kwargs):
        local = self._setup(params, mesh, kwargs)
        KronNewton.__init__(self, local, lr, weight_decay, weight_decay_mode,
                            **kwargs)

    def _local_view(self, i, x) -> torch.Tensor:
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            return x.to_local()
        return x[tuple(self.shards[i].slices)]

    @torch.no_grad()
    def step(self, closure=None, *, hvp_fn=None, vs=None, hvs=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        group = self.param_groups[0]
        params = group["params"]
        count = self.count
        grads = _classic_decay(group, self._local_grads(), params)
        mus = (self._momentum(params, grads, count) if self.momentum > 0
               else None)
        keys = fastrand.split(self.key, 4)
        self.key, k_gate, k_v, k_fit = keys[0], keys[1], keys[2], keys[3]
        onthefly = self.init_scale is None and count == 0
        do_fit = self._gate(k_gate, count) or onthefly
        damping = _sched(group["damping"], count)
        if do_fit:
            if hvp_fn is not None:
                from ..optim import hvp
                vs = hvp.rand_like(k_v, self.dparams, self.draw)
                hvs = hvp_fn(vs)
            elif vs is None or hvs is None:
                raise ValueError("per-shard Newton needs hvp_fn or explicit "
                                 "(vs, hvs) on a fit step")
            vl = [self._local_view(i, v) for i, v in enumerate(vs)]
            hl = [self._local_view(i, h) for i, h in enumerate(hvs)]
            if onthefly:
                v2 = self._global_means([torch.mean(torch.abs(
                    _cast(v, torch.float32)) ** 2) for v in vl])
                h4 = self._global_means([_m4(h) for h in hl])
                self._rescale_leaves(params, [
                    a ** 0.25 * (b + damping ** 4) ** (-1.0 / 8.0)
                    for a, b in zip(v2, h4)])
            self._fit(params, list(zip(vl, hl)), k_fit,
                      _sched(group["lr_preconditioner"], count),
                      _sched(group["betaL"], count), damping)
        self.fit_steps += int(do_fit)
        src = mus if self.momentum > 0 else grads
        pre = [self._precond(i, p, x, f).reshape(p.shape) for i, (p, x, f)
               in enumerate(zip(params, src, self._apply_factors(params)))]
        max_norm = _sched(group["grad_clip_max_norm"], count)
        if max_norm != float("inf"):
            sq = self._global_sums([torch.sum(torch.real(x * torch.conj(x)))
                                    for x in pre])
            norm = torch.sqrt(sum(sq))
            scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-38),
                                max=1.0)
            pre = [u * scale for u in pre]
        _descend(group, params, pre, count)
        self.count += 1
        return loss


def per_shard_kron_whiten(params, mesh, learning_rate: float | Callable = 1e-3,
                          weight_decay: float = 0.0,
                          weight_decay_mode: str = "decoupled",
                          **kwargs) -> PerShardKronWhiten:
    """``PerShardKronWhiten`` with the JAX factory's argument names."""
    return PerShardKronWhiten(params, mesh, lr=learning_rate,
                              weight_decay=weight_decay,
                              weight_decay_mode=weight_decay_mode, **kwargs)


def per_shard_kron_newton(params, mesh, learning_rate: float | Callable = 0.01,
                          weight_decay: float = 0.0,
                          weight_decay_mode: str = "decoupled",
                          **kwargs) -> PerShardKronNewton:
    """``PerShardKronNewton`` with the JAX factory's argument names."""
    return PerShardKronNewton(params, mesh, lr=learning_rate,
                              weight_decay=weight_decay,
                              weight_decay_mode=weight_decay_mode, **kwargs)
