"""The port's PSGD optimizers as ``torch.optim.Optimizer`` classes.

``KronWhiten``: counterpart of ``scale_by_kron_whiten`` / ``kron_whiten`` in
psgd_torch_tpu/optim/transforms.py (the optax chain weight decay -> whiten
-> weight decay -> -lr), with the ``zero_grad`` / ``backward`` / ``step``
contract.  Hyperparameters, defaults and the order of operations follow
the JAX transform:

* on-the-fly init scale on the first step when no
  ``preconditioner_init_scale`` is given;
* the bias-warmed momentum EMA;
* the fit gate ``uniform < preconditioner_update_probability`` (decided on
  the host from the threefry key tree; a literal probability >= 1 fits
  every step without drawing a gate's use);
* fit then apply (``update_preconditioner_first=True``) or apply then fit;
* whitening the gradient or the momentum (``whiten_grad``);
* per-tensor (per-layer for stacks) amplitude clipping;
* decoupled or classic weight decay, then -lr.  Decoupled decay applies to
  every parameter, biases and LayerNorm included, as optax's
  ``add_decayed_weights`` without a mask.

``KronNewton``: counterpart of ``scale_by_kron_newton`` / ``kron_newton``
(reference class KronNewton, psgd.py:832-978), fitted from Hessian-vector
products, with the reference's closure contract: ``step(closure)`` takes a
closure that returns the loss without calling backward.

``LRAWhiten``, ``LRANewton`` and ``DenseNewton``: counterparts of
``lra_whiten``, ``lra_newton`` and ``dense_newton`` (reference classes
LRAWhiten, LRANewton, DenseNewton, psgd.py:1075-1563), one preconditioner
over all parameters concatenated into one vector (``precond.lra``,
``precond.dense``); the Newton ones take the closure as KronNewton does.

``scanned_layers`` marks parameters whose leading axis is a layer stack:
each layer gets its own preconditioner and the whole stack one batched
update.  ``shared_layers`` (True, or a subset of the scanned parameters)
instead pools a stack into one preconditioner over the whole tensor, its
layer axis a diagonal factor.  ``cache_p`` keeps P_i = Q_i^H Q_i per
factor after every fit, so the apply is one product per dim.  KronWhiten
also takes ``share_fit_apply`` (a fit step's update is the fit's own
P damped(src)) and ``pipelined_fit`` (the fit reads the momentum as it
was before this step's EMA).  Parameter order (which fixes each leaf's
key) is the JAX pytree order: named parameters are sorted by their dotted
path.  KronWhiten and KronNewton take real and complex parameters and Q
(complex64, complex128; a complex Q over real parameters as the JAX
transforms take it: the sources cast to Q's dtype, the update's real part
applied); a complex gradient is what torch puts in ``.grad``, the
conjugate of what ``jax.grad`` returns, and ``p - lr * update`` descends.
The LRA and dense optimizers take them too, in the JAX package's forms
(``precond.lra``, ``precond.dense``: transposes where a Hermitian
preconditioner conjugates), with or without ``vector_sharding``.

``stack_sharding=(mesh, dim)`` (KronWhiten, KronNewton; or a
``ProcessGroup``, or a tuple of mesh dims taken as one) partitions the
preconditioner ZeRO-style, as the JAX transforms' ``stack_sharding``
does: of each scanned, unshared leaf with a dense factor, rank r of k
holds, fits and applies Q (and L, and the cache) for layers
[r L/k, (r+1) L/k) only, keyed by its slice of ``split(key, L)`` so the
result does not depend on k, bit for bit; the preconditioned layers are
then assembled on every rank by one ``all_gather`` of their bytes
(``parallel.mesh.all_gather_stack``).  Every other leaf, and the
gradients, momentum, gate and init scale, stay replicated: the ranks
must see the same gradients (average them first, as DDP does).  Under
``stack_sharding`` a leaf may also be a DTensor parameter that is not
routed, as FSDP2 (``fully_shard``) or the ``shard_model`` of
``models.gpt2`` and ``models.llama`` leave them: a stack the optimizer
shards whose local block is the rank's layers ``Shard(0)`` is fitted,
applied and stepped in place on that block, never gathered, its momentum
the block's; a stack the optimizer shards whose block is sharded within
its layers (JAX ``gpt2_partition_specs``' and ``llama_partition_specs``'
``(None, fsdp, tp)``) has its sources resharded to the rank's layers by
bytes (``parallel.mesh.LayerReshard``: an ``all_to_all_single`` over the
stack axis, an ``all_gather`` over the other dims that shard it), fitted
and applied as such a stack is, and its update resharded back into the
block, its momentum the block's, so k ranks equal 1 bit for bit; any
other (a diagonal stack, an unscanned leaf) is made whole by an
``all_gather`` of bytes (``parallel.gather_whole``), fitted and applied
as a replicated leaf, and its update's block written back, its momentum
the block's too.  KronNewton takes such leaves through the closure
(autograd differentiates the DTensor parameters, which the
``shard_model`` forwards of ``models.gpt2`` and ``models.llama`` reach;
under FSDP2 it cannot and raises) or through ``step(hvp_fn=)`` / ``step(vs=, hvs=)``.  ``_pieces``
and ``_unsharded_layout`` say where each rank's state sits in the
unsharded optimizer's, for checkpoints across world sizes
(``utils.gather_checkpoint``).
``factor_sharding=(mesh, placements)`` (KronWhiten, KronNewton) keeps one
global preconditioner for each leaf whose dims FSDP or TP shard, as the
JAX transforms' ``factor_sharding`` does: ``placements`` maps every
parameter name to its DTensor placements (``parallel.gpt2_partition_specs``
/ ``llama_partition_specs``), and a leaf that is not scanned, not shared,
in a geometry of ``kron.DIM_SHARDABLE_DQS`` and whose squeezed dims are
sharded is routed: it must be a DTensor parameter on ``mesh`` with exactly
those placements (what FSDP2 or TP hands an optimizer).  Its momentum is
this rank's block, its diagonal Q factors (and cache) this rank's blocks
in the compute layout (``kron.dim_shard_reshard_plan``: the axes of a
dense dim moved onto a diagonal dim, or the dense dim gathered), its dense
factors and L whole and equal on every rank; the fit runs on the local
blocks with one sum per dense factor over the mesh
(``kron.update_kron_whiten_dim_sharded`` / ``_newton_``), and the update
is written into ``p.to_local()``.  Every other leaf is a plain tensor,
replicated (or stack-sharded).  The amplitude clip's RMS, the step-0 init
scale and Newton's norm clip read the global leaves.  With routed leaves
``KronNewton.step`` takes the gradients from ``.grad`` and the pair from
``hvp_fn=`` or ``vs=``/``hvs=``, as the per-shard optimizers do.
``vector_sharding=(mesh, dim)`` (LRAWhiten, LRANewton, DenseNewton with
dq="QEQ"; or a ``ProcessGroup``) row-shards the one LRA or dense
preconditioner ZeRO-style, as the JAX transforms' ``vector_sharding``
does: each rank holds and fits a block of rows of U, V, d and the
momentum (of Q, for dense), the fit's reductions are r-sized (n-sized
for dense) sums over the group, and one ``all_gather`` of the update's
rows assembles the update on every rank (``lra_state_specs``,
``dense_state_specs`` describe the state).
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops import fastrand
from ..ops.linalg import real_dtype_of, resolve_norm_k
from ..precond import dense as dense_p
from ..precond import kron as kron_p
from ..precond import lra as lra_p
from . import hvp


def _sched(value, count: int):
    """A static hyperparameter, or a schedule ``count -> value``."""
    return value(count) if callable(value) else value


def _static_always(prob) -> bool:
    """A literal update probability >= 1: every step fits, no gate."""
    return isinstance(prob, (int, float)) and float(prob) >= 1.0


def _squeezed_shape(shape) -> tuple:
    """Drop singleton dims (reference squeezes grads, psgd.py:597)."""
    return tuple(int(s) for s in shape if int(s) != 1)


def _amp_clip(g: torch.Tensor, max_avg_amp: float, max_element_amp: float,
              stacked: bool) -> torch.Tensor:
    """RMS (accumulated in float32) and elementwise amplitude clipping per
    tensor, or per layer of a stack (psgd.py:642-651); a complex element
    is scaled down to modulus ``max_element_amp``, g / max(|g| / max, 1)
    (JAX ``_amp_clip``)."""
    dims = tuple(range(1, g.ndim)) if stacked else tuple(range(g.ndim))
    sq = torch.real(g * torch.conj(g)).to(torch.float32)
    avg_amp = torch.sqrt(torch.mean(sq, dim=dims, keepdim=True) if dims
                         else sq)
    scale = torch.clamp(max_avg_amp / torch.clamp(avg_amp, min=1e-30),
                        max=1.0).to(real_dtype_of(g.dtype))
    g = g * scale
    if g.is_complex():
        return g / torch.clamp(torch.abs(g) / max_element_amp, min=1.0)
    return torch.clamp(g, -max_element_amp, max_element_amp)


def _sharded_amp_clip(pg: torch.Tensor, clip_amps, total,
                      numel: int) -> torch.Tensor:
    """``_amp_clip`` of a block of a sharded tensor of ``numel`` entries,
    its RMS over the whole (JAX ``_sharded_amp_clip``: a float32 local
    sum; ``total(x)``, sum(x) over the shards)."""
    max_avg, max_el = clip_amps
    ss = total(torch.real(pg * torch.conj(pg)).to(torch.float32))
    avg = torch.sqrt(ss / numel)
    pg = pg * torch.clamp(max_avg / torch.clamp(avg, min=1e-30),
                          max=1.0).to(real_dtype_of(pg.dtype))
    if pg.is_complex():
        return pg / torch.clamp(torch.abs(pg) / max_el, min=1.0)
    return torch.clamp(pg, -max_el, max_el)


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x in ``dtype``; a complex x cast to a real dtype keeps its real part,
    as JAX's ``astype`` does."""
    if x.is_complex() and not dtype.is_complex:
        x = torch.real(x)
    return x.to(dtype)


def _whiten_scale_from_grads(grads, flags, damping: float,
                             mean=None) -> torch.Tensor:
    """On-the-fly init scale (mean|g|^4 + damping^4)^(-1/8), max over tensors
    (each layer of a stack counts as a tensor), on the device.  Of a
    complex g the real part only, as the JAX transform's
    ``g.astype(jnp.float32)`` reads it (ROADMAP, notes on the reference).
    ``mean(i, x)``: leaf i's mean (``_Kron._mean``: a routed leaf's over
    the global leaf)."""
    ms = []
    for i, (g, f) in enumerate(zip(grads, flags)):
        g4 = torch.abs(_cast(g, torch.float32)) ** 4
        if f:
            ms.append(torch.amax(torch.mean(g4.reshape(g4.shape[0], -1), 1)))
        else:
            ms.append(torch.mean(g4) if mean is None else mean(i, g4))
    return (torch.amax(torch.stack(ms)) + damping ** 4) ** (-1.0 / 8.0)


def _rounded(x: float, dtype: torch.dtype) -> float:
    """x as the nearest value of ``dtype`` (host-side, no device work)."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def _advisories(init_scale, whiten_grad: bool, momentum: float, dq: str,
                q_dtype) -> None:
    """The reference classes' stdout advisories (psgd.py:557, 564, 568) as
    Python warnings at construction (JAX ``_advisories``)."""
    if init_scale is None:
        warnings.warn(
            "Preconditioner initial scale will be set on the fly from the "
            "first step's statistics; recommend setting "
            "preconditioner_init_scale manually.", stacklevel=3)
    if not whiten_grad and momentum > 0:
        factor = ((1 + momentum) / (1 - momentum)) ** 0.5
        warnings.warn(
            f"Momentum whitening: recommend dividing the gradient-whitening "
            f"learning rate by {factor:.2f} for this setting.", stacklevel=3)
    if dq in kron_p._FIT_P and q_dtype is not None and \
            torch.finfo(real_dtype_of(q_dtype)).eps > 1e-6:
        warnings.warn(
            "Fitting P directly (QUAD4P/PRO4P) in half precision is risky; "
            "prefer float32 preconditioner_dtype for the *4P geometries.",
            stacklevel=3)


def _leaf_flags(option: str, value, names, n: int) -> list:
    """A per-leaf option as bools in the given parameter order: a dict
    name -> bool (named parameters; a name that is no parameter raises),
    or a sequence of n bools."""
    if isinstance(value, dict):
        if names is None:
            raise ValueError(f"a {option} dict needs named parameters")
        unknown = sorted(set(value) - set(names))
        if unknown:
            raise ValueError(f"{option} names {unknown}, which are not "
                             "parameters")
        return [bool(value.get(k, False)) for k in names]
    flags = [bool(f) for f in value]
    if len(flags) != n:
        raise ValueError(f"{option} has {len(flags)} entries, params have {n}")
    return flags


def _shared_flags(shared_layers, scan: list, names) -> list:
    """``shared_layers`` per leaf (JAX ``_shared_flags``): True pools every
    scanned stack; otherwise a dict or sequence whose marked leaves must be
    scanned (the pooled axis is the layer stack)."""
    if shared_layers is None:
        return [False] * len(scan)
    if shared_layers is True:
        if not any(scan):
            raise ValueError(
                "shared_layers=True pools each scanned layer stack, but no "
                "leaf is marked in scanned_layers — pass scanned_layers "
                "(otherwise the stack would get a dense cross-layer factor, "
                "not pooled per-layer whitening)")
        return list(scan)
    shared = _leaf_flags("shared_layers", shared_layers, names, len(scan))
    bad = [i for i, (s, f) in enumerate(zip(shared, scan)) if s and not f]
    if bad:
        raise ValueError(
            f"shared_layers marks leaves {bad} that are not in scanned_layers "
            "— factor sharing pools over the leading layer-stack axis")
    return shared


def _kron_plan(t: torch.Tensor, scanned: bool, shared: bool, max_size: float,
               max_skew: float, dq: str) -> kron_p.KronPlan:
    """A leaf's plan (JAX ``_kron_plans``): per layer for a scanned stack;
    over the whole tensor for a shared one, its layer axis forced diagonal
    (a stack of one layer has no layer axis left to force)."""
    shape = _squeezed_shape(t.shape[1:] if scanned else t.shape)
    fd = ((True,) + (False,) * (len(shape) - 1)
          if shared and t.shape[0] > 1 else None)
    return kron_p.make_kron_plan(shape, max_size, max_skew, dq, force_diag=fd)


def _newton_scale_from_vh(vs, hs, damping: float, opt=None) -> torch.Tensor:
    """On-the-fly init scale (mean|v|^2)^(1/4) (mean|h|^4 + damping^4)^(-1/8),
    mean|v|^2 over all leaves, mean|h|^4 the max over leaves, in float32 on
    the device (psgd.py:940-943); of complex v and h the real parts, as
    the JAX transform reads them.  ``opt``: the optimizer whose routed
    leaves (factor_sharding) these are blocks of (``_Kron._sum``,
    ``_mean``, ``_numel``: the global leaves' statistics)."""
    def total(i, x):
        return torch.sum(x) if opt is None else opt._sum(i, x)

    def mean(i, x):
        return torch.mean(x) if opt is None else opt._mean(i, x)

    numel = sum(v.numel() if opt is None else opt._numel(i, v)
                for i, v in enumerate(vs))
    v2 = sum(total(i, torch.abs(_cast(v, torch.float32)) ** 2)
             for i, v in enumerate(vs)) / numel
    h4 = torch.amax(torch.stack([mean(i, torch.abs(_cast(h, torch.float32)) ** 4)
                                 for i, h in enumerate(hs)]))
    return v2 ** 0.25 * (h4 + damping ** 4) ** (-1.0 / 8.0)


def _global_norm_scale(xs, max_norm: float, opt=None):
    """Trust-region scale min(1, max_norm / ||xs||) over all tensors, a
    device scalar (psgd.py:967-971); 1.0 for an infinite max_norm.
    ``opt`` as ``_newton_scale_from_vh``."""
    if math.isinf(max_norm):
        return 1.0
    sq = [torch.real(x * torch.conj(x)) for x in xs]
    norm = torch.sqrt(sum(torch.sum(x) if opt is None else opt._sum(i, x)
                          for i, x in enumerate(sq)))
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-38), max=1.0)


def _pytree_order(params):
    """The parameters in the JAX pytree order: (names or None, tensors,
    order), ``order`` the given index of each.  ``params``: tensors (kept
    in order, as a list is), or (name, tensor) pairs such as
    ``model.named_parameters()`` (sorted by their dotted path, as a dict
    of dicts is)."""
    items = list(params)
    named = bool(items) and isinstance(items[0], tuple)
    names = [n for n, _ in items] if named else None
    tensors = [t for _, t in items] if named else items
    order = list(range(len(tensors)))
    if names is not None:
        order.sort(key=lambda i: tuple(names[i].split(".")))
        names = [names[i] for i in order]
    return names, [tensors[i] for i in order], order


def _host_gate(prob, k_gate, count: int, draw) -> bool:
    """The fit gate uniform(k_gate) < p, decided on the host (a literal
    p >= 1 fits without a draw)."""
    if _static_always(prob):
        return True
    u = (float(fastrand.uniform01(k_gate)) if draw is None else
         float(draw("uniform", k_gate[None], (), torch.float64)[0]))
    return u < _sched(prob, count)


def _ema_(mu: torch.Tensor, g: torch.Tensor, count: int,
          momentum: float) -> torch.Tensor:
    """The bias-warmed EMA in place, beta = min(count / (count + 1),
    momentum) in the buffer's real dtype (psgd.py:604-611)."""
    rd = real_dtype_of(mu.dtype)
    b = _rounded(min(count / (count + 1.0), momentum), rd)
    return mu.mul_(b).add_(_cast(g, mu.dtype) * _rounded(1.0 - b, rd))


def _descend(group: dict, params, updates, count: int) -> None:
    """Decoupled weight decay, then -lr."""
    wd, lr = group["weight_decay"], _sched(group["lr"], count)
    for p, u in zip(params, updates):
        if wd and group["weight_decay_mode"] == "decoupled":
            u = u + wd * p
        p.add_(u * (-lr))


def _classic_decay(group: dict, grads, params) -> list:
    """Classic weight decay: wd p added to the gradients."""
    wd = group["weight_decay"]
    if wd and group["weight_decay_mode"] == "classic":
        return [g + wd * p for g, p in zip(grads, params)]
    return grads


def _as_param(v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A probe drawn at a parameter's global shape as the parameter takes
    it: a DTensor parameter's block of it, as a DTensor of its placements
    (no collective)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(p, DTensor):
        return v
    from ..parallel.sharded import _LeafShard
    block = v[tuple(_LeafShard(p, p.device_mesh, "probe").slices)]
    return DTensor.from_local(block.contiguous(), p.device_mesh, p.placements,
                              run_check=False)


def _unreached(loss: torch.Tensor, tensors) -> list:
    """The indices of the leaf ``tensors`` that autograd from ``loss``
    does not reach: a walk of its graph (no backward)."""
    want = {id(t): i for i, t in enumerate(tensors)}
    found, seen, todo = set(), set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None and id(var) in want:
            found.add(want[id(var)])
        todo.extend(f for f, _ in fn.next_functions)
    return [i for i in want.values() if i not in found]


def _newton_pass(closure, params, do_fit: bool, k_v, exact: bool, draw):
    """The Newton optimizers' autograd: on a fit step the probes v
    (``hvp.rand_like``, split(k_v) per parameter, at the parameters'
    global shapes; a DTensor parameter's block of it as a DTensor) and the
    gradient and H v in one pass (``hvp.hvp_exact``, or
    ``hvp_finite_diff``), else the gradient by one plain backward.
    ``.grad`` is not touched.  Returns (the closure's first loss, grads,
    vs, hvs); vs, hvs None without a fit."""
    losses = []

    def loss_fn():
        losses.append(closure())
        return losses[-1]

    if do_fit:
        vs = [_as_param(v, p) for v, p in
              zip(hvp.rand_like(k_v, params, draw), params)]
        hvp_fn = hvp.hvp_exact if exact else hvp.hvp_finite_diff
        grads, hvs = hvp_fn(loss_fn, params, vs)
    else:
        vs = hvs = None
        with torch.enable_grad():
            grads = hvp.gradients(loss_fn(), params)
    return losses[0], grads, vs, hvs


def _storable(value) -> bool:
    """A hyperparameter that ``state_dict`` keeps: not a schedule (a
    callable, or a tuple holding one).  A schedule belongs to the
    optimizer, as JAX's belongs to the transform; the state holds count."""
    if isinstance(value, (tuple, list)):
        return all(_storable(v) for v in value)
    return not callable(value)


def _describe(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"a tensor of shape {tuple(x.shape)}"
    return repr(x)


def _first_mismatch(saved, here, where: str) -> Optional[str]:
    """Where ``saved`` and ``here`` first differ in structure: dict keys,
    sequence lengths, tensor shapes (not dtypes: a state keeps its own),
    plain values.  None when they agree."""
    if isinstance(saved, torch.Tensor) or isinstance(here, torch.Tensor):
        if (isinstance(saved, torch.Tensor) and isinstance(here, torch.Tensor)
                and saved.shape == here.shape):
            return None
        return f"{where}: saved {_describe(saved)}, here {_describe(here)}"
    if isinstance(saved, dict) and isinstance(here, dict):
        for k in list(here) + [k for k in saved if k not in here]:
            if k not in saved or k not in here:
                return (f"{where}[{k!r}]: " + ("not in the saved state"
                        if k not in saved else "not in this optimizer"))
            found = _first_mismatch(saved[k], here[k], f"{where}[{k!r}]")
            if found:
                return found
        return None
    if isinstance(saved, (tuple, list)) and isinstance(here, (tuple, list)):
        if len(saved) != len(here):
            return f"{where}: saved {len(saved)} entries, here {len(here)}"
        for i, (a, b) in enumerate(zip(saved, here)):
            found = _first_mismatch(a, b, f"{where}[{i}]")
            if found:
                return found
        return None
    return None if saved == here else \
        f"{where}: saved {_describe(saved)}, here {_describe(here)}"


def _box_list(slices, shape) -> list:
    """Slices (None bounds allowed) over ``shape`` as [start, stop] per
    dim."""
    return [list(s.indices(int(n))[:2]) for s, n in zip(slices, shape)]


def _piece(shape, slices, local=None) -> dict:
    """A ``_pieces`` entry: the whole's shape, where this rank's part
    sits in it, and (``local``) which part of the rank's tensor holds it
    (default: all of it)."""
    out = {"shape": [int(n) for n in shape], "index": _box_list(slices, shape)}
    if local is not None:
        out["local"] = local
    return out


class _Resumable(torch.optim.Optimizer):
    """``state_dict`` / ``load_state_dict`` for the port's optimizers: the
    whole state the next step reads, as JAX's pure-pytree state.

    ``state_dict()`` holds tensors, ints, floats, strings and containers
    only, so ``torch.save`` writes it and ``torch.load(weights_only=True)``
    reads it back: ``state`` (per parameter, in the parameters' order),
    ``param_groups`` without their schedules (``_storable``) and ``psgd``:
    the layout the state depends on, ``count``, ``fit_steps``, the key as
    an int64 tensor and what ``_extra_state`` adds.  Like torch's, it
    holds references: copy it (or save it) before stepping on.

    ``load_state_dict`` raises ValueError naming the first place where the
    saved layout or state differs from this optimizer's, and otherwise
    takes copies of the saved tensors on this optimizer's device with the
    dtypes they were saved with (torch's own load casts floating state to
    the parameters' dtype), the saved count, key and fit_steps, and the
    saved hyperparameters but this optimizer's schedules."""

    def _layout(self) -> dict:
        """What the state's structure depends on, by name."""
        raise NotImplementedError

    def _extra_state(self) -> dict:
        """State that lives outside ``self.state``."""
        return {}

    def _load_extra_state(self, saved: dict) -> None:
        pass

    def _copy_here(self, x):
        """x with every tensor copied onto this optimizer's device, dtype
        kept."""
        if isinstance(x, torch.Tensor):
            return x.detach().to(self.device, copy=True)
        if isinstance(x, (tuple, list)):
            return type(x)(self._copy_here(v) for v in x)
        if isinstance(x, dict):
            return {k: self._copy_here(v) for k, v in x.items()}
        return x

    def _per_param_state(self) -> dict:
        params = self.param_groups[0]["params"]
        return {i: dict(self.state[p]) for i, p in enumerate(params)
                if self.state[p]}

    def state_dict(self) -> dict:
        groups = [dict({k: v for k, v in g.items()
                        if k != "params" and _storable(v)},
                       params=list(range(len(g["params"]))))
                  for g in self.param_groups]
        psgd = dict(layout=self._layout(), count=self.count,
                    fit_steps=self.fit_steps,
                    key=torch.from_numpy(self.key.astype(np.int64)),
                    **self._extra_state())
        return {"state": self._per_param_state(), "param_groups": groups,
                "psgd": psgd}

    def load_state_dict(self, state_dict: dict) -> None:
        saved = state_dict["psgd"]
        for part, ours, theirs in (
                ("layout", self._layout(), saved["layout"]),
                ("state", self._per_param_state(), state_dict["state"]),
                ("state", self._extra_state(),
                 {k: saved.get(k) for k in self._extra_state()})):
            found = _first_mismatch(theirs, ours, part)
            if found:
                raise ValueError(f"state_dict does not match this "
                                 f"{type(self).__name__}: {found}")
        for i, p in enumerate(self.param_groups[0]["params"]):
            self.state[p] = self._copy_here(state_dict["state"].get(i, {}))
        for group, theirs in zip(self.param_groups,
                                 state_dict["param_groups"]):
            group.update({k: v for k, v in theirs.items()
                          if k != "params" and _storable(group.get(k))})
        self.count = int(saved["count"])
        self.fit_steps = int(saved["fit_steps"])
        self.key = saved["key"].cpu().numpy().astype(np.uint32)
        self._load_extra_state(self._copy_here(
            {k: saved[k] for k in self._extra_state()}))


class _Routed(NamedTuple):
    """A factor-sharded leaf: its DTensor parameter, where its shard sits
    (``parallel.sharded._LeafShard``), per squeezed dim the mesh dims that
    shard it, the reshard plan and its block's squeezed shape."""
    dparam: Any
    shard: Any
    dim_axes: tuple
    rplan: tuple
    local_shape: tuple


class _Kron(_Resumable):
    """What KronWhiten and KronNewton share: the parameters in the JAX
    pytree order, the plans, the factored state (per parameter: ``q``,
    ``lips``, ``mu``, ``pcache``), the momentum buffers, the key chain and
    the per-leaf fit and apply.  With ``stack_sharding`` the leaves marked
    in ``self.sharded`` hold their state for this rank's layers
    ``self.layers[i]`` only; ``_gather`` assembles their updates.  With
    ``factor_sharding`` the leaves marked in ``self.routed`` are DTensors
    (``self.routed[i].dparam``) whose local blocks are the optimizer's
    parameters; ``_routed`` fits and applies each."""

    # (per-tensor fit, stacked fit) of precond.kron
    _FITS: tuple

    def __init__(self, params, defaults: dict, *, max_size: float,
                 max_skew: float, init_scale, momentum: float, momentum_dtype,
                 dq: str, preconditioner_dtype, norm_k, seed: int,
                 scanned_layers, shared_layers, cache_p: bool, device, draw,
                 stack_sharding=None, factor_sharding=None):
        if defaults["weight_decay_mode"] not in ("decoupled", "classic"):
            raise ValueError(
                f"unknown weight_decay_mode {defaults['weight_decay_mode']!r}")
        dq = kron_p.canonical_dq(dq)
        if cache_p and dq in kron_p._FIT_P:
            raise ValueError(
                "cache_p is a no-op for the fit-P geometries (QUAD4P/PRO4P): "
                "their apply is already a single factor pass — drop cache_p")
        self.device = resolve_device(device)

        items = list(params)
        names, tensors, order = _pytree_order(items)
        self._names = names
        given = [n for n, _ in items] if names is not None else None
        scan = ([False] * len(tensors) if scanned_layers is None else
                _leaf_flags("scanned_layers", scanned_layers, given,
                            len(tensors)))
        scan = [scan[i] for i in order]
        if not (shared_layers is None or shared_layers is True
                or isinstance(shared_layers, dict)):   # a sequence, reordered
            given = _leaf_flags("shared_layers", shared_layers, None, len(order))
            shared_layers = [given[i] for i in order]
        shared = _shared_flags(shared_layers, scan, names)
        # a shared stack is one tensor to the fit and the apply, not a stack
        self.scanned = [f and not s for f, s in zip(scan, shared)]
        self.shared = shared
        self.plans = [_kron_plan(t, f, s, max_size, max_skew, dq)
                      for t, f, s in zip(tensors, self.scanned, self.shared)]
        tensors = self._route(factor_sharding, names, tensors,
                              stack_sharding is not None)
        self.stack, self.layers = self._shard_stacks(stack_sharding, names,
                                                     tensors)
        self.sharded = [s is not None for s in self.layers]
        tensors = self._layer_shard(names, tensors)
        for t in tensors:
            if t.device != self.device:
                raise ValueError(f"parameter on {t.device}, optimizer on "
                                 f"{self.device}")

        super().__init__([{"params": tensors}], defaults)
        self.momentum = momentum
        self.init_scale = init_scale
        self.norm_k = norm_k
        self.cache_p = cache_p
        self.draw = draw
        self.count = 0
        self.key = fastrand.prng_key(seed)
        self.fit_steps = 0   # steps on which Q was fitted
        scale0 = 1.0 if init_scale is None else init_scale
        for i, (t, f, plan, s) in enumerate(zip(tensors, self.scanned,
                                                self.plans, self.layers)):
            qdt = preconditioner_dtype or t.dtype
            st = kron_p.init_kron_from_plan(plan, scale0, qdt, self.device)
            if self.routed[i] is not None:
                st = self._compute_blocks(i, st)
            if f:
                n = self._global_shape(i, t)[0] if s is None else s.stop - s.start
                # contiguous copies: clone keeps an expanded one-layer stack's
                # stride 0, whose bytes no collective can view
                st = kron_p.KronState(
                    q=tuple(x.expand((n,) + x.shape).clone(
                        memory_format=torch.contiguous_format) for x in st.q),
                    lips=tuple(x.expand(n).clone(memory_format=torch.contiguous_format)
                               for x in st.lips))
            state = self.state[t]
            state["q"], state["lips"] = st.q, st.lips
            if cache_p:
                state["pcache"] = kron_p.compute_p_factors(st, plan)
            if momentum > 0:
                state["mu"] = torch.zeros_like(t, dtype=momentum_dtype or t.dtype)

    def _route(self, factor_sharding, names, tensors, layered: bool) -> list:
        """Route the factor-sharded leaves (JAX transforms.py:896-912):
        ``self.routed`` per leaf, the mesh's collectives ``self.comm``;
        returns the tensors with each routed leaf's local block in its
        place.  Raises ValueError, naming the leaf, where the parameters
        do not match the map.  ``layered``: other DTensor leaves are
        ``_layer_shard``'s (stack_sharding given)."""
        self.routed, self.comm = [None] * len(tensors), None
        if factor_sharding is None:
            return tensors
        from torch.distributed.tensor import DTensor
        from ..parallel.mesh import MeshAxes, routed_axes
        from ..parallel.sharded import _LeafShard
        mesh, placements = factor_sharding
        if names is None:
            raise ValueError("factor_sharding maps parameter names to "
                             "placements: pass named parameters")
        missing = [k for k in names if k not in placements]
        unknown = sorted(set(placements) - set(names))
        if missing or unknown:
            raise ValueError(
                "factor_sharding placements do not match params: "
                f"{missing} have no placements, {unknown} are not parameters")
        self.comm = MeshAxes(mesh)
        mesh_names = tuple(mesh.mesh_dim_names)
        out = list(tensors)
        for i, (name, t) in enumerate(zip(names, tensors)):
            plan, want = self.plans[i], tuple(placements[name])
            axes = routed_axes(t.shape, want, mesh_names,
                               scanned=self.scanned[i], shared=self.shared[i],
                               dq=plan.dq)
            if axes is None:
                if isinstance(t, DTensor) and not layered:
                    raise ValueError(
                        f"factor_sharding: {name} is a DTensor, but it is not "
                        "routed (scanned, shared, unsharded, or a geometry "
                        "the dim-sharded fit lacks): pass it as a plain tensor")
                continue
            if not isinstance(t, DTensor):
                raise ValueError(
                    f"factor_sharding: {name} is a plain tensor, but its "
                    f"placements {want} shard it: pass it as a DTensor "
                    "parameter with those placements")
            if t.device_mesh != mesh:
                raise ValueError(f"factor_sharding: {name} lives on another mesh")
            if tuple(t.placements) != want:
                raise ValueError(
                    f"factor_sharding: {name} has placements {tuple(t.placements)}, "
                    f"the map {want}")
            shard = _LeafShard(t, mesh, name)
            with torch.no_grad():      # the block's storage, updated in place
                out[i] = t.to_local()
            rplan = kron_p.dim_shard_reshard_plan(plan, axes, self.comm.sizes)
            local = tuple(b for n, b in zip(t.shape, out[i].shape) if int(n) != 1)
            self.routed[i] = _Routed(t, shard, axes, rplan, local)
            self.comm.groups(*self._fit_axes(i), tuple(
                mesh_names[md] for md in shard.axes))
        return out

    def _fit_axes(self, i) -> list:
        """The axes tuples whose collectives leaf i's dim-sharded fit runs
        (``kron._update_kron_dim_sharded``), in a fixed order."""
        r, plan = self.routed[i], self.plans[i]
        eff, moves, gathers = r.rplan
        diag = [eff[d] if plan.is_diag[d] else () for d in range(plan.order)]
        out = [(ax,) for _, ax, _ in moves]
        out += [(ax,) for d in gathers for ax in r.dim_axes[d]]
        out += [tuple(ax for e, a in enumerate(diag) if e != d for ax in a)
                for d in range(plan.order)]
        return [a for a in out + diag if a]

    def _compute_blocks(self, i, st: kron_p.KronState) -> kron_p.KronState:
        """A routed leaf's whole state cut to this rank's: each diagonal
        factor its block in the compute layout, dense factors and L whole."""
        eff = self.routed[i].rplan[0]
        qs = []
        for f, diag, axes in zip(st.q, self.plans[i].is_diag, eff):
            if diag and axes:
                loc = f.shape[0] // self.comm.size(axes)
                f = f.narrow(0, self.comm.index(axes) * loc, loc).clone()
            qs.append(f)
        return kron_p.KronState(q=tuple(qs), lips=st.lips)

    def _sum(self, i, x) -> torch.Tensor:
        """sum(x) over leaf i: for a routed leaf the local sums summed over
        its shards, each shard once, in shard order
        (``parallel.sharded.global_sums``), so every rank holds the same."""
        x = torch.sum(x)
        if self.routed[i] is None:
            return x
        from ..parallel.sharded import global_sums
        shard = self.routed[i].shard
        names = tuple(self.comm.mesh.mesh_dim_names[md] for md in shard.axes)
        return global_sums([x], [shard], {shard.axes: self.comm.group(names)})[0]

    def _numel(self, i, x) -> int:
        return x.numel() if self.routed[i] is None else self.plans[i].numel

    def _mean(self, i, x) -> torch.Tensor:
        """mean(x) over leaf i (a routed leaf's over the global leaf)."""
        if self.routed[i] is None:
            return torch.mean(x)
        return self._sum(i, x) / self.plans[i].numel

    def _grads(self) -> list:
        """The gradients in the parameters' order: ``.grad``, a DTensor
        leaf's its DTensor's local block (zeros where there is none)."""
        out = []
        for p, d in zip(self.param_groups[0]["params"], self.dtensors):
            g = p.grad if d is None else (None if d.grad is None
                                          else d.grad.to_local())
            out.append(torch.zeros_like(p) if g is None else g)
        return out

    def zero_grad(self, set_to_none: bool = True) -> None:
        super().zero_grad(set_to_none)
        for d in self.dtensors:
            if d is not None and d.grad is not None:
                if set_to_none:
                    d.grad = None
                else:
                    d.grad.zero_()

    def _routed(self, i, p, fit_src, apply_src, do_fit: bool, k_fit, lr_q,
                beta_l, damping, fit_first: bool, share: bool = False):
        """Leaf i's dim-sharded fit and apply (fit_src (g,) or (v, h)),
        its state updated: P apply_src as this rank's block, in p's dtype
        and the leaf's squeezed local shape."""
        r, plan, st = self.routed[i], self.plans[i], self.state[p]
        qdt = st["q"][0].dtype
        views = [None if x is None else _cast(x.reshape(r.local_shape), qdt)
                 for x in fit_src]     # None off fit steps
        kw = dict(lr=lr_q, beta_l=beta_l, damping=damping,
                  norm_k=resolve_norm_k(self.norm_k, qdt), fit_first=fit_first,
                  pcache=st["pcache"] if self.cache_p else None, draw=self.draw)
        fit = (kron_p.update_kron_newton_dim_sharded if len(views) == 2 else
               functools.partial(kron_p.update_kron_whiten_dim_sharded,
                                 share=share))
        res = fit(kron_p.KronState(q=st["q"], lips=st["lips"]), plan, *views,
                  self._leaf_key(k_fit, i), r.dim_axes, r.rplan,
                  _cast(apply_src.reshape(r.local_shape), qdt), do_fit,
                  self.comm, **kw)
        if self.cache_p:
            st["pcache"] = res[1]
        st["q"], st["lips"] = res[0].q, res[0].lips
        return _cast(res[-1], p.dtype)

    def _routed_clip(self, i, pg, clip_amps) -> torch.Tensor:
        """The amplitude clip of a routed leaf's block, its RMS over the
        global leaf."""
        return _sharded_amp_clip(pg, clip_amps, lambda x: self._sum(i, x),
                                 self.plans[i].numel)

    def _local_view(self, i, x) -> torch.Tensor:
        """Leaf i's part of a global tensor: a DTensor leaf's block (a
        DTensor's local one, or cut from a plain tensor); a plain leaf's
        whole."""
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            return x.to_local()
        if self.dtensors[i] is None:
            return x
        return x[tuple(self._block(i))]

    def _shard_stacks(self, stack_sharding, names, tensors):
        """(shard group, per leaf this rank's layers or None): the scanned,
        unshared leaves with a dense factor are sharded (JAX
        transforms.py:887-893); a stack whose L does not divide by k
        raises."""
        self.stack_dims = None
        if stack_sharding is None:
            return None, [None] * len(tensors)
        from ..parallel.mesh import shard_group
        sg = shard_group(stack_sharding)
        if isinstance(stack_sharding, tuple):
            mesh, dims = stack_sharding
            dim_names = tuple(mesh.mesh_dim_names or ())
            self.stack_dims = tuple(
                d if isinstance(d, str) else dim_names[int(d)]
                for d in (dims if isinstance(dims, (tuple, list)) else (dims,)))
        layers = []
        for i, (t, f, plan) in enumerate(zip(tensors, self.scanned,
                                             self.plans)):
            if not f or all(plan.is_diag):
                layers.append(None)
                continue
            n_layer = t.shape[0]
            if n_layer % sg.size:
                leaf = names[i] if names is not None else f"leaf {i}"
                raise ValueError(
                    f"stack_sharding: {leaf} has {n_layer} layers, which "
                    f"{sg.size} shards do not divide")
            n = n_layer // sg.size
            layers.append(slice(sg.index * n, (sg.index + 1) * n))
        return sg, layers

    def _layer_shard(self, names, tensors) -> list:
        """The DTensor leaves that are not routed (FSDP2's or
        ``models.gpt2.shard_model``'s, under ``stack_sharding``):
        ``self.dtensors`` per leaf (every DTensor leaf's parameter, routed
        ones too), and one of three kinds: ``self.owned`` (a stack the
        optimizer shards whose local block is this rank's layers: fitted,
        applied and stepped in place, never gathered), ``self.resharded``
        (a stack the optimizer shards whose block is sharded within its
        layers, JAX's ``(None, fsdp, tp)``: (its ``parallel.mesh.
        LayerReshard``, where its block sits); its sources resharded to
        this rank's layers, fitted and applied as an owned stack's, its
        update resharded back into the block; its momentum the block's)
        and ``self.whole`` (any other: (its mesh's ``MeshAxes``, its
        placements, where its block sits); gathered whole by bytes, fitted
        and applied as a replicated leaf, its update's block written
        back).  Returns the tensors with each local block in its place.
        A stack whose layout the reshard cannot express raises
        NotImplementedError naming its placements."""
        n = len(tensors)
        self.dtensors = [None if r is None else r.dparam for r in self.routed]
        self.owned, self.whole = [False] * n, [None] * n
        self.resharded = [None] * n
        from torch.distributed.tensor import DTensor
        if not any(isinstance(t, DTensor) and self.routed[i] is None
                   for i, t in enumerate(tensors)):
            return tensors
        from ..parallel.mesh import MeshAxes, sharding_axes
        from ..parallel.sharded import _LeafShard
        out, comms = list(tensors), {}
        for i, t in enumerate(tensors):
            if self.routed[i] is not None or not isinstance(t, DTensor):
                continue
            leaf = names[i] if names is not None else f"leaf {i}"
            if self.stack is None:
                raise ValueError(
                    f"{leaf} is a DTensor: pass stack_sharding (its stacks' "
                    "layers over FSDP2's shard dim) or factor_sharding, or use "
                    "the per-shard optimizers")
            mesh, placements = t.device_mesh, tuple(t.placements)
            shard = _LeafShard(t, mesh, leaf)
            self.dtensors[i] = t
            if self.sharded[i]:
                s = self.layers[i]
                if _box_list(shard.slices, t.shape) == _box_list(
                        [s] + [slice(None)] * (t.ndim - 1), t.shape):
                    self.owned[i] = True
                else:
                    from ..parallel.mesh import LayerReshard
                    self.resharded[i] = (LayerReshard(
                        mesh, placements, t.shape, self.stack, self.stack_dims,
                        leaf), shard)
            else:
                key = id(mesh)
                if key not in comms:
                    comms[key] = MeshAxes(mesh)
                axes = comms[key]
                axes.groups(*[(name,) for name, _ in sharding_axes(
                    placements, mesh.mesh_dim_names)])
                self.whole[i] = (axes, placements, shard)
            with torch.no_grad():      # the block's storage, updated in place
                out[i] = t.to_local()
        return out

    def _wholes(self, xs, owned: bool = False) -> list:
        """xs (per leaf, this rank's blocks) as the fit and apply read
        them: each ``self.whole`` leaf's made whole (``gather_whole``),
        each resharded stack's this rank's layers (``to_layers``); with
        ``owned`` each owned and resharded stack whole (``all_gather_stack``
        and ``gather_whole``); the others as they are.  Contiguous, so a
        reduction over one sums in the unsharded optimizer's order."""
        from ..parallel.mesh import all_gather_stack, gather_whole
        out = list(xs)
        for i, x in enumerate(xs):
            if x is None:
                continue
            if self.whole[i] is not None:
                out[i] = gather_whole(x, *self.whole[i][:2]).contiguous()
            elif self.resharded[i] is not None:
                reshard = self.resharded[i][0]
                out[i] = (gather_whole(x, reshard.axes, reshard.placements)
                          .contiguous() if owned else reshard.to_layers(x))
            elif owned and self.owned[i]:
                out[i] = all_gather_stack(x.contiguous(), self.stack)
        return out

    def _global_shape(self, i, p) -> tuple:
        """Leaf i's shape as one tensor (a DTensor leaf's global one)."""
        return tuple((p if self.dtensors[i] is None else self.dtensors[i]).shape)

    @property
    def per_rank(self) -> bool:
        """Whether this rank's state is its own (checkpoints: one file
        per rank)."""
        return self.stack is not None or self.comm is not None

    def _layout(self) -> dict:
        out = {"optimizer": type(self).__name__, "cache_p": self.cache_p}
        if self.stack is not None:
            out["stack_sharding"] = dict(world=self.stack.size,
                                         rank=self.stack.index)
        if self.comm is not None:
            mesh = self.comm.mesh
            out["factor_sharding"] = dict(
                mesh=list(mesh.mesh_dim_names), shape=list(mesh.mesh.shape),
                coordinate=list(mesh.get_coordinate()))
        for i, (p, plan, f, s) in enumerate(zip(
                self.param_groups[0]["params"], self.plans, self.scanned,
                self.shared)):
            out[f"leaf {i}"] = dict(shape=list(p.shape), shared=s, scanned=f,
                                    plan=list(plan.shape),
                                    diagonal=list(plan.is_diag), dq=plan.dq)
            if self.sharded[i]:
                out[f"leaf {i}"]["layers"] = [self.layers[i].start,
                                              self.layers[i].stop]
            if self.routed[i] is not None:
                out[f"leaf {i}"]["dim_axes"] = [list(a) for a in
                                                self.routed[i].dim_axes]
                out[f"leaf {i}"]["compute_axes"] = [
                    list(a) for a in self.routed[i].rplan[0]]
            elif self.dtensors[i] is not None:
                out[f"leaf {i}"]["block"] = _box_list(
                    self._block(i), self._global_shape(i, p))
        return out

    def _unsharded_layout(self) -> dict:
        """The layout an unsharded optimizer of the same settings holds:
        no sharding entries, every leaf its global shape."""
        out = self._layout()
        out.pop("stack_sharding", None)
        out.pop("factor_sharding", None)
        for i, p in enumerate(self.param_groups[0]["params"]):
            leaf = out[f"leaf {i}"]
            for k in ("layers", "dim_axes", "compute_axes", "block"):
                leaf.pop(k, None)
            leaf["shape"] = list(self._global_shape(i, p))
        return out

    def _block(self, i) -> list:
        """Where a DTensor leaf's local block sits in the global tensor:
        a slice per dim."""
        shard = (self.routed[i].shard if self.routed[i] is not None else
                 self.whole[i][2] if self.whole[i] is not None else
                 self.resharded[i][1] if self.resharded[i] is not None else None)
        if shard is not None:
            return list(shard.slices)
        return [self.layers[i]] + [slice(None)] * (self.dtensors[i].ndim - 1)

    def _pieces(self) -> dict:
        """Where each tensor of ``state_dict()`` that is this rank's part
        of a larger one sits in it (``utils.checkpoint``): path -> {"shape":
        the whole's, "index": [start, stop] per dim}; a tensor not listed
        is the unsharded optimizer's whole, the same on every rank."""
        out = {}
        params = self.param_groups[0]["params"]
        for i, p in enumerate(params):
            st = self.state[p]
            gshape = self._global_shape(i, p)
            if self.sharded[i]:
                s = self.layers[i]
                for key in ("q", "lips", "pcache"):
                    for j, f in enumerate(st.get(key) or ()):
                        out[("state", i, key, j)] = _piece(
                            (gshape[0],) + tuple(f.shape[1:]),
                            [s] + [slice(None)] * (f.ndim - 1))
            if self.routed[i] is not None:
                eff = self.routed[i].rplan[0]
                for key in ("q", "pcache"):
                    for j, f in enumerate(st.get(key) or ()):
                        if self.plans[i].is_diag[j] and eff[j]:
                            k, loc = self.comm.index(eff[j]), f.shape[0]
                            out[("state", i, key, j)] = _piece(
                                (loc * self.comm.size(eff[j]),),
                                [slice(k * loc, (k + 1) * loc)])
            if self.dtensors[i] is not None and "mu" in st:
                out[("state", i, "mu")] = _piece(gshape, self._block(i))
        return out

    def _local(self, x, i):
        """x, or this rank's layers of it for a stack-sharded leaf held
        whole (an owned stack's x is its layers already, a resharded
        stack's x its layers from ``_wholes``)."""
        if self.layers[i] is None or self.owned[i] or \
                self.resharded[i] is not None:
            return x
        return x[self.layers[i]]

    def _local_shape(self, i, p) -> tuple:
        """The shape leaf i's fit and apply work at: this rank's layers
        of a stack-sharded leaf, a gathered leaf's whole."""
        if self.whole[i] is not None:
            return self._global_shape(i, p)
        if self.resharded[i] is not None:
            return (self.resharded[i][0].layers,) + self._global_shape(i, p)[1:]
        return tuple(self._local(p, i).shape)

    def _gather(self, updates: list) -> list:
        """The updates as each parameter takes them, in place in
        ``updates``: a stack-sharded leaf held whole gets its stack
        assembled from every rank's layers (``all_gather_stack``; each
        slice freed once its stack is whole), a gathered leaf its block of
        the whole update, a resharded stack its block of every rank's
        layers (``to_block``); an owned stack's layers and the others
        stay."""
        from ..parallel.mesh import all_gather_stack
        for i, s in enumerate(self.sharded):
            if self.resharded[i] is not None:
                updates[i] = self.resharded[i][0].to_block(updates[i])
            elif s and not self.owned[i]:
                updates[i] = all_gather_stack(updates[i], self.stack)
            elif self.whole[i] is not None:
                updates[i] = updates[i][tuple(self.whole[i][2].slices)]
        return updates

    def _leaf_key(self, k_fit, i):
        """Leaf i's fit key."""
        return fastrand.fold_in(k_fit, i)

    # -- pieces of one step -------------------------------------------------

    def _view(self, x, i):
        plan = self.plans[i]
        lead = (x.shape[0],) if self.scanned[i] else ()
        return x.reshape(lead + plan.shape)

    def _gate(self, k_gate, count: int) -> bool:
        """The fit gate: uniform(k_gate) < p, decided on the host (a literal
        p >= 1 fits without a draw)."""
        return _host_gate(
            self.param_groups[0]["preconditioner_update_probability"], k_gate,
            count, self.draw)

    def _rescale(self, params, scale) -> None:
        """Multiply Q by the on-the-fly init scale (squared for the fit-P
        geometries), spread over the factors; refresh the cache."""
        for p, plan in zip(params, self.plans):
            st = self.state[p]
            eff = scale * scale if plan.fits_p else scale
            mult = eff ** (1.0 / max(plan.order, 1))
            st["q"] = tuple(q * mult.to(real_dtype_of(q.dtype))
                            for q in st["q"])
            if self.cache_p:
                st["pcache"] = kron_p.compute_p_factors(
                    kron_p.KronState(q=st["q"], lips=st["lips"]), plan)

    def _momentum(self, params, grads, count: int):
        """The bias-warmed EMA of the gradients; the buffers."""
        return [_ema_(self.state[p]["mu"], g, count, self.momentum)
                for p, g in zip(params, grads)]

    def _fit(self, params, sources, k_fit, lr_q, beta_l, damping,
             return_pg: bool = False):
        """Fit each leaf's Q from its sources (g, or (v, h)) cast to Q's
        dtype, keyed by fold_in(k_fit, leaf), split per layer of a scanned
        stack; refresh the leaf's cache (cache_p).  ``return_pg``
        (whitening): the fits' P damped(src) per leaf, in Q's dtype."""
        fit_one, fit_stacked = self._FITS
        pgs = []
        for i, (p, src) in enumerate(zip(params, sources)):
            if self.routed[i] is not None:     # fitted with its apply
                pgs.append(None)
                continue
            st = self.state[p]
            qdt = st["q"][0].dtype
            key = self._leaf_key(k_fit, i)
            kw = dict(lr=lr_q, beta_l=beta_l, damping=damping,
                      norm_k=resolve_norm_k(self.norm_k, qdt), draw=self.draw)
            if return_pg:
                kw["return_pg"] = True
            state = kron_p.KronState(q=st["q"], lips=st["lips"])
            views = [_cast(self._view(self._local(x, i), i), qdt) for x in src]
            if self.scanned[i]:
                keys = fastrand.split(key, self._global_shape(i, p)[0])
                if self.sharded[i]:
                    keys = keys[self.layers[i]]
                out = fit_stacked(state, self.plans[i], *views, keys, **kw)
            else:
                out = fit_one(state, self.plans[i], *views, key, **kw)
            if return_pg:
                out, pg = out
                pgs.append(pg)
            st["q"], st["lips"] = out.q, out.lips
            if self.cache_p:
                st["pcache"] = kron_p.compute_p_factors(out, self.plans[i])
        return pgs

    def _apply_factors(self, params) -> list:
        """What each leaf's apply reads: its cached P_i (cache_p), or Q."""
        return [self.state[p]["pcache" if self.cache_p else "q"]
                for p in params]

    def _precond(self, i, p, src, factors):
        """P src for leaf i (parameter p), in p's dtype and the plan's
        shape, through ``factors``: the leaf's Q, or its cached P_i."""
        plan, stacked = self.plans[i], self.scanned[i]
        g = _cast(self._view(self._local(src, i), i), factors[0].dtype)
        if self.cache_p:
            fn = (kron_p.precond_grad_cached_stacked if stacked
                  else kron_p.precond_grad_cached)
            return _cast(fn(factors, plan, g), p.dtype)
        state = kron_p.KronState(q=factors, lips=())
        fn = kron_p.precond_grad_stacked if stacked else kron_p.precond_grad
        return _cast(fn(state, plan, g), p.dtype)


class KronWhiten(_Kron):
    """Kronecker-factored gradient/momentum whitening (reference class
    KronWhiten, psgd.py:516-654; JAX ``kron_whiten``).

    ``params``: tensors, or (name, tensor) pairs such as
    ``model.named_parameters()``; one parameter group.  ``scanned_layers``
    and ``shared_layers``: a dict name -> bool, or a sequence of bools in
    the given order (``shared_layers=True``: every scanned leaf).
    ``device``: where the optimizer runs (default CUDA; the parameters must
    live there).  ``draw``: optional replay hook ``draw(kind, keys, shape,
    dtype)`` that supplies the fit's random draws (see precond.kron) and
    the gate uniforms.  The options and their rules are the JAX
    transform's (psgd_torch_tpu/optim/transforms.py:644-780):
    ``share_fit_apply`` needs ``update_preconditioner_first=False``, fit
    and apply sources that coincide and no ``pipelined_fit``;
    ``pipelined_fit`` needs momentum whitening and an explicit
    ``preconditioner_init_scale``, and fits from step 1 on;
    ``share_fit_apply`` refuses ``dq="EQ"``, whose fit never forms P g.
    ``stack_sharding=(mesh, dim)`` (or a ``ProcessGroup``, or a tuple of
    mesh dims): each rank fits and applies its L/k layers of every
    scanned, unshared stack with a dense factor and the stack's update is
    gathered (module docstring); with every option above.

    ``dq`` takes each of the seven geometries (``kron.ALL_DQ``).  On CUDA
    tensors: Q0.5EQ1.5 steps each dense factor through the NS kernels
    (``kernels.fused_ns_update``, or the split and tiled routes at LLaMA's
    widths); QEP, QEQ, PRO4P, QUAD and QUAD4P take each dense factor's L
    from ``kernels.norm_bound`` (spd) and step it with ``matmul``, PRO4P
    then running ``linalg.procrustes_loop3`` (``kernels.tsub`` and the
    skew ``kernels.norm_bound``, 10 masked steps); EQ's L also comes from
    ``kernels.norm_bound``, its v Q^-1 from ``solve_triangular``.  Every
    geometry damps with ``kernels.damped_noise`` but EQ, which draws its
    probe with ``kernels.unit_noise``.  The constructor warns as the JAX
    transform's ``_advisories`` do (on-the-fly init scale, momentum
    whitening, QUAD4P and PRO4P in half precision).
    """

    _FITS = (kron_p.update_kron_whiten, kron_p.update_kron_whiten_stacked)

    def __init__(self, params, lr: float | Callable = 1e-3,
                 weight_decay: float = 0.0,
                 weight_decay_mode: str = "decoupled", *,
                 preconditioner_max_size: float = float("inf"),
                 preconditioner_max_skew: float = 1.0,
                 preconditioner_init_scale: Optional[float] = None,
                 lr_preconditioner: float | Callable = 0.1,
                 betaL: float | Callable = 0.9,
                 damping: float | Callable = 1e-9,
                 momentum: float = 0.0,
                 momentum_dtype: Optional[torch.dtype] = None,
                 grad_clip_max_amps=(2.0, 10.0),
                 preconditioner_update_probability: float | Callable = 1.0,
                 update_preconditioner_first: bool = True,
                 whiten_grad: bool = True,
                 dq: str = "Q0.5EQ1.5",
                 preconditioner_dtype: Optional[torch.dtype] = None,
                 norm_k: Optional[int] = None,
                 seed: int = 0,
                 scanned_layers: Any = None,
                 shared_layers: Any = None,
                 pipelined_fit: bool = False,
                 share_fit_apply: bool = False,
                 cache_p: bool = False,
                 stack_sharding=None,
                 factor_sharding=None,
                 device=None,
                 draw=None):
        dq = kron_p.canonical_dq(dq)
        momentum = momentum if 0.0 < momentum < 1.0 else 0.0
        if not whiten_grad and momentum == 0.0:
            raise ValueError("Cannot whiten momentum with momentum == 0")
        if pipelined_fit:
            if whiten_grad:
                raise ValueError(
                    "pipelined_fit requires momentum whitening "
                    "(whiten_grad=False, momentum > 0): the previous step's "
                    "fit source must already live in the optimizer state")
            if preconditioner_init_scale is None:
                raise ValueError(
                    "pipelined_fit requires an explicit "
                    "preconditioner_init_scale (the on-the-fly scale reads "
                    "the current gradients, which would re-couple the fit "
                    "to the backward pass)")
        if share_fit_apply:
            if update_preconditioner_first:
                raise ValueError(
                    "share_fit_apply requires update_preconditioner_first="
                    "False: the shared product is computed with the "
                    "pre-update Q")
            if pipelined_fit:
                raise ValueError(
                    "share_fit_apply is incompatible with pipelined_fit (the "
                    "pipelined fit source is the previous step's momentum, "
                    "not this step's apply source)")
            if momentum > 0 and whiten_grad:
                raise ValueError(
                    "share_fit_apply requires the fit and apply sources to "
                    "coincide: use whiten_grad=False (momentum whitening) or "
                    "momentum=0")
            if dq == kron_p.DQ_EQ:
                raise ValueError(
                    "share_fit_apply is unsupported for dq='EQ' (the EQ fit "
                    "never forms the full Pg product)")
        defaults = dict(
            lr=lr, weight_decay=weight_decay,
            weight_decay_mode=weight_decay_mode,
            lr_preconditioner=lr_preconditioner, betaL=betaL,
            damping=damping, grad_clip_max_amps=tuple(grad_clip_max_amps),
            preconditioner_update_probability=preconditioner_update_probability)
        super().__init__(
            params, defaults, max_size=preconditioner_max_size,
            max_skew=preconditioner_max_skew,
            init_scale=preconditioner_init_scale, momentum=momentum,
            momentum_dtype=momentum_dtype, dq=dq,
            preconditioner_dtype=preconditioner_dtype, norm_k=norm_k,
            seed=seed, scanned_layers=scanned_layers,
            shared_layers=shared_layers, cache_p=cache_p, device=device,
            draw=draw, stack_sharding=stack_sharding,
            factor_sharding=factor_sharding)
        _advisories(preconditioner_init_scale, whiten_grad, momentum, dq,
                    preconditioner_dtype)
        self.update_preconditioner_first = update_preconditioner_first
        self.whiten_grad = whiten_grad
        self.pipelined_fit = pipelined_fit
        self.share_fit_apply = share_fit_apply

    def _finish(self, i, p, pg, clip_amps):
        """P src in p's dtype, clipped per tensor (per layer of a scanned
        stack), in p's shape (this rank's layers of a stack-sharded
        leaf)."""
        return _amp_clip(_cast(pg, p.dtype), *clip_amps,
                         stacked=self.scanned[i]).reshape(
                             self._local_shape(i, p))

    def _apply(self, params, sources, clip_amps, factors=None):
        """P src clipped per leaf (the unclipped product freed leaf by
        leaf), through ``factors`` (default: what the state holds now)."""
        factors = factors or self._apply_factors(params)
        return [None if self.routed[i] is not None else
                self._finish(i, p, self._precond(i, p, src, f), clip_amps)
                for i, (p, src, f) in enumerate(zip(params, sources, factors))]

    def _fill_routed(self, updates, params, fit_src, apply_src, do_fit,
                     k_fit, fit_args, clip_amps) -> list:
        """The routed leaves' updates (their fit and apply at once, clipped
        over the global leaf) into ``updates``."""
        for i, p in enumerate(params):
            if self.routed[i] is not None:
                pg = self._routed(i, p, fit_src[i], apply_src[i], do_fit, k_fit,
                                  *fit_args, self.update_preconditioner_first,
                                  self.share_fit_apply)
                updates[i] = self._routed_clip(i, pg, clip_amps).reshape(p.shape)
        return updates

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._step(self._grads())
        return loss

    def _step(self, grads) -> None:
        """One step from the gradients (in the parameters' order)."""
        group = self.param_groups[0]
        params = group["params"]
        count = self.count
        grads = _classic_decay(group, grads, params)

        damping = _sched(group["damping"], count)
        if self.init_scale is None and count == 0:
            self._rescale(params, _whiten_scale_from_grads(
                self._wholes(grads, owned=True), self.scanned, damping,
                self._mean))

        keys = fastrand.split(self.key, 3)
        self.key, k_gate, k_fit = keys[0], keys[1], keys[2]
        do_fit = self._gate(k_gate, count)
        fit_args = (_sched(group["lr_preconditioner"], count),
                    _sched(group["betaL"], count), damping)
        clip = tuple(_sched(a, count) for a in group["grad_clip_max_amps"])

        if self.pipelined_fit:
            # the fit reads the momentum as it was before this step's EMA,
            # so it runs before the in-place EMA (step 0's buffer is zeros:
            # the first fit is at step 1); applying first means applying
            # with the factors from before the fit
            do_fit = do_fit and count > 0
            before = (None if self.update_preconditioner_first
                      else self._apply_factors(params))
            stale = [(self.state[p]["mu"].clone() if do_fit and r else None,)
                     for p, r in zip(params, self.routed)]
            if do_fit:
                self._fit(params, [(m,) for m in self._wholes(
                    [self.state[p]["mu"] for p in params])], k_fit, *fit_args)
            mus = self._wholes(self._momentum(params, grads, count))
            updates = self._fill_routed(self._apply(params, mus, clip, before),
                                        params, stale, mus, do_fit, k_fit,
                                        fit_args, clip)
        else:
            mus = (self._wholes(self._momentum(params, grads, count))
                   if self.momentum > 0 else None)
            if self.whiten_grad or self.momentum == 0:
                grads = self._wholes(grads)
            fit_src = [(g,) for g in (grads if self.whiten_grad else mus)]
            apply_src = mus if self.momentum > 0 else grads
            if self.share_fit_apply and do_fit:
                # the fit's P damped(src), pre-update Q, is the update
                pgs = self._fit(params, fit_src, k_fit, *fit_args,
                                return_pg=True)
                updates = [None if pg is None else self._finish(i, p, pg, clip)
                           for i, (p, pg) in enumerate(zip(params, pgs))]
            elif self.update_preconditioner_first:
                if do_fit:
                    self._fit(params, fit_src, k_fit, *fit_args)
                updates = self._apply(params, apply_src, clip)
            else:
                updates = self._apply(params, apply_src, clip)
                if do_fit:
                    self._fit(params, fit_src, k_fit, *fit_args)
            self._fill_routed(updates, params, fit_src, apply_src, do_fit,
                              k_fit, fit_args, clip)
        self.fit_steps += int(do_fit)
        _descend(group, params, self._gather(updates), count)
        self.count += 1


class KronNewton(_Kron):
    """Kronecker-factored Newton-type preconditioner fitted from
    Hessian-vector products (reference class KronNewton, psgd.py:832-978;
    JAX ``kron_newton``), in each of the seven geometries (``dq``).

    ``step(closure)``: the closure returns the loss and does not call
    backward.  The step draws the fit gate (uniform < p, or the first
    step); on a fit step it draws a probe v per parameter and takes the
    gradient and H v in one pass (``optim.hvp.hvp_exact``: double backward
    under the math attention; ``hvp_finite_diff`` with
    ``exact_hessian_vector_product=False``), and fits Q from (v, H v) cast
    to Q's dtype; otherwise it takes the gradient with one plain backward.
    Then the momentum EMA of the gradient, P applied to it (or to the
    gradient; through the cache refreshed by every fit with ``cache_p``),
    the global-norm trust-region clip ``grad_clip_max_norm``, weight decay
    and -lr.  ``.grad`` is neither read nor written.  Arguments otherwise
    as ``KronWhiten`` (``shared_layers``, ``cache_p``, ``stack_sharding``,
    ``dq`` and the advisories included; the norm clip reads the gathered
    tree).  On CUDA tensors each geometry's fit runs the
    kernels ``KronWhiten``'s does, the probe v is ``kernels.unit_noise``
    per leaf and the damping of h (EQ too) ``kernels.damped_noise``.
    """

    _FITS = (kron_p.update_kron_newton, kron_p.update_kron_newton_stacked)

    def __init__(self, params, lr: float | Callable = 0.01,
                 weight_decay: float = 0.0,
                 weight_decay_mode: str = "decoupled", *,
                 preconditioner_max_size: float = float("inf"),
                 preconditioner_max_skew: float = 1.0,
                 preconditioner_init_scale: Optional[float] = None,
                 lr_preconditioner: float | Callable = 0.1,
                 betaL: float | Callable = 0.9,
                 damping: float | Callable = 1e-9,
                 momentum: float = 0.0,
                 momentum_dtype: Optional[torch.dtype] = None,
                 grad_clip_max_norm: float | Callable = float("inf"),
                 preconditioner_update_probability: float | Callable = 1.0,
                 exact_hessian_vector_product: bool = True,
                 dq: str = "Q0.5EQ1.5",
                 preconditioner_dtype: Optional[torch.dtype] = None,
                 norm_k: Optional[int] = None,
                 seed: int = 0,
                 scanned_layers: Any = None,
                 shared_layers: Any = None,
                 cache_p: bool = False,
                 stack_sharding=None,
                 factor_sharding=None,
                 device=None,
                 draw=None):
        defaults = dict(
            lr=lr, weight_decay=weight_decay,
            weight_decay_mode=weight_decay_mode,
            lr_preconditioner=lr_preconditioner, betaL=betaL,
            damping=damping, grad_clip_max_norm=grad_clip_max_norm,
            preconditioner_update_probability=preconditioner_update_probability)
        super().__init__(
            params, defaults, max_size=preconditioner_max_size,
            max_skew=preconditioner_max_skew,
            init_scale=preconditioner_init_scale,
            momentum=momentum if 0.0 < momentum < 1.0 else 0.0,
            momentum_dtype=momentum_dtype, dq=dq,
            preconditioner_dtype=preconditioner_dtype, norm_k=norm_k,
            seed=seed, scanned_layers=scanned_layers,
            shared_layers=shared_layers, cache_p=cache_p, device=device,
            draw=draw, stack_sharding=stack_sharding,
            factor_sharding=factor_sharding)
        _advisories(preconditioner_init_scale, True, 0.0, dq,
                    preconditioner_dtype)
        self.exact_hvp = exact_hessian_vector_product

    def _checked(self, closure, params):
        """``closure`` refusing a loss whose autograd does not reach every
        DTensor leaf in ``params`` (FSDP2 runs the forward on the
        unsharded parameters it swaps in, so the shards are never
        reached); ``closure`` itself without DTensor leaves."""
        leaves = [i for i, d in enumerate(self.dtensors) if d is not None]
        if not leaves:
            return closure

        def checked():
            loss = closure()
            missed = [self._names[leaves[j]] if self._names else
                      f"leaf {leaves[j]}" for j in
                      _unreached(loss, [params[i] for i in leaves])]
            if missed:
                raise NotImplementedError(
                    f"KronNewton: autograd from the closure's loss does not "
                    f"reach the DTensor leaves {missed}: under FSDP2 "
                    "(fully_shard) the forward runs on the unsharded parameters "
                    "FSDP2 swaps in, not these shards, so the exact Hvp cannot "
                    "differentiate them. Shard the model with "
                    "models.gpt2.shard_model or models.llama.shard_model (their "
                    "collectives are in the "
                    "autograd graph), or pass step(hvp_fn=...) or "
                    "step(vs=..., hvs=...) computed on the model (ROADMAP A8c)")
            return loss
        return checked

    @torch.no_grad()
    def step(self, closure=None, *, hvp_fn=None, vs=None, hvs=None):
        """One step.  Without factor-sharded leaves the closure's autograd
        gives the gradients and, on a fit step, the pair (v, H v)
        (``_newton_pass``; DTensor leaves, ``models.gpt2.shard_model``'s,
        differentiated as DTensors, their probes their blocks of the global
        draws).  With DTensor leaves (routed ones must) the step also takes
        (JAX ``update(g, s, params, hvp_fn=)`` or ``update(g, s, vs=,
        hvs=)``) the gradients from ``.grad`` (a DTensor leaf's local
        block); on a fit step the pair from ``hvp_fn(vs) -> hvs`` (called
        with the probes at the parameters' global shapes, drawn as
        ``hvp.rand_like`` draws them on every rank alike; H v per leaf,
        global plain tensors or DTensors) or the explicit global ``vs`` and
        ``hvs``, which fit every step; ``closure``, if given, only returns
        the loss."""
        routed = self.comm is not None
        given = hvp_fn is not None or vs is not None or hvs is not None
        if given and not any(d is not None for d in self.dtensors):
            raise ValueError("KronNewton takes hvp_fn, vs and hvs with DTensor "
                             "leaves (factor_sharding, or stack_sharding over "
                             "DTensor blocks) only; pass the closure")
        if not given and not routed and closure is None:
            raise ValueError("KronNewton.step needs a closure that returns "
                             "the loss (without calling backward)")
        if (routed or given) and hvp_fn is None and (vs is None or hvs is None):
            raise ValueError("KronNewton with factor_sharding needs hvp_fn "
                             "or explicit (vs, hvs)")
        params = self.param_groups[0]["params"]
        count = self.count
        keys = fastrand.split(self.key, 4)
        self.key, k_gate, k_v, k_fit = keys[0], keys[1], keys[2], keys[3]
        explicit = hvp_fn is None and vs is not None     # fits every step
        do_fit = explicit or self._gate(k_gate, count) or count == 0
        if not (routed or given):
            targets = [p if d is None else d for p, d in zip(params, self.dtensors)]
            loss, grads, vs, hvs = _newton_pass(
                self._checked(closure, targets), targets, do_fit, k_v,
                self.exact_hvp, self.draw)
            grads = [self._local_view(i, g) for i, g in enumerate(grads)]
            if do_fit:
                vs = [self._local_view(i, v) for i, v in enumerate(vs)]
                hvs = [self._local_view(i, h) for i, h in enumerate(hvs)]
        else:
            loss = None
            if closure is not None:
                with torch.enable_grad():
                    loss = closure()
            grads = self._grads()
            if do_fit and hvp_fn is not None:
                vs = hvp.rand_like(k_v, [p if d is None else d for p, d
                                         in zip(params, self.dtensors)], self.draw)
                hvs = hvp_fn(vs)
            if do_fit:
                vs = [self._local_view(i, v) for i, v in enumerate(vs)]
                hvs = [self._local_view(i, h) for i, h in enumerate(hvs)]
        self._newton_step(grads, vs, hvs, do_fit, k_fit, count)
        return loss

    def _newton_step(self, grads, vs, hvs, do_fit: bool, k_fit,
                     count: int) -> None:
        """One step from the gradients and, on a fit step, the pairs (this
        rank's blocks of the routed leaves)."""
        group = self.param_groups[0]
        params = group["params"]
        grads = _classic_decay(group, grads, params)
        damping = _sched(group["damping"], count)
        lr_q, beta_l = (_sched(group["lr_preconditioner"], count),
                        _sched(group["betaL"], count))
        if do_fit:
            if self.init_scale is None and count == 0:
                self._rescale(params, _newton_scale_from_vh(
                    self._wholes(vs, owned=True), self._wholes(hvs, owned=True),
                    damping, self))
            self._fit(params, list(zip(self._wholes(vs), self._wholes(hvs))),
                      k_fit, lr_q, beta_l, damping)
        self.fit_steps += int(do_fit)

        src = self._momentum(params, grads, count) if self.momentum > 0 \
            else grads
        # contiguous: the norm clip then sums each leaf in one order, sharded
        # (gathered) or not
        pre = [None if self.routed[i] is not None else
               self._precond(i, p, x, f).reshape(self._local_shape(i, p)).contiguous()
               for i, (p, x, f) in enumerate(zip(params, self._wholes(src),
                                                 self._apply_factors(params)))]
        for i, p in enumerate(params):
            if self.routed[i] is not None:
                pair = (vs[i], hvs[i]) if do_fit else (None, None)
                pre[i] = self._routed(i, p, pair, src[i], do_fit, k_fit, lr_q,
                                      beta_l, damping,
                                      True).reshape(p.shape).contiguous()
        max_norm = _sched(group["grad_clip_max_norm"], count)
        held = list(pre)
        pre = self._gather(pre)
        # the clip reads the whole tree, after the gather (JAX :313-314): a
        # gathered leaf's whole update, an owned or resharded stack's
        # layers gathered whole
        from ..parallel.mesh import all_gather_stack
        tree = pre if math.isinf(max_norm) else [
            held[i] if self.whole[i] is not None else
            all_gather_stack(held[i], self.stack) if self.owned[i] or
            self.resharded[i] is not None else x for i, x in enumerate(pre)]
        scale = _global_norm_scale(tree, max_norm, self)
        _descend(group, params, [u * scale for u in pre], count)
        self.count += 1


def kron_whiten(params, learning_rate: float | Callable = 1e-3,
                weight_decay: float = 0.0,
                weight_decay_mode: str = "decoupled", **kwargs) -> KronWhiten:
    """KronWhiten with the JAX factory's argument names."""
    return KronWhiten(params, lr=learning_rate, weight_decay=weight_decay,
                      weight_decay_mode=weight_decay_mode, **kwargs)


def kron_newton(params, learning_rate: float | Callable = 0.01,
                weight_decay: float = 0.0,
                weight_decay_mode: str = "decoupled", **kwargs) -> KronNewton:
    """KronNewton with the JAX factory's argument names."""
    return KronNewton(params, lr=learning_rate, weight_decay=weight_decay,
                      weight_decay_mode=weight_decay_mode, **kwargs)


# ---------------------------------------------------------------------------
# LRA and dense: one preconditioner over the whole parameter vector
# ---------------------------------------------------------------------------


def _vector_group(vector_sharding):
    """The ``parallel.mesh.RowReduce`` of a ``vector_sharding`` argument
    (``(mesh, dim)``, a dim or a tuple of dims of a ``DeviceMesh``, or a
    ``ProcessGroup``, as ``stack_sharding`` takes), or None."""
    if vector_sharding is None:
        return None
    import torch.distributed as dist
    if not isinstance(vector_sharding, dist.ProcessGroup) and not (
            isinstance(vector_sharding, (tuple, list))
            and len(vector_sharding) == 2
            and hasattr(vector_sharding[0], "mesh_dim_names")):
        raise TypeError("vector_sharding must be (mesh, dim) with a "
                        "DeviceMesh, or a ProcessGroup; got "
                        f"{vector_sharding!r}")
    from ..parallel.mesh import RowReduce, shard_group
    return RowReduce(shard_group(vector_sharding))




class _Flat(_Resumable):
    """What LRAWhiten, LRANewton and DenseNewton share: the parameters in
    the JAX pytree order, concatenated into one vector for the fit and the
    apply (JAX ``ravel_pytree``) and split back for the step; the momentum
    of that vector, the key chain and the weight decay.  The
    preconditioner's state is ``self.precond``, the momentum ``self.mu``;
    ``state_dict`` carries both under ``psgd``.

    With ``vector_sharding`` (``self.rows``, a ``parallel.mesh.RowReduce``
    over k ranks) the vector is zero-padded to ``n_pad``, a multiple of k,
    and rank i works on rows [lo, lo + n_loc), n_loc = n_pad / k
    (``pad_mask`` marks its true rows, None where it has no pad row).
    ``ROW_VECTORS``: whether the momentum and the update are row blocks
    too (LRA), or whole on every rank (dense)."""

    ROW_VECTORS = True

    def __init__(self, params, defaults: dict, *, init_scale, momentum: float,
                 momentum_dtype, preconditioner_dtype, seed: int, device,
                 draw, vector_sharding):
        if defaults["weight_decay_mode"] not in ("decoupled", "classic"):
            raise ValueError(
                f"unknown weight_decay_mode {defaults['weight_decay_mode']!r}")
        self.device = resolve_device(device)
        _, tensors, _ = _pytree_order(params)
        for t in tensors:
            if t.device != self.device:
                raise ValueError(f"parameter on {t.device}, optimizer on "
                                 f"{self.device}")
        self.rows = _vector_group(vector_sharding)
        super().__init__([{"params": tensors}], defaults)
        self.vec_dtype = functools.reduce(torch.promote_types,
                                          (t.dtype for t in tensors))
        self.n = sum(t.numel() for t in tensors)
        k = 1 if self.rows is None else self.rows.size
        self.n_pad = -(-self.n // k) * k
        self.n_loc = self.n_pad // k
        self.lo = 0 if self.rows is None else self.rows.index * self.n_loc
        self.pad_mask = None
        if self.lo + self.n_loc > self.n:
            self.pad_mask = (torch.arange(self.lo, self.lo + self.n_loc,
                                          device=self.device) < self.n)[:, None]
        self.qdtype = preconditioner_dtype or self.vec_dtype
        self.momentum = momentum
        self.init_scale = init_scale
        self.draw = draw
        self.count = 0
        self.key = fastrand.prng_key(seed)
        self.fit_steps = 0   # steps on which the preconditioner was fitted
        self.mu = (torch.zeros(self.n_loc if self.ROW_VECTORS else self.n_pad,
                               dtype=momentum_dtype or self.vec_dtype,
                               device=self.device) if momentum > 0 else None)

    @property
    def per_rank(self) -> bool:
        """Whether this rank's state is its own (checkpoints: one file
        per rank)."""
        return self.rows is not None

    def _layout(self) -> dict:
        out = {"optimizer": type(self).__name__,
               "shapes": [list(p.shape) for p in self.param_groups[0]["params"]],
               "dq": getattr(self, "dq", None)}
        if self.rows is not None:
            out["vector_sharding"] = dict(world=self.rows.size,
                                          rank=self.rows.index,
                                          n_true=self.n, n_pad=self.n_pad)
        return out

    def _unsharded_layout(self) -> dict:
        """The layout an unsharded optimizer of the same settings holds."""
        out = self._layout()
        out.pop("vector_sharding", None)
        return out

    def _pieces(self) -> dict:
        """As ``_Kron._pieces``: this rank's true rows of U, V, d and the
        LRA momentum (of Q's rows, its true columns, for dense; the dense
        momentum's true entries), in the unsharded optimizer's (n, ...)
        tensors; the pad rows are left out (each rank's own)."""
        if self.rows is None:
            return {}
        t = max(0, min(self.lo + self.n_loc, self.n) - self.lo)
        n, lo = self.n, self.lo

        def rows(x, cols=None):
            rest = list(x.shape[1:]) if cols is None else [cols]
            whole = [slice(None)] * len(rest)
            return _piece([n] + rest, [slice(lo, lo + t)] + whole,
                          local=[[0, t]] + [[0, c] for c in rest])

        out = {}
        for f, x in self.precond._asdict().items():
            if x.ndim and x.shape[0] == self.n_loc:
                out[("psgd", "precond", f)] = rows(
                    x, n if f == "q" else None)
        if self.mu is not None:
            out[("psgd", "mu")] = (rows(self.mu) if self.ROW_VECTORS else
                                   _piece([n], [slice(None)], local=[[0, n]]))
        return out

    def _extra_state(self) -> dict:
        return {"precond": self.precond._asdict(), "mu": self.mu}

    def _load_extra_state(self, saved: dict) -> None:
        self.precond = type(self.precond)(**saved["precond"])
        self.mu = saved["mu"]

    def _flat(self, xs) -> torch.Tensor:
        return torch.cat([x.reshape(-1).to(self.vec_dtype) for x in xs])

    def _split(self, vec: torch.Tensor) -> list:
        params = self.param_groups[0]["params"]
        return [_cast(x.view(p.shape), p.dtype) for x, p in
                zip(vec.split([p.numel() for p in params]), params)]

    # -- the vector this rank works on --------------------------------------

    def _rows_of(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows [lo, lo + n_loc) of a whole (n,) vector, zero
        on the pad rows."""
        part = x[self.lo:min(self.lo + self.n_loc, self.n)]
        return torch.nn.functional.pad(part, (0, self.n_loc - part.shape[0]))

    def _padded(self, x: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(x, (0, self.n_pad - self.n))

    def _vec(self, x: torch.Tensor) -> torch.Tensor:
        """A whole (n,) vector as this rank works on it: its rows (LRA
        sharded), padded (dense sharded), or itself."""
        if self.rows is None:
            return x
        return self._rows_of(x) if self.ROW_VECTORS else self._padded(x)

    def _unvec(self, pre: torch.Tensor) -> torch.Tensor:
        """The whole (n,) update from what ``_vec`` gave: the row blocks
        of every rank by one ``all_gather`` (the step's one n-sized
        move), or the padded update cut to n."""
        if self.rows is None:
            return pre
        if self.ROW_VECTORS:
            from ..parallel.mesh import all_gather_stack
            pre = all_gather_stack(pre, self.rows.sg)
        return pre[:self.n]

    def _row_scale(self, d: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
        """A row block's true rows times ``mult`` (the on-the-fly init
        scale), its pad rows kept."""
        out = d * mult
        return out if self.pad_mask is None else torch.where(self.pad_mask, out, d)

    def _source(self, g: torch.Tensor, count: int) -> torch.Tensor:
        """The apply's source: the momentum after this step's EMA, or g."""
        if self.mu is None:
            return g
        return _ema_(self.mu, g, count, self.momentum)


class _FlatNewton(_Flat):
    """The Newton step of LRANewton and DenseNewton (JAX
    ``scale_by_lra_newton`` / ``scale_by_dense_newton``): the gate
    (uniform < p, or the first step); on a fit step the probes and H v
    (``_newton_pass``), the on-the-fly init scale at step 0, and the fit
    from the concatenated (v, H v) cast to the preconditioner's dtype;
    then the momentum, P applied, the global-norm clip, weight decay and
    -lr.  The closure returns the loss without calling backward."""

    def _fit(self, v, h, key, count, lr_q, beta_l, damping) -> None:
        raise NotImplementedError

    def _apply(self, src: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None, *, vs=None, hvs=None):
        """One step.  From the closure's autograd (``_newton_pass``), or,
        with explicit ``vs`` and ``hvs`` (the probes and H v per parameter,
        as JAX ``update(g, s, vs=, hvs=)`` takes them), from ``.grad`` and
        that pair, which fits every step; ``closure``, if given, then only
        returns the loss."""
        explicit = vs is not None or hvs is not None
        if explicit and (vs is None or hvs is None):
            raise ValueError(f"{type(self).__name__}.step takes vs and hvs "
                             "together")
        if closure is None and not explicit:
            raise ValueError(f"{type(self).__name__}.step needs a closure that "
                             "returns the loss (without calling backward)")
        group = self.param_groups[0]
        params = group["params"]
        count = self.count
        keys = fastrand.split(self.key, 4)
        self.key, k_gate, k_v, k_fit = keys[0], keys[1], keys[2], keys[3]
        do_fit = explicit or _host_gate(
            group["preconditioner_update_probability"], k_gate, count,
            self.draw) or count == 0
        if explicit:
            loss = None
            if closure is not None:
                with torch.enable_grad():
                    loss = closure()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
        else:
            loss, grads, vs, hvs = _newton_pass(closure, params, do_fit, k_v,
                                                self.exact_hvp, self.draw)
        g = self._flat(_classic_decay(group, grads, params))
        if do_fit:
            self._fit(self._flat(vs), self._flat(hvs), k_fit, count,
                      _sched(group["lr_preconditioner"], count),
                      _sched(group["betaL"], count),
                      _sched(group["damping"], count))
        self.fit_steps += int(do_fit)
        src = self._source(self._vec(g), count)
        pre = _cast(self._apply(_cast(src, self.qdtype)), g.dtype)
        max_norm = _sched(group["grad_clip_max_norm"], count)
        if self.rows is not None and self.ROW_VECTORS:
            if not math.isinf(max_norm):
                # the trust-region norm over the row blocks, in float32
                sq = self.rows.sum(torch.sum(
                    torch.real(pre * torch.conj(pre)).to(torch.float32)))
                pre = pre * torch.clamp(
                    max_norm / torch.clamp(torch.sqrt(sq), min=1e-38),
                    max=1.0).to(real_dtype_of(pre.dtype))
        else:
            pre = pre * _global_norm_scale([pre], max_norm)
        _descend(group, params, self._split(self._unvec(pre)), count)
        self.count += 1
        return loss


def _newton_scale(v: torch.Tensor, h: torch.Tensor,
                  damping: float) -> torch.Tensor:
    """On-the-fly init scale mean(v^2)^(1/4) (mean(h^4) + damping^4)^(-1/8)
    of the concatenated pair, in float32 (psgd.py:940-943); of a complex
    pair the real parts, as JAX's ``astype(float32)`` reads them."""
    return (torch.mean(_cast(v, torch.float32) ** 2) ** 0.25
            * (torch.mean(_cast(h, torch.float32) ** 4) + damping ** 4)
            ** (-1.0 / 8.0))


class LRAWhiten(_Flat):
    """Low-rank-approximation gradient/momentum whitening over the whole
    parameter vector (reference class LRAWhiten, psgd.py:1075-1190; JAX
    ``lra_whiten``), with the ``zero_grad`` / ``backward`` / ``step``
    contract.

    Per step: the on-the-fly init scale of d at step 0 without
    ``preconditioner_init_scale`` ((mean g^4 + damping^4)^(-1/8) of the
    concatenated gradient), the momentum EMA, the fit gate (uniform < p,
    no forced first fit), ``precond.lra.update_lra_whiten`` from the
    gradient (``whiten_grad``) or the momentum, before or after the apply
    (``update_preconditioner_first``), P applied to the momentum (or the
    gradient), amplitude clipping of the whole vector, weight decay and
    -lr.  ``params``, ``device``, ``draw``: as ``KronWhiten``.  U and V
    are drawn from key(seed + 1) at construction.  On CUDA a fit launches
    ``kernels.unit_noise`` and ``kernels.damped_noise`` once each (the
    probe and the damping, the same v).

    ``vector_sharding=(mesh, dim)`` (or a ``ProcessGroup``) runs the one
    preconditioner ZeRO-style over the group's k ranks, as the JAX
    transform's ``vector_sharding``: the vector is zero-padded to a
    multiple of k, and each rank holds, fits and applies its block of rows
    of U, V, d and the momentum (U and V drawn whole, as without it, and
    cut), with r-sized sums and maxes over the group
    (``precond.lra``'s ``reduce``); its probe is keyed by ``fold_in(kv,
    rank)`` (so a trajectory differs from the unsharded one by the probes'
    draws); the amplitude clip's RMS is over the whole vector.  The update
    is then assembled on every rank by one ``all_gather`` of its rows, the
    step's only n-sized collective, and every rank steps its whole
    parameters: the gradients must be equal on every rank (average them
    first, as DDP does)."""

    def __init__(self, params, lr: float | Callable = 1e-3,
                 weight_decay: float = 0.0,
                 weight_decay_mode: str = "decoupled", *,
                 rank_of_approximation: int = 10,
                 preconditioner_init_scale: Optional[float] = None,
                 lr_preconditioner: float | Callable = 0.1,
                 betaL: float | Callable = 0.9,
                 damping: float | Callable = 1e-9,
                 momentum: float = 0.0,
                 momentum_dtype: Optional[torch.dtype] = None,
                 grad_clip_max_amps=(2.0, 10.0),
                 preconditioner_update_probability: float | Callable = 1.0,
                 update_preconditioner_first: bool = True,
                 whiten_grad: bool = True,
                 preconditioner_dtype: Optional[torch.dtype] = None,
                 vector_sharding=None,
                 seed: int = 0,
                 device=None,
                 draw=None):
        momentum = momentum if 0.0 < momentum < 1.0 else 0.0
        if not whiten_grad and momentum == 0.0:
            raise ValueError("Cannot whiten momentum with momentum == 0")
        defaults = dict(
            lr=lr, weight_decay=weight_decay,
            weight_decay_mode=weight_decay_mode,
            lr_preconditioner=lr_preconditioner, betaL=betaL,
            damping=damping, grad_clip_max_amps=tuple(grad_clip_max_amps),
            preconditioner_update_probability=preconditioner_update_probability)
        super().__init__(params, defaults,
                         init_scale=preconditioner_init_scale,
                         momentum=momentum, momentum_dtype=momentum_dtype,
                         preconditioner_dtype=preconditioner_dtype, seed=seed,
                         device=device, draw=draw,
                         vector_sharding=vector_sharding)
        self.update_preconditioner_first = update_preconditioner_first
        self.whiten_grad = whiten_grad
        self.precond = _init_lra_rows(self, rank_of_approximation, seed,
                                      preconditioner_init_scale)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._step([p.grad if p.grad is not None else torch.zeros_like(p)
                    for p in self.param_groups[0]["params"]])
        return loss

    def _step(self, grads) -> None:
        """One step from the gradients (in the parameters' order)."""
        group = self.param_groups[0]
        params = group["params"]
        count = self.count
        g = self._flat(_classic_decay(group, grads, params))
        st, qdt, rows = self.precond, self.qdtype, self.rows
        keys = fastrand.split(self.key, 3)
        self.key, k_gate, k_fit = keys[0], keys[1], keys[2]
        do_fit = _host_gate(group["preconditioner_update_probability"], k_gate,
                            count, self.draw)
        lr_q = _sched(group["lr_preconditioner"], count)
        beta_l = _sched(group["betaL"], count)
        damping = _sched(group["damping"], count)
        amps = tuple(_sched(a, count) for a in group["grad_clip_max_amps"])
        g_loc = self._vec(g)
        if self.init_scale is None and count == 0:
            if rows is None:
                scale = (torch.mean(_cast(g, torch.float32) ** 4)
                         + damping ** 4) ** (-1.0 / 8.0)
            else:    # the mean over the whole vector, its rows summed
                g4 = rows.sum(torch.sum(torch.abs(_cast(g_loc, torch.float32)) ** 4))
                scale = (g4 / self.n + damping ** 4) ** (-1.0 / 8.0)
            st = st._replace(d=self._row_scale(st.d, scale.to(qdt)))
        src = self._source(g_loc, count)
        fit_src = _cast(g_loc if self.whiten_grad else src, qdt)

        def fit(s):
            return lra_p.update_lra_whiten(s, fit_src, k_fit, lr=lr_q,
                                           beta_l=beta_l, damping=damping,
                                           draw=self.draw, reduce=rows,
                                           pad_mask=self.pad_mask)

        def apply(s):
            pg = _cast(lra_p.precond_grad(s, _cast(src, qdt), rows), g.dtype)
            if rows is None:
                return _amp_clip(pg, *amps, stacked=False)
            return _sharded_amp_clip(pg, amps,
                                     lambda x: rows.sum(torch.sum(x)), self.n)

        if self.update_preconditioner_first:
            st = fit(st) if do_fit else st
            pre = apply(st)
        else:
            pre = apply(st)
            st = fit(st) if do_fit else st
        self.precond = st
        self.fit_steps += int(do_fit)
        _descend(group, params, self._split(self._unvec(pre)), count)
        self.count += 1


def _init_lra_rows(opt: _Flat, rank: int, seed: int, init_scale):
    """The LRA state of an LRAWhiten or LRANewton: U and V drawn whole from
    key(seed + 1); under ``vector_sharding`` padded (``pad_lra_state``)
    and cut to this rank's rows, so k ranks start where one does."""
    st = lra_p.init_lra(opt.n, rank, fastrand.prng_key(seed + 1),
                        1.0 if init_scale is None else init_scale, opt.qdtype,
                        opt.device, opt.draw)
    if opt.rows is None:
        return st
    st = lra_p.pad_lra_state(st, opt.n_pad - opt.n)
    rows = slice(opt.lo, opt.lo + opt.n_loc)
    return st._replace(u=st.u[rows].clone(), v=st.v[rows].clone(),
                       d=st.d[rows].clone())


class LRANewton(_FlatNewton):
    """Low-rank-approximation Newton-type preconditioner over the whole
    parameter vector, fitted from Hessian-vector products (reference class
    LRANewton, psgd.py:1201-1330; JAX ``lra_newton``), with the closure
    contract of ``KronNewton``.  The init scale of d on the first step
    without ``preconditioner_init_scale`` is mean(v^2)^(1/4) (mean(h^4)
    + damping^4)^(-1/8) of the concatenated pair.  On CUDA a fit launches
    ``kernels.unit_noise`` once per parameter (the probes) and
    ``kernels.damped_noise`` once (the damping of h).
    ``vector_sharding``: as ``LRAWhiten``'s; the probes v and H v are
    whole on every rank (the closure's autograd, or ``vs``/``hvs``) and
    each rank fits from its rows of them, its damping keyed by
    ``fold_in(kd, rank)``; the init scale's means and the norm clip's
    norm (in float32) are over the whole vector."""

    def __init__(self, params, lr: float | Callable = 0.01,
                 weight_decay: float = 0.0,
                 weight_decay_mode: str = "decoupled", *,
                 rank_of_approximation: int = 10,
                 preconditioner_init_scale: Optional[float] = None,
                 lr_preconditioner: float | Callable = 0.1,
                 betaL: float | Callable = 0.9,
                 damping: float | Callable = 1e-9,
                 momentum: float = 0.0,
                 momentum_dtype: Optional[torch.dtype] = None,
                 grad_clip_max_norm: float | Callable = float("inf"),
                 preconditioner_update_probability: float | Callable = 1.0,
                 exact_hessian_vector_product: bool = True,
                 preconditioner_dtype: Optional[torch.dtype] = None,
                 vector_sharding=None,
                 seed: int = 0,
                 device=None,
                 draw=None):
        defaults = dict(
            lr=lr, weight_decay=weight_decay,
            weight_decay_mode=weight_decay_mode,
            lr_preconditioner=lr_preconditioner, betaL=betaL,
            damping=damping, grad_clip_max_norm=grad_clip_max_norm,
            preconditioner_update_probability=preconditioner_update_probability)
        super().__init__(params, defaults,
                         init_scale=preconditioner_init_scale,
                         momentum=momentum if 0.0 < momentum < 1.0 else 0.0,
                         momentum_dtype=momentum_dtype,
                         preconditioner_dtype=preconditioner_dtype, seed=seed,
                         device=device, draw=draw,
                         vector_sharding=vector_sharding)
        self.exact_hvp = exact_hessian_vector_product
        self.precond = _init_lra_rows(self, rank_of_approximation, seed,
                                      preconditioner_init_scale)

    def _fit(self, v, h, key, count, lr_q, beta_l, damping) -> None:
        st, rows = self.precond, self.rows
        if rows is not None:
            v, h = self._rows_of(v), self._rows_of(h)
        if self.init_scale is None and count == 0:
            if rows is None:
                scale = _newton_scale(v, h, damping)
            else:    # the means over the whole vector, its rows summed
                v2 = rows.sum(torch.sum(torch.abs(_cast(v, torch.float32)) ** 2))
                h4 = rows.sum(torch.sum(torch.abs(_cast(h, torch.float32)) ** 4))
                scale = ((v2 / self.n) ** 0.25
                         * (h4 / self.n + damping ** 4) ** (-1.0 / 8.0))
            st = st._replace(d=self._row_scale(st.d, scale.to(self.qdtype)))
        self.precond = lra_p.update_lra_newton(
            st, _cast(v, self.qdtype), _cast(h, self.qdtype), key, lr=lr_q,
            beta_l=beta_l, damping=damping, draw=self.draw, reduce=rows,
            pad_mask=self.pad_mask)

    def _apply(self, src):
        return lra_p.precond_grad(self.precond, src, self.rows)


class DenseNewton(_FlatNewton):
    """Dense Newton-type preconditioner, one (n, n) Q over the whole
    parameter vector, in each of the seven geometries (reference class
    DenseNewton, psgd.py:1427-1563; JAX ``dense_newton``), with the closure
    contract of ``KronNewton``.  The on-the-fly init scale is
    ``LRANewton``'s, squared for the fit-P geometries.  On CUDA a fit
    launches ``kernels.unit_noise`` once per parameter and
    ``kernels.damped_noise`` once, and Q0.5EQ1.5 one ``kernels.procrustes``
    on the (1, n, n) stack, PRO4P ``linalg.procrustes_loop3`` (10
    ``kernels.tsub`` and 10 skew ``kernels.norm_bound``).  The constructor
    warns as the JAX transform's ``_advisories`` do.

    ``vector_sharding=(mesh, dim)`` (or a ``ProcessGroup``; QEQ only, as in
    JAX: the geometry whose update needs no transpose of Q) shards Q's
    rows over the group's k ranks, n zero-padded to a multiple of k, as
    ``dense_state_specs`` places them: each rank holds and fits its block
    of rows (``precond.dense.update_dense_qeq_row_sharded``: one (n,)-sized
    sum over the group per fit and one per apply), while v, H v, the
    momentum and the update are whole on every rank.  The damping is keyed
    by the fit key itself, as JAX's, so every rank draws the same; with no
    pad row a k-rank run matches a 1-rank ``vector_sharding`` run up to
    the order of the sums.  The gradients must be equal on every rank."""

    ROW_VECTORS = False

    def __init__(self, params, lr: float | Callable = 0.01,
                 weight_decay: float = 0.0,
                 weight_decay_mode: str = "decoupled", *,
                 preconditioner_init_scale: Optional[float] = None,
                 lr_preconditioner: float | Callable = 0.1,
                 betaL: float | Callable = 0.9,
                 damping: float | Callable = 1e-9,
                 momentum: float = 0.0,
                 momentum_dtype: Optional[torch.dtype] = None,
                 grad_clip_max_norm: float | Callable = float("inf"),
                 preconditioner_update_probability: float | Callable = 1.0,
                 exact_hessian_vector_product: bool = True,
                 dq: str = "Q0.5EQ1.5",
                 preconditioner_dtype: Optional[torch.dtype] = None,
                 norm_k: Optional[int] = None,
                 vector_sharding=None,
                 seed: int = 0,
                 device=None,
                 draw=None):
        dq = kron_p.canonical_dq(dq)
        if vector_sharding is not None and dq != kron_p.DQ_QEQ:
            raise ValueError("DenseNewton's vector_sharding takes dq='QEQ' "
                             f"only (the transpose-free geometry); got {dq!r}")
        _advisories(preconditioner_init_scale, True, 0.0, dq,
                    preconditioner_dtype)
        defaults = dict(
            lr=lr, weight_decay=weight_decay,
            weight_decay_mode=weight_decay_mode,
            lr_preconditioner=lr_preconditioner, betaL=betaL,
            damping=damping, grad_clip_max_norm=grad_clip_max_norm,
            preconditioner_update_probability=preconditioner_update_probability)
        super().__init__(params, defaults,
                         init_scale=preconditioner_init_scale,
                         momentum=momentum if 0.0 < momentum < 1.0 else 0.0,
                         momentum_dtype=momentum_dtype,
                         preconditioner_dtype=preconditioner_dtype, seed=seed,
                         device=device, draw=draw,
                         vector_sharding=vector_sharding)
        self.exact_hvp = exact_hessian_vector_product
        self.dq = dq
        self.norm_k = norm_k
        st = dense_p.init_dense(
            self.n_pad, 1.0 if preconditioner_init_scale is None
            else preconditioner_init_scale, dq, self.qdtype, self.device)
        if self.rows is not None:
            st = st._replace(q=st.q[self.lo:self.lo + self.n_loc].clone())
        self.precond = st

    def _fit(self, v, h, key, count, lr_q, beta_l, damping) -> None:
        st = self.precond
        if self.init_scale is None and count == 0:
            scale = _newton_scale(v, h, damping)
            if self.dq in kron_p._FIT_P:
                scale = scale * scale
            st = st._replace(q=self._row_scale(
                st.q, scale.to(real_dtype_of(self.qdtype))))
        v, h = _cast(v, self.qdtype), _cast(h, self.qdtype)
        if self.rows is None:
            self.precond = dense_p.update_dense(
                st, v, h, key, self.dq, lr=lr_q, beta_l=beta_l,
                damping=damping,
                norm_k=resolve_norm_k(self.norm_k, self.qdtype), draw=self.draw)
        else:
            self.precond = dense_p.DenseState(
                *dense_p.update_dense_qeq_row_sharded(
                    st.q, st.lips, self._padded(v), self._padded(h), key,
                    self.rows, self.n, lr=lr_q, beta_l=beta_l,
                    damping=damping, draw=self.draw))

    def _apply(self, src):
        if self.rows is None:
            return dense_p.precond_grad(self.precond, src, self.dq)
        return dense_p.precond_grad_qeq_row_sharded(self.precond.q, src,
                                                    self.rows)


def lra_whiten(params, learning_rate: float | Callable = 1e-3,
               weight_decay: float = 0.0,
               weight_decay_mode: str = "decoupled", **kwargs) -> LRAWhiten:
    """LRAWhiten with the JAX factory's argument names."""
    return LRAWhiten(params, lr=learning_rate, weight_decay=weight_decay,
                     weight_decay_mode=weight_decay_mode, **kwargs)


def lra_newton(params, learning_rate: float | Callable = 0.01,
               weight_decay: float = 0.0,
               weight_decay_mode: str = "decoupled", **kwargs) -> LRANewton:
    """LRANewton with the JAX factory's argument names."""
    return LRANewton(params, lr=learning_rate, weight_decay=weight_decay,
                     weight_decay_mode=weight_decay_mode, **kwargs)


def dense_newton(params, learning_rate: float | Callable = 0.01,
                 weight_decay: float = 0.0,
                 weight_decay_mode: str = "decoupled",
                 **kwargs) -> DenseNewton:
    """DenseNewton with the JAX factory's argument names."""
    return DenseNewton(params, lr=learning_rate, weight_decay=weight_decay,
                       weight_decay_mode=weight_decay_mode, **kwargs)
