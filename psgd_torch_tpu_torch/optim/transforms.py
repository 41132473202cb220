"""Kron whitening and Kron Newton as ``torch.optim.Optimizer`` classes.

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

``scanned_layers`` marks parameters whose leading axis is a layer stack:
each layer gets its own preconditioner and the whole stack one batched
update.  Parameter order (which fixes each leaf's key) is the JAX pytree
order: named parameters are sorted by their dotted path.  Complex
parameters are refused (ROADMAP A3).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch

from .. import resolve_device
from ..ops import fastrand
from ..ops.linalg import real_dtype_of, resolve_norm_k
from ..precond import kron as kron_p
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
    tensor, or per layer of a stack (psgd.py:642-651)."""
    dims = tuple(range(1, g.ndim)) if stacked else tuple(range(g.ndim))
    sq = torch.real(g * torch.conj(g)).to(torch.float32)
    avg_amp = torch.sqrt(torch.mean(sq, dim=dims, keepdim=True) if dims
                         else sq)
    scale = torch.clamp(max_avg_amp / torch.clamp(avg_amp, min=1e-30),
                        max=1.0).to(real_dtype_of(g.dtype))
    return torch.clamp(g * scale, -max_element_amp, max_element_amp)


def _whiten_scale_from_grads(grads, flags, damping: float) -> torch.Tensor:
    """On-the-fly init scale (mean|g|^4 + damping^4)^(-1/8), max over tensors
    (each layer of a stack counts as a tensor), on the device."""
    ms = []
    for g, f in zip(grads, flags):
        g4 = torch.abs(g.to(torch.float32)) ** 4
        if f:
            ms.append(torch.amax(torch.mean(g4.reshape(g4.shape[0], -1), 1)))
        else:
            ms.append(torch.mean(g4))
    return (torch.amax(torch.stack(ms)) + damping ** 4) ** (-1.0 / 8.0)


def _rounded(x: float, dtype: torch.dtype) -> float:
    """x as the nearest value of ``dtype`` (host-side, no device work)."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


_UNPORTED = {
    "shared_layers": "A2", "pipelined_fit": "A2", "share_fit_apply": "A2",
    "cache_p": "A2", "stack_sharding": "A8", "factor_sharding": "A8",
}
_NEWTON_OPTIONS = ("shared_layers", "cache_p", "stack_sharding",
                   "factor_sharding")


def _refuse_unported(unported: dict, allowed) -> None:
    for name, value in unported.items():
        if name not in allowed:
            raise TypeError(f"unexpected keyword argument {name!r}")
        if value:
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP {_UNPORTED[name]})")


def _newton_scale_from_vh(vs, hs, damping: float) -> torch.Tensor:
    """On-the-fly init scale (mean|v|^2)^(1/4) (mean|h|^4 + damping^4)^(-1/8),
    mean|v|^2 over all leaves, mean|h|^4 the max over leaves, in float32 on
    the device (psgd.py:940-943)."""
    numel = sum(v.numel() for v in vs)
    v2 = sum(torch.sum(torch.abs(v.to(torch.float32)) ** 2) for v in vs) / numel
    h4 = torch.amax(torch.stack([torch.mean(torch.abs(h.to(torch.float32)) ** 4)
                                 for h in hs]))
    return v2 ** 0.25 * (h4 + damping ** 4) ** (-1.0 / 8.0)


def _global_norm_scale(xs, max_norm: float):
    """Trust-region scale min(1, max_norm / ||xs||) over all tensors, a
    device scalar (psgd.py:967-971); 1.0 for an infinite max_norm."""
    if math.isinf(max_norm):
        return 1.0
    norm = torch.sqrt(sum(torch.sum(x * x) for x in xs))
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-38), max=1.0)


class _Kron(torch.optim.Optimizer):
    """What KronWhiten and KronNewton share: the parameters in the JAX
    pytree order, the plans, the factored state, the momentum buffers, the
    key chain and the per-leaf fit and apply."""

    # (per-tensor fit, stacked fit) of precond.kron
    _FITS: tuple

    def __init__(self, params, defaults: dict, *, max_size: float,
                 max_skew: float, init_scale, momentum: float, momentum_dtype,
                 dq: str, preconditioner_dtype, norm_k, seed: int,
                 scanned_layers, device, draw):
        if defaults["weight_decay_mode"] not in ("decoupled", "classic"):
            raise ValueError(
                f"unknown weight_decay_mode {defaults['weight_decay_mode']!r}")
        dq = kron_p.canonical_dq(dq)
        kron_p._require_main_path_dq(dq)
        self.device = resolve_device(device)

        items = list(params)
        named = bool(items) and isinstance(items[0], tuple)
        names = [n for n, _ in items] if named else None
        tensors = [t for _, t in items] if named else items
        if isinstance(scanned_layers, dict):
            if names is None:
                raise ValueError("a scanned_layers dict needs named parameters")
            flags = [bool(scanned_layers.get(n, False)) for n in names]
        elif scanned_layers is None:
            flags = [False] * len(tensors)
        else:
            flags = [bool(f) for f in scanned_layers]
            if len(flags) != len(tensors):
                raise ValueError(f"scanned_layers has {len(flags)} entries, "
                                 f"params have {len(tensors)}")
        order = list(range(len(tensors)))
        if names is not None:   # JAX pytree order: sorted dotted paths
            order.sort(key=lambda i: tuple(names[i].split(".")))
        self.scanned = [flags[i] for i in order]
        tensors = [tensors[i] for i in order]
        for t in tensors:
            if t.device != self.device:
                raise ValueError(f"parameter on {t.device}, optimizer on "
                                 f"{self.device}")
        kron_p.require_real(*(t.dtype for t in tensors),
                            *((preconditioner_dtype,) if preconditioner_dtype
                              else ()))

        super().__init__([{"params": tensors}], defaults)
        self.momentum = momentum
        self.init_scale = init_scale
        self.norm_k = norm_k
        self.draw = draw
        self.count = 0
        self.key = fastrand.prng_key(seed)
        self.fit_steps = 0   # steps on which Q was fitted
        self.plans = []
        for t, f in zip(tensors, self.scanned):
            shape = _squeezed_shape(t.shape[1:] if f else t.shape)
            self.plans.append(kron_p.make_kron_plan(shape, max_size, max_skew,
                                                    dq))
        scale0 = 1.0 if init_scale is None else init_scale
        for t, f, plan in zip(tensors, self.scanned, self.plans):
            qdt = preconditioner_dtype or t.dtype
            st = kron_p.init_kron_from_plan(plan, scale0, qdt, self.device)
            if f:
                st = kron_p.KronState(
                    q=tuple(x.expand((t.shape[0],) + x.shape).clone()
                            for x in st.q),
                    lips=tuple(x.expand(t.shape[0]).clone() for x in st.lips))
            state = self.state[t]
            state["q"], state["lips"] = st.q, st.lips
            if momentum > 0:
                state["mu"] = torch.zeros_like(t, dtype=momentum_dtype or t.dtype)

    # -- pieces of one step -------------------------------------------------

    def _view(self, x, i):
        plan = self.plans[i]
        lead = (x.shape[0],) if self.scanned[i] else ()
        return x.reshape(lead + plan.shape)

    def _gate(self, k_gate, count: int) -> bool:
        """The fit gate: uniform(k_gate) < p, decided on the host (a literal
        p >= 1 fits without a draw)."""
        prob = self.param_groups[0]["preconditioner_update_probability"]
        if _static_always(prob):
            return True
        u = (float(fastrand.uniform01(k_gate)) if self.draw is None else
             float(self.draw("uniform", k_gate[None], (), torch.float64)[0]))
        return u < _sched(prob, count)

    def _rescale(self, params, scale) -> None:
        """Multiply Q by the on-the-fly init scale (squared for the fit-P
        geometries), spread over the factors."""
        for p, plan in zip(params, self.plans):
            st = self.state[p]
            eff = scale * scale if plan.fits_p else scale
            mult = eff ** (1.0 / max(plan.order, 1))
            st["q"] = tuple(q * mult.to(real_dtype_of(q.dtype))
                            for q in st["q"])

    def _momentum(self, params, grads, count: int):
        """The bias-warmed EMA of the gradients; the buffers."""
        beta = min(count / (count + 1.0), self.momentum)
        for p, g in zip(params, grads):
            mu = self.state[p]["mu"]
            b = _rounded(beta, mu.dtype)
            mu.mul_(b).add_(g.to(mu.dtype) * _rounded(1.0 - b, mu.dtype))
        return [self.state[p]["mu"] for p in params]

    def _fit(self, params, sources, k_fit, lr_q, beta_l, damping):
        """Fit each leaf's Q from its sources (g, or (v, h)) cast to Q's
        dtype, keyed by fold_in(k_fit, leaf), split per layer of a stack."""
        fit_one, fit_stacked = self._FITS
        for i, (p, src) in enumerate(zip(params, sources)):
            st = self.state[p]
            qdt = st["q"][0].dtype
            key = fastrand.fold_in(k_fit, i)
            kw = dict(lr=lr_q, beta_l=beta_l, damping=damping,
                      norm_k=resolve_norm_k(self.norm_k, qdt), draw=self.draw)
            state = kron_p.KronState(q=st["q"], lips=st["lips"])
            views = [self._view(x, i).to(qdt) for x in src]
            if self.scanned[i]:
                out = fit_stacked(state, self.plans[i], *views,
                                  fastrand.split(key, views[0].shape[0]), **kw)
            else:
                out = fit_one(state, self.plans[i], *views, key, **kw)
            st["q"], st["lips"] = out.q, out.lips

    def _precond(self, i, p, src):
        """P src for leaf i (parameter p), in p's dtype and the plan's
        shape."""
        st = self.state[p]
        state = kron_p.KronState(q=st["q"], lips=st["lips"])
        g = self._view(src, i).to(st["q"][0].dtype)
        if self.scanned[i]:
            pg = kron_p.precond_grad_stacked(state, self.plans[i], g)
        else:
            pg = kron_p.precond_grad(state, self.plans[i], g)
        return pg.to(p.dtype)

    def _descend(self, params, updates, count: int) -> None:
        """Decoupled weight decay, then -lr."""
        group = self.param_groups[0]
        wd, lr = group["weight_decay"], _sched(group["lr"], count)
        for p, u in zip(params, updates):
            if wd and group["weight_decay_mode"] == "decoupled":
                u = u + wd * p
            p.add_(u * (-lr))


class KronWhiten(_Kron):
    """Kronecker-factored gradient/momentum whitening (reference class
    KronWhiten, psgd.py:516-654; JAX ``kron_whiten``).

    ``params``: tensors, or (name, tensor) pairs such as
    ``model.named_parameters()``; one parameter group.  ``scanned_layers``:
    a dict name -> bool, or a sequence of bools in the given order.
    ``device``: where the optimizer runs (default CUDA; the parameters must
    live there).  ``draw``: optional replay hook ``draw(kind, keys, shape,
    dtype)`` that supplies the fit's random draws (see precond.kron) and
    the gate uniforms.
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
                 device=None,
                 draw=None,
                 **unported):
        _refuse_unported(unported, _UNPORTED)
        momentum = momentum if 0.0 < momentum < 1.0 else 0.0
        if not whiten_grad and momentum == 0.0:
            raise ValueError("Cannot whiten momentum with momentum == 0")
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
            seed=seed, scanned_layers=scanned_layers, device=device, draw=draw)
        self.update_preconditioner_first = update_preconditioner_first
        self.whiten_grad = whiten_grad

    def _apply(self, params, sources, clip_amps):
        """P src clipped per leaf (the unclipped product freed leaf by
        leaf)."""
        return [_amp_clip(self._precond(i, p, src), *clip_amps,
                          stacked=self.scanned[i]).reshape(p.shape)
                for i, (p, src) in enumerate(zip(params, sources))]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        group = self.param_groups[0]
        params = group["params"]
        count = self.count
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        wd = group["weight_decay"]
        if wd and group["weight_decay_mode"] == "classic":
            grads = [g + wd * p for g, p in zip(grads, params)]

        damping = _sched(group["damping"], count)
        if self.init_scale is None and count == 0:
            self._rescale(params,
                          _whiten_scale_from_grads(grads, self.scanned, damping))

        mus = self._momentum(params, grads, count) if self.momentum > 0 else None
        fit_src = grads if self.whiten_grad else mus
        apply_src = mus if self.momentum > 0 else grads

        keys = fastrand.split(self.key, 3)
        self.key, k_gate, k_fit = keys[0], keys[1], keys[2]
        do_fit = self._gate(k_gate, count)
        fit_args = (_sched(group["lr_preconditioner"], count),
                    _sched(group["betaL"], count), damping)
        clip = tuple(_sched(a, count) for a in group["grad_clip_max_amps"])
        fit_src = [(g,) for g in fit_src]

        if self.update_preconditioner_first:
            if do_fit:
                self._fit(params, fit_src, k_fit, *fit_args)
            updates = self._apply(params, apply_src, clip)
        else:
            updates = self._apply(params, apply_src, clip)
            if do_fit:
                self._fit(params, fit_src, k_fit, *fit_args)
        self.fit_steps += int(do_fit)
        self._descend(params, updates, count)
        self.count += 1
        return loss


class KronNewton(_Kron):
    """Kronecker-factored Newton-type preconditioner fitted from
    Hessian-vector products (reference class KronNewton, psgd.py:832-978;
    JAX ``kron_newton``), Q0.5EQ1.5.

    ``step(closure)``: the closure returns the loss and does not call
    backward.  The step draws the fit gate (uniform < p, or the first
    step); on a fit step it draws a probe v per parameter and takes the
    gradient and H v in one pass (``optim.hvp.hvp_exact``: double backward
    under the math attention; ``hvp_finite_diff`` with
    ``exact_hessian_vector_product=False``), and fits Q from (v, H v) cast
    to Q's dtype; otherwise it takes the gradient with one plain backward.
    Then the momentum EMA of the gradient, P applied to it (or to the
    gradient), the global-norm trust-region clip ``grad_clip_max_norm``,
    weight decay and -lr.  ``.grad`` is neither read nor written.
    Arguments otherwise as ``KronWhiten``.
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
                 device=None,
                 draw=None,
                 **unported):
        _refuse_unported(unported, _NEWTON_OPTIONS)
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
            seed=seed, scanned_layers=scanned_layers, device=device, draw=draw)
        self.exact_hvp = exact_hessian_vector_product

    @torch.no_grad()
    def step(self, closure=None):
        if closure is None:
            raise ValueError("KronNewton.step needs a closure that returns "
                             "the loss (without calling backward)")
        group = self.param_groups[0]
        params = group["params"]
        count = self.count
        keys = fastrand.split(self.key, 4)
        self.key, k_gate, k_v, k_fit = keys[0], keys[1], keys[2], keys[3]
        do_fit = self._gate(k_gate, count) or count == 0
        losses = []

        def loss_fn():
            losses.append(closure())
            return losses[-1]

        if do_fit:
            vs = hvp.rand_like(k_v, params, self.draw)
            hvp_fn = hvp.hvp_exact if self.exact_hvp else hvp.hvp_finite_diff
            grads, hvs = hvp_fn(loss_fn, params, vs)
        else:
            with torch.enable_grad():
                grads = hvp.gradients(loss_fn(), params)
        wd = group["weight_decay"]
        if wd and group["weight_decay_mode"] == "classic":
            grads = [g + wd * p for g, p in zip(grads, params)]

        damping = _sched(group["damping"], count)
        if do_fit:
            if self.init_scale is None and count == 0:
                self._rescale(params, _newton_scale_from_vh(vs, hvs, damping))
            self._fit(params, list(zip(vs, hvs)), k_fit,
                      _sched(group["lr_preconditioner"], count),
                      _sched(group["betaL"], count), damping)
        self.fit_steps += int(do_fit)

        src = self._momentum(params, grads, count) if self.momentum > 0 \
            else grads
        pre = [self._precond(i, p, x).reshape(p.shape)
               for i, (p, x) in enumerate(zip(params, src))]
        scale = _global_norm_scale(pre, _sched(group["grad_clip_max_norm"],
                                               count))
        self._descend(params, [u * scale for u in pre], count)
        self.count += 1
        return losses[0]


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
