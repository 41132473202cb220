"""Kron whitening as a ``torch.optim.Optimizer``.

Counterpart of ``scale_by_kron_whiten`` / ``kron_whiten`` in
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

``scanned_layers`` marks parameters whose leading axis is a layer stack:
each layer gets its own preconditioner and the whole stack one batched
update.  Parameter order (which fixes each leaf's key) is the JAX pytree
order: named parameters are sorted by their dotted path.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from .. import resolve_device
from ..ops import fastrand
from ..ops.linalg import real_dtype_of, resolve_norm_k
from ..precond import kron as kron_p


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
    "shared_layers": "A6", "pipelined_fit": "A6", "share_fit_apply": "A6",
    "cache_p": "A6", "stack_sharding": "A11", "factor_sharding": "A11",
}


class KronWhiten(torch.optim.Optimizer):
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
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"unexpected keyword argument {name!r}")
            if value:
                raise NotImplementedError(
                    f"{name} is not ported yet (ROADMAP {_UNPORTED[name]})")
        if weight_decay_mode not in ("decoupled", "classic"):
            raise ValueError(f"unknown weight_decay_mode {weight_decay_mode!r}")
        dq = kron_p.canonical_dq(dq)
        kron_p._require_main_path_dq(dq)
        momentum = momentum if 0.0 < momentum < 1.0 else 0.0
        if not whiten_grad and momentum == 0.0:
            raise ValueError("Cannot whiten momentum with momentum == 0")
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

        defaults = dict(
            lr=lr, weight_decay=weight_decay,
            weight_decay_mode=weight_decay_mode,
            lr_preconditioner=lr_preconditioner, betaL=betaL,
            damping=damping, grad_clip_max_amps=tuple(grad_clip_max_amps),
            preconditioner_update_probability=preconditioner_update_probability)
        super().__init__([{"params": tensors}], defaults)
        self.momentum = momentum
        self.init_scale = preconditioner_init_scale
        self.update_preconditioner_first = update_preconditioner_first
        self.whiten_grad = whiten_grad
        self.norm_k = norm_k
        self.draw = draw
        self.count = 0
        self.key = fastrand.prng_key(seed)
        self.fit_steps = 0   # steps on which Q was fitted
        self.plans = []
        for t, f in zip(tensors, self.scanned):
            shape = _squeezed_shape(t.shape[1:] if f else t.shape)
            self.plans.append(kron_p.make_kron_plan(
                shape, preconditioner_max_size, preconditioner_max_skew, dq))
        scale0 = 1.0 if preconditioner_init_scale is None \
            else preconditioner_init_scale
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

    def _fit(self, params, sources, k_fit, lr_q, beta_l, damping):
        for i, (p, src) in enumerate(zip(params, sources)):
            st = self.state[p]
            qdt = st["q"][0].dtype
            key = fastrand.fold_in(k_fit, i)
            kw = dict(lr=lr_q, beta_l=beta_l, damping=damping,
                      norm_k=resolve_norm_k(self.norm_k, qdt), draw=self.draw)
            state = kron_p.KronState(q=st["q"], lips=st["lips"])
            g = self._view(src, i).to(qdt)
            if self.scanned[i]:
                out = kron_p.update_kron_whiten_stacked(
                    state, self.plans[i], g, fastrand.split(key, g.shape[0]),
                    **kw)
            else:
                out = kron_p.update_kron_whiten(state, self.plans[i], g, key,
                                                **kw)
            st["q"], st["lips"] = out.q, out.lips

    def _apply(self, params, sources, clip_amps):
        out = []
        for i, (p, src) in enumerate(zip(params, sources)):
            st = self.state[p]
            state = kron_p.KronState(q=st["q"], lips=st["lips"])
            g = self._view(src, i).to(st["q"][0].dtype)
            if self.scanned[i]:
                pg = kron_p.precond_grad_stacked(state, self.plans[i], g)
            else:
                pg = kron_p.precond_grad(state, self.plans[i], g)
            pg = pg.to(p.dtype)
            pg = _amp_clip(pg, *clip_amps, stacked=self.scanned[i])
            out.append(pg.reshape(p.shape))
        return out

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
            scale = _whiten_scale_from_grads(grads, self.scanned, damping)
            for p, plan in zip(params, self.plans):
                st = self.state[p]
                eff = scale * scale if plan.fits_p else scale
                mult = eff ** (1.0 / max(plan.order, 1))
                st["q"] = tuple(q * mult.to(real_dtype_of(q.dtype))
                                for q in st["q"])

        if self.momentum > 0:
            beta = min(count / (count + 1.0), self.momentum)
            for p, g in zip(params, grads):
                mu = self.state[p]["mu"]
                b = _rounded(beta, mu.dtype)
                mu.mul_(b).add_(g.to(mu.dtype) * _rounded(1.0 - b, mu.dtype))
            mus = [self.state[p]["mu"] for p in params]
        fit_src = grads if self.whiten_grad else mus
        apply_src = mus if self.momentum > 0 else grads

        keys = fastrand.split(self.key, 3)
        self.key, k_gate, k_fit = keys[0], keys[1], keys[2]
        prob = group["preconditioner_update_probability"]
        if _static_always(prob):
            do_fit = True
        else:
            u = (float(fastrand.uniform01(k_gate)) if self.draw is None else
                 float(self.draw("uniform", k_gate[None], (), torch.float64)[0]))
            do_fit = u < _sched(prob, count)
        fit_args = (_sched(group["lr_preconditioner"], count),
                    _sched(group["betaL"], count), damping)
        clip = tuple(_sched(a, count) for a in group["grad_clip_max_amps"])

        if self.update_preconditioner_first:
            if do_fit:
                self._fit(params, fit_src, k_fit, *fit_args)
            updates = self._apply(params, apply_src, clip)
        else:
            updates = self._apply(params, apply_src, clip)
            if do_fit:
                self._fit(params, fit_src, k_fit, *fit_args)
        self.fit_steps += int(do_fit)

        lr = _sched(group["lr"], count)
        for p, u in zip(params, updates):
            if wd and group["weight_decay_mode"] == "decoupled":
                u = u + wd * p
            p.add_(u * (-lr))
        self.count += 1
        return loss


def kron_whiten(params, learning_rate: float | Callable = 1e-3,
                weight_decay: float = 0.0,
                weight_decay_mode: str = "decoupled", **kwargs) -> KronWhiten:
    """KronWhiten with the JAX factory's argument names."""
    return KronWhiten(params, lr=learning_rate, weight_decay=weight_decay,
                      weight_decay_mode=weight_decay_mode, **kwargs)

