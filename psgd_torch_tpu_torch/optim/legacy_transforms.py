"""The legacy preconditioner families as ``torch.optim.Optimizer`` classes.

Counterpart of psgd_torch_tpu/optim/legacy_transforms.py, whose optax
transforms package the reference's deprecated closure classes (LRA/UVd
:756, XMat :993, Newton :1216, Affine :1723 of
preconditioned_stochastic_gradient_descent.py), one per family:

* ``XMat``: Q = diag(a) + adiag(b) over the concatenated parameters
  (``precond.xmat``);
* ``SPLU``: the sparse LU with rank-r corners (``precond.splu``);
* ``NewtonInv``: dense Q on GL(n, R) with a Woodbury-kept inverse
  (``precond.legacy.update_newton_inv``);
* ``UVd``: the legacy LRA with the '1st'/'2nd' normalizers
  (``precond.legacy.update_uvd``);
* ``Affine``: one kron(Q2, Q1) per parameter viewed as a matrix by its
  ``matrixizer`` plan; whitening takes the drop-v update where the sides
  allow (``precond.affine``).

Each takes ``preconditioner_type`` "whitening" or "Newton".  A step splits
the key into (key, k_gate, k_v, k_fit) as the JAX transforms do and fits
on the first step and where uniform(k_gate) < the update probability (a
host decision).  Whitening fits from the damped pair (v, g + damping
mean|g| v) of the gradient (``.grad``), v standard normal from k_v.
Newton fits from (v, H v), v standard normal per parameter from
split(k_v, n): through ``step(closure)`` (the closure returns the loss
without calling backward; a fit step takes the gradient and H v in one
double backward, ``optim.hvp.hvp_exact``, another step one plain
backward), ``step(hvp_fn=...)`` (``hvp_fn(vs) -> hvs``, the gradients from
``.grad``) or ``step(vs=, hvs=)`` (fits every step).  Without
``preconditioner_init_scale`` the preconditioner is scaled on the first
fit: whitening by mean(g^4)^(-1/8), Newton by mean(v^2)^(1/4)
mean(h^4)^(-1/8) (of the concatenated vector; Affine: the largest leaf's
mean of the fourth powers, each side by the square root).  Then the
bias-warmed momentum, P applied (to the momentum, or the gradient), the
global-norm trust region ``grad_clip_max_norm``, weight decay
(``weight_decay_mode``, as the other optimizers) and -lr.

Parameters are taken in the JAX pytree order (``transforms._pytree_order``:
a list as given, named parameters by their sorted dotted path), so the
concatenated vector is JAX ``ravel_pytree``'s, which XMat's anti-diagonal
pairing depends on.  Draws: a standard normal is ``torch.randn`` from a
``torch.Generator`` seeded by its key (``ops.fastrand.generator``), a
uniform is ``fastrand.uniform01`` of its key; ``draw(kind, keys, shape,
dtype)`` replaces both (the CPU tests replay the JAX draws).  No kernel of
``ops.kernels`` runs: the families' work is products, solves and
elementwise passes in PyTorch, as the JAX package's is outside any Pallas
kernel.  The whole state goes through ``state_dict()``.  Real and
complex (complex64, complex128) parameters and preconditioners alike, in
the JAX package's forms: XMat, SPLU, NewtonInv and UVd transpose where a
Hermitian preconditioner conjugates, Affine conjugates; a complex value
cast to a real dtype keeps its real part, as JAX's ``astype`` does (the
on-the-fly init scale reads the real parts).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import resolve_device
from ..ops import fastrand
from ..ops.linalg import damped_pair_vg
from ..precond import affine as affine_p
from ..precond import legacy as legacy_p
from ..precond import splu as splu_p
from ..precond import xmat as xmat_p
from . import hvp
from .transforms import (_Flat, _Resumable, _cast, _classic_decay, _descend,
                         _ema_, _global_norm_scale, _host_gate, _pytree_order,
                         _sched)


def _default_lr_precond(lr, step_normalizer: str):
    """The reference legacy classes' default lr_preconditioner: 0.1 for the
    '2nd' normalizer, 0.01 for '1st' (preconditioned...py:803-808)."""
    if lr is not None:
        return lr
    return 0.1 if step_normalizer == "2nd" else 0.01


def _normal(key, shape, dtype, device, draw) -> torch.Tensor:
    """A standard normal draw from one host key (or the replayed one)."""
    if draw is not None:
        return draw("normal", fastrand.as_keys(key)[None], shape,
                    dtype)[0].to(device)
    return torch.randn(shape, dtype=dtype, device=device,
                       generator=fastrand.generator(key, device))


def _uniform(key, draw) -> float:
    """uniform(key) on the host (or the replayed one)."""
    if draw is None:
        return float(fastrand.uniform01(key))
    return float(draw("uniform", fastrand.as_keys(key)[None], (),
                      torch.float64)[0])


def _f32_mean(x: torch.Tensor, power: int) -> torch.Tensor:
    """mean |x|^power in float32, of a complex x its real part's."""
    return torch.mean(torch.abs(_cast(x, torch.float32)) ** power)


class _Legacy:
    """The step the legacy optimizers share (JAX ``_vector_family``'s and
    ``scale_by_affine``'s update): the key chain and the gate, the fit's
    pair, then ``_apply`` (momentum, P, the norm clip), weight decay and
    -lr.  A subclass gives ``_fit(grads, vs, hvs, k_v, k_fit, count)``
    and ``_apply(grads, count) -> clipped updates``."""

    def _legacy_options(self, preconditioner_type: str, step_normalizer: str):
        if preconditioner_type not in ("whitening", "Newton"):
            raise ValueError(f"unknown preconditioner_type {preconditioner_type!r}")
        if step_normalizer not in ("1st", "2nd"):
            raise ValueError(f"unknown step_normalizer {step_normalizer!r}")
        self.newton = preconditioner_type == "Newton"
        self.step_normalizer = step_normalizer

    def _probes(self, k_v, params) -> list:
        """The Newton probes: a standard normal per parameter from
        split(k_v, n) (JAX ``rand_like_tree``)."""
        keys = fastrand.split(k_v, len(params))
        return [_normal(k, p.shape, p.dtype, p.device, self.draw)
                for k, p in zip(keys, params)]

    @torch.no_grad()
    def step(self, closure=None, *, hvp_fn=None, vs=None, hvs=None):
        """One step.  Whitening: the gradients from ``.grad`` (``closure``,
        if given, runs first under autograd and returns the loss).  Newton:
        ``closure`` alone returns the loss without calling backward and the
        step runs autograd itself; with ``hvp_fn`` (vs -> hvs, called under
        ``torch.no_grad``: it enables autograd itself) or explicit ``vs``
        and ``hvs`` the gradients come from ``.grad`` and ``closure``, if
        given, only returns the loss."""
        name = type(self).__name__
        explicit = vs is not None or hvs is not None
        if explicit and (vs is None or hvs is None):
            raise ValueError(f"{name}.step takes vs and hvs together")
        if not self.newton and (explicit or hvp_fn is not None):
            raise ValueError(f"{name} whitening takes no hvp_fn, vs or hvs")
        own_pass = self.newton and hvp_fn is None and not explicit
        if own_pass and closure is None:
            raise ValueError(f"{name} Newton needs a closure that returns the "
                             "loss (without calling backward), hvp_fn or "
                             "(vs, hvs)")
        group = self.param_groups[0]
        params = group["params"]
        count = self.count
        keys = fastrand.split(self.key, 4)
        self.key, k_gate, k_v, k_fit = keys[0], keys[1], keys[2], keys[3]
        do_fit = explicit or _host_gate(
            group["preconditioner_update_probability"], k_gate, count,
            self.draw) or count == 0
        loss = None
        if own_pass:
            losses = []

            def loss_fn():
                losses.append(closure())
                return losses[-1]

            if do_fit:
                vs = self._probes(k_v, params)
                grads, hvs = hvp.hvp_exact(loss_fn, params, vs)
            else:
                with torch.enable_grad():
                    grads = hvp.gradients(loss_fn(), params)
            loss = losses[0]
        else:
            if closure is not None:
                with torch.enable_grad():
                    loss = closure()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            if self.newton and do_fit and hvp_fn is not None:
                vs = self._probes(k_v, params)
                hvs = hvp_fn(vs)
        grads = _classic_decay(group, grads, params)
        if do_fit:
            self._fit(grads, vs, hvs, k_v, k_fit, count)
        self.fit_steps += int(do_fit)
        _descend(group, params, self._apply(grads, count), count)
        self.count += 1
        return loss


class _LegacyFlat(_Legacy, _Flat):
    """A family over the concatenated parameter vector (JAX
    ``_vector_family``, whose ``scale_by`` arguments it takes, with
    ``device`` and ``draw``): ``_Flat``'s vector, momentum and state, the
    state a NamedTuple in ``self.precond`` made by ``_init`` at scale 1 and
    scaled by ``_rescaled`` (Q -> m Q)."""

    def __init__(self, params, lr: float | Callable = 0.01,
                 weight_decay: float = 0.0,
                 weight_decay_mode: str = "decoupled", *,
                 preconditioner_type: str = "whitening",
                 preconditioner_init_scale: Optional[float] = None,
                 lr_preconditioner: Optional[float | Callable] = None,
                 step_normalizer: str = "2nd",
                 momentum: float = 0.0,
                 momentum_dtype: Optional[torch.dtype] = None,
                 grad_clip_max_norm: float | Callable = float("inf"),
                 preconditioner_update_probability: float | Callable = 1.0,
                 damping: float | Callable = 2.0 ** -13,
                 preconditioner_dtype: Optional[torch.dtype] = None,
                 seed: int = 0,
                 device=None,
                 draw=None):
        self._legacy_options(preconditioner_type, step_normalizer)
        params = list(params)
        defaults = dict(
            lr=lr, weight_decay=weight_decay,
            weight_decay_mode=weight_decay_mode,
            lr_preconditioner=_default_lr_precond(lr_preconditioner,
                                                  step_normalizer),
            damping=damping, grad_clip_max_norm=grad_clip_max_norm,
            preconditioner_update_probability=preconditioner_update_probability)
        super().__init__(params, defaults, init_scale=preconditioner_init_scale,
                         momentum=momentum if 0.0 < momentum < 1.0 else 0.0,
                         momentum_dtype=momentum_dtype,
                         preconditioner_dtype=preconditioner_dtype, seed=seed,
                         device=device, draw=draw, vector_sharding=None)
        st = self._init(fastrand.prng_key(seed + 1))
        if preconditioner_init_scale is not None:
            # JAX scales the unit state by the init scale as a float32
            st = self._rescaled(st, torch.tensor(preconditioner_init_scale,
                                                 dtype=torch.float32))
        self.precond = st

    def _init(self, key):
        raise NotImplementedError

    def _rescaled(self, st, mult: torch.Tensor):
        raise NotImplementedError

    def _update(self, st, v, h, key, lr_q):
        raise NotImplementedError

    def _precond_grad(self, st, g):
        raise NotImplementedError

    def _fit(self, grads, vs, hvs, k_v, k_fit, count) -> None:
        group = self.param_groups[0]
        st, qdt = self.precond, self.qdtype
        first = self.init_scale is None and count == 0
        if self.newton:
            v, h = self._flat(vs), self._flat(hvs)
            if first:
                st = self._rescaled(st, _f32_mean(v, 2) ** 0.25
                                    * _f32_mean(h, 4) ** (-1.0 / 8.0))
            v, h = _cast(v, qdt), _cast(h, qdt)
        else:
            g = self._flat(grads)
            if first:
                st = self._rescaled(st, _f32_mean(g, 4) ** (-1.0 / 8.0))
            v, h = damped_pair_vg(_cast(g, qdt), _sched(group["damping"], count),
                                  v=_normal(k_v, g.shape, qdt, self.device,
                                            self.draw))
        self.precond = self._update(st, v, h, k_fit,
                                    _sched(group["lr_preconditioner"], count))

    def _apply(self, grads, count) -> list:
        g = self._flat(grads)
        src = self._source(g, count)
        pre = _cast(self._precond_grad(self.precond, _cast(src, self.qdtype)),
                    g.dtype)
        pre = pre * _global_norm_scale(
            [pre], _sched(self.param_groups[0]["grad_clip_max_norm"], count))
        return self._split(pre)


def _mult(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return m.to(device=x.device, dtype=x.dtype)


class XMat(_LegacyFlat):
    """The X-matrix preconditioner Q = diag(a) + adiag(b) over all
    parameters concatenated (reference class XMat, :993-1161; JAX
    ``xmat``).  Arguments as JAX ``scale_by_xmat`` plus ``device`` and
    ``draw``."""

    def _init(self, key):
        return xmat_p.init_xmat(self.n, 1.0, self.qdtype, self.device)

    def _rescaled(self, st, mult):
        return xmat_p.XMatState(a=st.a * _mult(mult, st.a),
                                b=st.b * _mult(mult, st.b))

    def _update(self, st, v, h, key, lr_q):
        return xmat_p.update_xmat(st, v, h, lr=lr_q,
                                  step_normalizer=self.step_normalizer)

    def _precond_grad(self, st, g):
        return xmat_p.precond_grad_xmat(st, g)


class SPLU(_LegacyFlat):
    """The sparse-LU preconditioner with rank-``rank`` corners (clamped to
    [1, n - 1]) over all parameters concatenated (reference :481-617; JAX
    ``splu``).  SPLU has no step-normalizer choice: ``step_normalizer``
    only sets the default lr_preconditioner."""

    def __init__(self, params, lr: float | Callable = 0.01,
                 weight_decay: float = 0.0,
                 weight_decay_mode: str = "decoupled", *, rank: int = 10,
                 **kwargs):
        self.rank = rank
        super().__init__(params, lr, weight_decay, weight_decay_mode, **kwargs)

    def _init(self, key):
        return splu_p.init_splu(self.n, max(1, min(self.rank, self.n - 1)), 1.0,
                                self.qdtype, self.device)

    def _rescaled(self, st, mult):
        # Q = L U: the scale split between the two factors
        root = torch.sqrt(mult)
        return splu_p.SPLUState(*(x * _mult(root, x) for x in st))

    def _update(self, st, v, h, key, lr_q):
        return splu_p.update_splu(st, v, h, lr=lr_q)

    def _precond_grad(self, st, g):
        return splu_p.precond_grad_splu(st, g)


class NewtonInv(_LegacyFlat):
    """Dense Q on GL(n, R) with inv(Q) kept by rank-2 Woodbury updates over
    all parameters concatenated (reference keep_invQ path, :1171-1213;
    JAX ``newton_inv``)."""

    def _init(self, key):
        return legacy_p.init_newton_inv(self.n, 1.0, self.qdtype, self.device)

    def _rescaled(self, st, mult):
        return legacy_p.NewtonInvState(q=st.q * _mult(mult, st.q),
                                       inv_q=st.inv_q / _mult(mult, st.inv_q))

    def _update(self, st, v, h, key, lr_q):
        return legacy_p.update_newton_inv(st, v, h, lr=lr_q,
                                          step_normalizer=self.step_normalizer)

    def _precond_grad(self, st, g):
        return legacy_p.precond_grad_newton_inv(st, g)


class UVd(_LegacyFlat):
    """The legacy LRA Q = (I + U V^T) diag(d) of rank ``rank`` over all
    parameters concatenated (reference class LRA/UVd, :635-942; JAX
    ``uvd``).  U and V are drawn from split(key(seed + 1)); a fit's
    balance and U-or-V coin are uniform(kb), uniform(kc), (kb, kc) =
    split(k_fit)."""

    def __init__(self, params, lr: float | Callable = 0.01,
                 weight_decay: float = 0.0,
                 weight_decay_mode: str = "decoupled", *, rank: int = 10,
                 **kwargs):
        self.rank = rank
        super().__init__(params, lr, weight_decay, weight_decay_mode, **kwargs)

    def _init(self, key):
        ku, kv = fastrand.split(key)
        shape = (self.n, self.rank)
        return legacy_p.init_uvd(
            self.n, self.rank, 1.0, self.qdtype, self.device,
            u=_normal(ku, shape, self.qdtype, self.device, self.draw),
            v=_normal(kv, shape, self.qdtype, self.device, self.draw))

    def _rescaled(self, st, mult):
        # the reference scales d only (preconditioned...py:879-881)
        return st._replace(d=st.d * _mult(mult, st.d))

    def _update(self, st, v, h, key, lr_q):
        kb, kc = fastrand.split(key)
        return legacy_p.update_uvd(st, v, h, u_balance=_uniform(kb, self.draw),
                                   u_coin=_uniform(kc, self.draw), lr=lr_q,
                                   step_normalizer=self.step_normalizer)

    def _precond_grad(self, st, g):
        return legacy_p.precond_grad_uvd(st, g)


class Affine(_Legacy, _Resumable):
    """One affine preconditioner kron(Q2, Q1) per parameter, viewed as a
    matrix by its ``matrixizer`` plan (reference class Affine, :1723-1899;
    JAX ``affine``).  Each side is upper triangular, or diagonal when it is
    below 2, above ``preconditioner_max_size`` or above
    ``preconditioner_max_skew`` times the other side.  Whitening fits each
    leaf by ``update_affine_dropv`` (v integrated out where the sides
    allow), Newton by ``update_affine``, leaf i keyed by fold_in(k_fit, i).
    The state per parameter: ``ql``, ``qr`` and ``momentum``."""

    def __init__(self, params, lr: float | Callable = 0.01,
                 weight_decay: float = 0.0,
                 weight_decay_mode: str = "decoupled", *,
                 preconditioner_type: str = "whitening",
                 preconditioner_init_scale: Optional[float] = None,
                 lr_preconditioner: Optional[float | Callable] = None,
                 step_normalizer: str = "2nd",
                 momentum: float = 0.0,
                 momentum_dtype: Optional[torch.dtype] = None,
                 grad_clip_max_norm: float | Callable = float("inf"),
                 preconditioner_update_probability: float | Callable = 1.0,
                 preconditioner_max_size: float = float("inf"),
                 preconditioner_max_skew: float = float("inf"),
                 preconditioner_dtype: Optional[torch.dtype] = None,
                 seed: int = 0,
                 device=None,
                 draw=None):
        self._legacy_options(preconditioner_type, step_normalizer)
        if weight_decay_mode not in ("decoupled", "classic"):
            raise ValueError(f"unknown weight_decay_mode {weight_decay_mode!r}")
        self.device = resolve_device(device)
        _, tensors, _ = _pytree_order(params)
        for t in tensors:
            if t.device != self.device:
                raise ValueError(f"parameter on {t.device}, optimizer on "
                                 f"{self.device}")
        defaults = dict(
            lr=lr, weight_decay=weight_decay,
            weight_decay_mode=weight_decay_mode,
            lr_preconditioner=_default_lr_precond(lr_preconditioner,
                                                  step_normalizer),
            grad_clip_max_norm=grad_clip_max_norm,
            preconditioner_update_probability=preconditioner_update_probability)
        super().__init__([{"params": tensors}], defaults)
        self.momentum = momentum if 0.0 < momentum < 1.0 else 0.0
        self.init_scale = preconditioner_init_scale
        self.draw = draw
        self.count = 0
        self.key = fastrand.prng_key(seed)
        self.fit_steps = 0
        self.plans = [affine_p.matrixizer(t.shape) for t in tensors]
        for p, plan in zip(tensors, self.plans):
            st = affine_p.init_affine(
                plan.matrix_shape, 1.0 if preconditioner_init_scale is None
                else preconditioner_init_scale, preconditioner_max_size,
                preconditioner_max_skew, preconditioner_dtype or p.dtype,
                self.device)
            self.state[p]["ql"], self.state[p]["qr"] = st
            if self.momentum > 0:
                self.state[p]["momentum"] = torch.zeros(
                    p.shape, dtype=momentum_dtype or p.dtype, device=self.device)

    def _layout(self) -> dict:
        return {"optimizer": "Affine",
                "shapes": [list(p.shape) for p in self.param_groups[0]["params"]],
                "plans": [[list(pl.perm), list(pl.matrix_shape)]
                          for pl in self.plans]}

    def _states(self, params) -> list:
        return [affine_p.AffineState(self.state[p]["ql"], self.state[p]["qr"])
                for p in params]

    def _fit(self, grads, vs, hvs, k_v, k_fit, count) -> None:
        params = self.param_groups[0]["params"]
        states = self._states(params)
        if self.init_scale is None and count == 0:
            if self.newton:
                numel = sum(v.numel() for v in vs)
                v2 = sum(torch.sum(torch.abs(_cast(v, torch.float32)) ** 2)
                         for v in vs) / numel
                scale = v2 ** 0.25 * torch.amax(torch.stack(
                    [_f32_mean(h, 4) for h in hvs])) ** (-1.0 / 8.0)
            else:
                scale = torch.amax(torch.stack(
                    [_f32_mean(g, 4) for g in grads])) ** (-1.0 / 8.0)
            root = torch.sqrt(scale)
            states = [affine_p.AffineState(st.ql * _mult(root, st.ql),
                                           st.qr * _mult(root, st.qr))
                      for st in states]
        kw = dict(lr=_sched(self.param_groups[0]["lr_preconditioner"], count),
                  step_normalizer=self.step_normalizer)
        for i, (p, st, plan) in enumerate(zip(params, states, self.plans)):
            qdt = st.ql.dtype
            key = fastrand.fold_in(k_fit, i)
            if self.newton:
                st = affine_p.update_affine(
                    st, _cast(affine_p.to_matrix(plan, vs[i]), qdt),
                    _cast(affine_p.to_matrix(plan, hvs[i]), qdt),
                    u_balance=_uniform(key, self.draw), **kw)
            else:
                kb, kv = fastrand.split(key)
                gm = _cast(affine_p.to_matrix(plan, grads[i]), qdt)
                v = None if affine_p.dropv_branch(st) else _normal(
                    kv, gm.shape, qdt, self.device, self.draw)
                st = affine_p.update_affine_dropv(
                    st, gm, u_balance=_uniform(kb, self.draw), v=v, **kw)
            self.state[p]["ql"], self.state[p]["qr"] = st

    def _apply(self, grads, count) -> list:
        params = self.param_groups[0]["params"]
        pre = []
        for p, g, st, plan in zip(params, grads, self._states(params), self.plans):
            src = g if self.momentum == 0 else _ema_(
                self.state[p]["momentum"], g, count, self.momentum)
            pg = affine_p.precond_grad_affine(
                st, _cast(affine_p.to_matrix(plan, src), st.ql.dtype))
            pre.append(_cast(affine_p.from_matrix(plan, pg), g.dtype).reshape(g.shape))
        scale = _global_norm_scale(
            pre, _sched(self.param_groups[0]["grad_clip_max_norm"], count))
        return [u * scale for u in pre]


def _factory(cls, name: str):
    def make(params, learning_rate: float | Callable = 0.01,
             weight_decay: float = 0.0, weight_decay_mode: str = "decoupled",
             **kwargs):
        return cls(params, lr=learning_rate, weight_decay=weight_decay,
                   weight_decay_mode=weight_decay_mode, **kwargs)
    make.__name__ = make.__qualname__ = name
    make.__doc__ = f"{cls.__name__} with the JAX factory's argument names."
    return make


xmat = _factory(XMat, "xmat")
splu = _factory(SPLU, "splu")
newton_inv = _factory(NewtonInv, "newton_inv")
uvd = _factory(UVd, "uvd")
affine = _factory(Affine, "affine")
