"""The reference's five optimizer classes, with its argument names and its
closure contract.

Counterpart of psgd_torch_tpu/optim/classes.py (reference psgd.py:
KronWhiten:516, KronNewton:832, LRAWhiten:1075, LRANewton:1201,
DenseNewton:1427).  Each class wraps the port's optimizer of the same
family (``optim.transforms``, reachable as ``.optimizer``) and takes the
reference's names (``lr_params``, ``dQ``; the rest as the optimizer's):

    opt = DenseNewton(params, lr_params=1.0, lr_preconditioner=0.5,
                      momentum=0.9, device="cpu")
    for _ in range(steps):
        loss = opt.step(lambda: rosenbrock(params[0]))

``state_dict()`` and ``load_state_dict()`` are the wrapped optimizer's, so a
class checkpoints and resumes as its optimizer does.

``step(closure)`` runs autograd itself and updates the parameters in
place: the closure computes the loss and calls no backward.  The
whitening classes take the gradient of the closure's loss; the Newton
classes hand the closure to their optimizer, which takes the gradient and,
on a fit step, the Hessian-vector products.  ``.grad`` is not touched.
With ``has_aux=True`` the closure returns ``(loss, aux)``, loss first
(psgd.py:594-596).  ``step`` returns what the closure returned (the first
call's, where the finite-difference Hvp calls it twice).

Every hyperparameter that a step reads is mutable: assigning it (for
example ``opt.lr_params = 0.1`` or ``opt.grad_clip_max_amps = (1.0, 1.0)``)
takes effect on the next step, with no rebuild.  Those that fix the
state's structure (rank, dtype, ``dQ``, plans, seed, the Kron options;
switching momentum on or off) raise ``ValueError`` on assignment: they
need a fresh optimizer, as the JAX classes document.  Further keyword
arguments (``device``, ``draw``, ``momentum_dtype``, ``shared_layers``,
...) go to the optimizer as they are.
"""

from __future__ import annotations

import torch

from . import hvp
from . import transforms as T

# reference name -> the optimizer's param-group key (read every step)
_GROUP = {"lr_params": "lr", "lr_preconditioner": "lr_preconditioner",
          "betaL": "betaL", "damping": "damping",
          "grad_clip_max_amps": "grad_clip_max_amps",
          "grad_clip_max_norm": "grad_clip_max_norm",
          "preconditioner_update_probability":
              "preconditioner_update_probability"}
# reference name -> the optimizer's attribute (read every step)
_ATTR = {"momentum": "momentum", "preconditioner_init_scale": "init_scale",
         "update_preconditioner_first": "update_preconditioner_first",
         "whiten_grad": "whiten_grad",
         "exact_hessian_vector_product": "exact_hvp", "norm_k": "norm_k"}
# reference name -> the optimizer's keyword
_KEYWORD = {"lr_params": "lr", "dQ": "dq"}


class _ClosureOptimizer:
    """Shared machinery: the wrapped optimizer, the hyperparameter names,
    and ``step(closure, has_aux)``."""

    _OPT: type
    _NEWTON = False

    def __init__(self, params, options: dict, **kwargs):
        object.__setattr__(self, "_hyper", dict(kwargs))
        object.__setattr__(self, "optimizer", self._OPT(
            params, **{_KEYWORD.get(k, k): v for k, v in kwargs.items()},
            **options))

    def _where(self, name):
        """(kind, key) of a mutable hyperparameter, else None."""
        if name in _GROUP and _GROUP[name] in self.optimizer.param_groups[0]:
            return "group", _GROUP[name]
        if name in _ATTR and hasattr(self.optimizer, _ATTR[name]):
            return "attr", _ATTR[name]
        return None

    def __getattr__(self, name):
        hyper = self.__dict__.get("_hyper", {})
        if name not in hyper:
            raise AttributeError(name)
        where = self._where(name)
        if where is None:
            return hyper[name]
        kind, key = where
        if kind == "group":
            return self.optimizer.param_groups[0][key]
        return getattr(self.optimizer, key)

    def __setattr__(self, name, value):
        if name not in self._hyper:
            object.__setattr__(self, name, value)
            return
        where = self._where(name)
        if where is None:
            raise ValueError(
                f"{name} fixes the optimizer's state; construct a fresh "
                f"{type(self).__name__} to change it")
        kind, key = where
        if kind == "group":
            if name == "grad_clip_max_amps":
                value = tuple(value)
            self.optimizer.param_groups[0][key] = value
        else:
            setattr(self.optimizer, key, self._checked(name, value))
        self._hyper[name] = value

    def _checked(self, name, value):
        """An attribute's new value, refused where it would change the
        state's structure or break the optimizer's own rules."""
        opt = self.optimizer
        if name == "momentum":
            value = value if 0.0 < value < 1.0 else 0.0
            if (value > 0) != (opt.momentum > 0):
                raise ValueError("switching momentum on or off changes the "
                                 "state; construct a fresh optimizer")
        if name in ("update_preconditioner_first", "whiten_grad") and (
                getattr(opt, "share_fit_apply", False)
                or getattr(opt, "pipelined_fit", False)):
            raise ValueError(f"{name} is fixed by share_fit_apply / "
                             "pipelined_fit")
        if name == "whiten_grad" and not value and opt.momentum == 0.0:
            raise ValueError("Cannot whiten momentum with momentum == 0")
        return value

    def state_dict(self) -> dict:
        """The wrapped optimizer's ``state_dict`` (its whole state)."""
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict: dict) -> None:
        """The wrapped optimizer's ``load_state_dict``."""
        self.optimizer.load_state_dict(state_dict)

    def step(self, closure, has_aux: bool = False):
        """One step; returns what the closure returned."""
        outs = []

        def loss_fn():
            outs.append(closure())
            return outs[-1][0] if has_aux else outs[-1]

        if self._NEWTON:
            self.optimizer.step(loss_fn)
        else:
            params = self.optimizer.param_groups[0]["params"]
            with torch.enable_grad():
                grads = hvp.gradients(loss_fn(), params)
            with torch.no_grad():
                self.optimizer._step(grads)
        return outs[0]


class KronWhiten(_ClosureOptimizer):
    """Reference KronWhiten (psgd.py:516-654) over ``optim.KronWhiten``."""

    _OPT = T.KronWhiten

    def __init__(self, params, preconditioner_max_size=float("inf"),
                 preconditioner_max_skew=1.0, preconditioner_init_scale=None,
                 lr_params=0.001, lr_preconditioner=0.1, betaL=0.9,
                 damping=1e-9, momentum=0.0, grad_clip_max_amps=(2.0, 10.0),
                 preconditioner_update_probability=1.0,
                 update_preconditioner_first=True, whiten_grad=True,
                 dQ="Q0.5EQ1.5", preconditioner_dtype=None, norm_k=None,
                 seed=0, scanned_layers=None, share_fit_apply=False,
                 cache_p=False, **options):
        super().__init__(
            params, options, preconditioner_max_size=preconditioner_max_size,
            preconditioner_max_skew=preconditioner_max_skew,
            preconditioner_init_scale=preconditioner_init_scale,
            lr_params=lr_params, lr_preconditioner=lr_preconditioner,
            betaL=betaL, damping=damping, momentum=momentum,
            grad_clip_max_amps=grad_clip_max_amps,
            preconditioner_update_probability=preconditioner_update_probability,
            update_preconditioner_first=update_preconditioner_first,
            whiten_grad=whiten_grad, dQ=dQ,
            preconditioner_dtype=preconditioner_dtype, norm_k=norm_k,
            seed=seed, scanned_layers=scanned_layers,
            share_fit_apply=share_fit_apply, cache_p=cache_p)


class KronNewton(_ClosureOptimizer):
    """Reference KronNewton (psgd.py:832-978) over ``optim.KronNewton``."""

    _OPT = T.KronNewton
    _NEWTON = True

    def __init__(self, params, preconditioner_max_size=float("inf"),
                 preconditioner_max_skew=1.0, preconditioner_init_scale=None,
                 lr_params=0.01, lr_preconditioner=0.1, betaL=0.9,
                 damping=1e-9, momentum=0.0, grad_clip_max_norm=float("inf"),
                 preconditioner_update_probability=1.0,
                 exact_hessian_vector_product=True, dQ="Q0.5EQ1.5",
                 preconditioner_dtype=None, norm_k=None, seed=0,
                 scanned_layers=None, cache_p=False, **options):
        super().__init__(
            params, options, preconditioner_max_size=preconditioner_max_size,
            preconditioner_max_skew=preconditioner_max_skew,
            preconditioner_init_scale=preconditioner_init_scale,
            lr_params=lr_params, lr_preconditioner=lr_preconditioner,
            betaL=betaL, damping=damping, momentum=momentum,
            grad_clip_max_norm=grad_clip_max_norm,
            preconditioner_update_probability=preconditioner_update_probability,
            exact_hessian_vector_product=exact_hessian_vector_product, dQ=dQ,
            preconditioner_dtype=preconditioner_dtype, norm_k=norm_k,
            seed=seed, scanned_layers=scanned_layers, cache_p=cache_p)


class LRAWhiten(_ClosureOptimizer):
    """Reference LRAWhiten (psgd.py:1075-1190) over ``optim.LRAWhiten``."""

    _OPT = T.LRAWhiten

    def __init__(self, params, rank_of_approximation=10,
                 preconditioner_init_scale=None, lr_params=0.001,
                 lr_preconditioner=0.1, betaL=0.9, damping=1e-9, momentum=0.0,
                 grad_clip_max_amps=(2.0, 10.0),
                 preconditioner_update_probability=1.0,
                 update_preconditioner_first=True, whiten_grad=True,
                 preconditioner_dtype=None, seed=0, **options):
        super().__init__(
            params, options, rank_of_approximation=rank_of_approximation,
            preconditioner_init_scale=preconditioner_init_scale,
            lr_params=lr_params, lr_preconditioner=lr_preconditioner,
            betaL=betaL, damping=damping, momentum=momentum,
            grad_clip_max_amps=grad_clip_max_amps,
            preconditioner_update_probability=preconditioner_update_probability,
            update_preconditioner_first=update_preconditioner_first,
            whiten_grad=whiten_grad, preconditioner_dtype=preconditioner_dtype,
            seed=seed)


class LRANewton(_ClosureOptimizer):
    """Reference LRANewton (psgd.py:1201-1330) over ``optim.LRANewton``."""

    _OPT = T.LRANewton
    _NEWTON = True

    def __init__(self, params, rank_of_approximation=10,
                 preconditioner_init_scale=None, lr_params=0.01,
                 lr_preconditioner=0.1, betaL=0.9, damping=1e-9, momentum=0.0,
                 grad_clip_max_norm=float("inf"),
                 preconditioner_update_probability=1.0,
                 exact_hessian_vector_product=True,
                 preconditioner_dtype=None, seed=0, **options):
        super().__init__(
            params, options, rank_of_approximation=rank_of_approximation,
            preconditioner_init_scale=preconditioner_init_scale,
            lr_params=lr_params, lr_preconditioner=lr_preconditioner,
            betaL=betaL, damping=damping, momentum=momentum,
            grad_clip_max_norm=grad_clip_max_norm,
            preconditioner_update_probability=preconditioner_update_probability,
            exact_hessian_vector_product=exact_hessian_vector_product,
            preconditioner_dtype=preconditioner_dtype, seed=seed)


class DenseNewton(_ClosureOptimizer):
    """Reference DenseNewton (psgd.py:1427-1563) over
    ``optim.DenseNewton``."""

    _OPT = T.DenseNewton
    _NEWTON = True

    def __init__(self, params, preconditioner_init_scale=None, lr_params=0.01,
                 lr_preconditioner=0.1, betaL=0.9, damping=1e-9, momentum=0.0,
                 grad_clip_max_norm=float("inf"),
                 preconditioner_update_probability=1.0,
                 exact_hessian_vector_product=True, dQ="Q0.5EQ1.5",
                 preconditioner_dtype=None, norm_k=None, seed=0, **options):
        super().__init__(
            params, options, preconditioner_init_scale=preconditioner_init_scale,
            lr_params=lr_params, lr_preconditioner=lr_preconditioner,
            betaL=betaL, damping=damping, momentum=momentum,
            grad_clip_max_norm=grad_clip_max_norm,
            preconditioner_update_probability=preconditioner_update_probability,
            exact_hessian_vector_product=exact_hessian_vector_product, dQ=dQ,
            preconditioner_dtype=preconditioner_dtype, norm_k=norm_k,
            seed=seed)
