"""The reference-named closure classes (psgd_torch_tpu_torch.optim.classes)
against the JAX package's (psgd_torch_tpu.optim.classes): three steps of
each of the five classes on the small tensor-rank problem in float64 on
replayed draws (``jax_draw``), with hyperparameters assigned between
steps on both sides; the DenseNewton class on the coupled Rosenbrock
function (tests/test_classes.py); the LRA classes' descent; ``has_aux``;
assignment rules.

Tolerance: rtol 1e-9 (atol 1e-9 of the largest entry) in float64, but
for the whitening classes, whose amplitude clip takes its RMS in float32
on both sides, summed in another order (CLIP_RTOL = 1e-6, as in
test_torch_lra_dense_optim.py)."""

import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_torch_tpu.optim import classes as jclasses
from psgd_torch_tpu_torch.optim import classes
from test_torch_kron import jax_draw, to_np
from test_torch_lra_dense_optim import jax_loss, problem, torch_loss

RTOL = 1e-9
CLIP_RTOL = 1e-6
STEPS = 3

# class -> (constructor kwargs, hyperparameters assigned after step 1, rtol).
# lr_params are powers of 2: the JAX classes pass lr_params to their step
# in float32, so other values would differ from the port's by that rounding
ARMS = {
    "KronWhiten": (dict(lr_params=2 ** -4, preconditioner_init_scale=1.0,
                        momentum=0.9, grad_clip_max_amps=(1.0, 2.0)),
                   dict(lr_preconditioner=0.3, grad_clip_max_amps=(0.5, 1.0)),
                   CLIP_RTOL),
    "KronNewton": (dict(lr_params=2 ** -4, preconditioner_init_scale=1.0,
                        grad_clip_max_norm=10.0, dQ="QEQ"),
                   dict(lr_params=2 ** -5, betaL=0.5), RTOL),
    "LRAWhiten": (dict(lr_params=2 ** -4, rank_of_approximation=3,
                       preconditioner_init_scale=1.0,
                       grad_clip_max_amps=(0.5, 1.0)),
                  dict(lr_preconditioner=0.2, damping=1e-3), CLIP_RTOL),
    "LRANewton": (dict(lr_params=2 ** -4, rank_of_approximation=4,
                       momentum=0.9, grad_clip_max_norm=10.0),
                  dict(lr_params=2 ** -3, momentum=0.5), RTOL),
    "DenseNewton": (dict(lr_params=2 ** -4, lr_preconditioner=0.5,
                         momentum=0.9, grad_clip_max_norm=10.0),
                    dict(lr_preconditioner=0.2, damping=1e-3), RTOL),
}


def close(got, ref, rtol, what):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(to_np(got), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max(), err_msg=what)


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """STEPS steps of the JAX class, the ARMS assignments after step 1:
    (losses, final params)."""
    kw, later, _ = ARMS[name]
    target, init = problem()
    loss = jax_loss(jnp.asarray(target))
    params = [jnp.asarray(x) for x in init]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = getattr(jclasses, name)(params, **kw)
        losses = []
        for i in range(STEPS):
            if i == 1:
                for k, v in later.items():
                    setattr(opt, k, v)
            out, params = opt.step(loss, params)
            losses.append(float(out))
    return losses, params


@pytest.mark.parametrize("name", sorted(ARMS))
def test_class_three_steps_match_jax(name):
    """Each class against the JAX class of its name, the same
    hyperparameters assigned after the first step on both sides."""
    kw, later, rtol = ARMS[name]
    jlosses, jparams = jax_run(name)
    target, init = problem()
    target = torch.from_numpy(target)
    params = [torch.from_numpy(x).requires_grad_() for x in init]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = getattr(classes, name)(params, device="cpu", draw=jax_draw, **kw)
    losses = []
    for i in range(STEPS):
        if i == 1:
            for k, v in later.items():
                setattr(opt, k, v)
        losses.append(opt.step(lambda: torch_loss(target, params)).item())
    for k, v in later.items():
        assert getattr(opt, k) == (tuple(v) if isinstance(v, tuple) else v)
    np.testing.assert_allclose(losses, jlosses, rtol=rtol)
    for i, (p, j) in enumerate(zip(params, jparams)):
        close(p, j, rtol, f"{name} param {i}")


def rosenbrock(x):
    x1, x2 = x[0::2], x[1::2]
    return torch.sum(100.0 * (x2 - x1 ** 2) ** 2 + (1.0 - x1) ** 2)


def test_dense_newton_class_rosenbrock():
    """hello_psgd: the 50-dimensional coupled Rosenbrock function from 0 by
    the DenseNewton class (lr_params 1, lr_preconditioner 0.5, momentum
    0.9), in float64, below 1e-7 in 1500 steps (tests/test_classes.py)."""
    x = torch.zeros(50, dtype=torch.float64, requires_grad=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = classes.DenseNewton([x], lr_params=1.0, lr_preconditioner=0.5,
                                  momentum=0.9, device="cpu", draw=jax_draw)
    for _ in range(1500):
        loss = opt.step(lambda: rosenbrock(x))
    assert loss.item() < 1e-7, loss.item()


def test_lra_classes_descend():
    """tests/test_classes.py's LRA drives: LRANewton to < 1e-5 and LRAWhiten
    to a tenth of the start on a diagonal quadratic, 300 steps each."""
    scales = torch.linspace(0.1, 10.0, 30, dtype=torch.float64)
    w = torch.ones(30, dtype=torch.float64, requires_grad=True)
    loss_fn = lambda: 0.5 * torch.sum(w ** 2 * scales)   # noqa: E731
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = classes.LRANewton([w], rank_of_approximation=5, lr_params=0.5,
                                grad_clip_max_norm=10.0, device="cpu",
                                draw=jax_draw)
        for _ in range(300):
            loss = opt.step(loss_fn)
        assert loss.item() < 1e-5, loss.item()
        with torch.no_grad():
            w.fill_(1.0)
        l0 = loss_fn().item()
        opt2 = classes.LRAWhiten([w], rank_of_approximation=5, lr_params=0.02,
                                 device="cpu", draw=jax_draw)
        for _ in range(300):
            loss2 = opt2.step(loss_fn)
    assert loss2.item() < 0.1 * l0, (loss2.item(), l0)


@pytest.mark.parametrize("name", ["KronWhiten", "LRAWhiten", "DenseNewton"])
def test_step_has_aux(name):
    """has_aux=True: the closure returns (loss, aux), loss first
    (psgd.py:594-596); step returns that tuple and descends on the loss;
    .grad is not touched."""
    w = torch.ones(16, dtype=torch.float64, requires_grad=True)
    h = torch.linspace(0.5, 5.0, 16, dtype=torch.float64)

    def closure():
        loss = 0.5 * torch.sum(w * w * h)
        return loss, {"norm": torch.linalg.vector_norm(w).detach()}

    opt = getattr(classes, name)([w], lr_params=0.05, device="cpu",
                                 preconditioner_init_scale=1.0)
    l0 = closure()[0].item()
    for _ in range(5):
        out = opt.step(closure, has_aux=True)
    assert isinstance(out, tuple) and set(out[1]) == {"norm"}
    assert out[0].item() < l0 and w.grad is None


def test_assigned_hyperparameters_take_effect():
    """Assigning a hyperparameter changes the next step (the amplitudes,
    as tests/test_classes.py holds it); one that fixes the state's
    structure raises; the reference names read back."""
    def loss_fn(p):
        return torch.sum(p ** 2 * torch.linspace(1.0, 5.0, 16,
                                                 dtype=torch.float64))

    for name in ("KronWhiten", "LRAWhiten"):
        p = torch.ones(16, dtype=torch.float64, requires_grad=True)
        opt = getattr(classes, name)([p], preconditioner_init_scale=1.0,
                                     lr_params=0.1, device="cpu")
        opt.step(lambda: loss_fn(p))
        moved = (p.detach() - 1.0).abs().max().item()
        opt.grad_clip_max_amps = (1e-5, 1e-5)
        before = p.detach().clone()
        opt.step(lambda: loss_fn(p))
        assert (p.detach() - before).abs().max().item() <= 0.1 * 1e-5 + 1e-12
        assert moved > 1e-4
        assert opt.grad_clip_max_amps == (1e-5, 1e-5) and opt.lr_params == 0.1
        opt.lr_params = 0.0
        before = p.detach().clone()
        opt.step(lambda: loss_fn(p))
        assert torch.equal(p.detach(), before)
    with pytest.raises(ValueError, match="fresh"):
        opt.rank_of_approximation = 2
    with pytest.raises(ValueError, match="fresh"):
        opt.momentum = 0.9           # momentum 0 -> > 0 changes the state
    kron = classes.KronNewton([torch.ones(4, requires_grad=True)],
                              preconditioner_init_scale=1.0, device="cpu")
    with pytest.raises(ValueError, match="fresh"):
        kron.dQ = "QEQ"
    kron.exact_hessian_vector_product = False
    assert kron.optimizer.exact_hvp is False
    dense = classes.DenseNewton([torch.ones(4, requires_grad=True)],
                                preconditioner_init_scale=1.0, device="cpu")
    with pytest.raises(ValueError, match="fresh"):
        dense.dQ = "QEQ"
    dense.momentum = 0.0             # stays off: no change of structure
    assert dense.dQ == "Q0.5EQ1.5" and dense.momentum == 0.0
