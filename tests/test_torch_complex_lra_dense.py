"""The LRA and dense preconditioners on complex parameters against the JAX
package's: ``precond.lra.update_lra`` on a complex state whose I + V^T U is
not Hermitian (the plain-transpose solve, JAX ``lu_solve(..., trans=1)``,
where torch's ``adjoint=True`` would conjugate), LRAWhiten and LRANewton at
rank 0 and 3, DenseNewton in each of its seven geometries, the three
closure classes, and a complex ``state_dict`` round trip.

The gradient convention.  For a real loss of a complex parameter torch's
``.grad`` is the conjugate of ``jax.grad``'s, so each side gets its own
form of one quadratic over the parameters concatenated, x: torch
0.5 Re(x^H S x) - Re(c^H x), JAX 0.5 Re(x^T S x) - Re(c^T x), S real
symmetric positive definite.  Both then see the gradient S x - c and the
Hessian action S v (exact Hvp by double backward and by ``jax.jvp``), so
the same arrays go into both optimizers.

Every draw is the JAX package's, replayed (``jax_draw``, as
``test_torch_legacy.fast_draw`` compiles it: complex normals for a
complex dtype).  Three steps in complex128; parameters and state
within rtol 1e-9 (atol 1e-9 of the largest entry), as the real LRA and
dense tests (tests/test_torch_lra_dense_optim.py).  The JAX steps are
jitted with XLA's backend optimizations off (``FAST_COMPILE``), which
cuts their compiles, the cost of these cases.
"""

import functools
import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import psgd_torch_tpu.optim as jopt
from psgd_torch_tpu.optim import classes as jclasses
from psgd_torch_tpu.precond import lra as jlra
from psgd_torch_tpu_torch.optim import (DenseNewton, LRANewton, LRAWhiten,
                                        classes)
from psgd_torch_tpu_torch.precond import lra as tlra
from psgd_torch_tpu_torch.precond.lra import LRAState
from psgd_torch_tpu_torch.utils import psgd_metrics
from test_torch_kron import to_np
from test_torch_legacy import FAST_COMPILE, fast_draw as jax_draw

RTOL = 1e-9
STEPS = 3
LR = 0.05
SHAPES = ((3, 2), (4,))        # n = 10
C = torch.complex128


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The torch side in one thread: these sizes gain nothing from more,
    and the test run's workers share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cn(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def problem(shapes=SHAPES, seed=0):
    """(S, c, initial leaves) over leaves of ``shapes``: S real SPD
    (n, n), c and the leaves complex."""
    rng = np.random.default_rng(seed)
    n = sum(int(np.prod(s)) for s in shapes)
    a = rng.standard_normal((n, n)) / n ** 0.5
    s = a @ a.T + 0.5 * np.eye(n)
    return s, _cn(rng, n), [_cn(rng, shape) for shape in shapes]


def jax_loss(s, c):
    def loss(leaves):
        x = jnp.concatenate([p.reshape(-1)
                             for p in jax.tree_util.tree_leaves(leaves)])
        return 0.5 * jnp.real(x @ (s @ x)) - jnp.real(c @ x)
    return loss


def torch_loss(s, c, leaves):
    x = torch.cat([p.reshape(-1) for p in leaves])
    st, ct = torch.from_numpy(s).to(x.dtype), torch.from_numpy(c).to(x.dtype)
    return 0.5 * torch.real(x.conj() @ (st @ x)) - torch.real(ct.conj() @ x)


def close(got, ref, what, rtol=RTOL):
    ref = to_np(ref)
    np.testing.assert_allclose(to_np(got), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(initial=0.0), 1e-300),
                               err_msg=what)


def jax_steps(name, newton, kw):
    """STEPS JAX steps of optimizer ``name``: (leaves, precond)."""
    s, c, init = problem()
    loss = jax_loss(jnp.asarray(s), jnp.asarray(c))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = getattr(jopt, name)(learning_rate=LR, **kw)
    @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    def one(p, st):
        extra = {"hvp_fn": jopt.make_hvp_fn(loss)} if newton else {}
        upd, st = opt.update(jax.grad(loss)(p), st, p, **extra)
        return optax.apply_updates(p, upd), st

    params = [jnp.asarray(x) for x in init]
    state = opt.init(params)
    for _ in range(STEPS):
        params, state = one(params, state)
    return params, [x for x in state if hasattr(x, "precond")][0].precond


def torch_run(cls, newton, kw, steps=STEPS, dtype=C):
    s, c, init = problem()
    params = [torch.from_numpy(x).to(dtype).requires_grad_() for x in init]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = cls(params, lr=LR, device="cpu", draw=jax_draw, **kw)
    for _ in range(steps):
        step(opt, newton, params, s, c)
    return params, opt


def step(opt, newton, params, s, c):
    if newton:
        return opt.step(lambda: torch_loss(s, c, params))
    opt.zero_grad()
    torch_loss(s, c, params).backward()
    return opt.step()


def hold(name, cls, newton, kw):
    jparams, jst = jax_steps(name, newton, kw)
    params, opt = torch_run(cls, newton, kw)
    for i, (p, j) in enumerate(zip(params, jparams)):
        assert p.dtype == C
        close(p, j, f"param {i}")
    for f in opt.precond._fields:
        got = getattr(opt.precond, f)
        assert got.dtype == getattr(torch, str(np.asarray(getattr(jst, f)).dtype))
        close(got, getattr(jst, f), f)
    return opt


# ---------------------------------------------------------------------------
# the transpose in LRA's solve
# ---------------------------------------------------------------------------


def _adjoint_solve(lu, piv, b):
    """What a Hermitian rewrite would solve: (I + V^T U)^H x = b."""
    return torch.linalg.lu_solve(lu, piv, b, adjoint=True)


def test_lra_update_solves_with_the_plain_transpose(monkeypatch):
    """``update_lra`` on a complex state whose I + V^T U is far from
    Hermitian against JAX's, both U-or-V branches: U, V, d and the L
    estimates within 1e-9.  With the solve made ``adjoint=True`` (the
    conjugate transpose) the port leaves JAX by far more than that, so
    this pins the transpose."""
    rng = np.random.default_rng(3)
    n, r = 9, 3
    u, v = 0.4 * _cn(rng, (n, r)), 0.4 * _cn(rng, (n, r))
    small = np.eye(r) + v.T @ u
    assert np.abs(small - small.conj().T).max() > 0.1
    d = (1.0 + 0.3 * rng.random((n, 1))) * np.exp(0.3j * rng.standard_normal((n, 1)))
    pv, ph = _cn(rng, (n, 1)), _cn(rng, (n, 1))
    jst = jlra.LRAState(u=jnp.asarray(u), v=jnp.asarray(v), d=jnp.asarray(d),
                        lu=jnp.zeros(()), lv=jnp.zeros(()), ld=jnp.zeros(()))
    tst = tlra.lra_state_from_jax(jst, device="cpu")
    update = jax.jit(functools.partial(jlra.update_lra, lr=0.1),
                     compiler_options=FAST_COMPILE)
    for seed in (0, 1):     # the coin: U, then V
        key = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
        ref = update(jst, jnp.asarray(pv), jnp.asarray(ph),
                     jax.random.PRNGKey(seed))
        got = tlra.update_lra(tst, torch.from_numpy(pv), torch.from_numpy(ph),
                              key, lr=0.1, draw=jax_draw)
        for f in LRAState._fields:
            close(getattr(got, f), getattr(ref, f), f"seed {seed} {f}")
        with monkeypatch.context() as m:
            m.setattr(tlra, "lu_solve_t", _adjoint_solve)
            wrong = tlra.update_lra(tst, torch.from_numpy(pv),
                                    torch.from_numpy(ph), key, lr=0.1,
                                    draw=jax_draw)
        gap = np.abs(to_np(wrong.d) - np.asarray(ref.d)).max()
        assert gap > 1e-3 * np.abs(np.asarray(ref.d)).max(), gap
    close(tlra.log_det(tst), jlra.log_det(jst), "log det")
    g = _cn(rng, n)
    close(tlra.precond_grad(tst, torch.from_numpy(g)),
          jlra.precond_grad(jst, jnp.asarray(g)), "P g")


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------


LRA_ARMS = {
    # momentum, the on-the-fly init scale (the real parts' mean)
    "whiten_rank3": ("lra_whiten", LRAWhiten, False,
                     dict(rank_of_approximation=3, momentum=0.9)),
    "whiten_rank0": ("lra_whiten", LRAWhiten, False,
                     dict(rank_of_approximation=0, preconditioner_init_scale=0.5)),
    "newton_rank3": ("lra_newton", LRANewton, True,
                     dict(rank_of_approximation=3, grad_clip_max_norm=10.0)),
    "newton_rank0": ("lra_newton", LRANewton, True,
                     dict(rank_of_approximation=0, momentum=0.5)),
}


@pytest.mark.parametrize("arm", sorted(LRA_ARMS))
def test_lra_optimizers_match_jax(arm):
    name, cls, newton, kw = LRA_ARMS[arm]
    opt = hold(name, cls, newton, kw)
    assert opt.precond.u.dtype == C and opt.precond.ld.dtype == torch.float64


DENSE_GEOMETRIES = ("EQ", "QEP", "QEQ", "Q0.5EQ1.5", "PRO4P", "QUAD", "QUAD4P")


@pytest.mark.parametrize("dq", DENSE_GEOMETRIES)
def test_dense_newton_matches_jax(dq):
    """DenseNewton with momentum and the on-the-fly init scale; Q0.5EQ1.5's
    rotation is ``kernels.xla_procrustes`` (PyTorch operations), PRO4P's
    loop runs its PyTorch-operation bound."""
    opt = hold("dense_newton", DenseNewton, True,
               dict(dq=dq, momentum=0.9, lr_preconditioner=0.3, norm_k=4))
    assert opt.precond.q.dtype == C and opt.precond.lips.dtype == torch.float64


# lr_params powers of 2: the JAX classes pass it to their step in float32
CLASS_ARMS = {
    "LRAWhiten": dict(lr_params=2 ** -4, rank_of_approximation=3,
                      preconditioner_init_scale=1.0),
    "LRANewton": dict(lr_params=2 ** -4, rank_of_approximation=3, momentum=0.9),
    "DenseNewton": dict(lr_params=2 ** -4, lr_preconditioner=0.5,
                        grad_clip_max_norm=10.0),
}


@pytest.mark.parametrize("name", sorted(CLASS_ARMS))
def test_closure_classes_match_jax(name):
    """Each closure class against the JAX class of its name on the complex
    quadratic (the JAX class differentiates its own loss form)."""
    kw = CLASS_ARMS[name]
    s, c, init = problem()
    jl = jax_loss(jnp.asarray(s), jnp.asarray(c))
    jparams = [jnp.asarray(x) for x in init]
    params = [torch.from_numpy(x).requires_grad_() for x in init]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jo = getattr(jclasses, name)(jparams, **kw)
        to = getattr(classes, name)(params, device="cpu", draw=jax_draw, **kw)
        for _ in range(STEPS):
            _, jparams = jo.step(jl, jparams)
            to.step(lambda: torch_loss(s, c, params))
    for i, (p, j) in enumerate(zip(params, jparams)):
        close(p, j, f"{name} param {i}")


# ---------------------------------------------------------------------------
# state_dict
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls,newton,kw", [
    (LRAWhiten, False, dict(rank_of_approximation=3, momentum=0.9)),
    (LRANewton, True, dict(rank_of_approximation=2)),
    (DenseNewton, True, dict(dq="QUAD", momentum=0.9))],
    ids=["LRAWhiten", "LRANewton", "DenseNewton"])
def test_complex_state_dict_round_trip(cls, newton, kw):
    """Two complex64 steps, the state through torch.save /
    torch.load(weights_only=True) into a fresh optimizer: the state comes
    back complex64 bit for bit, and a third step from it equals the
    unbroken run's third step bit for bit."""
    s, c, _ = problem()
    params, opt = torch_run(cls, newton, kw, steps=2, dtype=torch.complex64)
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    twin_params = [p.detach().clone().requires_grad_() for p in params]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        twin = cls(twin_params, lr=LR, device="cpu", draw=jax_draw, **kw)
    buf.seek(0)
    twin.load_state_dict(torch.load(buf, weights_only=True))
    for f in opt.precond._fields:
        a, b = getattr(twin.precond, f), getattr(opt.precond, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert opt.precond[0].dtype == torch.complex64
    if opt.mu is not None:
        assert twin.mu.dtype == torch.complex64 and torch.equal(twin.mu, opt.mu)
    # psgd_metrics reads the complex state (dense: L, |Q|, its row maxima)
    metrics = {k: float(v) for k, v in psgd_metrics(opt).items()}
    assert metrics == {k: float(v) for k, v in psgd_metrics(twin).items()}
    assert "q_abs_max" in metrics and all(np.isfinite(v) for v in metrics.values())
    step(opt, newton, params, s, c)
    step(twin, newton, twin_params, s, c)
    for a, b in zip(params, twin_params):
        assert torch.equal(a, b)
        assert torch.isfinite(torch.view_as_real(a)).all()
