"""The legacy families on complex parameters against the JAX package's: the
matrix Kron dispatcher's four kernels (``precond.legacy``), and the
optimizers XMat, SPLU, NewtonInv and UVd over the concatenated vector,
each with both step normalizers, and Affine on a 3-D leaf, by Newton and
by its drop-v whitening; a complex ``state_dict`` round trip, and
``psgd_metrics`` reading each state.

The quadratic and the gradient convention are those of
tests/test_torch_complex_lra_dense.py (each side its own form of one
quadratic with a real SPD S, so both see the gradient S x - c and the
Hessian action S v).  XMat, SPLU, NewtonInv and UVd transpose where a
Hermitian preconditioner conjugates, Affine conjugates, as JAX does; a
complex value cast to a real dtype keeps its real part (JAX's
``astype``), and the balancing reads maxima in JAX's order of complex
numbers.  Three steps in complex128 on replayed draws; parameters and
state within rtol 1e-9 (atol 1e-9 of the largest entry).  Affine's
Newton arm takes an explicit init scale: its on-the-fly scale is a
float32 sum over the leaves that the two sides take in another order
here (4.6e-7 apart after three steps); the vector families' '2nd' arms
take theirs on the fly.
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
from psgd_torch_tpu.precond import legacy as jlegacy
from psgd_torch_tpu_torch.optim import SPLU, Affine, NewtonInv, UVd, XMat
from psgd_torch_tpu_torch.precond import legacy as tlegacy
from psgd_torch_tpu_torch.utils import psgd_metrics
from test_torch_complex_lra_dense import (C, close, jax_loss, one_torch_thread,  # noqa: F401
                                          problem, torch_loss)
from test_torch_legacy import FAST_COMPILE, fast_draw as jax_draw

STEPS = 3
LR = 0.05
LEAVES = ((3, 4), (5,))                  # n = 17: XMat's odd middle
TREE = {"a": (2, 3, 4), "b": (5,)}       # Affine: (6, 4) and (1, 5)


def _cn(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# ---------------------------------------------------------------------------
# the matrix Kron dispatcher
# ---------------------------------------------------------------------------


KRON_KINDS = [("dense", "dense"), ("norm", "dense"), ("norm", "scale"),
              ("dense", "scale")]


@pytest.mark.parametrize("kinds", KRON_KINDS, ids="-".join)
def test_kron_dispatch_complex_matches_jax(kinds):
    """Each of the four kernels from a complex start, three updates from
    complex (dx, dg) pairs, then P g: the balancing's rho from the
    diagonal's maxima in JAX's order, the step sizes real."""
    shape = (6, 5)
    rng = np.random.default_rng(KRON_KINDS.index(kinds))
    ql, qr = tlegacy.init_kron_legacy(shape, *kinds, scale=0.7, dtype=C,
                                      device="cpu")
    jql, jqr = jnp.asarray(ql.numpy()), jnp.asarray(qr.numpy())
    update = jax.jit(functools.partial(jlegacy.update_precond_kron, lr=0.2),
                     compiler_options=FAST_COMPILE)
    for i in range(3):
        dx, dg = _cn(rng, shape), _cn(rng, shape)
        ql, qr = tlegacy.update_precond_kron(ql, qr, torch.from_numpy(dx),
                                             torch.from_numpy(dg), lr=0.2)
        jql, jqr = update(jql, jqr, jnp.asarray(dx), jnp.asarray(dg))
        close(ql, jql, f"ql {i}")
        close(qr, jqr, f"qr {i}")
    assert ql.dtype == C and bool((ql.imag != 0).any())
    g = _cn(rng, shape)
    close(tlegacy.precond_grad_kron(ql, qr, torch.from_numpy(g)),
          jlegacy.precond_grad_kron(jql, jqr, jnp.asarray(g)), "P g")


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------


def as_tree(kind, leaves):
    return dict(zip(sorted(TREE), leaves)) if kind == "tree" else list(leaves)


def jax_steps(name, newton, kind, kw):
    """STEPS JAX steps of ``name``: (final leaves, precond state)."""
    shapes = tuple(TREE[k] for k in sorted(TREE)) if kind == "tree" else LEAVES
    s, c, init = problem(shapes)
    loss = jax_loss(jnp.asarray(s), jnp.asarray(c))
    opt = getattr(jopt, name)(learning_rate=LR, **kw)

    @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    def one(p, st):
        extra = {"hvp_fn": jopt.make_hvp_fn(loss)} if newton else {}
        upd, st = opt.update(jax.grad(loss)(p), st, p, **extra)
        return optax.apply_updates(p, upd), st

    params = as_tree(kind, [jnp.asarray(x) for x in init])
    state = opt.init(params)
    for _ in range(STEPS):
        params, state = one(params, state)
    return (jax.tree_util.tree_leaves(params),
            [x for x in state if hasattr(x, "precond")][0].precond)


def torch_run(cls, newton, kind, kw, steps=STEPS, dtype=C):
    shapes = tuple(TREE[k] for k in sorted(TREE)) if kind == "tree" else LEAVES
    s, c, init = problem(shapes)
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in init]
    params = list(zip(sorted(TREE), leaves)) if kind == "tree" else leaves
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = cls(params, lr=LR, device="cpu", draw=jax_draw, **kw)
    for _ in range(steps):
        step(opt, newton, leaves, s, c)
    return leaves, opt


def step(opt, newton, leaves, s, c):
    if newton:
        return opt.step(lambda: torch_loss(s, c, leaves))
    opt.zero_grad()
    torch_loss(s, c, leaves).backward()
    return opt.step()


# name -> (JAX factory, class, Newton, leaves, kwargs): the '2nd' arms whiten
# the gradient with momentum and the on-the-fly init scale, the '1st' arms
# fit from exact Hvps by the closure
ARMS = {
    "xmat-2nd": ("xmat", XMat, False, "vec", dict(momentum=0.9)),
    "xmat-1st": ("xmat", XMat, True, "vec", dict(
        step_normalizer="1st", preconditioner_type="Newton",
        preconditioner_init_scale=1.0)),
    "splu-2nd": ("splu", SPLU, False, "vec", dict(rank=3, momentum=0.9)),
    "splu-1st": ("splu", SPLU, True, "vec", dict(
        rank=3, step_normalizer="1st", preconditioner_type="Newton")),
    "newton_inv-2nd": ("newton_inv", NewtonInv, False, "vec", dict()),
    "newton_inv-1st": ("newton_inv", NewtonInv, True, "vec", dict(
        step_normalizer="1st", preconditioner_type="Newton",
        grad_clip_max_norm=10.0)),
    "uvd-2nd": ("uvd", UVd, False, "vec", dict(rank=3, momentum=0.9)),
    "uvd-1st": ("uvd", UVd, True, "vec", dict(
        rank=3, step_normalizer="1st", preconditioner_type="Newton")),
    # the 3-D leaf's sides (6, 4): dense both by Newton; at max_skew 1 the
    # 6 side diagonal, so whitening integrates v out (drop-v)
    "affine-newton": ("affine", Affine, True, "tree", dict(
        preconditioner_type="Newton", step_normalizer="1st",
        preconditioner_init_scale=1.0)),
    "affine-dropv": ("affine", Affine, False, "tree", dict(
        preconditioner_max_skew=1.0, momentum=0.9)),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_legacy_optimizers_match_jax(arm):
    name, cls, newton, kind, kw = ARMS[arm]
    jleaves, jst = jax_steps(name, newton, kind, kw)
    leaves, opt = torch_run(cls, newton, kind, kw)
    for i, (p, j) in enumerate(zip(leaves, jleaves)):
        assert p.dtype == C
        close(p, j, f"param {i}")
    # psgd_metrics reads the complex state: |Q|'s largest entry, as JAX's
    # psgd_metrics summarises a state without .q (every field)
    qmax = max(float(np.abs(np.asarray(x)).max()) for x in jax.tree_util.tree_leaves(jst))
    np.testing.assert_allclose(float(psgd_metrics(opt)["q_abs_max"]), qmax, rtol=1e-6)
    if cls is Affine:
        for i, p in enumerate(leaves):
            close(opt.state[p]["ql"], jst[i].ql, f"ql {i}")
            close(opt.state[p]["qr"], jst[i].qr, f"qr {i}")
        if arm == "affine-dropv":
            assert opt.state[leaves[0]]["ql"].ndim == 1
    else:
        for f, a, b in zip(opt.precond._fields, opt.precond, jst):
            assert a.dtype == C, f
            close(a, b, f)


def test_uvd_complex64_state_dict_round_trip():
    """UVd on complex64: two steps, the state through torch.save /
    torch.load(weights_only=True) into a fresh optimizer, complex64 bit
    for bit, and a third step equal to the unbroken run's bit for bit."""
    kw = dict(rank=3, momentum=0.9)
    s, c, _ = problem(LEAVES)
    leaves, opt = torch_run(UVd, False, "vec", kw, steps=2,
                            dtype=torch.complex64)
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    twin_leaves = [p.detach().clone().requires_grad_() for p in leaves]
    twin = UVd(twin_leaves, lr=LR, device="cpu", draw=jax_draw, **kw)
    buf.seek(0)
    twin.load_state_dict(torch.load(buf, weights_only=True))
    for a, b in zip(twin.precond + (twin.mu,), opt.precond + (opt.mu,)):
        assert a.dtype == torch.complex64 and torch.equal(a, b)
    metrics = {k: float(v) for k, v in psgd_metrics(opt).items()}
    assert metrics == {k: float(v) for k, v in psgd_metrics(twin).items()}
    assert set(metrics) == {"step", "q_abs_max", "momentum_rms"}
    assert all(np.isfinite(v) for v in metrics.values())
    step(opt, False, leaves, s, c)
    step(twin, False, twin_leaves, s, c)
    for a, b in zip(leaves, twin_leaves):
        assert torch.equal(a, b) and torch.isfinite(torch.view_as_real(a)).all()
