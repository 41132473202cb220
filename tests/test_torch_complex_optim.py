"""KronWhiten and KronNewton on complex parameters against the JAX package's
kron_whiten and kron_newton, and the complex pieces of the optimizers:
the amplitude clip, the trust-region norm, the on-the-fly init scales,
the Hessian-vector products, the gradient convention, ``state_dict`` and
``psgd_metrics``.

The gradient convention.  For a real loss of a complex parameter torch's
``.grad`` is the conjugate of what ``jax.grad`` returns (for |z|^2 at
3 + 4j: torch 6 + 8j, JAX 6 - 8j).  The port follows torch: its optimizers
read ``.grad`` as torch makes it and ``p - lr * update`` descends.  The
parity tests therefore feed both sides the same gradient, probe and
Hessian-vector arrays and never compare each side's own autograd.

The tree is the JAX package's test_complex_leaf_through_transform's: a
complex (4, 3) leaf beside a real (5,) leaf, here complex128 and float64,
three steps, rtol 1e-9 (atol 1e-9 of the largest entry)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import psgd_torch_tpu.optim as jopt
from psgd_torch_tpu.optim import transforms as jtransforms
from psgd_torch_tpu.utils import psgd_metrics as jax_metrics
from psgd_torch_tpu_torch.optim import KronNewton, KronWhiten, hvp, transforms
from psgd_torch_tpu_torch.utils import psgd_metrics
from test_torch_kron import jax_draw, to_np
from test_torch_lra_dense_optim import STEPS, mixed_seed

RTOL = 1e-9
LR = 0.05
GATED = lambda c: 0.5   # noqa: E731
# amplitude clips that never bind (the clip's f32 RMS then scales by 1)
LOOSE_CLIP = (1e3, 1e4)
WHITEN = {
    "grad_gated": dict(preconditioner_max_skew=float("inf"),
                       preconditioner_init_scale=1.0, grad_clip_max_amps=LOOSE_CLIP,
                       preconditioner_update_probability=GATED,
                       seed=mixed_seed(3, False)[0]),
    "momentum_cache_decay": dict(momentum=0.9, whiten_grad=False, cache_p=True,
                                 weight_decay=0.01, dq="QEQ",
                                 preconditioner_init_scale=1.0,
                                 grad_clip_max_amps=LOOSE_CLIP),
}
NEWTON = {
    "gated_momentum": dict(preconditioner_max_skew=float("inf"), momentum=0.9,
                           preconditioner_init_scale=1.0, grad_clip_max_norm=10.0,
                           preconditioner_update_probability=GATED,
                           seed=mixed_seed(4, True)[0]),
    # real parameters with a complex Q (what the JAX transforms do with it:
    # the sources cast to complex, the update's real part applied)
    "complex_q_over_real": dict(preconditioner_dtype=torch.complex128,
                                preconditioner_init_scale=1.0, dq="QUAD"),
}


def _cn(rng, shape):
    return np.asarray(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))


def tree(real_only=False):
    """{"c": complex128 (4, 3), "r": float64 (5,)} (a real (4, 3) "c" with
    ``real_only``)."""
    rng = np.random.default_rng(0)
    c = _cn(rng, (4, 3))
    return {"c": c.real.copy() if real_only else c, "r": rng.standard_normal(5)}


def grads_at(t, params):
    rng = np.random.default_rng(100 + t)
    return {k: 0.3 * (_cn(rng, v.shape) if np.iscomplexobj(v) else
                      rng.standard_normal(v.shape)) for k, v in params.items()}


def torch_params(params):
    return [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
            for k, v in sorted(params.items())]


def compare(opt, named, jparams, state):
    """Parameters and each leaf's Q and L against the JAX chain's."""
    precond = [s for s in state if hasattr(s, "precond")][0].precond
    for (name, p), st in zip(named, precond):
        ref = np.asarray(jparams[name])
        np.testing.assert_allclose(to_np(p), ref, rtol=RTOL,
                                   atol=RTOL * np.abs(ref).max(), err_msg=name)
        for a, b in zip(opt.state[p]["q"], st.q):
            b = np.asarray(b)
            np.testing.assert_allclose(to_np(a), b, rtol=RTOL,
                                       atol=RTOL * np.abs(b).max(), err_msg=name)
        for a, b in zip(opt.state[p]["lips"], st.lips):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       err_msg=name)


def run_whiten(name):
    """STEPS steps of both sides from the same gradients; returns (port
    optimizer, named parameters, JAX params, JAX state, last updates)."""
    kw = WHITEN[name]
    params = tree()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jo = jopt.kron_whiten(learning_rate=LR, **kw)
        named = torch_params(params)
        to = KronWhiten(named, lr=LR, device="cpu", draw=jax_draw, **kw)
    state = jo.init(params)
    update = jax.jit(jo.update)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for t in range(STEPS):
        g = grads_at(t, params)
        upd, state = update({k: jnp.asarray(v) for k, v in g.items()}, state,
                            jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in named:
            p.grad = torch.from_numpy(g[k])
        to.step()
    return to, named, jparams, state, upd


@pytest.mark.parametrize("name", sorted(WHITEN))
def test_kron_whiten_complex_tree_matches_jax(name):
    """KronWhiten on the mixed tree (the gate replayed at p = 0.5, or
    momentum whitening with the cache, QEQ and decoupled decay) against
    kron_whiten fed the same gradients: parameters, Q and L within 1e-9;
    the complex leaf's Q complex128, the real leaf's float64."""
    to, named, jparams, state, _ = run_whiten(name)
    compare(to, named, jparams, state)
    assert to.state[named[0][1]]["q"][0].dtype == torch.complex128
    assert to.state[named[1][1]]["q"][0].dtype == torch.float64
    if name == "grad_gated":
        assert 0 < to.fit_steps < STEPS


def _hvp_pair(params):
    """A fixed linear Hessian action both sides apply: a Hermitian positive
    4 x 4 matrix on the complex (or real) leaf's rows, a positive diagonal
    on the real leaf."""
    rng = np.random.default_rng(7)
    x = _cn(rng, (4, 8)) if np.iscomplexobj(params["c"]) else rng.standard_normal((4, 8))
    m = x @ x.conj().T / 8 + 0.5 * np.eye(4)
    d = 1.0 + rng.random(5)
    jax_h = lambda vs: {"c": jnp.asarray(m) @ vs["c"], "r": jnp.asarray(d) * vs["r"]}
    torch_h = lambda v: [torch.from_numpy(m) @ v[0], torch.from_numpy(d) * v[1]]
    return jax_h, torch_h


def run_newton(name, monkeypatch):
    """STEPS KronNewton steps from given gradients and a given Hessian
    action, against kron_newton fed the same (its hvp_fn returns the
    action of the probes it draws, as the port's patched exact Hvp does);
    a no-fit step's gradient comes from a closure whose torch gradient is
    the given one (the loss sum Re(conj(G) p))."""
    kw = dict(NEWTON[name])
    params = tree(real_only="preconditioner_dtype" in kw)
    jax_h, torch_h = _hvp_pair(params)
    jkw = dict(kw, preconditioner_dtype=jnp.complex128) \
        if "preconditioner_dtype" in kw else kw
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jo = jopt.kron_newton(learning_rate=LR, **jkw)
        named = torch_params(params)
        to = KronNewton(named, lr=LR, device="cpu", draw=jax_draw, **kw)
    state = jo.init(params)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    given = {}

    def fake_hvp(loss_fn, ps, vs):
        loss_fn()
        return [torch.from_numpy(given["g"][k]) for k, _ in named], torch_h(vs)

    monkeypatch.setattr(transforms.hvp, "hvp_exact", fake_hvp)
    update = jax.jit(lambda g, s, p: jo.update(
        g, s, p, hvp_fn=lambda pp, vs: (None, jax_h(vs))))
    for t in range(STEPS):
        given["g"] = g = grads_at(t, params)
        upd, state = update({k: jnp.asarray(v) for k, v in g.items()}, state,
                            jparams)
        jparams = optax.apply_updates(jparams, upd)
        to.step(lambda: sum(torch.sum(torch.real(torch.from_numpy(g[k]).conj() * p))
                            for k, p in named))
    return to, named, jparams, state


@pytest.mark.parametrize("name", sorted(NEWTON))
def test_kron_newton_complex_matches_jax(name, monkeypatch):
    """KronNewton against kron_newton on the same gradients, probes
    (replayed) and Hessian action: the complex tree with gated fits and
    momentum, and real parameters with a complex128 Q (QUAD), whose
    update is the real part of P g: parameters, Q and L within 1e-9."""
    to, named, jparams, state = run_newton(name, monkeypatch)
    if name == "complex_q_over_real":
        for _, p in named:
            assert p.dtype == torch.float64
            assert all(f.dtype == torch.complex128 for f in to.state[p]["q"])
    compare(to, named, jparams, state)
    if name == "gated_momentum":
        assert 0 < to.fit_steps < STEPS


# ---------------------------------------------------------------------------
# the complex pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["rms_binds", "element_binds"])
def test_amp_clip_complex_matches_jax(case):
    """The complex branch of the amplitude clip, g / max(|g| / max_el, 1)
    after the RMS scale, against JAX's _amp_clip: rtol 1e-6 (both take the
    RMS in float32, summed in another order); every |element| <= max_el
    and the phases kept."""
    rng = np.random.default_rng(3)
    g = _cn(rng, (6, 5))
    g[1, 2] *= 40.0
    amps = (0.5, 100.0) if case == "rms_binds" else (100.0, 3.0)
    out = transforms._amp_clip(torch.from_numpy(g), *amps, stacked=False).numpy()
    ref = np.asarray(jtransforms._amp_clip(jnp.asarray(g), *amps))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    assert np.abs(out).max() <= amps[1] * (1 + 1e-12)
    np.testing.assert_allclose(np.angle(out), np.angle(g), atol=1e-12)
    stacked = transforms._amp_clip(torch.from_numpy(np.stack([g, g])), *amps,
                                   stacked=True).numpy()
    np.testing.assert_allclose(stacked[1], out, rtol=1e-12)


def test_global_norm_scale_complex_matches_jax():
    """The trust-region scale reads sum |x|^2 = Re(x conj x) of a complex
    leaf, as JAX's _global_norm_scale."""
    rng = np.random.default_rng(4)
    xs = [_cn(rng, (4, 3)), rng.standard_normal(5)]
    out = transforms._global_norm_scale([torch.from_numpy(x) for x in xs], 0.7)
    ref = jtransforms._global_norm_scale([jnp.asarray(x) for x in xs], 0.7)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-15)
    norm = np.sqrt(sum(np.sum(np.abs(x) ** 2) for x in xs))
    np.testing.assert_allclose(out.item(), 0.7 / norm, rtol=1e-12)


def test_init_scales_read_the_real_part_as_jax():
    """Pinned: the on-the-fly init scales take |g.astype(float32)|, which of
    a complex g is its real part (JAX transforms.py:137, :148-149); the
    port computes the same (a note on the reference in ROADMAP), not
    |g|."""
    rng = np.random.default_rng(5)
    g = _cn(rng, (4, 3))
    out = transforms._whiten_scale_from_grads([torch.from_numpy(g)], [False], 1e-9)
    ref = jtransforms._whiten_scale_from_grads([jnp.asarray(g)], [False], 1e-9)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
    real_part = np.mean(np.abs(g.real) ** 4) ** (-1 / 8)
    modulus = np.mean(np.abs(g) ** 4) ** (-1 / 8)
    np.testing.assert_allclose(out.item(), real_part, rtol=1e-6)
    assert abs(out.item() / modulus - 1) > 0.05
    v, h = _cn(rng, (4, 3)), _cn(rng, (4, 3))
    out = transforms._newton_scale_from_vh([torch.from_numpy(v)],
                                           [torch.from_numpy(h)], 1e-9)
    ref = jtransforms._newton_scale_from_vh([jnp.asarray(v)], [jnp.asarray(h)], 1e-9)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(
        out.item(), np.mean(v.real ** 2) ** 0.25 * np.mean(h.real ** 4) ** (-1 / 8),
        rtol=1e-6)


def test_gradient_convention_is_torchs():
    """Pinned: for |z|^2 at 3 + 4j torch's gradient is 6 + 8j and jax.grad's
    6 - 8j, its conjugate.  The port reads torch's: a step of
    p - lr * grad lowers the loss."""
    z = torch.tensor(3 + 4j, dtype=torch.complex128, requires_grad=True)
    (torch.abs(z) ** 2).backward()
    np.testing.assert_allclose(z.grad.item(), 6 + 8j, rtol=1e-15)
    np.testing.assert_allclose(
        complex(jax.grad(lambda w: jnp.abs(w) ** 2)(jnp.asarray(3 + 4j))), 6 - 8j,
        rtol=1e-15)
    with torch.no_grad():
        assert abs(z - 0.1 * z.grad).item() < abs(z).item()


def test_hvp_of_a_complex_least_squares():
    """hvp_exact's double backward on 0.5 |W X - Y|^2 over a complex W: the
    gradient (W X - Y) X^H (torch's convention) and the Hessian action
    V X X^H; hvp_finite_diff agrees (the loss is quadratic)."""
    rng = np.random.default_rng(6)
    x, y = _cn(rng, (3, 8)), _cn(rng, (4, 8))
    w = torch.from_numpy(_cn(rng, (4, 3))).requires_grad_()
    v = torch.from_numpy(_cn(rng, (4, 3)))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    loss = lambda: 0.5 * torch.sum(torch.abs(w @ xt - yt) ** 2)   # noqa: E731
    grads, hvs = hvp.hvp_exact(loss, [w], [v])
    wd = w.detach().numpy()
    np.testing.assert_allclose(grads[0].numpy(), (wd @ x - y) @ x.conj().T, rtol=1e-12)
    np.testing.assert_allclose(hvs[0].numpy(), v.numpy() @ x @ x.conj().T, rtol=1e-12)
    _, fd = hvp.hvp_finite_diff(loss, [w], [v])
    np.testing.assert_allclose(fd[0].numpy(), hvs[0].numpy(), rtol=1e-6, atol=1e-6)


def test_state_dict_keeps_complex64_bitwise():
    """KronWhiten and KronNewton on a complex64 (4, 3) parameter: Q and the
    momentum complex64; the state through torch.save and
    torch.load(weights_only=True) into a fresh optimizer keeps its dtypes
    and bits, and the next step is bitwise equal."""
    import io
    rng = np.random.default_rng(8)
    w0 = torch.from_numpy(_cn(rng, (4, 3))).to(torch.complex64)
    target = torch.from_numpy(_cn(rng, (4, 3))).to(torch.complex64)
    for cls, kw in ((KronWhiten, dict(momentum=0.9)), (KronNewton, dict(momentum=0.9))):
        ps = [torch.nn.Parameter(w0.clone()) for _ in range(2)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            opts = [cls([p], lr=0.1, device="cpu", preconditioner_init_scale=1.0,
                        **kw) for p in ps]
        closure = lambda p: (lambda: torch.sum(torch.abs(p - target) ** 2))  # noqa: E731

        def step(opt, p):
            if cls is KronNewton:
                opt.step(closure(p))
                return
            opt.zero_grad()
            closure(p)().backward()
            opt.step()

        for _ in range(2):
            step(opts[0], ps[0])
        buf = io.BytesIO()
        torch.save(opts[0].state_dict(), buf)
        buf.seek(0)
        with torch.no_grad():
            ps[1].copy_(ps[0])
        opts[1].load_state_dict(torch.load(buf, weights_only=True))
        st = opts[1].state[ps[1]]
        assert all(f.dtype == torch.complex64 for f in st["q"])
        assert st["mu"].dtype == torch.complex64
        for a, b in zip(st["q"] + (st["mu"],),
                        opts[0].state[ps[0]]["q"] + (opts[0].state[ps[0]]["mu"],)):
            assert torch.equal(torch.view_as_real(a), torch.view_as_real(b))
        for opt, p in zip(opts, ps):
            step(opt, p)
        assert torch.equal(torch.view_as_real(ps[0].detach()),
                           torch.view_as_real(ps[1].detach()))
        assert torch.sum(torch.abs(ps[0] - target) ** 2) < torch.sum(
            torch.abs(w0 - target) ** 2)


def test_psgd_metrics_on_complex_state_match_jax():
    """psgd_metrics of the momentum-whitening run against JAX's: the same
    keys, ``step`` equal, every value within rtol 1e-6 (float32
    reductions); |Q| of the complex factors, and of the complex momentum
    and updates the real part's RMS, as JAX's astype(float32) reads it."""
    to, named, jparams, state, upd = run_whiten("momentum_cache_decay")
    ups = [torch.from_numpy(np.array(upd[k])) for k, _ in named]
    out = psgd_metrics(to, updates=ups, per_leaf=True)
    ref = jax_metrics(state, updates=upd, per_leaf=True)
    assert set(ref) <= set(out) and int(out["step"]) == int(ref["step"])
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-6,
                                   err_msg=k)
