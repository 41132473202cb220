"""The port's Q0.5EQ1.5 Newton fit (psgd_torch_tpu_torch.precond.kron) and
its optimizer (KronNewton) against the JAX package's update_kron_newton,
update_kron_newton_stacked and kron_newton, on replayed draws, in float64;
the refusals of unported options.  Complex tensors: test_torch_complex_kron.py
and test_torch_complex_optim.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import psgd_torch_tpu.optim as jopt
from psgd_torch_tpu.precond import kron as jkron
from psgd_torch_tpu_torch.ops import fastrand
from psgd_torch_tpu_torch.optim import KronNewton, kron_newton
from psgd_torch_tpu_torch.precond import kron as tkron
from test_torch_kron import _compare_states, _random_state, jax_draw
from test_torch_kron_whiten import MODELS

# orders 0-3; dense factors, diagonal ones, and a mix
SHAPES = [((12, 20), 2.0), ((16, 40), 2.0), ((6,), 1.0), ((3, 4, 5), float("inf")),
          ((), 1.0)]


def _pair(shape, seed, batch=None):
    """(v, h) as numpy: a probe and a stand-in for its Hvp."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return rng.standard_normal(lead + shape), rng.standard_normal(lead + shape)


@pytest.mark.parametrize("shape,skew", SHAPES)
def test_update_kron_newton_matches_jax(shape, skew):
    """One Newton fit on replayed draws, f64: Q and L within rtol 1e-10."""
    plan, ts, js, jplan = _random_state(shape, skew, 21)
    v, h = _pair(shape, 22)
    key = fastrand.fold_in(fastrand.prng_key(23), 4)
    out = tkron.update_kron_newton(ts, plan, torch.from_numpy(v),
                                   torch.from_numpy(h), key, lr=0.2, norm_k=8,
                                   draw=jax_draw)
    ref = jkron.update_kron_newton(js, jplan, jnp.asarray(v), jnp.asarray(h),
                                   jnp.asarray(key), lr=0.2, norm_k=8)
    assert any(not torch.equal(a, b) for a, b in zip(out.q, ts.q))
    _compare_states(out, ref, 1e-10)


@pytest.mark.parametrize("shape,skew", [((16, 40), 2.0), ((24, 24), 1.0),
                                        ((3, 4, 5), float("inf")), ((8,), 1.0),
                                        ((), 1.0)])
def test_update_kron_newton_stacked_matches_jax(shape, skew):
    """A layer stack (B = 3) in one call against the JAX stacked update (its
    XLA tail with step_mat = term1 - term2 for the dense factors, its vmap
    for order 0), f64 on replayed draws, rtol 1e-10."""
    plan, ts, js, jplan = _random_state(shape, skew, 24, batch=3)
    v, h = _pair(shape, 25, batch=3)
    keys = fastrand.split(fastrand.prng_key(26), 3)
    out = tkron.update_kron_newton_stacked(ts, plan, torch.from_numpy(v),
                                           torch.from_numpy(h), keys,
                                           norm_k=8, draw=jax_draw)
    ref = jkron.update_kron_newton_stacked(js, jplan, jnp.asarray(v),
                                           jnp.asarray(h), jnp.asarray(keys),
                                           norm_k=8)
    _compare_states(out, ref, 1e-10)


def test_step_matrix_equal_to_term1_keeps_the_bits():
    """step_mat = None reads term1 for the step: passing term1's values as
    the step matrix gives the same bits on every route, so the whitening
    fit (no step matrix) computes what it computed before."""
    from psgd_torch_tpu_torch.ops import kernels
    rng = np.random.default_rng(27)
    a = rng.standard_normal((2, 24, 24))
    t1 = torch.from_numpy(a @ a.transpose(0, 2, 1) / 24 + np.eye(24))
    q = torch.from_numpy(np.eye(24) + 0.05 * rng.standard_normal((2, 24, 24)))
    args = (t1, q, torch.zeros(2, dtype=torch.float64), torch.ones(2, dtype=torch.float64),
            kernels.key_seed_words(fastrand.split(fastrand.prng_key(1), 2), "cpu"),
            0.1, 0.9)
    for route in kernels.NS_ROUTES:
        plain = kernels.fused_ns_update(*args, k=8, route=route)
        same = kernels.fused_ns_update(*args, k=8, route=route, step_mat=t1.clone())
        assert all(torch.equal(x, y) for x, y in zip(plain, same)), route


# ---------------------------------------------------------------------------
# the optimizer: three steps against psgd_torch_tpu.optim.kron_newton
# ---------------------------------------------------------------------------

# the Newton arm of tools/measure_cache_p_tpu.py:134-140 (p = 1 here)
ARM = dict(preconditioner_max_skew=2.0, preconditioner_init_scale=1.0,
           norm_k=128, grad_clip_max_norm=10.0)
LR = 1e-3
CONFIGS = {
    "newton_arm": dict(ARM),
    # the on-the-fly init scale, momentum, classic decay and a clip that binds
    "init_scale_momentum_classic_wd": dict(
        preconditioner_max_skew=2.0, preconditioner_init_scale=None,
        momentum=0.9, norm_k=128, grad_clip_max_norm=0.05, weight_decay=0.01,
        weight_decay_mode="classic"),
    "llama_newton_arm": dict(ARM, model="llama"),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_three_newton_steps_match_jax(name):
    """f64 parameters and Q on both sides, p = 1.0, the JAX draws replayed,
    the JAX side fed an exact hvp_fn (jvp over grad) and the port its
    double backward: parameters within 1e-5 of each leaf's largest entry,
    Q and L within rtol 1e-6 (the tolerances of the whitening test
    ``test_three_steps_match_jax``)."""
    kw = dict(CONFIGS[name])
    pair, toks, jloss, jmask, tloss, tmask = MODELS[kw.pop("model", "gpt2")]
    params, cfgj, model = pair(torch.float64, jnp.float64)
    x, y = toks(1)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jo = jopt.kron_newton(learning_rate=LR, scanned_layers=jmask(params), **kw)
    state = jo.init(params)
    loss_of = lambda p: jloss(p, jx, jy, cfgj)

    @jax.jit
    def jstep(p, s):
        upd, s = jo.update(jax.grad(loss_of)(p), s, p,
                           hvp_fn=jopt.make_hvp_fn(loss_of))
        return optax.apply_updates(p, upd), s

    to = kron_newton(model.named_parameters(), learning_rate=LR, device="cpu",
                     scanned_layers=tmask(model), draw=jax_draw, **kw)
    for _ in range(3):
        params, state = jstep(params, state)
        loss = to.step(lambda: tloss(model, tx, ty))
        assert loss.ndim == 0 and torch.isfinite(loss)
    assert to.fit_steps == 3
    got = dict(model.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    precond = [s for s in state if hasattr(s, "precond")][0].precond
    for (path, ref), st in zip(flat, precond):
        leaf = ".".join(k.key for k in path)
        p = got[leaf]
        ref = np.asarray(ref)
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=leaf)
        for a, b in zip(to.state[p]["q"], st.q):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max(), err_msg=leaf)
        for a, b in zip(to.state[p]["lips"], st.lips):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       err_msg=leaf)


def test_gate_fits_first_and_at_the_drawn_steps():
    """p = 0.1: the port fits on step 0 (the count-0 clause) and exactly on
    the steps where the JAX key chain's float32 gate uniform is below 0.1
    (key, k_gate, k_v, k_fit = split(key, 4)); Q is untouched otherwise."""
    _, _, model = MODELS["gpt2"][0]()
    x, y = (torch.from_numpy(t) for t in MODELS["gpt2"][1](2))
    opt = KronNewton(model.named_parameters(), lr=LR, device="cpu", seed=1,
                     preconditioner_update_probability=0.1,
                     scanned_layers=MODELS["gpt2"][5](model), **ARM)
    key = jax.random.PRNGKey(1)
    expected, fits = [], []
    first = next(iter(model.parameters()))
    for step in range(12):
        key, k_gate, _, _ = jax.random.split(key, 4)
        expected.append(step == 0 or
                        bool(jax.random.uniform(k_gate, dtype=jnp.float32) < 0.1))
        q_before = opt.state[first]["q"][0].clone()
        n0 = opt.fit_steps
        opt.step(lambda: MODELS["gpt2"][4](model, x, y))
        fits.append(opt.fit_steps > n0)
        assert torch.equal(q_before, opt.state[first]["q"][0]) != fits[-1]
    assert fits == expected
    assert fits[0] and 1 < sum(fits) < 12


def test_finite_diff_steps_track_the_exact_ones():
    """exact_hessian_vector_product=False fits from finite differences
    (float32 parameters, delta = eps^(1/2) = 3.5e-4): three steps land
    within 5% (Frobenius-relative over all leaves) of the exact Hvp's
    parameter change."""
    changes = []
    for exact in (True, False):
        _, _, model = MODELS["gpt2"][0]()
        p0 = [p.detach().clone() for p in model.parameters()]
        x, y = (torch.from_numpy(t) for t in MODELS["gpt2"][1](3))
        opt = KronNewton(model.named_parameters(), lr=LR, device="cpu",
                         exact_hessian_vector_product=exact,
                         scanned_layers=MODELS["gpt2"][5](model), **ARM)
        for _ in range(3):
            opt.step(lambda: MODELS["gpt2"][4](model, x, y))
        changes.append(torch.cat([(p.detach() - q).flatten() for p, q in
                                  zip(model.parameters(), p0)]))
    rel = ((changes[1] - changes[0]).norm() / changes[0].norm()).item()
    assert rel < 0.05, rel


def test_newton_unported_options_raise():
    _, _, model = MODELS["gpt2"][0]()
    # stack_sharding and factor_sharding are ported
    # (tests/test_torch_parallel.py, tests/test_torch_factor_sharding.py); a
    # factor_sharding map that names no parameter is refused
    with pytest.raises(ValueError, match="placements do not match params"):
        KronNewton(model.named_parameters(), device="cpu",
              factor_sharding=("mesh", {}))
    # a geometry other than Q0.5EQ1.5 constructs and steps
    x, y = (torch.from_numpy(t) for t in MODELS["gpt2"][1](1))
    qeq = KronNewton(model.named_parameters(), device="cpu", dq="QEQ", **ARM)
    loss = qeq.step(lambda: MODELS["gpt2"][4](model, x, y))
    assert qeq.plans[0].dq == "QEQ" and qeq.fit_steps == 1
    assert torch.isfinite(loss) and all(torch.isfinite(p).all()
                                        for p in model.parameters())
    with pytest.raises(TypeError, match="share_fit_apply"):
        KronNewton(model.named_parameters(), device="cpu", share_fit_apply=True)
    opt = KronNewton(model.named_parameters(), device="cpu")
    with pytest.raises(ValueError, match="closure"):
        opt.step()
