"""The port's Kron preconditioner (psgd_torch_tpu_torch.precond.kron)
against the JAX package's, on replayed draws, in float64.

Also holds ``jax_draw``, the replay hook the other test_torch_* files use:
it makes the JAX package's own draws (threefry normal / uniform) from the
key data the port derives, so both sides see the same random numbers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_torch_tpu.precond import kron as jkron
from psgd_torch_tpu_torch.ops import fastrand
from psgd_torch_tpu_torch.precond import kron as tkron

_JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32,
        torch.bfloat16: jnp.bfloat16, torch.complex128: jnp.complex128,
        torch.complex64: jnp.complex64}


@functools.lru_cache(maxsize=None)
def _drawer(kind, shape, dtype):
    """The batched draw of one kind, shape and dtype, traced once."""
    if kind == "normal":
        return jax.jit(jax.vmap(lambda k: jax.random.normal(k, shape,
                                                            _JDT[dtype])))
    return jax.jit(jax.vmap(lambda k: jax.random.uniform(k, shape)))


def jax_draw(kind, keys, shape, dtype):
    """Replay hook: the JAX package's draws for the port's (B, 2) keys.
    "normal" as jax.random.normal(key, shape, dtype) (the damping probe and
    the bound starts; complex for a complex dtype, as the JAX package draws
    its complex probes and starts); "uniform" as jax.random.uniform(key) in
    JAX's default float type (the fit and balance gates)."""
    ks = jnp.asarray(np.asarray(keys, np.uint32))
    out = _drawer(kind, tuple(shape), dtype)(ks)
    wide = jnp.complex128 if dtype.is_complex else jnp.float64
    return torch.from_numpy(np.array(out.astype(wide))).to(dtype)


def to_np(x):
    """A tensor or array as float64, complex128 if it is complex."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return np.asarray(x.to(torch.complex128 if x.is_complex()
                               else torch.float64))
    x = np.asarray(x)
    return x.astype(np.complex128 if np.iscomplexobj(x) else np.float64)


# the 124M leaves (per layer for the stacked ones), bench max_skew 2.0
GPT2_124M_SHAPES = [(768,), (768, 768), (2304,), (768, 2304), (3072,),
                    (768, 3072), (3072, 768), (1024, 768), (50304, 768)]


@pytest.mark.parametrize("max_skew", [1.0, 2.0])
def test_plan_is_diag_matches_jax(max_skew):
    for shape in GPT2_124M_SHAPES + [(), (1, 5), (4, 5, 6)]:
        tp = tkron.make_kron_plan(shape, max_skew=max_skew)
        jp = jkron.make_kron_plan(shape, max_skew=max_skew)
        assert tp.is_diag == jp.is_diag, shape
        assert tp.numel == jp.numel and tp.shape == jp.shape


def test_plan_rules_and_limits():
    assert tkron.canonical_dq("Q0p5EQ1p5") == "Q0.5EQ1.5"
    with pytest.raises(ValueError):
        tkron.canonical_dq("XYZ")
    with pytest.raises(ValueError):
        tkron.make_kron_plan((1,) * 27)
    # every geometry fits (QEQ here; the others in test_torch_kron_geometries)
    st, plan = tkron.init_kron((4, 5), dq="QEQ", dtype=torch.float64,
                               device="cpu")
    g = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 5)))
    out = tkron.update_kron_whiten(st, plan, g, fastrand.prng_key(0))
    assert plan.dq == "QEQ" and out.q[0].shape == (4, 4)
    assert all(torch.isfinite(f).all() for f in out.q + out.lips)
    assert not torch.equal(out.q[0], st.q[0])


def test_init_kron_defaults_to_the_card(monkeypatch):
    """init_kron and init_kron_from_plan resolve their device as every entry
    point does: without a card and without a device they raise; with
    device="cpu" they build the JAX package's state (max_skew 2 makes both
    factors of (4, 5) dense; scale 4 gives 2 I per factor)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkron.init_kron((4, 5))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkron.init_kron_from_plan(tkron.make_kron_plan((4, 5)))
    st, plan = tkron.init_kron((4, 5), scale=4.0, max_skew=2.0, device="cpu")
    jst, jplan = jkron.init_kron((4, 5), scale=4.0, max_skew=2.0)
    assert plan.is_diag == jplan.is_diag == (False, False)
    for t, j in zip(st.q + st.lips, jst.q + jst.lips):
        assert t.device.type == "cpu" and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _random_state(shape, max_skew, seed, batch=None):
    """Random (not identity) Q factors so the apply is a real test."""
    rng = np.random.default_rng(seed)
    plan = tkron.make_kron_plan(shape, max_skew=max_skew)
    lead = () if batch is None else (batch,)
    qs, lips = [], []
    for n, diag in zip(plan.shape or (1,), plan.is_diag):
        if not plan.shape:
            q = np.asarray(1.0 + 0.1 * rng.standard_normal(lead))
        elif diag:
            q = 1.0 + 0.1 * rng.standard_normal(lead + (n,))
        else:
            q = np.eye(n) + 0.1 * rng.standard_normal(lead + (n, n))
        qs.append(q)
        lips.append(np.abs(rng.standard_normal(lead)) + 0.5)
    t = tkron.KronState(q=tuple(torch.from_numpy(np.asarray(q)) for q in qs),
                        lips=tuple(torch.from_numpy(np.asarray(l)) for l in lips))
    j = jkron.KronState(q=tuple(jnp.asarray(q) for q in qs),
                        lips=tuple(jnp.asarray(l) for l in lips))
    return plan, t, j, jkron.make_kron_plan(shape, max_skew=max_skew)


SHAPES = [((12, 20), 2.0), ((16, 40), 2.0), ((6,), 1.0), ((3, 4, 5), float("inf")),
          ((), 1.0)]


@pytest.mark.parametrize("shape,skew", SHAPES)
def test_precond_grad_matches_jax(shape, skew):
    """f64, rtol 1e-12: the same products in another order."""
    plan, ts, js, jplan = _random_state(shape, skew, 1)
    g = np.random.default_rng(2).standard_normal(shape)
    out = tkron.precond_grad(ts, plan, torch.from_numpy(g))
    ref = jkron.precond_grad(js, jplan, jnp.asarray(g))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(ref)).max())


def _compare_states(ts, js, rtol):
    for a, b in zip(ts.q, js.q):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=rtol,
                                   atol=rtol * np.abs(np.asarray(b)).max())
    for a, b in zip(ts.lips, js.lips):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=rtol)


@pytest.mark.parametrize("shape,skew", SHAPES)
def test_update_kron_whiten_matches_jax(shape, skew):
    """One Q0.5EQ1.5 whitening fit on replayed draws, f64, rtol 1e-9."""
    plan, ts, js, jplan = _random_state(shape, skew, 3)
    g = np.random.default_rng(4).standard_normal(shape)
    key = fastrand.fold_in(fastrand.prng_key(5), 3)
    out = tkron.update_kron_whiten(ts, plan, torch.from_numpy(g), key, lr=0.2,
                                   norm_k=8, draw=jax_draw)
    ref = jkron.update_kron_whiten(js, jplan, jnp.asarray(g), jnp.asarray(key),
                                   lr=0.2, norm_k=8)
    _compare_states(out, ref, 1e-9)


@pytest.mark.parametrize("shape,skew", [((16, 40), 2.0), ((24, 24), 1.0),
                                        ((8,), 1.0)])
def test_update_kron_whiten_stacked_matches_jax(shape, skew):
    """A layer stack (B = 3) in one call against the JAX stacked update,
    f64 on replayed draws, rtol 1e-9."""
    plan, ts, js, jplan = _random_state(shape, skew, 6, batch=3)
    g = np.random.default_rng(7).standard_normal((3,) + shape)
    keys = fastrand.split(fastrand.prng_key(8), 3)
    out = tkron.update_kron_whiten_stacked(ts, plan, torch.from_numpy(g), keys,
                                           norm_k=8, draw=jax_draw)
    ref = jkron.update_kron_whiten_stacked(js, jplan, jnp.asarray(g),
                                           jnp.asarray(keys), norm_k=8)
    _compare_states(out, ref, 1e-9)


def test_balance_matches_jax():
    """The balance rescaling itself, and the gate taking it per layer."""
    plan, ts, js, _ = _random_state((16, 40), 2.0, 9, batch=3)
    ts = tkron.KronState(q=(ts.q[0] * 50.0, ts.q[1]), lips=ts.lips)
    out = tkron.balance_kron(ts.q, batched=True)
    for i in range(3):
        ref = jkron.balance_kron(tuple(jnp.asarray(to_np(f[i])) for f in ts.q))
        for a, b in zip(out, ref):
            np.testing.assert_allclose(to_np(a[i]), np.asarray(b), rtol=1e-12)
    gated = tkron._maybe_balance(ts.q, [0.5, 0.001, 0.5])
    for a, b, f in zip(gated, out, ts.q):
        assert torch.equal(a[1], b[1])
        assert torch.equal(a[0], f[0]) and torch.equal(a[2], f[2])


def test_apply_and_fit_do_not_use_opt_einsum():
    """Same bits with torch's opt_einsum path optimiser disabled, as on the
    card (where opt_einsum is not installed)."""
    plan, ts, _, _ = _random_state((16, 40), 2.0, 10, batch=2)
    g = torch.from_numpy(np.random.default_rng(11).standard_normal((2, 16, 40)))
    keys = fastrand.split(fastrand.prng_key(12), 2)

    def run():
        pg = tkron.precond_grad_stacked(ts, plan, g)
        st = tkron.update_kron_whiten_stacked(ts, plan, g, keys, norm_k=8)
        return (pg,) + st.q + st.lips

    before = run()
    prev = torch.backends.opt_einsum.enabled
    torch.backends.opt_einsum.enabled = False
    try:
        after = run()
    finally:
        torch.backends.opt_einsum.enabled = prev
    for a, b in zip(before, after):
        assert torch.equal(a, b)


def test_damped_matches_jax():
    """The single-tensor damping g + (damping + eps|g|) v on the JAX probe,
    f64, exact up to rounding (rtol 1e-15)."""
    g = np.random.default_rng(13).standard_normal((6, 9))
    key = fastrand.prng_key(14)
    v = jax_draw("normal", key[None], g.shape, torch.float64)[0]
    out = tkron._damped(torch.from_numpy(g), key, 1e-3, v=v)
    ref = jkron._damped(jnp.asarray(g), jnp.asarray(key), 1e-3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-15)
