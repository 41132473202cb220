"""Complex (complex128) and float64 Kron preconditioning in the port against
the JAX package on replayed draws: the whitening and Newton fits of all
seven geometries per tensor and stacked, orders 0-3, the apply and its
cached form, the exact EQ whitening, the balancing, the XLA tail of the
NS update (``kernels.ns_route`` "xla") and the linear algebra it runs, in
complex128.  Tolerance: rtol 1e-9 with an atol of 1e-9 of the largest
entry (``_compare_states``); the linear algebra 1e-10.

The JAX side draws its complex probes and bound starts with
``jax.random.normal(key, shape, complex)`` and its damping noise as
(u(kr) s + 1j u(ki) s) with (kr, ki) = split(key); ``jax_draw`` replays the
first for both, which differ in the last bit of each part only."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_torch_tpu.ops import linalg as jlinalg
from psgd_torch_tpu.precond import kron as jkron
from psgd_torch_tpu.precond.kron import _ns_tail_stacked_xla
from psgd_torch_tpu_torch.ops import fastrand, kernels
from psgd_torch_tpu_torch.ops import linalg as tlinalg
from psgd_torch_tpu_torch.precond import kron as tkron
from test_torch_kron import _compare_states, jax_draw, to_np

RTOL = 1e-9
FITS = 2
# scalar, diagonal, one dense factor, dense x diagonal, dense x dense, three
# dense factors
SHAPES = {"scalar": ((), 1.0), "diag": ((6,), 1.0), "matrix": ((6,), float("inf")),
          "kron_diag_matrix": ((8, 12), 1.0),
          "kron_matrix_matrix": ((4, 6), float("inf")),
          "kron3": ((2, 3, 4), float("inf"))}


def _cn(rng, shape):
    """A complex128 standard normal array (unit variance per part)."""
    return np.asarray(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))


def complex_state(shape, skew, dq, seed, batch=None, dtype=np.complex128):
    """Random complex factors for geometry ``dq``: 1 + 0.1 noise on the
    diagonal ones, I + 0.1 noise on the dense ones (upper triangular for
    EQ), real L in [0.5, ...).  Returns (port plan, port state, JAX state,
    JAX plan)."""
    rng = np.random.default_rng(seed)
    plan = tkron.make_kron_plan(shape, max_skew=skew, dq=dq)
    lead = () if batch is None else (batch,)
    qs, lips = [], []
    for n, diag in zip(plan.shape or (1,), plan.is_diag):
        if not plan.shape:
            q = 1.0 + 0.1 * _cn(rng, lead)
        elif diag:
            q = 1.0 + 0.1 * _cn(rng, lead + (n,))
        else:
            q = np.eye(n) + 0.1 * _cn(rng, lead + (n, n))
            if dq == "EQ":
                q = np.triu(q)
        qs.append(np.asarray(q if np.dtype(dtype).kind == "c" else q.real, dtype))
        lips.append(np.abs(rng.standard_normal(lead)) + 0.5)
    t = tkron.KronState(q=tuple(torch.from_numpy(q) for q in qs),
                        lips=tuple(torch.from_numpy(np.asarray(l)) for l in lips))
    j = jkron.KronState(q=tuple(jnp.asarray(q) for q in qs),
                        lips=tuple(jnp.asarray(l) for l in lips))
    return plan, t, j, jkron.make_kron_plan(shape, max_skew=skew, dq=dq)


@functools.lru_cache(maxsize=None)
def jax_fit(name, jplan, **kw):
    """A JAX package fit with its plan and options bound, jitted once."""
    return jax.jit(functools.partial(getattr(jkron, name), plan=jplan, **kw))


def _fits(dq, case, mode, batch, seed=1):
    """FITS fits on both sides from one random complex state, each on fresh
    sources and key; yields (port state, JAX state) after each."""
    shape, skew = SHAPES[case]
    plan, ts, js, jplan = complex_state(shape, skew, dq, seed, batch)
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(seed + 100)
    name = f"update_kron_{mode}" + ("" if batch is None else "_stacked")
    port = getattr(tkron, name)
    ref = jax_fit(name, jplan, lr=0.2, norm_k=8)
    for t in range(FITS):
        key = fastrand.fold_in(fastrand.prng_key(31), t)
        key = key if batch is None else fastrand.split(key, batch)
        kk = {"key" if batch is None else "keys": jnp.asarray(key)}
        srcs = [_cn(rng, lead + shape) for _ in range(1 if mode == "whiten" else 2)]
        out = port(ts, plan, *map(torch.from_numpy, srcs), key, lr=0.2,
                   norm_k=8, draw=jax_draw)
        names = ("g",) if mode == "whiten" else ("v", "h")
        jout = ref(js, **dict(zip(names, map(jnp.asarray, srcs))), **kk)
        yield out, jout
        ts, js = out, jout


@pytest.mark.parametrize("mode", ["whiten", "newton"])
@pytest.mark.parametrize("dq", tkron.ALL_DQ)
def test_fit_matches_jax(dq, mode):
    """Two fits of a complex128 (8, 12) tensor (a dense and a diagonal
    factor) in each geometry, whitening and Newton, against the JAX
    package's on replayed draws: Q and L within rtol 1e-9, Q complex."""
    for out, ref in _fits(dq, "kron_diag_matrix", mode, None):
        assert all(f.dtype == torch.complex128 for f in out.q)
        _compare_states(out, ref, RTOL)


@pytest.mark.parametrize("dq", tkron.ALL_DQ)
def test_whiten_fit_stacked_matches_jax(dq):
    """The whitening fit of a stack of two complex128 (2, 3, 4) layers
    (three dense factors) in one call against JAX's stacked update."""
    for out, ref in _fits(dq, "kron3", "whiten", 2):
        _compare_states(out, ref, RTOL)


@pytest.mark.parametrize("dq", ["Q0.5EQ1.5", "PRO4P", "EQ"])
def test_newton_fit_stacked_matches_jax(dq):
    """The Newton fit of a stack of two complex128 (4, 6) layers: the XLA
    tail (Q0.5EQ1.5), the Procrustes loop (PRO4P), the triangular solves
    of conj(v) (EQ)."""
    for out, ref in _fits(dq, "kron_matrix_matrix", "newton", 2):
        _compare_states(out, ref, RTOL)


@pytest.mark.parametrize("case", ["scalar", "diag", "matrix", "kron_matrix_matrix",
                                  "kron3"])
def test_q05eq15_orders_match_jax(case):
    """Q0.5EQ1.5 whitening of one complex128 tensor of each order 0-3."""
    for out, ref in _fits("Q0.5EQ1.5", case, "whiten", None):
        _compare_states(out, ref, RTOL)


@pytest.mark.parametrize("case", ["scalar", "kron_diag_matrix"])
def test_newton_orders_stacked_match_jax(case):
    """Q0.5EQ1.5 Newton fit of a complex128 stack of three layers, orders 0
    and 2 (order 3 stacked: the whitening fits above)."""
    for out, ref in _fits("Q0.5EQ1.5", case, "newton", 3):
        _compare_states(out, ref, RTOL)


@pytest.mark.parametrize("dq", ["QUAD", "QEP"])
def test_fit_stays_hermitian(dq):
    """QUAD symmetrizes as (p + p^H) / 2: its dense factors stay Hermitian
    to rounding; QEP's do not have to.  Both keep a Hermitian positive P =
    Q^H Q."""
    out = None
    for out, _ in _fits(dq, "kron_matrix_matrix", "whiten", None):
        pass
    for f in out.q:
        p = (f.mH @ f).numpy()
        np.testing.assert_allclose(p, p.conj().T, rtol=0, atol=1e-13)
        assert np.linalg.eigvalsh(p).min() > 0
        if dq == "QUAD":
            np.testing.assert_allclose(f.numpy(), f.numpy().conj().T, rtol=0,
                                       atol=1e-13)


# ---------------------------------------------------------------------------
# the apply, its cached form, the exact EQ whitening, the balancing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["scalar", "kron_diag_matrix", "kron3"])
def test_precond_grad_matches_jax(case):
    """P g = Q^H Q g of a complex128 tensor, rtol 1e-12; and for the fit-P
    geometry PRO4P, Q g."""
    shape, skew = SHAPES[case]
    g = _cn(np.random.default_rng(2), shape)
    for dq in ("Q0.5EQ1.5", "PRO4P"):
        plan, ts, js, jplan = complex_state(shape, skew, dq, 3)
        out = tkron.precond_grad(ts, plan, torch.from_numpy(g))
        ref = np.asarray(jkron.precond_grad(js, jplan, jnp.asarray(g)))
        np.testing.assert_allclose(to_np(out), ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("case", ["kron_diag_matrix", "kron3"])
def test_cached_apply_matches_jax(case):
    """P_i = Q_i^H Q_i (|q_i|^2 diagonal) and the one-pass apply, per tensor
    and for a stack of two layers, against JAX's compute_p_factors and
    precond_grad_cached (the stack: per layer), rtol 1e-12."""
    shape, skew = SHAPES[case]
    g = _cn(np.random.default_rng(4), (2,) + shape)
    plan, ts, js, jplan = complex_state(shape, skew, "QEQ", 5, batch=2)
    pcs = tkron.compute_p_factors(ts, plan)
    out = tkron.precond_grad_cached_stacked(pcs, plan, torch.from_numpy(g))
    for i in range(2):
        jst = jkron.KronState(q=tuple(f[i] for f in js.q),
                              lips=tuple(l[i] for l in js.lips))
        jpc = jkron.compute_p_factors(jst, jplan)
        for a, b in zip(pcs, jpc):
            np.testing.assert_allclose(to_np(a[i]), np.asarray(b), rtol=1e-12,
                                       atol=1e-12)
        ref = np.asarray(jkron.precond_grad_cached(jpc, jplan, jnp.asarray(g[i])))
        np.testing.assert_allclose(to_np(out[i]), ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())
        one = tkron.precond_grad(
            tkron.KronState(tuple(f[i] for f in ts.q), ()), plan,
            torch.from_numpy(g[i]))
        np.testing.assert_allclose(to_np(one), ref, rtol=1e-11,
                                   atol=1e-11 * np.abs(ref).max())


@pytest.mark.parametrize("normalizer", ["2nd", "1st"])
def test_eq_exact_matches_jax(normalizer):
    """update_kron_whiten_eq_exact of a complex128 (8, 12) tensor, both
    step normalizers: Q^-H Q^-1 and the legacy bound of a complex matrix,
    two fits, rtol 1e-9."""
    shape, skew = SHAPES["kron_diag_matrix"]
    plan, ts, js, jplan = complex_state(shape, skew, "EQ", 6)
    rng = np.random.default_rng(7)
    ref_fit = jax_fit("update_kron_whiten_eq_exact", jplan, lr=0.2,
                      step_normalizer=normalizer)
    for t in range(FITS):
        g = _cn(rng, shape)
        key = fastrand.fold_in(fastrand.prng_key(8), t)
        out = tkron.update_kron_whiten_eq_exact(
            ts, plan, torch.from_numpy(g), key, lr=0.2,
            step_normalizer=normalizer, draw=jax_draw)
        ref = ref_fit(js, g=jnp.asarray(g), key=jnp.asarray(key))
        _compare_states(out, ref, RTOL)
        ts, js = out, ref


def test_balance_kron_matches_jax():
    """balance_kron on complex factors 50x apart: real multipliers (the
    factors' phases kept), max |f| equal across factors, as JAX's."""
    plan, ts, js, jplan = complex_state((4, 6), float("inf"), "QEQ", 9)
    q = (ts.q[0] * 50.0, ts.q[1])
    out = tkron.balance_kron(q)
    ref = jkron.balance_kron((js.q[0] * 50.0, js.q[1]))
    for a, b, f in zip(out, ref, q):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-13, atol=0)
        ratio = (a / f).numpy()
        np.testing.assert_allclose(ratio.imag, 0.0, atol=1e-15)
    assert abs(out[0].abs().max() / out[1].abs().max() - 1.0) < 1e-12


# ---------------------------------------------------------------------------
# the XLA tail (ns_route "xla") and its linear algebra
# ---------------------------------------------------------------------------


def test_ns_route_is_xla_for_the_xla_dtypes():
    """ns_route sends exactly float64, complex64 and complex128 to "xla", at
    every width; f32 and bf16 keep their kernel routes."""
    for n in (128, 768, 1536, 2048, 3072, 4096, 5000):
        for dt in (torch.float64, torch.complex64, torch.complex128):
            assert kernels.ns_route(n, dt) == "xla"
        for dt in (torch.float32, torch.bfloat16):
            assert kernels.ns_route(n, dt) in kernels.NS_ROUTES
    assert set(kernels.XLA_DTYPES) == {torch.float64, torch.complex64,
                                       torch.complex128}
    with pytest.raises(TypeError, match="XLA tail"):
        kernels.xla_ns_update(*_tail_inputs(torch.float32)[:7])


def _tail_inputs(dtype, b=3, n=24, seed=11):
    """A Hermitian positive term1 stack and Q = I + noise (complex for a
    complex dtype), L, term2 and seed words."""
    rng = np.random.default_rng(seed)
    cx = torch.tensor([], dtype=dtype).is_complex()
    x = _cn(rng, (b, n, 2 * n)) if cx else rng.standard_normal((b, n, 2 * n))
    term1 = x @ np.conj(np.swapaxes(x, 1, 2)) / (2 * n) + 0.5 * np.eye(n)
    q = np.eye(n) + 0.05 * (_cn(rng, (b, n, n)) if cx else
                            rng.standard_normal((b, n, n)))
    lips = torch.tensor([0.0, 2.0, 40.0], dtype=torch.float64)
    term2 = torch.tensor([3.0, 3.0, 0.5], dtype=torch.float64)
    seeds = kernels.key_seed_words(fastrand.split(fastrand.prng_key(seed), b), "cpu")
    return (torch.from_numpy(term1).to(dtype), torch.from_numpy(q).to(dtype),
            lips, term2, seeds, 0.1, 0.9)


@pytest.mark.parametrize("dtype", ["complex128", "float64"])
@pytest.mark.parametrize("step_mat", [False, True])
def test_xla_route_matches_jax_tail(dtype, step_mat):
    """fused_ns_update on the "xla" route (chosen by dtype, no route named)
    against JAX's _ns_tail_stacked_xla on the same replayed starts, with
    and without a step matrix, rtol 1e-10; counted in
    ``xla_ns_update.launches``."""
    dt = getattr(torch, dtype)
    term1, q, lips, term2, seeds, lr, beta = _tail_inputs(dt)
    b, n = q.shape[0], q.shape[-1]
    s_mat = term1 - 0.3 * torch.eye(n, dtype=dt) if step_mat else None
    root = jax.random.split(jax.random.PRNGKey(n), 2 * b)
    kb, kp = root[:b], root[b:]
    jdt = jnp.complex128 if dtype == "complex128" else jnp.float64
    starts = tuple(torch.from_numpy(np.array(jax.vmap(
        lambda kk: jax.random.normal(kk, (8, n), jdt))(keys))) for keys in (kb, kp))
    kernels.reset_launch_counts()
    out_q, out_l = kernels.fused_ns_update(term1, q, lips, term2, seeds, lr, beta,
                                           k=8, starts=starts, step_mat=s_mat)
    assert kernels.xla_ns_update.launches == 1
    assert kernels.xla_ns_update.step_mat_launches == int(step_mat)
    assert kernels.fused_ns_update.launches == 0
    ref_q, ref_l = _ns_tail_stacked_xla(
        jnp.asarray(q.numpy()), jnp.asarray(term1.numpy()), jnp.asarray(lips.numpy()),
        jnp.asarray(term2.numpy()), kb, kp, lr, beta, 8,
        step_mat=None if s_mat is None else jnp.asarray(s_mat.numpy()))
    np.testing.assert_allclose(to_np(out_q), np.asarray(ref_q), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(out_l.numpy(), np.asarray(ref_l), rtol=1e-10)


def test_xla_route_complex64_keeps_its_dtypes():
    """complex64: Q stays complex64, L float32, close to the complex128
    computation (rtol 1e-4), drawing its starts from the seeds."""
    args = _tail_inputs(torch.complex64)
    args = args[:2] + (args[2].float(), args[3].float()) + args[4:]
    out_q, out_l = kernels.fused_ns_update(*args, k=8)
    wide = _tail_inputs(torch.complex128)
    ref_q, ref_l = kernels.fused_ns_update(*wide, k=8)
    assert out_q.dtype == torch.complex64 and out_l.dtype == torch.float32
    np.testing.assert_allclose(to_np(out_q), to_np(ref_q), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out_l.numpy(), ref_l.numpy(), rtol=1e-4)


def _hpd(rng, n, b):
    x = _cn(rng, (b, n, 2 * n))
    return x @ np.conj(np.swapaxes(x, 1, 2)) / (2 * n)


def _cstart(keys, k, n):
    """The complex128 starts JAX's bounds draw from ``keys``."""
    return torch.from_numpy(np.array(jax.vmap(
        lambda kk: jax.random.normal(kk, (k, n), jnp.complex128))(keys)))


@pytest.mark.parametrize("mode", ["spd", "skh"])
def test_norm_bounds_complex_match_jax(mode):
    """norm_lower_bound_spd on Hermitian and _skh on skew-Hermitian complex128
    matrices (sgn, the row energies Re(a conj a), the start rotated toward
    the largest row), a stack of three against JAX per matrix, rtol
    1e-10; the bound is at most the norm."""
    rng = np.random.default_rng(12)
    a = _hpd(rng, 20, 3)
    if mode == "skh":
        a = a - np.conj(np.swapaxes(a, 1, 2)) + 1j * np.eye(20)
    keys = jax.random.split(jax.random.PRNGKey(13), 3)
    fn = tlinalg.norm_lower_bound_spd if mode == "spd" else tlinalg.norm_lower_bound_skh
    jfn = jlinalg.norm_lower_bound_spd if mode == "spd" else jlinalg.norm_lower_bound_skh
    out = fn(torch.from_numpy(a), k=8, v0=_cstart(keys, 8, 20))
    assert out.dtype == torch.float64
    for i in range(3):
        ref = float(jfn(jnp.asarray(a[i]), keys[i], k=8))
        np.testing.assert_allclose(out[i].item(), ref, rtol=1e-10)
        assert out[i].item() <= np.linalg.norm(a[i], 2) * (1 + 1e-12)


def test_procrustes_steps_complex_match_jax():
    """procrustes_step2 and procrustes_step3 (R = Q^H - Q) of complex128
    stacks against JAX per matrix, rtol 1e-10; each moves Q toward
    Hermitian."""
    rng = np.random.default_rng(14)
    q = np.eye(12) + 0.2 * _cn(rng, (3, 12, 12))
    keys = fastrand.split(fastrand.prng_key(15), 3)
    v0 = jax_draw("normal", keys, (8, 12), torch.complex128)
    two = tlinalg.procrustes_step2(torch.from_numpy(q), norm_k=8, v0=v0)
    three = tlinalg.procrustes_step3(torch.from_numpy(q),
                                     kernels.key_seed_words(keys, "cpu"),
                                     norm_k=8, v0=v0)
    asym = lambda m: np.abs(m - m.conj().T).max()   # noqa: E731
    for i in range(3):
        k = jnp.asarray(keys[i])
        for out, jfn in ((two, jlinalg.procrustes_step2),
                         (three, jlinalg.procrustes_step3)):
            ref = np.asarray(jfn(jnp.asarray(q[i]), k, norm_k=8))
            np.testing.assert_allclose(out[i].numpy(), ref, rtol=1e-10, atol=1e-12)
            assert asym(out[i].numpy()) < asym(q[i])


def test_procrustes_loop3_complex_matches_jax():
    """The masked loop on a complex128 stack (layers that leave on
    different steps) against JAX's while loop per layer, rtol 1e-10."""
    rng = np.random.default_rng(16)
    base = np.eye(10) + 0.1 * _cn(rng, (10, 10))
    herm = (base + base.conj().T) / 2
    skew = (base - base.conj().T) / 2
    q = np.stack([herm + s * skew for s in (1e-6, 0.2, 1.0)])
    keys = fastrand.split(fastrand.prng_key(17), 3)
    out = tlinalg.procrustes_loop3(torch.from_numpy(q), keys, norm_k=8,
                                   draw=jax_draw)
    for i in range(3):
        ref = jlinalg.procrustes_loop3(jnp.asarray(q[i]), jnp.asarray(keys[i]),
                                       norm_k=8)
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref), rtol=1e-10,
                                   atol=1e-12)


def test_norm_lower_bound_legacy_complex_matches_jax():
    """The legacy row/column-energy bound of complex matrices (|a|^2
    energies, conjugated products) against JAX's per matrix, rtol 1e-12,
    a largest row and a largest column."""
    rng = np.random.default_rng(18)
    a = _cn(rng, (2, 9, 9))
    a[0, 2] *= 10.0
    a[1, :, 4] *= 10.0
    out = tlinalg.norm_lower_bound(torch.from_numpy(a)).numpy()
    ref = np.array([float(jlinalg.norm_lower_bound(jnp.asarray(m))) for m in a])
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=0)
    assert np.all(out <= np.linalg.norm(a, ord=2, axis=(1, 2)) * (1 + 1e-12))


def test_sgn_and_row_norms_complex():
    """sgn(x) = x / |x| with sgn(0) = 0, and the row norms sqrt(sum |v|^2),
    as JAX's on complex128."""
    x = np.array([3 + 4j, 0j, -2j, 1e-300 + 0j])
    np.testing.assert_allclose(tlinalg.sgn(torch.from_numpy(x)).numpy(),
                               np.asarray(jlinalg.sgn(jnp.asarray(x))), rtol=1e-15)
    v = _cn(np.random.default_rng(19), (3, 7))
    np.testing.assert_allclose(tlinalg._row_norms(torch.from_numpy(v)).numpy(),
                               np.asarray(jlinalg._row_norms(jnp.asarray(v))),
                               rtol=1e-15)


def test_f64_geometries_run_the_xla_tail_and_bounds():
    """A float64 fit takes the XLA tail (Q0.5EQ1.5) and the XLA tail's
    bounds and skew part (the other geometries) on every device: on the
    CPU it launches and counts no kernel, and agrees with JAX at 1e-9."""
    kernels.reset_launch_counts()
    shape, skew = (4, 6), float("inf")
    for dq in ("Q0.5EQ1.5", "PRO4P"):
        plan, ts, js, jplan = complex_state(shape, skew, dq, 20, dtype=np.float64)
        g = np.random.default_rng(21).standard_normal(shape)
        key = fastrand.prng_key(22)
        out = tkron.update_kron_whiten(ts, plan, torch.from_numpy(g), key, lr=0.2,
                                       norm_k=8, draw=jax_draw)
        ref = jax_fit("update_kron_whiten", jplan, lr=0.2, norm_k=8)(
            js, g=jnp.asarray(g), key=jnp.asarray(key))
        _compare_states(out, ref, RTOL)
    assert kernels.xla_ns_update.launches == 2      # two dense factors
    assert kernels.fused_ns_update.launches == 0
