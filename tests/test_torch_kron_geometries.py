"""The port's six other Kron geometries (EQ, QEP, QEQ, QUAD, QUAD4P, PRO4P):
their whitening fits per tensor and stacked, the exact EQ whitening and
the linear algebra they add (procrustes_step3, procrustes_loop3 and the
legacy norm_lower_bound) against the JAX package, in float64 on replayed
draws.  The optimizers' side is in test_torch_kron_geometries_optim.py,
the Newton fits in test_torch_kron_geometries_newton.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_torch_tpu.ops import linalg as jlinalg
from psgd_torch_tpu.precond import kron as jkron
from psgd_torch_tpu_torch.ops import fastrand, kernels
from psgd_torch_tpu_torch.ops import linalg as tlinalg
from psgd_torch_tpu_torch.precond import kron as tkron
from test_torch_kron import _compare_states, jax_draw, to_np

GEOMETRIES = ["EQ", "QEP", "QEQ", "QUAD", "QUAD4P", "PRO4P"]
# orders 0-3: a scalar, one dense factor, a dense and a diagonal factor
# mixed, three dense factors
SHAPES = {"order0": ((), 1.0), "order1": ((6,), float("inf")),
          "order2_mixed": ((16, 40), 2.0), "order3": ((3, 4, 5), float("inf"))}
STACKED = ["order0", "order2_mixed", "order3"]
FITS = 3


def geometry_state(shape, skew, dq, seed, batch=None):
    """Random (not identity) factors for geometry ``dq``: 1 + 0.1 noise on
    the diagonal ones, I + 0.1 noise on the dense ones (upper triangular
    for EQ, whose fit solves with them), L in [0.5, ...).  Returns (port
    plan, port state, JAX state, JAX plan)."""
    rng = np.random.default_rng(seed)
    plan = tkron.make_kron_plan(shape, max_skew=skew, dq=dq)
    lead = () if batch is None else (batch,)
    qs, lips = [], []
    for n, diag in zip(plan.shape or (1,), plan.is_diag):
        if not plan.shape:
            q = np.asarray(1.0 + 0.1 * rng.standard_normal(lead))
        elif diag:
            q = 1.0 + 0.1 * rng.standard_normal(lead + (n,))
        else:
            q = np.eye(n) + 0.1 * rng.standard_normal(lead + (n, n))
            if dq == "EQ":
                q = np.triu(q)
        qs.append(q)
        lips.append(np.abs(rng.standard_normal(lead)) + 0.5)
    t = tkron.KronState(q=tuple(torch.from_numpy(np.asarray(q)) for q in qs),
                        lips=tuple(torch.from_numpy(np.asarray(l)) for l in lips))
    j = jkron.KronState(q=tuple(jnp.asarray(q) for q in qs),
                        lips=tuple(jnp.asarray(l) for l in lips))
    return plan, t, j, jkron.make_kron_plan(shape, max_skew=skew, dq=dq)


@functools.lru_cache(maxsize=None)
def jax_fit(name, jplan, **kw):
    """A JAX package fit (``jkron.<name>``) with its plan and options bound,
    jitted once per (name, plan, options)."""
    return jax.jit(functools.partial(getattr(jkron, name), plan=jplan, **kw))


def _keys(t, batch):
    key = fastrand.fold_in(fastrand.prng_key(31), t)
    return key if batch is None else fastrand.split(key, batch)


def _whiten_fits(dq, case, batch, return_pg=False):
    """FITS whitening fits on both sides from one random state, each on a
    fresh gradient and key; yields (port result, JAX result) per fit."""
    shape, skew = SHAPES[case]
    plan, ts, js, jplan = geometry_state(shape, skew, dq, 32, batch)
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(33)
    name = "update_kron_whiten" if batch is None else "update_kron_whiten_stacked"
    port = getattr(tkron, name)
    ref = jax_fit(name, jplan, lr=0.2, norm_k=8, return_pg=return_pg)
    for t in range(FITS):
        g = rng.standard_normal(lead + shape)
        key = _keys(t, batch)
        out = port(ts, plan, torch.from_numpy(g), key, lr=0.2, norm_k=8,
                   draw=jax_draw, return_pg=return_pg)
        jout = ref(js, g=jnp.asarray(g),
                   **{"key" if batch is None else "keys": jnp.asarray(key)})
        yield out, jout
        ts, js = (out[0], jout[0]) if return_pg else (out, jout)


@pytest.mark.parametrize("case", sorted(SHAPES))
@pytest.mark.parametrize("dq", GEOMETRIES)
def test_whiten_fit_matches_jax(dq, case):
    """Three whitening fits of one tensor on replayed draws, f64: Q and L
    within rtol 1e-9 of the JAX package's after each fit."""
    for out, ref in _whiten_fits(dq, case, None):
        _compare_states(out, ref, 1e-9)


@pytest.mark.parametrize("case", STACKED)
@pytest.mark.parametrize("dq", GEOMETRIES)
def test_whiten_fit_stacked_matches_jax(dq, case):
    """Three whitening fits of a layer stack (B = 3) in one call each
    against the JAX stacked update (its vmap of the per-tensor update),
    f64 on replayed draws, rtol 1e-9."""
    for out, ref in _whiten_fits(dq, case, 3):
        _compare_states(out, ref, 1e-9)


@pytest.mark.parametrize("dq", [d for d in GEOMETRIES if d != "EQ"])
def test_return_pg_matches_jax(dq):
    """return_pg: the fit's P damped(g) with the pre-update Q (QEP: the
    balanced Q), per tensor and stacked, rtol 1e-9, with the same state."""
    for batch in (None, 3):
        for (out, pg), (ref, jpg) in _whiten_fits(dq, "order2_mixed", batch,
                                                   return_pg=True):
            _compare_states(out, ref, 1e-9)
            np.testing.assert_allclose(to_np(pg), np.asarray(jpg), rtol=1e-9,
                                       atol=1e-9 * np.abs(np.asarray(jpg)).max())


def test_return_pg_refused_for_eq():
    """EQ never forms P g: return_pg raises ValueError, as in JAX."""
    plan, ts, js, jplan = geometry_state((16, 40), 2.0, "EQ", 34)
    g = torch.zeros(16, 40, dtype=torch.float64)
    with pytest.raises(ValueError, match="EQ"):
        tkron.update_kron_whiten(ts, plan, g, fastrand.prng_key(0),
                                 return_pg=True)
    st = tkron.KronState(tuple(f[None] for f in ts.q),
                         tuple(l[None] for l in ts.lips))
    with pytest.raises(ValueError, match="EQ"):
        tkron.update_kron_whiten_stacked(st, plan, g[None],
                                         fastrand.split(fastrand.prng_key(0), 1),
                                         return_pg=True)
    with pytest.raises(ValueError, match="EQ"):
        jkron.update_kron_whiten(js, jplan, jnp.asarray(g.numpy()),
                                 jax.random.PRNGKey(0), return_pg=True)


def test_pro4p_loop_takes_several_steps():
    """The PRO4P fit's Procrustes loop runs on these states: the first fit
    of each dense factor takes more than one step (counted on the
    device), so the parity tests above hold the loop, not its exit."""
    tlinalg.procrustes_loop3.layer_steps = 0
    out, _ = next(_whiten_fits("PRO4P", "order3", None))
    assert int(tlinalg.procrustes_loop3.layer_steps) > 3


@pytest.mark.parametrize("case", sorted(SHAPES))
@pytest.mark.parametrize("normalizer", ["2nd", "1st"])
def test_eq_exact_matches_jax(normalizer, case):
    """update_kron_whiten_eq_exact, both step normalizers: three fits of one
    tensor (the balance gate replayed), f64, rtol 1e-9; the first-order
    normalizer leaves L as it is."""
    shape, skew = SHAPES[case]
    plan, ts, js, jplan = geometry_state(shape, skew, "EQ", 35)
    rng = np.random.default_rng(36)
    ref_fit = jax_fit("update_kron_whiten_eq_exact", jplan, lr=0.2,
                      step_normalizer=normalizer)
    for t in range(FITS):
        g = rng.standard_normal(shape)
        key = _keys(t, None)
        out = tkron.update_kron_whiten_eq_exact(
            ts, plan, torch.from_numpy(g), key, lr=0.2,
            step_normalizer=normalizer, draw=jax_draw)
        ref = ref_fit(js, g=jnp.asarray(g), key=jnp.asarray(key))
        _compare_states(out, ref, 1e-9)
        if normalizer == "1st":
            assert all(torch.equal(a, b) for a, b in zip(out.lips, ts.lips))
        ts, js = out, ref


def test_eq_exact_balances_at_its_own_key():
    """The gate of update_kron_whiten_eq_exact is keyed by the call's key
    itself: with factors 50x apart, a key whose uniform (JAX's default
    float, float64 here) is below 0.01 balances them before the fit, as in
    JAX."""
    plan, ts, js, jplan = geometry_state((16, 40), 2.0, "EQ", 37)
    ts = tkron.KronState((ts.q[0] * 50.0, ts.q[1]), ts.lips)
    js = jkron.KronState((js.q[0] * 50.0, js.q[1]), js.lips)
    key = next(k for k in map(fastrand.prng_key, range(10000))
               if jax_draw("uniform", k[None], (), torch.float64)[0] < 0.01)
    g = np.random.default_rng(38).standard_normal((16, 40))
    out = tkron.update_kron_whiten_eq_exact(ts, plan, torch.from_numpy(g), key,
                                            draw=jax_draw)
    ref = jkron.update_kron_whiten_eq_exact(js, jplan, jnp.asarray(g),
                                            jnp.asarray(key))
    _compare_states(out, ref, 1e-9)
    ratio = (out.q[0].abs().max() / out.q[1].abs().max()).item()
    assert 0.5 < ratio < 2.0, ratio


# ---------------------------------------------------------------------------
# the linear algebra
# ---------------------------------------------------------------------------


def _asymmetric_stack(n, scales, seed):
    """(B, n, n) near-SPD matrices whose skew parts have the given sizes."""
    rng = np.random.default_rng(seed)
    out = []
    for s in scales:
        a = rng.standard_normal((n, n))
        out.append(np.eye(n) + 0.1 * (a + a.T) / 2 + s * (a - a.T) / 2)
    return np.stack(out)


def test_procrustes_step3_matches_jax():
    """One third-order step per layer against JAX's procrustes_step3 on the
    same start, f64, rtol 1e-12; the step moves Q toward symmetry."""
    q = _asymmetric_stack(12, (0.05, 0.2, 0.01), 39)
    keys = fastrand.split(fastrand.prng_key(40), 3)
    v0 = jax_draw("normal", keys, (8, 12), torch.float64)
    out = tlinalg.procrustes_step3(torch.from_numpy(q),
                                   kernels.key_seed_words(keys, "cpu"),
                                   norm_k=8, v0=v0)
    for i in range(3):
        ref = jlinalg.procrustes_step3(jnp.asarray(q[i]), jnp.asarray(keys[i]),
                                       norm_k=8)
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-12)
        asym = lambda m: np.abs(m - m.T).max()
        assert asym(out[i].numpy()) < asym(q[i])


_jax_step3 = jax.jit(functools.partial(jlinalg.procrustes_step3, norm_k=8))


def test_procrustes_loop3_exits_per_layer_like_jax():
    """The loop over a stack whose layers leave on different steps (one
    already symmetric enough: no step; the others several), each against
    JAX's procrustes_loop3 of that layer alone, f64, rtol 1e-12; the
    device count of the steps taken is the sum of JAX's own."""
    q = _asymmetric_stack(10, (1e-5, 0.02, 0.3), 41)
    keys = fastrand.split(fastrand.prng_key(42), 3)
    tlinalg.procrustes_loop3.layer_steps = 0
    out = tlinalg.procrustes_loop3(torch.from_numpy(q), keys, norm_k=8,
                                   draw=jax_draw)
    steps = []
    for i in range(3):
        ref = jlinalg.procrustes_loop3(jnp.asarray(q[i]), jnp.asarray(keys[i]),
                                       norm_k=8)
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-12)
        qq, n = q[i], 0      # JAX's exit test replayed on its own iterates
        while n < 10 and np.abs(qq.T - qq).max() >= 1e-3 * np.abs(qq).max():
            qq = np.asarray(_jax_step3(
                jnp.asarray(qq), jax.random.fold_in(jnp.asarray(keys[i]), n)))
            n += 1
        steps.append(n)
    assert steps[0] == 0 and steps[1] >= 1 and steps[2] > steps[1], steps
    assert np.array_equal(out[0].numpy(), q[0])
    assert int(tlinalg.procrustes_loop3.layer_steps) == sum(steps)


@pytest.mark.parametrize("kind", ["tall_rows", "wide_cols", "zero", "tiny"])
def test_norm_lower_bound_matches_jax(kind):
    """The legacy row/column-energy bound per matrix of a stack against
    JAX's norm_lower_bound, f64, rtol 1e-12: a matrix whose largest energy
    is a row, one where it is a column, zero, and one at 1e-200."""
    rng = np.random.default_rng(43)
    a = rng.standard_normal((3, 9, 9))
    if kind == "tall_rows":
        a[:, 2] *= 10.0
    elif kind == "wide_cols":
        a[:, :, 4] *= 10.0
    elif kind == "zero":
        a[1] = 0.0
    else:
        a *= 1e-200
    out = tlinalg.norm_lower_bound(torch.from_numpy(a)).numpy()
    ref = np.array([float(jlinalg.norm_lower_bound(jnp.asarray(m))) for m in a])
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=0)
    assert np.all(out <= np.linalg.norm(a, ord=2, axis=(1, 2)) * (1 + 1e-12))
