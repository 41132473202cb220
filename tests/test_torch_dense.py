"""The port's dense preconditioner (psgd_torch_tpu_torch.precond.dense)
against the JAX package's, in each of the seven geometries, in float64 on
replayed draws (``jax_draw``: the damping, the whitening probe, the
Procrustes rotation's start and the Procrustes loop's starts), both sides
started from one state carried across with ``dense_state_from_jax``.

Tolerance: rtol 1e-9 (atol 1e-9 of the largest entry) in float64, the
same arithmetic in another order."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_torch_tpu.precond import dense as jdense
from psgd_torch_tpu_torch.ops import fastrand
from psgd_torch_tpu_torch.ops import linalg as tlinalg
from psgd_torch_tpu_torch.precond import dense as tdense
from psgd_torch_tpu_torch.precond import kron as tkron
from test_torch_kron import jax_draw, to_np

RTOL = 1e-9
UPDATES = 3
N = 10


def close(got, ref, what=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(to_np(got), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max(), err_msg=what)


def same_state(t, j, what=""):
    close(t.q, j.q, f"{what} q")
    close(t.lips, j.lips, f"{what} lips")


def random_state(dq, seed, skew=0.1):
    """Q = I + 0.1 noise (upper triangular for EQ, whose update solves with
    it; symmetric for QUAD and QUAD4P, which keep it so), skewed so that
    PRO4P's loop takes steps; L > 0."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((N, N)) / N ** 0.5
    q = np.eye(N) + 0.1 * (a + a.T) + (skew * (a - a.T)
                                       if dq not in ("QUAD", "QUAD4P") else 0.0)
    if dq == "EQ":
        q = np.triu(q)
    j = jdense.DenseState(q=jnp.asarray(q), lips=jnp.asarray(0.5 + rng.random()))
    return tdense.dense_state_from_jax(j, device="cpu"), j


@functools.lru_cache(maxsize=None)
def jax_update(name, dq, damping_none=False):
    """A JAX update for geometry dq, jitted once (norm_k 4)."""
    kw = dict(dq=dq, norm_k=4)
    if damping_none:
        kw["damping"] = None
    return jax.jit(functools.partial(getattr(jdense, name), **kw))


@pytest.mark.parametrize("dq", tkron.ALL_DQ)
def test_update_dense_matches_jax(dq):
    """UPDATES successive Newton updates from random (v, h) pairs (v as
    (n,), h as (n, 1) and back), damped from kd, against
    jdense.update_dense; PRO4P's loop takes the same steps."""
    t, j = random_state(dq, seed=len(dq))
    rng = np.random.default_rng(7)
    tlinalg.procrustes_loop3.layer_steps = 0
    for i in range(UPDATES):
        key = fastrand.prng_key(30 + i)
        v, h = rng.standard_normal((2, N))
        hc = h[:, None] if i % 2 else h
        j = jax_update("update_dense", dq)(j, jnp.asarray(v), jnp.asarray(hc),
                                           jnp.asarray(key), lr=0.3,
                                           beta_l=0.8, damping=1e-2)
        t = tdense.update_dense(t, torch.from_numpy(v), torch.from_numpy(hc),
                                key, dq, lr=0.3, beta_l=0.8, damping=1e-2,
                                norm_k=4, draw=jax_draw)
        same_state(t, j, f"{dq} update {i}")
    if dq == "PRO4P":
        assert int(tlinalg.procrustes_loop3.layer_steps) > 0


@pytest.mark.parametrize("dq", ["Q0.5EQ1.5", "QEQ", "PRO4P"])
def test_update_dense_without_damping_matches_jax(dq):
    """damping=None: (v, h) taken as they are, no noise drawn."""
    t, j = random_state(dq, seed=2)
    v, h = np.random.default_rng(1).standard_normal((2, N, 1))
    key = fastrand.prng_key(3)
    j = jax_update("update_dense", dq, True)(j, jnp.asarray(v), jnp.asarray(h),
                                             jnp.asarray(key))
    calls = []

    def draw(kind, keys, shape, dtype):
        calls.append(shape)
        return jax_draw(kind, keys, shape, dtype)

    t = tdense.update_dense(t, torch.from_numpy(v), torch.from_numpy(h), key,
                            dq, damping=None, norm_k=4, draw=draw)
    same_state(t, j, dq)
    assert (N, 1) not in calls


@pytest.mark.parametrize("dq", tkron.ALL_DQ)
def test_update_dense_whiten_matches_jax(dq):
    """The whitening wrapper: the probe v and the damped g from kv, fed
    undamped to the update keyed ku."""
    t, j = random_state(dq, seed=11)
    rng = np.random.default_rng(8)
    for i in range(2):
        key = fastrand.prng_key(50 + i)
        g = rng.standard_normal(N)
        j = jax_update("update_dense_whiten", dq)(j, jnp.asarray(g),
                                                  jnp.asarray(key), lr=0.2,
                                                  damping=1e-2)
        t = tdense.update_dense_whiten(t, torch.from_numpy(g), key, dq, lr=0.2,
                                       damping=1e-2, norm_k=4, draw=jax_draw)
        same_state(t, j, f"{dq} whiten {i}")


@pytest.mark.parametrize("dq", tkron.ALL_DQ)
def test_init_and_precond_grad_match_jax(dq):
    """init_dense (scale squared for the fit-P geometries) and the apply
    (Q g, Q Q g for QUAD, Q^T Q g otherwise) on (n,) and (n, 1)."""
    t0 = tdense.init_dense(N, 1.5, dq, torch.float64, device="cpu")
    j0 = jdense.init_dense(N, 1.5, dq, jnp.float64)
    same_state(t0, j0, dq)
    t, j = random_state(dq, seed=4)
    g = np.random.default_rng(6).standard_normal(N)
    close(tdense.precond_grad(t, torch.from_numpy(g), dq),
          jdense.precond_grad(j, jnp.asarray(g), dq))
    out = tdense.precond_grad(t, torch.from_numpy(g[:, None]), dq)
    assert out.shape == (N, 1)
    close(out, jdense.precond_grad(j, jnp.asarray(g[:, None]), dq))


def test_dense_rules_and_port_draws():
    """Unknown dQ refused; complex Q taken (A3b); the alias accepted;
    without a replay hook a Q0.5EQ1.5 and a PRO4P update are finite and
    move Q."""
    with pytest.raises(ValueError, match="dQ"):
        tdense.init_dense(4, dq="XYZ", device="cpu")
    cx = tdense.init_dense(4, dtype=torch.complex64, device="cpu")
    assert cx.q.dtype == torch.complex64 and cx.lips.dtype == torch.float32
    st = tdense.init_dense(4, dq="Q0p5EQ1p5", device="cpu")
    assert torch.equal(st.q, torch.eye(4))
    gen = torch.Generator().manual_seed(0)
    for dq in ("Q0.5EQ1.5", "PRO4P"):
        st = tdense.init_dense(32, dq=dq, device="cpu")
        v, h = torch.randn((2, 32), generator=gen)
        out = tdense.update_dense(st, v, h, fastrand.prng_key(1), dq)
        assert torch.isfinite(out.q).all() and not torch.equal(out.q, st.q)
