"""The port's LRA preconditioner (psgd_torch_tpu_torch.precond.lra) against
the JAX package's, in float64 on replayed draws (``jax_draw``: the U/V
init, the whitening probe, the Newton damping and the U-or-V coin), both
sides started from one state carried across with ``lra_state_from_jax``.

Tolerance: rtol 1e-9 (atol 1e-9 of the largest entry) in float64, the
same arithmetic in another order."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_torch_tpu.precond import lra as jlra
from psgd_torch_tpu_torch.ops import fastrand
from psgd_torch_tpu_torch.precond import lra as tlra
from test_torch_kron import jax_draw, to_np

RTOL = 1e-9
UPDATES = 3


def close(got, ref, what=""):
    ref = np.asarray(ref, np.float64)
    atol = RTOL * max(np.abs(ref).max(initial=0.0), 1e-300)
    np.testing.assert_allclose(to_np(got), ref, rtol=RTOL, atol=atol,
                               err_msg=what)


def same_state(t, j):
    for f in tlra.LRAState._fields:
        close(getattr(t, f), getattr(j, f), f)


def random_state(n, rank, seed):
    """U, V of norm ~0.3, d = 1 + noise, L > 0: the JAX state and the
    port's, carried across."""
    rng = np.random.default_rng(seed)
    j = jlra.LRAState(
        u=jnp.asarray(0.3 * rng.standard_normal((n, rank)) / max(rank, 1)),
        v=jnp.asarray(0.3 * rng.standard_normal((n, rank)) / max(rank, 1)),
        d=jnp.asarray(1.0 + 0.1 * rng.standard_normal((n, 1))),
        lu=jnp.asarray(0.5 + rng.random()), lv=jnp.asarray(0.5 + rng.random()),
        ld=jnp.asarray(0.5 + rng.random()))
    return tlra.lra_state_from_jax(j, device="cpu"), j


def coin_is_u(key) -> bool:
    """The branch ``update_lra`` takes for ``key`` under the JAX draw."""
    kc = fastrand.fold_in(key, tlra.COIN_FOLD)
    return float(jax_draw("uniform", kc[None], (), torch.float64)[0]) < 0.5


def key_for(branch: str, start: int):
    """The first key prng_key(s), s >= start, whose coin takes ``branch``."""
    s = start
    while coin_is_u(fastrand.prng_key(s)) != (branch == "u"):
        s += 1
    return fastrand.prng_key(s)


@functools.lru_cache(maxsize=None)
def jax_fn(name):
    """A JAX update, jitted once (lr, beta_l and damping traced)."""
    return jax.jit(getattr(jlra, name))


def test_coin_branches_are_forced_by_key():
    for branch in ("u", "v"):
        assert coin_is_u(key_for(branch, 0)) == (branch == "u")


@pytest.mark.parametrize("n", [7, 24])
@pytest.mark.parametrize("rank,branch", [(0, "-"), (3, "u"), (3, "v")])
def test_update_lra_matches_jax(rank, branch, n):
    """UPDATES successive raw updates from random (v, h) pairs, the first
    keyed to take ``branch`` (rank 0: only d moves), against
    jlra.update_lra."""
    t, j = random_state(n, rank, seed=n + rank)
    rng = np.random.default_rng(100 + n)
    branches = []
    for i in range(UPDATES):
        key = key_for(branch, 10 * i) if (i == 0 and rank) else \
            fastrand.prng_key(1000 + i)
        branches.append(coin_is_u(key))
        v, h = rng.standard_normal((2, n, 1))
        j = jax_fn("update_lra")(j, jnp.asarray(v), jnp.asarray(h),
                                 jnp.asarray(key), 0.3, 0.8)
        t = tlra.update_lra(t, torch.from_numpy(v), torch.from_numpy(h[:, 0]),
                            key, lr=0.3, beta_l=0.8, draw=jax_draw)
        same_state(t, j)
    if rank:
        assert branches[0] == (branch == "u")
        assert t.u.shape == (n, rank) and t.d.shape == (n, 1)
    else:
        assert t.u.shape == (n, 0)


@pytest.mark.parametrize("rank", [0, 3])
def test_update_lra_whiten_and_newton_match_jax(rank):
    """The whitening wrapper (its probe v and the damped g from kv) and the
    Newton wrapper (h damped from kd) against JAX, three updates each,
    on (n,) and (n, 1) inputs; a large damping makes the noise count."""
    n = 20
    rng = np.random.default_rng(5)
    t, j = random_state(n, rank, seed=1)
    tn, jn = t, j
    for i in range(UPDATES):
        key = fastrand.prng_key(40 + i)
        g = rng.standard_normal(n) if i % 2 else rng.standard_normal((n, 1))
        j = jax_fn("update_lra_whiten")(j, jnp.asarray(g), jnp.asarray(key),
                                        0.2, 0.9, 1e-2)
        t = tlra.update_lra_whiten(t, torch.from_numpy(g), key, lr=0.2,
                                   beta_l=0.9, damping=1e-2, draw=jax_draw)
        same_state(t, j)
        v, h = rng.standard_normal((2, n))
        jn = jax_fn("update_lra_newton")(jn, jnp.asarray(v), jnp.asarray(h),
                                         jnp.asarray(key), 0.2, 0.9, 1e-2)
        tn = tlra.update_lra_newton(tn, torch.from_numpy(v), torch.from_numpy(h),
                                    key, lr=0.2, beta_l=0.9, damping=1e-2,
                                    draw=jax_draw)
        same_state(tn, jn)


@pytest.mark.parametrize("rank", [0, 3])
def test_precond_grad_and_log_det_match_jax(rank):
    n = 16
    t, j = random_state(n, rank, seed=9)
    g = np.random.default_rng(3).standard_normal((n, 1))
    close(tlra.precond_grad(t, torch.from_numpy(g)), jlra.precond_grad(j, g))
    out = tlra.precond_grad(t, torch.from_numpy(g[:, 0]))
    assert out.shape == (n,)
    close(out, jlra.precond_grad(j, g[:, 0]))
    close(tlra.log_det(t), jlra.log_det(j))
    x = torch.from_numpy(g)
    close(tlra.ip_uvt_matvec(t.u, t.v, x), jlra.ip_uvt_matvec(j.u, j.v, g))


@pytest.mark.parametrize("rank", [0, 4])
def test_init_lra_matches_jax(rank):
    """U and V from split(key) scaled to ||.||_F = sqrt(0.1) (the norm taken
    in float32, as JAX takes it), d = scale, L = 0 in the lifted dtype."""
    key = fastrand.prng_key(11)
    t = tlra.init_lra(9, rank, key, scale=2.5, dtype=torch.float64,
                      device="cpu", draw=jax_draw)
    j = jlra.init_lra(9, rank, jnp.asarray(key), 2.5, jnp.float64)
    same_state(t, j)
    assert t.lu.dtype == torch.float64 and t.u.shape == (9, rank)
    if rank:
        assert abs(torch.linalg.vector_norm(t.u).item() - 0.1 ** 0.5) < 1e-6
    t32 = tlra.init_lra(9, rank, key, dtype=torch.bfloat16, device="cpu",
                        draw=jax_draw)
    assert t32.d.dtype == torch.bfloat16 and t32.ld.dtype == torch.float32


def test_init_lra_rules():
    key = fastrand.prng_key(0)
    for rank in (-1, 5, 6):
        with pytest.raises(ValueError, match="rank"):
            tlra.init_lra(5, rank, key, device="cpu")
    # complex (A3b): complex64 U, V and d, the U and V norms from their
    # real parts (JAX's astype(float32)), real L estimates
    cx = tlra.init_lra(5, 2, key, dtype=torch.complex64, device="cpu")
    assert cx.u.dtype == cx.d.dtype == torch.complex64
    assert cx.lu.dtype == torch.float32 and bool((cx.u.imag != 0).any())
    assert abs(torch.linalg.vector_norm(cx.u.real).item() - 0.1 ** 0.5) < 1e-6
    # the port's own draws: U and V differ, both at the target norm
    st = tlra.init_lra(50, 3, key, device="cpu")
    assert not torch.equal(st.u, st.v)
    for x in (st.u, st.v):
        assert abs(torch.linalg.vector_norm(x).item() - 0.1 ** 0.5) < 1e-6


def test_port_draws_whiten_and_newton():
    """Without a replay hook the whitening probe and its damping come from
    one key (the same v), and the update is finite and moves the state."""
    n = 64
    st = tlra.init_lra(n, 4, fastrand.prng_key(1), device="cpu")
    g = torch.randn(n, generator=torch.Generator().manual_seed(0))
    out = tlra.update_lra_whiten(st, g, fastrand.prng_key(2), damping=0.5)
    assert all(torch.isfinite(x).all() for x in out)
    assert not torch.equal(out.d, st.d)
    out2 = tlra.update_lra_newton(st, g, 2 * g, fastrand.prng_key(2))
    assert all(torch.isfinite(x).all() for x in out2)
