"""The NS update (psgd_torch_tpu_torch.ops.kernels.fused_ns_update) against
the JAX package's XLA tail, ``kron._ns_tail_stacked_xla``.

On the CPU the wrapper runs its plain version; the CUDA kernel is held
against that plain version on the card (tests/test_torch_kernels_gpu.py,
and chip_smoke.py at the main path's shapes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psgd_torch_tpu.ops.linalg import norm_lower_bound_spd
from psgd_torch_tpu.precond.kron import _ns_tail_stacked_xla
from psgd_torch_tpu_torch.ops import fastrand, kernels


def _inputs(b, n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, n, n))
    term1 = a @ np.swapaxes(a, 1, 2) / n + 0.5 * np.eye(n)
    q = 0.7 * np.eye(n) + 0.02 * rng.standard_normal((b, n, n))
    return term1.astype(dtype), q.astype(dtype)


@pytest.mark.parametrize("n", [128, 256])
def test_plain_matches_jax_on_replayed_draws(n):
    """f64, rtol 1e-10: the same arithmetic with the JAX draws replayed."""
    b, k = 3, 32
    term1, q = _inputs(b, n, n)
    lips = np.array([0.0, 2.0, 40.0])
    term2 = np.full(b, 3.0)
    root = jax.random.split(jax.random.PRNGKey(n), 2 * b)
    kb, kp = root[:b], root[b:]
    ref_q, ref_l = _ns_tail_stacked_xla(
        jnp.asarray(q), jnp.asarray(term1), jnp.asarray(lips),
        jnp.asarray(term2), kb, kp, 0.1, 0.9, k)
    starts = tuple(torch.from_numpy(np.array(jax.vmap(
        lambda kk: jax.random.normal(kk, (k, n), jnp.float64))(keys)))
        for keys in (kb, kp))
    seeds = kernels.key_seed_words(np.asarray(kb), "cpu")
    out_q, out_l = kernels.fused_ns_update(
        torch.from_numpy(term1), torch.from_numpy(q), torch.from_numpy(lips),
        torch.from_numpy(term2), seeds, 0.1, 0.9, k=k, starts=starts)
    np.testing.assert_allclose(out_q.numpy(), np.asarray(ref_q), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(out_l.numpy(), np.asarray(ref_l), rtol=1e-10)


def test_own_draws_match_jax_within_bound_noise():
    """f32 with the port's own Philox starts against the JAX XLA tail with
    its threefry starts, held as the Pallas kernel is held against XLA
    (tests/test_pallas_kernels.py): q within 5e-3 (max-abs relative), L
    within rtol 0.06 (the stochastic bound's spread)."""
    b, n = 4, 256
    term1, q = _inputs(b, n, 0, np.float32)
    lips = np.zeros(b, np.float32)
    term2 = np.full(b, 3.0, np.float32)
    root = jax.random.split(jax.random.PRNGKey(7), 2 * b)
    ref_q, ref_l = _ns_tail_stacked_xla(
        jnp.asarray(q), jnp.asarray(term1), jnp.asarray(lips),
        jnp.asarray(term2), root[:b], root[b:], 0.1, 0.9, 128)
    seeds = kernels.key_seed_words(fastrand.split(fastrand.prng_key(1), b),
                                   "cpu")
    out_q, out_l = kernels.fused_ns_update(
        torch.from_numpy(term1), torch.from_numpy(q), torch.from_numpy(lips),
        torch.from_numpy(term2), seeds, 0.1, 0.9, k=128)
    ref_q = np.asarray(ref_q)
    rel = np.abs(out_q.numpy() - ref_q).max() / np.abs(ref_q).max()
    assert rel < 5e-3, rel
    np.testing.assert_allclose(out_l.numpy(), np.asarray(ref_l), rtol=0.06)


@pytest.mark.parametrize("n", [128, 256])
def test_bound_is_a_tight_lower_bound(n):
    """With L = 0 and term2 = 0 the returned L is the spd bound itself: at
    most 1.001 x the true norm and above 0.9 x the JAX bound."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, n)).astype(np.float32) / n ** 0.5
    term1 = a @ a.T + 0.1 * np.eye(n, dtype=np.float32)
    true = np.linalg.eigvalsh(term1.astype(np.float64))[-1]
    q = (0.9 * np.eye(n) + 0.05 * rng.standard_normal((n, n))).astype(np.float32)
    seeds = kernels.key_seed_words(np.array([[n, n + 7]], np.uint32), "cpu")
    _, lip = kernels.fused_ns_update(
        torch.from_numpy(term1)[None], torch.from_numpy(q)[None],
        torch.zeros(1), torch.zeros(1), seeds, 0.1, 0.9, k=128)
    ref = float(norm_lower_bound_spd(jnp.asarray(term1), jax.random.PRNGKey(3),
                                     k=128))
    assert lip.item() <= 1.001 * true
    assert lip.item() > 0.9 * ref


def test_bf16_inputs():
    """bf16 Q and term1: the plain version computes in f32 and rounds q' to
    bf16 once, so against the f32 run on the same (bf16-exact) inputs and
    seeds q' differs by that rounding only (2^-8 relative per element):
    Frobenius-relative error < 4e-3, L equal to rtol 1e-6."""
    b, n = 2, 128
    term1, q = _inputs(b, n, 5, np.float32)
    t_bf = torch.from_numpy(term1).to(torch.bfloat16)
    q_bf = torch.from_numpy(q).to(torch.bfloat16)
    seeds = kernels.key_seed_words(fastrand.split(fastrand.prng_key(2), b), "cpu")
    args = (torch.zeros(b), torch.full((b,), 3.0), seeds, 0.1, 0.9)
    qb, lb = kernels.fused_ns_update(t_bf, q_bf, *args, k=128)
    qf, lf = kernels.fused_ns_update(t_bf.float(), q_bf.float(), *args, k=128)
    assert qb.dtype == torch.bfloat16 and lb.dtype == torch.float32
    rel = ((qb.float() - qf).norm() / qf.norm()).item()
    assert rel < 4e-3, rel
    np.testing.assert_allclose(lb.numpy(), lf.numpy(), rtol=1e-6)

